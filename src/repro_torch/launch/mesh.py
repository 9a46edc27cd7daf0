"""The graph engine's device mesh and its sharding rules.

Counterpart of the graph half of the JAX package's ``repro/launch/mesh.py``
(``make_graph_mesh``, ``GraphShardingRules``).  There a 1-D ``Mesh`` and
``PartitionSpec``s tell ``shard_map`` where each operand lives; here one
process drives several devices, so the mesh is a named tuple of
``torch.device``s and each rule is the operation that places or collects a
tensor:

  * the block-ELL tile table and its column-index table split by row-stripe
    on the axis (one contiguous slab a shard);
  * activations (X, x_r; or H, W, w_r) are replicated: any stripe's column
    blocks may reference any row;
  * output rows live where their stripes live, and are concatenated onto
    the first device;
  * scalar check partials reduce to one replicated value (the psum), added
    in shard order on the first device;
  * per-stripe check partials concatenate, each stripe from its one owner.

The LM half, :func:`make_production_mesh`, :func:`make_test_mesh` and
:class:`ShardingRules`, is the counterpart of the reference's LM mesh on
DTensor: a ``DeviceMesh`` over the default process group stands for the
``Mesh``, a spec (one entry a tensor dim: ``None``, an axis name or a tuple
of axis names — the ``PartitionSpec``'s own entries) for the
``PartitionSpec``, and :meth:`ShardingRules.placements` turns a spec into
the ``Shard``/``Replicate`` placement of each mesh dim.  The rules are the
reference's line for line, so a spec here equals the reference's spec
entry for entry.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GraphMesh:
    """A 1-D list of devices named by one axis."""

    devices: Tuple[torch.device, ...]
    axis: str = "graph"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a graph mesh needs at least one device")

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis,)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: len(self.devices)}


def make_graph_mesh(n_devices: Optional[int] = None, axis: str = "graph", *,
                    device: DeviceLike = "cuda") -> GraphMesh:
    """1-D mesh of ``n_devices`` shards for stripe sharding.

    On ``"cuda"`` shard i lives on card ``i % torch.cuda.device_count()``:
    each shard on a card of its own when there are enough, every shard on
    ``cuda:0`` on a one-card machine.  ``n_devices`` defaults to the card
    count.  On ``"cpu"`` every shard lives on the CPU (default 1 shard).
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        devices = tuple(torch.device("cuda", i % count) for i in range(n))
    else:
        n = 1 if n_devices is None else n_devices
        devices = (dev,) * n
    if n < 1:
        raise ValueError(f"a graph mesh needs n_devices >= 1, got {n}")
    return GraphMesh(devices, axis)


class GraphShardingRules:
    """Where each operand of the stripe-sharded block-ELL backend lives."""

    def __init__(self, mesh: GraphMesh, axis: str = "graph"):
        assert axis in mesh.axis_names, (axis, mesh.axis_names)
        self.mesh = mesh
        self.axis = axis

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.axis]

    def _bounds(self, n_rows: int) -> List[Tuple[int, int]]:
        n = self.n_shards
        if n_rows % n:
            raise ValueError(f"{n_rows} stripes do not split over {n} "
                             f"shards; pad with pad_block_rows first")
        per = n_rows // n
        return [(i * per, (i + 1) * per) for i in range(n)]

    def split_stripes(self, t: Tensor) -> List[Tensor]:
        """block_cols [nbm, width] or values [nbm, width, bm, bk]: shard i
        owns stripes [i·nbm/n, (i+1)·nbm/n), a contiguous slab of ``t``
        (a view at an offset base pointer on its own device)."""
        return [t[a:b].to(d) for (a, b), d
                in zip(self._bounds(t.shape[0]), self.mesh.devices)]

    def replicate(self, t: Tensor) -> List[Tensor]:
        """An activation on every shard's device (one copy a device)."""
        copies: Dict[torch.device, Tensor] = {}
        return [copies.setdefault(d, t.to(d)) for d in self.mesh.devices]

    def gather_rows(self, parts: Sequence[Tensor]) -> Tensor:
        """Row-sharded outputs (or per-stripe partials) concatenated in
        shard order on the first device."""
        first = self.mesh.devices[0]
        return torch.cat([p.to(first) for p in parts], dim=0)

    def psum(self, parts: Sequence[Tensor]) -> Tensor:
        """Scalar partials added in shard order on the first device."""
        first = self.mesh.devices[0]
        total = parts[0].to(first)
        for p in parts[1:]:
            total = total + p.to(first)
        return total


# ---------------------------------------------------------------------------
# The LM mesh: (data 16, model 16) a pod, (pod 2, data 16, model 16) across
# two pods, over the default process group.  Importing this module touches
# no process group: the meshes are built behind functions.
#
# Parameters: the largest non-'model' axis FSDP-shards over ('pod', 'data');
# head/expert/ff/vocab axes shard over 'model' when divisible.  Batch shards
# over ('pod', 'data').  KV caches: kv-heads over 'model' when divisible,
# otherwise the cache *sequence* axis shards over 'model' (MQA); batch over
# ('pod', 'data') unless batch == 1 (long_500k), where sequence sharding
# carries all of it.
# ---------------------------------------------------------------------------

# A spec entry: None (replicated), an axis name, or a tuple of axis names.
Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = "cuda"):
    """The production ``DeviceMesh``: (16, 16) ("data", "model"), or
    (2, 16, 16) ("pod", "data", "model") with ``multi_pod``, over the
    default process group, which must have exactly that many ranks (a
    ``"fake"`` group of 256 or 512 ranks for the dry run)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    import torch.distributed as dist

    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise RuntimeError(
            f"need {need} ranks for {shape}, have {have} — run under a "
            f"process group of world size {need} (dryrun.py makes a 'fake' "
            f"one)")
    return make_test_mesh(shape, axes, device=device)


def make_test_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
                   device: DeviceLike = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    ``prod(shape)`` ranks of the default process group."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def _mesh_shape(mesh) -> Dict[str, int]:
    """Axis sizes by name: a ``DeviceMesh``'s, or a stand-in's ``shape``
    dict (an object with ``axis_names`` and ``shape``, as the reference's
    tests pass)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_names(mesh) -> Tuple[str, ...]:
    return tuple(getattr(mesh, "axis_names", None) or mesh.mesh_dim_names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where one tensor lives: a mesh and a spec.  Unpacks as the pair
    ``(mesh, placements)`` — one DTensor placement a mesh dim."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return spec_placements(self.mesh, self.spec)

    def __iter__(self) -> Iterator:
        return iter((self.mesh, self.placements))


def spec_placements(mesh, spec: Spec) -> tuple:
    """One placement a mesh dim: ``Shard(i)`` where tensor dim ``i``'s
    entry names the mesh dim's axis, else ``Replicate()``; an axis of size
    1 replicates (the same layout, which DTensor lets a view merge).  A
    tensor dim split over several axes names them in mesh order (major
    first), as DTensor nests its shards."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axis_names(mesh)
    sizes = _mesh_shape(mesh)
    owner: Dict[str, int] = {}
    for i, entry in enumerate(spec):
        axes = () if entry is None else \
            (entry,) if isinstance(entry, str) else tuple(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {spec}: axes {axes} are not in mesh "
                             f"order {names}")
        for a in axes:
            if a in owner:
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            owner[a] = i
    return tuple(Shard(owner[a]) if a in owner and sizes[a] > 1
                 else Replicate() for a in names)


def _map_keyed(fn, tree: Any) -> Any:
    """``fn(key, leaf)`` over every leaf of ``tree``, its structure kept;
    ``key`` is the leaf's path joined by ``/``, as the reference names it
    (``segments/0/b0/attn/wq/w``)."""
    from repro_torch.optim.tree import tree_flatten_with_path, tree_unflatten

    return tree_unflatten(tree, iter(
        [fn("/".join(str(p) for p in path), leaf)
         for path, leaf in tree_flatten_with_path(tree)]))


def sharding_leaves(tree: Any, shardings: Any) -> List["NamedSharding"]:
    """The sharding of each leaf of ``tree``: ``shardings`` is a tree of
    its structure, or one sharding for every leaf."""
    from repro_torch.optim.tree import tree_leaves

    n = len(tree_leaves(tree))
    if isinstance(shardings, NamedSharding):
        return [shardings] * n
    out = tree_leaves(shardings)
    if len(out) != n:
        raise ValueError(f"{len(out)} shardings for {n} leaves")
    return out


class ShardingRules:
    """Maps parameter/batch/cache paths to specs for a given mesh."""

    def __init__(self, mesh, *, fsdp: bool = True,
                 shard_cache_seq_for_mqa: bool = True):
        self.mesh = mesh
        self.axes = _axis_names(mesh)
        self.model_size = _mesh_shape(mesh)["model"]
        dp = [a for a in ("pod", "data") if a in self.axes]
        self.dp: Any = tuple(dp) if len(dp) > 1 else dp[0]
        self.fsdp_axis: Any = self.dp if fsdp else None
        self.shard_cache_seq_for_mqa = shard_cache_seq_for_mqa

    # -- helpers ----------------------------------------------------------
    # Shapes divide EXACTLY (the reference's pjit rejects uneven shards;
    # DTensor would take them): every rule checks strictly and falls back
    # to an alternate axis or replication.

    @property
    def dp_size(self) -> int:
        ax = self.fsdp_axis if isinstance(self.fsdp_axis, tuple) else \
            (self.fsdp_axis,)
        return math.prod(_mesh_shape(self.mesh)[a] for a in ax if a)

    def _model_if_div(self, dim: int) -> Optional[str]:
        return "model" if dim > 0 and dim % self.model_size == 0 else None

    def _fsdp_if_div(self, dim: int):
        if self.fsdp_axis is None:
            return None
        return self.fsdp_axis if dim % self.dp_size == 0 else None

    # -- parameters -------------------------------------------------------

    def param_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        stacked = bool(re.search(r"segments/\d+/", path))
        base = self._param_base(path, shape[1:] if stacked else shape)
        if stacked:
            base = (None,) + base
        assert len(base) == len(shape), (path, shape, base)
        return tuple(base)

    def _param_base(self, path: str, s: Tuple[int, ...]) -> Tuple:
        fs = self._fsdp_if_div
        md = self._model_if_div
        # vocab is padded to a mesh multiple (ModelConfig.padded_vocab).
        # NEVER shard d_model of embed/head: the tied-head matmul would
        # contract over a sharded axis and all-reduce [B,T,V] activations.
        if path.endswith("embed/table"):
            return (md(s[0]), None)
        if path.endswith("head/w"):
            return (None, md(s[1]))
        # attention (3-D [d, heads, hd] — rwkv reuses wk/wv names for 2-D).
        # NEVER shard head_dim: a sharded score/AV contraction forces
        # per-chunk all-reduces.  Heads that do not divide the model axis
        # replicate (attention params are small; the model axis still
        # carries the MLP).
        for nm in ("wq/w", "wk/w", "wv/w"):
            if path.endswith(nm) and len(s) == 3:
                return (fs(s[0]), md(s[1]), None)
        for nm in ("wq/b", "wk/b", "wv/b"):
            if path.endswith(nm) and len(s) == 2:
                return (md(s[0]), None)
        if path.endswith("wo/w") and len(s) == 2 and ("attn" in path or
                                                      "xattn" in path):
            return (md(s[0]), fs(s[1]))
        # MoE
        if path.endswith("router/w"):
            return (fs(s[0]), md(s[1]))
        if "w_up" in path or "w_gate" in path:
            return (md(s[0]), fs(s[1]), None)
        if "w_down" in path:
            return (md(s[0]), None, fs(s[2]))
        if "gate_x" in path or "gate_a" in path:   # rglru block-diag gates
            return (md(s[0]), None, None)
        # MLP / rwkv / rglru dense params [d_in, d_out]
        if len(s) == 2 and path.endswith("/w"):
            # shard the bigger of ff-style dims over model
            if s[1] >= s[0]:
                if md(s[1]):
                    return (fs(s[0]), md(s[1]))
                return (md(s[0]), fs(s[1]))
            if md(s[0]):
                return (md(s[0]), fs(s[1]))
            return (fs(s[0]), md(s[1]))
        if len(s) == 2 and ("lora" in path or path.endswith("mu")):
            return (None, None)
        if len(s) == 3:      # e.g. rwkv lora_a [d,5,r] / lora_b [5,r,d]
            return (None, None, None) if s[0] <= 8 else (fs(s[0]), None, None)
        if len(s) == 1:
            return (None,)
        return tuple(None for _ in s)

    def _combined_if_div(self, dim: int):
        """('pod','data','model') stacked on one axis when divisible."""
        ax = (self.fsdp_axis if isinstance(self.fsdp_axis, tuple)
              else (self.fsdp_axis,)) if self.fsdp_axis else ()
        combo = tuple(a for a in ax if a) + ("model",)
        size = self.dp_size * self.model_size
        if dim % size == 0:
            return combo
        return self._fsdp_if_div(dim) or self._model_if_div(dim)

    def params_shardings(self, params: Any) -> Any:
        """A tree of :class:`NamedSharding` of ``params``' structure (its
        leaves tensors of any device, ``meta`` included)."""
        return _map_keyed(lambda key, leaf: NamedSharding(
            self.mesh, self.param_spec(key, tuple(leaf.shape))), params)

    # -- batch / activations ----------------------------------------------

    def batch_spec(self, shape: Tuple[int, ...], batch_size: int) -> Spec:
        dp = self.dp if batch_size > 1 else None
        return (dp, *(None,) * (len(shape) - 1))

    def batch_shardings(self, batch: Any) -> Any:
        return _map_keyed(lambda _key, leaf: NamedSharding(
            self.mesh, self.batch_spec(tuple(leaf.shape), leaf.shape[0])),
            batch)

    # -- decode state -----------------------------------------------------

    def cache_spec(self, path: str, shape: Tuple[int, ...], batch: int,
                   n_kv: int) -> Spec:
        """Shapes carry a leading [count] (stacked units) axis."""
        dp = self.dp if batch > 1 else None
        kv_sharded = n_kv % self.model_size == 0
        if path.endswith("/k") or path.endswith("/v") or \
                path.endswith("xk") or path.endswith("xv"):
            # [count, B, L, Kh, hd]
            if kv_sharded:
                return (None, dp, None, "model", None)
            if self.shard_cache_seq_for_mqa:
                return (None, dp, "model", None, None)
            return (None, dp, None, None, None)
        if path.endswith("/vr") or path.endswith("xvr"):
            # [count, B, L, H] — mirror k's L sharding
            if kv_sharded:
                return (None, dp, None, self._model_if_div(shape[3]))
            if self.shard_cache_seq_for_mqa:
                return (None, dp, "model", None)
            return (None, dp, None, None)
        if path.endswith("/pos"):
            if not kv_sharded and self.shard_cache_seq_for_mqa:
                return (None, dp, "model")
            return (None, dp, None)
        if path.endswith("wkv"):          # [count, B, H, hd, hd]
            return (None, dp, self._model_if_div(shape[2]), None, None)
        if path.endswith("/h"):           # rglru [count, B, dr]
            return (None, dp, self._model_if_div(shape[2]))
        if path.endswith("conv"):         # [count, B, K-1, dr]
            return (None, dp, None, self._model_if_div(shape[3]))
        if path.endswith("x_tm") or path.endswith("x_cm"):
            return (None, dp, None)
        return (None,) * len(shape)

    def state_shardings(self, states: Any, batch: int, n_kv: int) -> Any:
        return _map_keyed(lambda key, leaf: NamedSharding(
            self.mesh, self.cache_spec(key, tuple(leaf.shape), batch, n_kv)),
            states)

    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, ())

    def placements(self, spec: Spec) -> tuple:
        """``spec``'s DTensor placements on this mesh, one a mesh dim."""
        return spec_placements(self.mesh, spec)


def distribute_tree(tree: Any, shardings: Any) -> Any:
    """Each tensor leaf of ``tree`` as a DTensor placed by the matching
    :class:`NamedSharding` (:func:`sharding_leaves`).  A leaf that is
    already a DTensor is redistributed; a shape that does not divide its
    spec raises (the rules never produce one)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.optim.tree import tree_leaves, tree_unflatten

    out = []
    for t, sh in zip(tree_leaves(tree), sharding_leaves(tree, shardings)):
        mesh, placements = sh
        local_shape(tuple(t.shape), sh)
        out.append(t.redistribute(mesh, placements) if isinstance(t, DTensor)
                   else distribute_tensor(t, mesh, placements))
    return tree_unflatten(tree, iter(out))


def local_shape(shape: Tuple[int, ...], sharding: NamedSharding
                ) -> Tuple[int, ...]:
    """Each rank's shard of a tensor of ``shape``; raises unless every
    sharded dim divides by its axes' sizes."""
    sizes = _mesh_shape(sharding.mesh)
    local = list(shape)
    for i, entry in enumerate(sharding.spec):
        axes = () if entry is None else \
            (entry,) if isinstance(entry, str) else entry
        n = math.prod(sizes[a] for a in axes)
        if local[i] % n:
            raise ValueError(f"dim {i} of {shape} does not divide over "
                             f"{axes} ({sharding.spec})")
        local[i] //= n
    return tuple(local)


# ---------------------------------------------------------------------------
# Views of sharded DTensors.  XLA reshards around any reshape; DTensor
# (torch 2.11) refuses a view that splits a sharded dim unless the first of
# its parts divides by the shard count, and one that merges dims unless
# only the first of them is sharded ("cannot be performed without
# redistribution").  Inside a sharded step every such view first gathers
# the mesh dims that shard the offending dims (an all-gather each, counted
# as collective bytes), the same on every torch version.
# ---------------------------------------------------------------------------

def _view_groups(src: Tuple[int, ...], dst: Tuple[int, ...]
                 ) -> List[Tuple[List[int], List[int]]]:
    """The input dims and output dims of a view that map onto each other
    (equal products), size-1 dims left out (none is ever sharded)."""
    a = [(i, s) for i, s in enumerate(src) if s != 1]
    b = [(j, s) for j, s in enumerate(dst) if s != 1]
    groups, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        ins, outs = [a[i][0]], [b[j][0]]
        pa, pb = a[i][1], b[j][1]
        i, j = i + 1, j + 1
        while pa != pb:
            if pa < pb:
                ins.append(a[i][0])
                pa, i = pa * a[i][1], i + 1
            else:
                outs.append(b[j][0])
                pb, j = pb * b[j][1], j + 1
        groups.append((ins, outs))
    return groups


def view_placements(x, shape: Sequence[int]) -> tuple:
    """``x``'s placements with every mesh dim replicated that shards a dim
    the view to ``shape`` splits or merges illegally: a sharded dim that is
    not the first of its group, or whose group's first output dim does not
    divide by the dim's shard count."""
    from torch.distributed.tensor import Replicate, Shard

    src = tuple(x.shape)
    dst = [int(s) for s in shape]
    if -1 in dst:
        known = math.prod(s for s in dst if s != -1)
        dst[dst.index(-1)] = x.numel() // known if known else 0
    if 0 in src:
        return tuple(x.placements)
    sizes = tuple(x.device_mesh.shape)
    count = {}
    for m, p in enumerate(x.placements):
        if p.is_shard():
            count[p.dim] = count.get(p.dim, 1) * sizes[m]
    out = list(x.placements)
    for ins, outs in _view_groups(src, tuple(dst)):
        if len(ins) == 1 and len(outs) == 1:
            continue
        for m, p in enumerate(x.placements):
            if p.is_shard() and p.dim in ins and (
                    type(p) is not Shard or p.dim != ins[0]
                    or dst[outs[0]] % count[p.dim]):
                out[m] = Replicate()
    return tuple(out)


class ReshardViews(TorchDispatchMode):
    """Under this dispatch mode a view of a DTensor that DTensor cannot
    propagate gathers the offending mesh dims first
    (:func:`view_placements`); every other operation runs as it is."""

    VIEWS = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from repro_torch.kernels import any_dtensor

        kwargs = kwargs or {}
        if func in self.VIEWS and any_dtensor(args[0]):
            x = args[0]
            keep = view_placements(x, args[1])
            if keep != tuple(x.placements):
                args = (x.redistribute(x.device_mesh, keep), *args[1:])
        return func(*args, **kwargs)
