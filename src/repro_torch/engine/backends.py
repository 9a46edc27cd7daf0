"""Aggregation backends for the unified GCN engine.

A backend owns exactly one thing: the aggregation matmul H_out = S @ X and
the eq.-6 corner of the fused check for that multiply.  Everything else —
the eq.-5 extra column x_r = H w_r, split-vs-fused policy, ReLU
chain-breaking, report reduction — lives once in ``engine/api.py``.

The protocol is deliberately narrow::

    aggregate(x, x_r) -> (h_out, Check | None)

``x`` is the combination output X = H W; ``x_r`` is the carried checksum
column H w_r (a [..., n]-vector, or ``None`` when checking is disabled).
When ``x_r`` is given, the returned :class:`~repro_torch.core.abft.Check`
holds ``predicted = s_c @ x_r`` (equivalently ``Σ S x_r`` — the kernel
backend never materializes s_c online) and ``actual = Σ H_out``.

Three built-in backends, selected by name or inferred from the operand:

  * ``dense``     — ``torch.matmul`` over a dense S; batched leading axes ok.
  * ``bcoo``      — a ``torch`` sparse S (COO or CSR) through
                    ``torch.sparse.mm``, with the O(nnz) offline s_c
                    (``sparse_col_checksum``).  The JAX package computes
                    this product outside any Pallas kernel too.
  * ``block_ell`` — the CUDA spmm_abft kernel over a padded block-ELL
                    layout; the check rides the kernel's fused epilogue,
                    and a :class:`~repro_torch.engine.sharded.Partition`
                    splits the row-stripes over devices, one launch a
                    shard, with the partial corners summed in shard order.

Counterpart of the JAX package's ``repro/engine/backends.py``.

New backends register with :func:`register_backend`; the registry is the
single dispatch point for ``gcn_apply(..., backend=...)``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.abft import (GRANULARITIES, ABFTConfig, Check,
                                   CheckedOp, _is_sparse, _total,
                                   check_matmul, segment_sum,
                                   sparse_col_checksum)
from repro_torch.core.checksum import col_checksum, row_checksum
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor

_REGISTRY: Dict[str, Callable[..., "AggregationBackend"]] = {}


def _validate_granularity(name: str, granularity: str,
                          supported: Tuple[str, ...]) -> str:
    if granularity not in GRANULARITIES:
        raise ValueError(f"granularity {granularity!r} not in "
                         f"{GRANULARITIES}")
    if granularity not in supported:
        raise ValueError(
            f"{name} backend supports granularity in {supported}, not "
            f"{granularity!r}; stripe-granular corners need the block_ell "
            f"kernel path (per-row-stripe checksum partials)")
    return granularity


def register_backend(name: str):
    """Class decorator: make ``name`` resolvable by :func:`get_backend`."""
    def deco(cls):
        _REGISTRY[name] = cls
        cls.name = name
        return cls
    return deco


def get_backend(name: str) -> Callable[..., "AggregationBackend"]:
    if name not in _REGISTRY:
        raise ValueError(f"unknown engine backend {name!r}; "
                         f"registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def backend_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def infer_backend(s: Any) -> str:
    """Map an adjacency operand to its natural backend name."""
    from repro_torch.engine.batching import PackedGraphs
    from repro_torch.kernels.spmm_abft.layout import BlockEll
    if isinstance(s, (BlockEll, PackedGraphs)):
        return "block_ell"
    if _is_sparse(s):
        return "bcoo"
    return "dense"


class AggregationBackend(CheckedOp):
    """Protocol base; subclasses implement :meth:`aggregate`.

    An aggregation backend is a :class:`~repro_torch.core.abft.CheckedOp`
    implementation: calling it runs one whole GCN layer under the engine's
    eq. 4–6 algebra —

        h_out, checks = bk(cfg, h, w, w_r=folded_w_r)

    — delegating to ``engine.gcn_layer`` (which in turn consults the
    backend's :meth:`layer`/:meth:`network` fusion hooks and
    :meth:`aggregate`).

    Constructors take only the options they honour — an unknown or
    inapplicable keyword (``block_g`` on dense, a typo) raises TypeError
    instead of being silently dropped.

    ``granularity`` declares what one element of the emitted Check
    attributes a fault to: ``"layer"`` (one scalar corner per linear
    chain — the paper's check), ``"graph"`` (one corner per packed /
    batched graph), or ``"stripe"``/``"slot"`` (block_ell only).
    """

    name = "abstract"
    op_id = "gcn_layer"
    granularity = "layer"

    def __init__(self, s: Any, cfg: ABFTConfig, *, s_c: Optional[Tensor] = None,
                 partition=None, device: DeviceLike = "cuda"):
        raise NotImplementedError

    def __call__(self, cfg: ABFTConfig, h: Tensor, w: Tensor, *,
                 w_r: Optional[Tensor] = None):
        """CheckedOp entry point: one pre-activation GCN layer
        ``H_out = S (H W)`` with its declared-granularity check(s)."""
        from .api import gcn_layer
        h_out, checks = gcn_layer(self, h, w, cfg, w_r=w_r)
        if not checks:
            return h_out, None
        return h_out, (checks[0] if len(checks) == 1 else checks)

    def aggregate(self, x: Tensor, x_r: Optional[Tensor]
                  ) -> Tuple[Tensor, Optional[Check]]:
        raise NotImplementedError

    def layer(self, h: Tensor, w: Tensor, cfg: ABFTConfig, *,
              w_r: Optional[Tensor] = None):
        """Whole-layer hook: execute H_out = S (H W) plus the eq. 4–6 check
        in one backend-fused step, returning (h_out, Check | None) — or
        ``NotImplemented`` to make the engine run the generic two-pass path
        (combination via ``torch.matmul``, then :meth:`aggregate`).

        Only consulted for the fused/none check modes: the split baseline
        (eqs. 2–3) checks the combination product X itself, and a layer
        that never materializes X has nothing for that check to read.

        The ``fused_hits``/``fused_fallbacks`` counters on implementing
        backends count *decisions*; the port runs eagerly, so they tick once
        per layer call.
        """
        return NotImplemented

    def network(self, h0: Tensor, ws, wrs, cfg: ABFTConfig, *,
                stash: bool = False):
        """Whole-network hook: execute EVERY layer in one backend-fused
        sweep, returning ``(logits, [Check | None] per layer, h_layers |
        None)``, or ``NotImplemented`` to make the engine run its per-layer
        loop (which still consults :meth:`layer` for each).

        ``ws``/``wrs`` are the per-layer weights and folded eq.-5 columns
        (``wrs`` all ``None`` when checking is off — the checks stay
        per-layer and pre-activation either way).  ``stash=True`` asks for
        the per-layer input activations ``h_layers`` (the surgical-repair
        tiers replay from them).  Like :meth:`layer`, only consulted for
        the fused/none modes: the split baseline checks the combination
        product X itself, which whole-network fusion never materializes."""
        return NotImplemented

    def combination_check(self, h: Tensor, w: Tensor, x: Tensor,
                          cfg: ABFTConfig, *, w_r: Optional[Tensor] = None
                          ) -> Check:
        """Split-mode (eq. 2–3) check of the combination matmul x = h w.

        The default is the generic :func:`~repro_torch.core.abft.check_matmul`;
        backends whose check granularity is finer than "one scalar per
        operand" (the packed block-diagonal batch) override it so the split
        check matches their aggregate corner's per-graph shape.
        """
        return check_matmul(h, w, x, cfg)


@register_backend("dense")
class DenseBackend(AggregationBackend):
    """S as a dense tensor.  Leading batch axes broadcast: S [..., n, n]
    with X [..., n, g] yields batched scalar checks, which ``summarize``
    reduces — this is what batched dense multi-graph serving runs on."""

    def __init__(self, s: Any, cfg: ABFTConfig, *,
                 s_c: Optional[Tensor] = None, partition=None,
                 granularity: str = "layer", device: DeviceLike = "cuda"):
        if partition is not None:
            raise ValueError("dense backend does not support partition=; "
                             "use backend='block_ell'")
        # "graph" is what the batched leading axes already deliver (one
        # scalar corner per batch element); "stripe" has no meaning without
        # the block-ELL row-stripe partials.
        self.granularity = _validate_granularity("dense", granularity,
                                                 ("layer", "graph"))
        self.device = resolve_device(device)
        self.s = torch.as_tensor(s).to(self.device)
        self.cfg = cfg
        self.s_c = s_c if s_c is not None else (
            col_checksum(self.s, cfg.dtype) if cfg.enabled else None)

    def aggregate(self, x, x_r):
        h_out = torch.matmul(self.s, x)
        if x_r is None:
            return h_out, None
        pred = torch.einsum("...k,...k->...", self.s_c, x_r)
        return h_out, Check(predicted=pred, actual=_total(h_out, self.cfg),
                            granularity=self.granularity)


@register_backend("bcoo")
class BcooBackend(AggregationBackend):
    """S as a ``torch`` sparse tensor (COO or CSR; the JAX package's BCOO);
    s_c is the O(nnz) offline column sum (``sparse_col_checksum``) shared
    across layers/steps.  A COO operand is converted to CSR once here
    (duplicates summed): ``torch.sparse.mm`` would otherwise coalesce and
    convert it on every product.  On an H100 both layouts repeat bit for
    bit across runs, and at full NELL the CSR product takes 0.064 ms
    against COO's 0.230 (``chip_smoke.py``, phase ``sparse``)."""

    def __init__(self, s: Any, cfg: ABFTConfig, *,
                 s_c: Optional[Tensor] = None, partition=None,
                 granularity: str = "layer", device: DeviceLike = "cuda"):
        if partition is not None:
            raise ValueError("bcoo backend does not support partition=; "
                             "use backend='block_ell'")
        self.granularity = _validate_granularity("bcoo", granularity,
                                                 ("layer",))
        if not _is_sparse(s):
            raise TypeError("bcoo backend needs a torch sparse (COO or CSR) "
                            "operand; convert with Coo.to_sparse")
        self.device = resolve_device(device)
        s = s.to(self.device)
        self.s = s.to_sparse_csr() if s.layout == torch.sparse_coo else s
        self.cfg = cfg
        self.s_c = s_c if s_c is not None else (
            sparse_col_checksum(self.s, cfg.dtype) if cfg.enabled else None)

    def aggregate(self, x, x_r):
        h_out = torch.sparse.mm(self.s, x)
        if x_r is None:
            return h_out, None
        pred = torch.einsum("...k,...k->...", self.s_c, x_r)
        return h_out, Check(predicted=pred, actual=_total(h_out, self.cfg))


@register_backend("block_ell")
class BlockEllBackend(AggregationBackend):
    """S as a host-side padded block-ELL (``kernels/spmm_abft/layout.py``);
    aggregation runs through the CUDA spmm_abft kernel, whose fused
    epilogue carries the eq.-5 column so predicted = Σ S x_r = s_c H w_r
    without an online s_c pass.

    A :class:`~repro_torch.engine.batching.PackedGraphs` operand
    (block-diagonal packed batch) routes through the segmented epilogue
    instead: the kernel's per-stripe checksum partials segment-sum into one
    eq.-6 corner *per packed graph*, so the Check fields are [n_slots]
    batched scalars and a fault in one graph flags only that graph's corner.

    ``fused_layer=True`` additionally activates the whole-layer hook
    (:meth:`layer`): fused/none-mode layers run through the single-pass
    ``kernels/gcn_fused`` kernel — combination, aggregation, and checksum
    in one sweep — falling back to the two-pass path above when one block's
    shared-memory working set exceeds ``vmem_budget``.

    ``fused_network=True`` activates the whole-network hook
    (:meth:`network`): an entire fused/none-mode forward runs through ONE
    ``gcn_network`` launch — every layer's combination, aggregation, check
    and ReLU, the activations in device memory between layers — falling
    back to the per-layer ladder (fused layer, then two-pass) when the
    port's predicate ``analysis.vmem.fused_network_fits`` declines (non-
    square blocks, too many layers, a layer width outside the register
    tile, or one block's shared memory over ``vmem_budget``).
    ``network_hits``/``network_fallbacks`` count those decisions; they
    follow the port's predicate, which takes Cora's widths at block 128
    where the JAX package's TPU predicate does not.

    With ``partition=Partition(mesh, axis)`` the row-stripes split over the
    mesh's devices (``engine/sharded.py``): the layout is padded to a
    multiple of the shard count, each shard makes one launch on its slab,
    and the per-shard (predicted, actual) partials add in shard order into
    the global check — the single-device corner, because the checksum is
    linear.  Stripe corners concatenate; slot corners, ``inject=`` and
    packed batches are refused under a partition, and :meth:`network`
    declines (the per-layer ladder runs), as in the reference.

    ``granularity="stripe"`` declines every collapse: the kernels' per-
    row-stripe checksum partials stay individual corners ([n_block_rows]
    Check fields), so a detected fault names the stripe it corrupted.
    ``granularity="slot"`` refines below stripes on the fused kernel path
    ([n_block_rows, width] telescope-difference corners naming the exact
    ell-slot); the two-pass fallback cannot split a stripe's sweep, so it
    degrades slot corners to stripe corners for that layer.
    Defaults to ``"graph"`` for packed batches and ``"layer"`` otherwise.

    ``inject=(layer, stripe, slot, delta)`` is the CI fault-injection
    hook: the given layer's aggregation sweep perturbs one accumulator
    element mid-flight, in whichever kernel runs that layer (whole-network,
    fused single-layer or the two-pass spmm — all three carry the hook, so
    the fallback paths are injectable too).

    ``staged=(cols, vals)`` hands over device tensors of ``s`` (as padded
    for the partition) that the caller staged once, so several backends
    over one layout share one copy of its tile table.
    """

    def __init__(self, s: Any, cfg: ABFTConfig, *,
                 s_c: Optional[Tensor] = None, partition=None,
                 block_g: int = 128, fused_layer: bool = False,
                 fused_network: bool = False,
                 vmem_budget: Optional[int] = None,
                 granularity: Optional[str] = None,
                 inject: Optional[Tuple[int, int, int, float]] = None,
                 staged: Optional[Tuple[Tensor, Tensor]] = None,
                 device: DeviceLike = "cuda"):
        from repro_torch.engine.batching import PackedGraphs
        from repro_torch.kernels.spmm_abft.layout import (BlockEll,
                                                          pad_block_rows)
        from repro_torch.kernels.spmm_abft.ops import device_block_ell
        self._init_options(cfg, block_g, fused_layer, fused_network,
                           vmem_budget, partition)
        self.device = resolve_device(device)
        packed = isinstance(s, PackedGraphs)
        self._set_granularity(granularity, packed=packed)
        self._set_inject(inject)
        if packed:
            if partition is not None:
                raise ValueError("packed block-diagonal batches do not "
                                 "support partition= (stripes already "
                                 "interleave graphs)")
            self.segments = torch.from_numpy(s.stripe_graph).to(self.device)
            self.n_slots = s.n_slots
            s = s.bell
        elif not isinstance(s, BlockEll):
            raise TypeError("block_ell backend needs a BlockEll or "
                            "PackedGraphs operand; convert with "
                            "dense_to_block_ell/coo_to_block_ell or "
                            "engine.batching.pack_graphs")
        elif partition is not None:
            s = pad_block_rows(s, partition.n_shards)
        self.bell = s
        if staged is None:
            self.cols, self.vals = device_block_ell(s, self.device)
        elif (tuple(staged[1].shape) != s.values.shape
              or tuple(staged[0].shape) != s.block_cols.shape):
            raise ValueError(f"staged tables {tuple(staged[1].shape)} are "
                             f"not the layout's {s.values.shape} (padded "
                             f"for the partition)")
        else:
            self.cols, self.vals = staged

    def _init_options(self, cfg, block_g, fused_layer, fused_network,
                      vmem_budget, partition):
        self.cfg = cfg
        self.block_g = block_g
        self.partition = partition
        self.fused_layer = fused_layer
        self.fused_network = fused_network
        self.vmem_budget = vmem_budget
        self.fused_hits = 0
        self.fused_fallbacks = 0
        self.network_hits = 0
        self.network_fallbacks = 0
        self.segments = None
        self.n_slots = None

    def _set_granularity(self, granularity: Optional[str], *, packed: bool):
        if granularity is None:
            granularity = "graph" if packed else "layer"
        # packed batches must stay at least graph-attributable (the guard's
        # per-graph retry reads per-graph corners); single systems have no
        # graph segmentation to offer
        supported = (("graph", "stripe", "slot") if packed
                     else ("layer", "stripe", "slot"))
        if granularity == "slot" and self.partition is not None:
            raise ValueError(
                "granularity='slot' is not plumbed through the sharded "
                "path (sharded_gcn_fused collapses each shard's partials "
                "before the sum) — use granularity='stripe' there")
        self.granularity = _validate_granularity("block_ell", granularity,
                                                 supported)

    def _set_inject(self, inject):
        if inject is not None:
            if self.partition is not None:
                raise ValueError("inject= is not plumbed through the "
                                 "sharded path (sharded_gcn_fused runs the "
                                 "kernel without the hook) — injecting "
                                 "there would silently run clean")
            if len(inject) != 4:
                raise ValueError("inject is (layer, stripe, slot, delta); "
                                 f"got {inject!r}")
        self.inject = inject
        # which whole-layer call the injection lands in
        self._layer_calls = 0

    def _next_inject(self) -> Optional[Tuple[int, int, float]]:
        """The (stripe, slot, delta) hook for the layer about to run, or
        ``None``; advances the layer counter."""
        inject = None
        if self.inject is not None and self._layer_calls == self.inject[0]:
            inject = tuple(self.inject[1:])
        self._layer_calls += 1
        return inject

    @classmethod
    def from_staged(cls, cols: Tensor, vals: Tensor, segments: Tensor,
                    n_slots: int, cfg: ABFTConfig, *, block_g: int = 128,
                    fused_layer: bool = False, fused_network: bool = False,
                    vmem_budget: Optional[int] = None,
                    granularity: Optional[str] = None,
                    inject: Optional[Tuple[int, int, int, float]] = None
                    ) -> "BlockEllBackend":
        """Packed backend over already-staged device tensors.

        This is the constructor batched serving uses: a serving step takes
        (cols, vals, segments, h0) as *arguments*, so every batch of one
        packed shape runs the same step on its own tile table.  The backend
        lives on the tensors' device.
        """
        bk = cls.__new__(cls)
        bk._init_options(cfg, block_g, fused_layer, fused_network,
                         vmem_budget, None)
        bk.device = vals.device
        bk.bell = None
        bk.cols, bk.vals = cols, vals
        bk.segments = segments
        bk.n_slots = n_slots
        bk._set_granularity(granularity, packed=True)
        bk._set_inject(inject)
        return bk

    def layer(self, h, w, cfg, *, w_r=None):
        """Fused layer (``kernels/gcn_fused``): one call runs the
        combination H W once per row into a workspace that stays in L2,
        then the aggregation sweep with its check column, stripe sums and
        slot telescopes.  Falls back to the engine's two-pass
        path (returns ``NotImplemented``) when the option is off or one
        block's shared-memory working set exceeds the budget.
        """
        if not self.fused_layer:
            return NotImplemented
        from repro_torch.kernels.gcn_fused.ops import (
            FUSED_SMEM_BUDGET,
            fused_layer_fits,
            gcn_fused_layer,
            gcn_fused_packed,
        )
        f, g = w.shape
        bm, bk_ = self.vals.shape[2], self.vals.shape[3]
        budget = FUSED_SMEM_BUDGET if self.vmem_budget is None \
            else self.vmem_budget
        if not fused_layer_fits(f, g, bm, bk_, block_g=self.block_g,
                                budget=budget):
            self.fused_fallbacks += 1
            return NotImplemented
        self.fused_hits += 1
        inject = self._next_inject()
        if self.segments is not None:
            return gcn_fused_packed(self.cols, self.vals, h, w, w_r,
                                    self.segments, num_segments=self.n_slots,
                                    block_g=self.block_g,
                                    granularity=self.granularity,
                                    inject=inject)
        if self.partition is not None:
            from .sharded import sharded_gcn_fused
            return sharded_gcn_fused(self.bell, self.cols, self.vals, h, w,
                                     w_r, self.partition,
                                     block_g=self.block_g,
                                     granularity=self.granularity)
        return gcn_fused_layer(self.bell, h, w, w_r, block_g=self.block_g,
                               granularity=self.granularity, inject=inject,
                               _staged=(self.cols, self.vals))

    def network(self, h0, ws, wrs, cfg, *, stash=False):
        """Whole-network fusion (``kernels/gcn_fused``'s network kernel):
        every layer's combination + aggregation + ReLU runs in one launch
        with the activations in device memory between layers and the eq.-5
        column carried across each layer boundary, so the checks stay
        per-layer and pre-activation.

        Falls back to the per-layer ladder (returns ``NotImplemented``)
        when the option is off, the operand is sharded, or
        ``fused_network_fits`` declines the model at this block shape and
        shared-memory budget.
        """
        if not self.fused_network or self.partition is not None:
            return NotImplemented
        from repro_torch.kernels.gcn_fused.ops import (
            FUSED_SMEM_BUDGET,
            fused_network_fits,
            gcn_network_layer,
            gcn_network_packed,
        )
        nbm, _width, bm, bk_ = self.vals.shape
        dims = [int(ws[0].shape[0])] + [int(w.shape[1]) for w in ws]
        budget = FUSED_SMEM_BUDGET if self.vmem_budget is None \
            else self.vmem_budget
        if not fused_network_fits(dims, bm, nbm * bm, bk=bk_,
                                  block_g=self.block_g, budget=budget):
            self.network_fallbacks += 1
            return NotImplemented
        self.network_hits += 1
        self._layer_calls += len(ws)     # the sweep consumed every layer
        if self.segments is not None:
            return gcn_network_packed(self.cols, self.vals, h0, ws, wrs,
                                      self.segments,
                                      num_segments=self.n_slots,
                                      block_g=self.block_g,
                                      granularity=self.granularity,
                                      inject=self.inject, stash_acts=stash)
        return gcn_network_layer(self.bell, h0, ws, wrs,
                                 block_g=self.block_g,
                                 granularity=self.granularity,
                                 inject=self.inject, stash_acts=stash,
                                 _staged=(self.cols, self.vals))

    def combination_check(self, h, w, x, cfg, *, w_r=None):
        nbm, bm = self.vals.shape[0], self.vals.shape[2]
        if self.granularity in ("stripe", "slot"):
            # slot corners need the fused kernel's telescopes; split mode's
            # two-pass combination check localizes at stripe granularity.
            # Per-stripe eq. 2–3 corners: rows group by stripe (row ->
            # stripe is just a reshape), matching the aggregate corner's
            # [n_block_rows] shape so split mode localizes too
            if w_r is None:
                w_r = row_checksum(w, cfg.dtype)
            rows = nbm * bm
            if h.shape[0] != rows:    # single-graph: pad the stripe residue
                h = F.pad(h, [0, 0, 0, rows - h.shape[0]])
                x = F.pad(x, [0, 0, 0, rows - x.shape[0]])
            hsum = h.to(cfg.dtype).reshape(nbm, bm, -1).sum(dim=1)
            actual = x.to(cfg.dtype).reshape(nbm, bm, -1).sum(dim=(1, 2))
            return Check(predicted=hsum @ w_r, actual=actual,
                         granularity="stripe")
        if self.segments is None:
            return super().combination_check(h, w, x, cfg, w_r=w_r)
        # per-graph eq. 2–3 corners: rows of h/x are contiguous per graph
        # (row -> stripe -> graph), so both checksum sides segment exactly —
        #   predicted[g] = (Σ_{rows∈g} h) · w_r,  actual[g] = Σ_{rows∈g} x
        # rows reduce to stripes by a reshape first, stripes to graphs by
        # the fixed-order segment sum
        hsum = segment_sum(h.to(cfg.dtype).reshape(nbm, bm, -1).sum(dim=1),
                           self.segments, self.n_slots)
        if w_r is None:
            w_r = row_checksum(w, cfg.dtype)
        pred = hsum @ w_r
        actual = segment_sum(
            x.to(cfg.dtype).reshape(nbm, bm, -1).sum(dim=(1, 2)),
            self.segments, self.n_slots)
        return Check(predicted=pred, actual=actual, granularity="graph")

    def aggregate(self, x, x_r):
        if x.ndim != 2:
            raise ValueError("block_ell backend is single-graph ([n, g]); "
                             "batch via engine.batching or the dense backend")
        xr_col = None if x_r is None else x_r.to(torch.float32)[:, None]
        # the two-pass kernel cannot split a stripe's ell-sweep into slot
        # corners; slot-granularity layers that fall through to this path
        # degrade to stripe corners (still surgical, one rung coarser)
        gran = "stripe" if self.granularity == "slot" else self.granularity
        inject = self._next_inject()
        if self.segments is not None:
            from repro_torch.kernels.spmm_abft.ops import spmm_abft_packed
            return spmm_abft_packed(self.cols, self.vals, x, xr_col,
                                    self.segments, num_segments=self.n_slots,
                                    block_g=self.block_g, granularity=gran,
                                    inject=inject)
        if self.partition is not None:
            from .sharded import sharded_spmm_abft
            return sharded_spmm_abft(self.bell, self.cols, self.vals, x,
                                     xr_col, self.partition,
                                     block_g=self.block_g, granularity=gran)
        from repro_torch.kernels.spmm_abft.ops import spmm_abft
        out, chk = spmm_abft(self.bell, x, xr_col, block_g=self.block_g,
                             granularity=gran, inject=inject,
                             _staged=(self.cols, self.vals))
        return out, (chk if x_r is not None else None)


def make_backend(s: Any, cfg: ABFTConfig, *, backend: Optional[str] = None,
                 s_c: Optional[Tensor] = None, partition=None,
                 device: DeviceLike = "cuda", **opts) -> AggregationBackend:
    """Resolve + construct the aggregation backend for operand ``s``."""
    name = backend or infer_backend(s)
    return get_backend(name)(s, cfg, s_c=s_c, partition=partition,
                             device=device, **opts)
