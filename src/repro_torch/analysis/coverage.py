"""ABFT coverage verifier: prove every matmul in a traced step flows into
an eq. 4-6 checksum comparison.

Counterpart of the JAX package's ``repro/analysis/coverage.py``, as the
same proof over a ``torch.fx`` graph:

1. Trace the step with ``make_fx(..., tracing_mode="real")`` under
   :func:`repro_torch.core.marker.check_tagging`, so every ``Check.diff()``
   comparison leaves an ``abft_check_sink`` node in the graph and every
   kernel launch one ``repro_torch::<kernel>`` node
   (``kernels/sites.py``).  Real mode, because the launches need real
   device pointers and the steps read the host (a decode position, MoE
   routing); the kernels run, the step's outputs are the untagged run's.
2. Collect **op sites**: every matmul-shaped ATen node (``mm``, ``bmm``,
   ``addmm``, ``baddbmm``, ``addbmm``, ``mv``, ``addmv``, ``dot``,
   ``vdot``, the sparse products, a library's attention), and every kernel
   site node — B1-B5, each one opaque site, as the reference counts a
   ``pallas_call``: its internal products are covered by the checksum its
   own epilogue emits, so the site is checked iff any of its outputs (the
   actual-checksum corners included) reaches a sink.
3. Build the reverse def-use graph from ``node.all_input_nodes``.  An
   in-place op that ``make_fx`` records on a *view* leaves its base's later
   readers pointing at the base's older node, so the trace also records,
   per storage, the nodes that wrote it, and a later reader of that
   storage gains edges to them.
4. Run backward reachability from every sink's inputs, once per
   granularity.  A site is **checked** iff it is an ancestor of a sink
   input; the granularities of the sinks it reaches are recorded per site.

Anything that fails step 4 is reported with its provenance (``file:line
(fn)``, the innermost frame outside PyTorch, the standard library, the
kernel wrappers and this machinery, stamped while tracing) and serialized
into a :class:`CoverageManifest` with the reference's keys.

Nodes the walker does not understand — a higher-order op with a subgraph
— keep only their coarse all-inputs -> output edges: products inside the
subgraph still become sites, and they stay *unchecked* unless a sink
reaches them, so the lint fails loud rather than trusting unknown control
flow.
"""
from __future__ import annotations

import dataclasses
import json
import operator
import os
import sys
import sysconfig
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import torch

from repro_torch.core.marker import CHECK_SINK, check_tagging

Tensor = torch.Tensor

# ATen ops whose node is one matmul-shaped site (by overload packet name)
MATMUL_OPS = frozenset({
    "mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot",
    "_sparse_addmm", "_sparse_mm",
    # a library's attention, should one appear
    "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_flash_attention_for_cpu",
    "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_cudnn_attention",
    "_flash_attention_forward", "_efficient_attention_forward",
})
# the op namespace of the kernel site ops and the check sink
NAMESPACE = "repro_torch"

# node.meta keys this module stamps while tracing
PROV_KEY = "abft_provenance"
_WRITERS = "abft_storage_writers"

_PKG = Path(__file__).resolve().parents[1]          # src/repro_torch
_ROOT = _PKG.parents[1]                              # the checkout
# frames never named as provenance: PyTorch, the standard library, the
# kernel wrappers (a site names the code that asked for the launch) and
# the tagging machinery itself
_SKIP = (os.path.dirname(torch.__file__) + os.sep,
         sysconfig.get_paths()["stdlib"] + os.sep,
         str(_PKG / "kernels") + os.sep,
         str(_PKG / "core" / "marker.py"),
         str(Path(__file__).resolve()))


@dataclasses.dataclass
class OpSite:
    """One matmul-shaped operation occurrence in the traced step."""

    kind: str                 # "aten" | "kernel"
    name: str                 # ATen op or kernel site name
    out_shape: Tuple[int, ...]
    provenance: str           # "file:line (fn)"
    path: str                 # subgraph nesting path, "/" at top level
    checked: bool = False
    granularities: Tuple[str, ...] = ()

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["out_shape"] = list(self.out_shape)
        d["granularities"] = list(self.granularities)
        return d


@dataclasses.dataclass
class CoverageManifest:
    """Machine-readable result of one coverage run — the golden artifact
    tests and the card's smoke run assert against."""

    step: str
    n_sinks: int
    sink_granularities: Tuple[str, ...]
    checked_ops: List[OpSite]
    unchecked_ops: List[OpSite]

    @property
    def n_checked(self) -> int:
        return len(self.checked_ops)

    @property
    def n_unchecked(self) -> int:
        return len(self.unchecked_ops)

    @property
    def coverage(self) -> float:
        total = self.n_checked + self.n_unchecked
        return 1.0 if total == 0 else self.n_checked / total

    def to_dict(self) -> dict:
        return {
            "step": self.step,
            "n_sinks": self.n_sinks,
            "sink_granularities": list(self.sink_granularities),
            "n_checked": self.n_checked,
            "n_unchecked": self.n_unchecked,
            "coverage": round(self.coverage, 6),
            "checked_ops": [s.to_dict() for s in self.checked_ops],
            "unchecked_ops": [s.to_dict() for s in self.unchecked_ops],
        }

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kw)


def _op_name(target: Any) -> Optional[Tuple[str, str]]:
    """(namespace, name) of an ATen or custom op node target."""
    packet = getattr(target, "_overloadpacket", None)
    qual = getattr(packet, "_qualified_op_name", None)
    if not qual or "::" not in qual:
        return None
    ns, name = qual.split("::", 1)
    return ns, name


def site_kind(target: Any) -> Optional[str]:
    """``"kernel"``, ``"aten"`` or None: is a call of ``target`` a site?"""
    op = _op_name(target)
    if op is None:
        return None
    ns, name = op
    if ns == NAMESPACE and name != CHECK_SINK:
        return "kernel"
    if ns == "aten" and name in MATMUL_OPS:
        return "aten"
    return None


def provenance(frame: Any = None) -> str:
    """``file:line (fn)`` of the innermost calling frame (or of ``frame``
    and its callers) outside PyTorch, the standard library, the kernel
    wrappers and the tagging machinery; the file relative to the checkout
    when it lies inside it."""
    f = sys._getframe(1) if frame is None else frame
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(_SKIP) and not fn.startswith("<"):
            try:
                shown = str(Path(fn).resolve().relative_to(_ROOT))
            except ValueError:
                shown = fn
            return f"{shown}:{f.f_lineno} ({f.f_code.co_name})"
        f = f.f_back
    return "<unknown>"


def _tensors(tree: Any) -> List[Tensor]:
    leaves = torch.utils._pytree.tree_leaves(tree)
    return [t for t in leaves if isinstance(t, Tensor)]


def _storage(t: Tensor) -> Optional[Tuple[str, int]]:
    if t.numel() == 0 or t.layout != torch.strided:
        return None
    return str(t.device), t.untyped_storage().data_ptr()


class _Recorder(torch.utils._python_dispatch.TorchDispatchMode):
    """Pushed inside the traced function, above ``make_fx``'s proxy mode:
    runs each op unchanged, then stamps its node — provenance on a site,
    and edges to the earlier writers of every storage it reads (see the
    module docstring, step 3).  A written tensor is held until the trace
    ends, so its storage address is not reused by another tensor inside
    one trace."""

    def __init__(self):
        super().__init__()
        self.writers: Dict[Tuple[str, int], List[Any]] = {}
        self.held: List[Tensor] = []
        self.thread = threading.get_ident()

    def _provenance(self) -> str:
        """The calling frame's provenance; on another thread (a CUDA
        backward runs on the autograd engine's device thread, whose stack
        holds no user frame) the tracing thread's, which waits in the
        ``torch.autograd`` call that started the backward."""
        prov = provenance()
        if prov == "<unknown>" and threading.get_ident() != self.thread:
            prov = provenance(sys._current_frames().get(self.thread))
        return prov

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        node = self._node_of(out)
        if node is None:
            return out
        if site_kind(func) is not None:
            node.meta.setdefault(PROV_KEY, self._provenance())
        reads = {k for k in map(_storage, _tensors((args, kwargs)))
                 if k is not None}
        extra = node.meta.setdefault(_WRITERS, [])
        for key in reads:
            extra.extend(w for w in self.writers.get(key, ())
                         if w is not node and w not in extra)
        for i, arg in enumerate(func._schema.arguments):
            info = arg.alias_info
            if info is None or not info.is_write:
                continue
            val = kwargs.get(arg.name) if arg.kwarg_only or \
                i >= len(args) else args[i]
            for t in _tensors(val):
                key = _storage(t)
                if key is not None:
                    self.writers.setdefault(key, []).append(node)
                    self.held.append(t)
        return out

    @staticmethod
    def _node_of(out: Any):
        from torch.fx.experimental.proxy_tensor import (get_proxy_mode,
                                                        get_proxy_slot,
                                                        has_proxy_slot)
        mode = get_proxy_mode()
        if mode is None:
            return None
        for t in _tensors(out):
            if has_proxy_slot(t, mode.tracer):
                node = get_proxy_slot(t, mode.tracer).proxy.node
                if node.target is operator.getitem:
                    node = node.args[0]
                return node
        return None


def trace(fn: Any, *args: Any) -> torch.fx.GraphModule:
    """``fn(*args)`` traced in real mode under check tagging: one
    ``torch.fx`` graph whose nodes carry the stamps of :class:`_Recorder`.
    The kernels run (a CUDA operand launches or raises); ``fn``'s outputs
    are cut to their tensor leaves.  Free the graph module after use: it
    holds every tensor the step closed over as a constant."""
    from torch._subclasses.fake_tensor import FakeTensorMode, is_fake
    from torch.fx.experimental import proxy_tensor
    from torch.fx.experimental.proxy_tensor import make_fx

    def recorded(*a):
        with _Recorder():
            return _tensors(fn(*a))

    fake_mode = FakeTensorMode(allow_fallback_kernels=True)

    def extract_val(val, *a, **kw):
        # make_fx records a real tensor's metadata as a fake tensor made in
        # a fake mode of its own per node; one mode for the whole trace
        # does the same at a fraction of the cost.  A compressed sparse
        # tensor has no strides to record (the "bcoo" backend holds S as
        # CSR): no value for it.
        if isinstance(val, Tensor) and not is_fake(val):
            if val.layout == torch.strided:
                with fake_mode:
                    return torch.empty_strided(val.shape, val.stride(),
                                               device=val.device,
                                               dtype=val.dtype)
            if val.layout != torch.sparse_coo:
                return None
        return plain_extract(val, *a, **kw)

    plain_extract = proxy_tensor.extract_val
    proxy_tensor.extract_val = extract_val
    try:
        with check_tagging():
            return make_fx(recorded, tracing_mode="real",
                           _error_on_data_dependent_ops=False)(*args)
    finally:
        proxy_tensor.extract_val = plain_extract


def _out_shape(node: Any) -> Tuple[int, ...]:
    val = node.meta.get("val", node.meta.get("tensor_meta"))
    if isinstance(val, (list, tuple)):
        val = next((v for v in val if hasattr(v, "shape")), None)
    return tuple(int(d) for d in getattr(val, "shape", ()))


@dataclasses.dataclass
class _Graph:
    """Reverse def-use graph over fx nodes (of the graph and of any
    subgraph), its sites and its sinks."""

    rev: Dict[Any, Set[Any]]
    sites: List[Tuple[OpSite, Any]]          # site, its node
    sinks: List[Tuple[str, List[Any]]]       # granularity, sink inputs


def _walk(g: _Graph, graph: torch.fx.Graph, owner: Any, path: str) -> None:
    for node in graph.nodes:
        g.rev.setdefault(node, set()).update(node.all_input_nodes)
        g.rev[node].update(node.meta.get(_WRITERS, ()))
        if node.op != "call_function":
            continue
        target = node.target
        op = _op_name(target)
        if op == (NAMESPACE, CHECK_SINK):
            gran = node.args[2] if len(node.args) > 2 else \
                node.kwargs.get("granularity", "?")
            g.sinks.append((str(gran), [a for a in node.args[:2]
                                        if isinstance(a, torch.fx.Node)]))
            continue
        kind = site_kind(target)
        if kind is not None:
            g.sites.append((OpSite(
                kind=kind, name=op[1], out_shape=_out_shape(node),
                provenance=node.meta.get(PROV_KEY, "<unknown>"),
                path=path or "/"), node))
            continue
        if isinstance(target, torch._ops.HigherOrderOperator):
            # conservative fallback: walk the subgraphs for sites, tie
            # nothing inside to the outer graph (coarse in -> out edges)
            for arg in node.all_input_nodes:
                sub = getattr(owner, str(arg.target), None) \
                    if arg.op == "get_attr" else None
                if isinstance(sub, torch.fx.GraphModule):
                    _walk(g, sub.graph, sub, f"{path}/{target.name()}")


def _carry(g: _Graph, graph: torch.fx.Graph,
           carry: Sequence[Tuple[int, int]]) -> None:
    """Alias input leaf ``i`` with output tensor ``o`` for each ``(i, o)``,
    both ways: the state a serving loop carries from one step to the next
    (the reference's scan-carry loop-back)."""
    ins = [n for n in graph.nodes if n.op == "placeholder"]
    out = next(n for n in reversed(graph.nodes) if n.op == "output")
    outs = torch.utils._pytree.tree_leaves(out.args)
    for i, o in carry:
        a, b = ins[i], outs[o]
        g.rev.setdefault(a, set()).add(b)
        g.rev.setdefault(b, set()).add(a)


def analyze_graph(gm: torch.fx.GraphModule, *, step: str = "",
                  carry: Sequence[Tuple[int, int]] = ()
                  ) -> CoverageManifest:
    """Run the coverage analysis on a graph traced by :func:`trace`.

    The trace must have been taken under check tagging for sinks to exist;
    a trace with zero sinks reports every matmul unchecked (which is
    exactly what an unguarded model should look like).  ``carry`` pairs
    (input leaf, output tensor) positions that the caller feeds back into
    the next step — a decode step's recurrent state: the JAX package walks
    its in-step recurrences as scans whose carries loop back, where the
    port's unrolled loops leave the last state update only in the step's
    output."""
    g = _Graph(rev={}, sites=[], sinks=[])
    _walk(g, gm.graph, gm, "")
    _carry(g, gm.graph, carry)

    ancestors_by_gran: Dict[str, Set[Any]] = {}
    for gran, inputs in g.sinks:
        seen = ancestors_by_gran.setdefault(gran, set())
        frontier = list(inputs)
        while frontier:
            node = frontier.pop()
            if node in seen:
                continue
            seen.add(node)
            frontier.extend(g.rev.get(node, ()))

    checked, unchecked = [], []
    for site, node in g.sites:
        grans = sorted(gran for gran, anc in ancestors_by_gran.items()
                       if node in anc)
        if grans:
            site.checked = True
            site.granularities = tuple(grans)
            checked.append(site)
        else:
            unchecked.append(site)

    return CoverageManifest(
        step=step, n_sinks=len(g.sinks),
        sink_granularities=tuple(sorted({gr for gr, _ in g.sinks})),
        checked_ops=checked, unchecked_ops=unchecked)


def analyze_step(fn: Any, *args: Any, step: str = "",
                 carry: Sequence[Tuple[int, int]] = ()) -> CoverageManifest:
    """Trace ``fn(*args)`` under check tagging (:func:`trace`) and analyze
    its coverage.  ``fn`` closes over everything that is not a tensor;
    ``args`` are the step's operands (they are run: real mode)."""
    gm = trace(fn, *args)
    try:
        return analyze_graph(gm, step=step, carry=carry)
    finally:
        del gm


def kernel_site_counts(m: CoverageManifest) -> Dict[str, int]:
    """Kernel site nodes of a manifest, by kernel name."""
    counts: Dict[str, int] = {}
    for s in m.checked_ops + m.unchecked_ops:
        if s.kind == "kernel":
            counts[s.name] = counts.get(s.name, 0) + 1
    return counts


def format_report(m: CoverageManifest, *, verbose: bool = False) -> str:
    """Human-readable lint report for one manifest."""
    lines = [f"[coverage] step={m.step or '<unnamed>'}: "
             f"{m.n_checked} checked, {m.n_unchecked} unchecked matmul "
             f"site(s); {m.n_sinks} check sink(s) "
             f"({', '.join(m.sink_granularities) or 'none'})"]
    for s in m.unchecked_ops:
        lines.append(f"  UNCHECKED {s.kind} {s.name} out={list(s.out_shape)}"
                     f" at {s.provenance}  [{s.path}]")
    if verbose:
        for s in m.checked_ops:
            lines.append(f"  checked   {s.kind} {s.name} "
                         f"out={list(s.out_shape)} at {s.provenance} "
                         f"-> {','.join(s.granularities)}")
    return "\n".join(lines)
