"""ABFT checking layer: split (baseline) and fused (GCN-ABFT) checks.

Every check produces a :class:`Check` — a (predicted, actual) pair of scalars
(or batched scalars) held as tensors on the device that computed them.  A
serving step collects all layer checks and reduces them with
:func:`summarize` into a single flag + max divergence that the runtime layer
(``runtime/abft_guard.py``) acts on.

Three policies (``ABFTConfig.mode``):
  * ``none``  — no checks (perf baseline).
  * ``split`` — the paper's baseline: one check per matmul (eqs. 2–3).
  * ``fused`` — GCN-ABFT: one check per *linear chain* (eq. 4).  Chains are
    broken by nonlinearities; isolated matmuls degrade to split checks.

The engine-facing contract is the :class:`CheckedOp` protocol: a checked op
takes its operands plus folded check vectors and returns ``(out, Check)`` at
a declared granularity.  The eq. 4–6 chaining/fold/report algebra that
backs every implementation — :func:`resolve_w_r`, :func:`fold_w_r_tree`,
:func:`check_chain` and the report reducers — lives here, op-generically:
none of it mentions GCNs.

Counterpart of the JAX package's ``repro/core/abft.py``.  ``Check.diff`` has
no check-sink marker (that marker exists for jaxpr static analysis only).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

from .checksum import (
    col_checksum,
    kahan_total,
    predicted_matmul_checksum,
    row_checksum,
    total_checksum,
)

Tensor = torch.Tensor

MODES = ("none", "split", "fused")

# Check granularities, coarsest to finest.  "layer" is one scalar corner per
# linear chain (the paper's granularity); "graph" segments the corner per
# packed graph (exact by linearity); "stripe" keeps the kernel's
# per-row-stripe partials as individual corners, so a detected fault names
# the stripe it corrupted and recovery can re-execute just those rows;
# "slot" differences the kernel's telescoped per-ell-slot running sums into
# one corner per (stripe, slot) step — a fault names the exact tile
# product (or accumulator step) that produced it.
GRANULARITIES = ("layer", "graph", "stripe", "slot")


@dataclasses.dataclass(frozen=True)
class ABFTConfig:
    """Static configuration for ABFT checking (hashable)."""

    mode: str = "fused"
    # Accumulation dtype for checksums.  Paper: float64 (CPU repro benches);
    # production: float32 (+ kahan=True to compensate).
    dtype: torch.dtype = torch.float32
    kahan: bool = False
    # Detection threshold tau.  relative=True flags when
    #   |pred - actual| > threshold * max(1, |actual|)
    # which is what a deployment wants; the paper's Table I uses absolute
    # thresholds (relative=False) in 1e-4..1e-7.
    threshold: float = 1e-3
    relative: bool = True

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"abft mode {self.mode!r} not in {MODES}")

    @property
    def enabled(self) -> bool:
        return self.mode != "none"


@dataclasses.dataclass(frozen=True)
class Check:
    """One checksum comparison.  Fields may be scalars or batched scalars.

    ``granularity`` records what one element of the comparison attributes a
    fault to — ``"layer"`` (scalar corner per chain), ``"graph"`` (one
    corner per packed graph), ``"stripe"`` (one corner per block-ELL
    row-stripe) or ``"slot"``.  It is static metadata, so report reducers
    dispatch on it without a device read.
    """

    predicted: Tensor
    actual: Tensor
    granularity: str = "layer"

    def __post_init__(self):
        if self.granularity not in GRANULARITIES:
            raise ValueError(f"check granularity {self.granularity!r} not "
                             f"in {GRANULARITIES}")

    def diff(self) -> Tensor:
        return (self.predicted - self.actual).abs()

    def _scale(self) -> Tensor:
        # the relative scale must stay FINITE: an overflowed output
        # (actual = ±inf, e.g. a high exponent bit flip in a weight)
        # would make tau*scale infinite and the comparison pass silently
        # (inf <= inf).  Clamped to 1.0, the infinite divergence flags.
        scale = self.actual.abs().clamp(min=1.0)
        return torch.where(torch.isfinite(scale), scale,
                           torch.ones_like(scale))

    def flag(self, cfg: ABFTConfig) -> Tensor:
        # NaN-safe: a NaN divergence (corrupted checksum path — a bit
        # flip in w_r/s_c/the carried eq.-5 column propagating to pred)
        # must FLAG.  ``d > tau`` is False for NaN, which would silently
        # disable ABFT, so the comparison is negated: not (d <= tau).
        d = self.diff()
        if cfg.relative:
            return (~(d <= cfg.threshold * self._scale())).any()
        return (~(d <= cfg.threshold)).any()

    def elementwise(self, cfg: ABFTConfig) -> tuple[Tensor, Tensor]:
        """Per-element (flags, rel divergence) — the shared reduction core
        of :func:`per_graph_report` / :func:`per_stripe_report`.  NaN-safe
        like :meth:`flag`: a NaN comparison flags its element."""
        d = self.diff()
        scale = self._scale()
        f = ~(d <= cfg.threshold * (scale if cfg.relative else 1.0))
        return f, (d / scale).to(torch.float32)


class ABFTReport(NamedTuple):
    """Aggregated result of all checks in one step (scalar tensors)."""

    flag: Tensor       # bool — any check tripped
    max_rel: Tensor    # worst relative divergence seen
    n_checks: Tensor   # number of scalar comparisons performed


def _total(a: Tensor, cfg: ABFTConfig) -> Tensor:
    if cfg.kahan:
        return kahan_total(a.to(cfg.dtype))
    return total_checksum(a, cfg.dtype)


def check_matmul(a: Tensor, b: Tensor, c: Tensor, cfg: ABFTConfig,
                 *, b_r: Optional[Tensor] = None) -> Check:
    """Split-ABFT check of an already-computed product c = a @ b.

    Batched operands are fine (leading axes broadcast): one scalar check per
    batch element, reduced later by :func:`summarize`.  A folded right
    checksum ``b_r = B·e`` (from :func:`fold_w_r_tree` at weight-load time)
    skips the per-step row-sum of B; it must have been folded at this
    config's checksum dtype (validated — a stale fold raises).
    """
    if b_r is None:
        pred = predicted_matmul_checksum(a, b, cfg.dtype)
    else:
        b_r = resolve_w_r(b, b_r, cfg)
        pred = torch.einsum("...k,...k->...", col_checksum(a, cfg.dtype), b_r)
    return Check(predicted=pred, actual=_total(c, cfg))


def checked_matmul(a: Tensor, b: Tensor, cfg: ABFTConfig
                   ) -> tuple[Tensor, Optional[Check]]:
    """Compute a @ b and (mode-dependent) its ABFT check."""
    c = torch.matmul(a, b)
    if not cfg.enabled:
        return c, None
    return c, check_matmul(a, b, c, cfg)


def check_chain(mats: Sequence[Tensor], out: Tensor, cfg: ABFTConfig
                ) -> Check:
    """Fused (GCN-ABFT) check of out = mats[0] @ ... @ mats[-1].

    Supports batched leading axes on any operand: the left checksum vector is
    pushed through the chain with vector-matrix products (broadcasting
    applies).
    """
    v = col_checksum(mats[0], cfg.dtype)                    # [..., k0]
    for m in mats[1:-1]:
        v = torch.einsum("...k,...kj->...j", v, m.to(cfg.dtype))
    pred = torch.einsum("...k,...k->...", v,
                        row_checksum(mats[-1], cfg.dtype))
    return Check(predicted=pred, actual=_total(out, cfg))


# ---------------------------------------------------------------------------
# The CheckedOp protocol and its op-generic fold/report algebra.
#
# An op's check vectors fold once at weight-load time (resolve_w_r /
# fold_w_r_tree — the paper's "offline" eq.-5 convention), the op returns
# (out, Check) at its declared granularity, and the report algebra
# (summarize / per_graph_report / ...) reduces the checks into verdicts the
# runtime guard acts on.
# ---------------------------------------------------------------------------

def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def resolve_w_r(w: Tensor, w_r: Optional[Tensor],
                cfg: ABFTConfig) -> Optional[Tensor]:
    """Resolve one op's right checksum w_r = W·e: computed at ``cfg.dtype``
    when absent, validated against the checksum dtype when folded, ``None``
    when checking is off.  Every CheckedOp implementation shares this so a
    stale fold raises identically everywhere."""
    if not cfg.enabled:
        return None
    if w_r is None:
        return row_checksum(w, cfg.dtype)
    have = w_r.dtype if isinstance(w_r, Tensor) \
        else torch.as_tensor(w_r).dtype
    if have != cfg.dtype:
        raise ValueError(
            f"folded w_r has dtype {have} but cfg.dtype is {cfg.dtype}: "
            f"the checks would run at a stale precision.  Re-fold the "
            f"params (fold_w_r_tree / engine.fold_w_r) after changing "
            f"ABFTConfig.dtype (or drop the fold to recompute w_r per step)")
    return w_r


def fold_w_r_tree(params: Any, cfg: ABFTConfig, *, lead_axes: int = 0,
                  compute_dtype: Any = None) -> Any:
    """Tree-generic offline fold: walk any params tree and add a folded
    right checksum ``"w_r"`` next to every ``"w"`` weight leaf.

    ``w`` is ``[d_in, *d_out]`` and the fold sums over every output axis —
    ``w_r = W·e`` of the 2-D flattened weight, one value per input feature.
    ``lead_axes`` names leading batch/stack axes to preserve.  Existing
    ``"w_r"`` entries are overwritten — re-fold after any weight update or
    ``cfg.dtype`` change.  Non-dict leaves and dicts without a ``"w"`` array
    pass through untouched, so one call folds a whole model.  Weights may be
    tensors or numpy arrays; the fold stays in the leaf's own array type.

    ``compute_dtype`` quantizes the weights to the model's compute dtype
    *before* the checksum accumulation, so the folded prediction matches the
    weights the product actually consumed.
    """
    if not cfg.enabled:
        return params

    def _cast(w, dtype):
        if isinstance(w, Tensor):
            return w.to(dtype)
        return w.astype(_numpy_dtype(dtype) if isinstance(dtype, torch.dtype)
                        else dtype)

    def _fold(node):
        if isinstance(node, dict):
            out = {k: _fold(v) for k, v in node.items()}
            w = node.get("w")
            if w is not None and hasattr(w, "ndim") and \
                    w.ndim >= 2 + lead_axes:
                if compute_dtype is not None:
                    w = _cast(w, compute_dtype)
                w = _cast(w, cfg.dtype)
                out["w_r"] = w.reshape(*w.shape[:1 + lead_axes], -1).sum(-1)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(_fold(v) for v in node)
        return node

    return _fold(params)


class CheckedOp:
    """Protocol for one checked op — the engine's unit of ABFT coverage.

    A checked op takes its operands plus folded check vectors and returns
    ``(out, Check)`` at a declared granularity::

        op = SomeOp(...)
        params = op.fold(params, cfg)          # offline, at weight load
        out, check = op(cfg, *operands, **folded_check_vectors)

    ``check`` is a :class:`Check` (or ``None`` when ``cfg.mode == "none"``;
    ops whose policy emits several comparisons — e.g. the split eq. 2–3
    baseline — may return a list of Checks).  The contract implementations
    must honour:

      * the *predicted* side is computed only from the op's inputs and
        folded vectors — never from the output (a fault would cancel);
      * ``granularity`` declares what one comparison element attributes a
        fault to (see :data:`GRANULARITIES`);
      * ``op_id`` keys the op's verdicts in per-op reports and guard
        repair sites (``"op:<id>"``) — stable across steps of one serving
        trace.

    Implementations: the GCN ``AggregationBackend``s (``engine/backends``),
    the reference ops below, and the kernel ops ``kernels/matmul_abft``
    (``MatmulAbftOp``, every dense of the LM) and ``kernels/flash_checksum``
    (``FlashAttentionOp``).
    """

    op_id: str = "op"
    granularity: str = "layer"

    def fold(self, params: Any, cfg: ABFTConfig) -> Any:
        """Fold this op's check vectors into ``params`` at load time."""
        return fold_w_r_tree(params, cfg)

    def __call__(self, cfg: ABFTConfig, *operands, **folded):
        raise NotImplementedError


class MatmulOp(CheckedOp):
    """Reference split-ABFT op (eqs. 2–3): ``out = A @ B``, one scalar
    comparison, optional folded ``b_r``.  Plain PyTorch: the kernel-backed
    drop-in is ``kernels.matmul_abft.ops.MatmulAbftOp``."""

    op_id = "matmul"

    def __call__(self, cfg: ABFTConfig, a: Tensor, b: Tensor, *,
                 b_r: Optional[Tensor] = None):
        c = torch.matmul(a, b)
        if not cfg.enabled:
            return c, None
        return c, check_matmul(a, b, c, cfg, b_r=b_r)


class ChainOp(CheckedOp):
    """Reference fused op (eqs. 4–6): ``out = M0 @ ... @ Mk`` with ONE
    comparison for the whole linear chain, optional folded right checksum
    of the last matrix."""

    op_id = "chain"

    def __call__(self, cfg: ABFTConfig, *mats: Tensor,
                 w_r: Optional[Tensor] = None):
        out = mats[0]
        for m in mats[1:]:
            out = torch.matmul(out, m)
        if not cfg.enabled:
            return out, None
        if w_r is None:
            return out, check_chain(mats, out, cfg)
        w_r = resolve_w_r(mats[-1], w_r, cfg)
        v = col_checksum(mats[0], cfg.dtype)
        for m in mats[1:-1]:
            v = torch.einsum("...k,...kj->...j", v, m.to(cfg.dtype))
        pred = torch.einsum("...k,...k->...", v, w_r)
        return out, Check(predicted=pred, actual=_total(out, cfg))


def per_op_report(checks: Sequence[Optional[Check]], cfg: ABFTConfig, *,
                  prefix: str = "op", device: Any = None
                  ) -> tuple[tuple, Tensor, Tensor]:
    """Per-op twin of :func:`summarize`: one verdict per check element,
    keyed by a static op id.

    Returns ``(op_ids, flags, max_rel)`` where ``op_ids`` is a tuple of
    strings and ``flags``/``max_rel`` are aligned ``[n_ops]`` vectors.  A
    check whose fields are batched — a transformer segment stacks one
    comparison per layer into ``[count]`` fields — contributes one verdict
    per element with a ``:L{j}`` suffix, so a flagged op names the layer it
    fired in.  The ids are positional among the present checks (``None`` =
    op disabled): stable across steps of one serving configuration, which
    is all the guard's persistent-site discrimination needs.  ``device``
    places the empty vectors when there is nothing to report.
    """
    checks = [c for c in checks if c is not None]
    if not checks or not cfg.enabled:
        return ((), torch.zeros((0,), dtype=torch.bool, device=device),
                torch.zeros((0,), dtype=torch.float32, device=device))
    ids: list = []
    flags, rels = [], []
    for i, c in enumerate(checks):
        f, r = c.elementwise(cfg)
        f, r = f.reshape(-1), r.reshape(-1)
        n = int(f.shape[0])
        if n == 1:
            ids.append(f"{prefix}{i}")
        else:
            ids.extend(f"{prefix}{i}:L{j}" for j in range(n))
        flags.append(f)
        rels.append(r.to(torch.float32))
    return tuple(ids), torch.cat(flags), torch.cat(rels)


# ---------------------------------------------------------------------------
# The paper's GCN layer checks, both dataflows.
# ---------------------------------------------------------------------------

def gcn_layer_split(s: Any, h: Tensor, w: Tensor, cfg: ABFTConfig, *,
                    device: DeviceLike = "cuda"
                    ) -> tuple[Tensor, tuple[Check, Check]]:
    """Baseline ABFT (eqs. 2–3): combination-first, two separate checks."""
    return gcn_layer_split_sparse(s, h, w, cfg, device=device)


def gcn_layer_fused(s: Any, h: Tensor, w: Tensor, cfg: ABFTConfig, *,
                    device: DeviceLike = "cuda"
                    ) -> tuple[Tensor, Check]:
    """GCN-ABFT (eqs. 4–6): single fused check s_c H w_r vs e^T H_out e.

    H carries *no* check state: we only form w_r = W e (offline in a real
    deployment), the extra column x_r = H w_r during the first multiply, and
    s_c = e^T S (offline for static graphs).
    """
    return gcn_layer_fused_sparse(s, h, w, cfg, device=device)


def gcn_layer(s: Any, h: Tensor, w: Tensor, cfg: ABFTConfig, *,
              device: DeviceLike = "cuda"
              ) -> tuple[Tensor, list[Check]]:
    """Policy dispatch used by the GCN model."""
    return gcn_layer_sparse(s, h, w, cfg, device=device)


# ---------------------------------------------------------------------------
# Canonical layer implementations, generic over the adjacency (a ``torch``
# sparse tensor, COO or CSR, or dense S — the dense gcn_layer* wrappers
# above delegate here).  Only the aggregation product and the s_c checksum
# honour sparsity.  For a static graph s_c = e^T S never changes — compute
# it once offline (:func:`sparse_col_checksum`) and pass it to every
# layer/step.
# ---------------------------------------------------------------------------

def _is_sparse(s: Any) -> bool:
    """A ``torch`` sparse tensor in COO or CSR layout."""
    return isinstance(s, Tensor) and s.layout in (torch.sparse_coo,
                                                  torch.sparse_csr)


def sparse_matmul(s: Any, x: Tensor) -> Tensor:
    """S @ X for sparse or dense S."""
    return torch.sparse.mm(s, x) if _is_sparse(s) else torch.matmul(s, x)


def sparse_col_checksum(s: Any, dtype: torch.dtype = torch.float32
                        ) -> Tensor:
    """e^T S without densifying: O(nnz) over the column indices.

    This is the offline s_c precompute for static graphs — call it once per
    graph and thread the result through :func:`gcn_layer_fused_sparse`.
    For a sparse S it is built once on the host in one fixed order
    (``np.bincount``, float64, then cast to ``dtype``) and placed on S's
    device: ``index_add_`` on CUDA adds floats with atomics, in an order
    that changes from run to run.
    """
    if not _is_sparse(s):
        return col_checksum(torch.as_tensor(s), dtype)
    if s.layout == torch.sparse_csr:
        cols, data = s.col_indices(), s.values()
    else:
        cols, data = s._indices()[1], s._values()
    sums = np.bincount(cols.cpu().numpy(), minlength=s.shape[1],
                       weights=data.cpu().numpy().astype(np.float64))
    return torch.from_numpy(sums).to(dtype).to(s.device)


def _engine_layer(s: Any, h: Tensor, w: Tensor, cfg: ABFTConfig,
                  s_c: Optional[Tensor], mode: str, device: DeviceLike
                  ) -> tuple[Tensor, list[Check]]:
    """Delegate one layer to the unified engine under a forced mode.

    The eq. 4–6 algebra lives in ``repro_torch/engine/api.py``; these entry
    points stay for callers that address a single layer directly.  ``h``
    and ``w`` move to ``device``.  Imports are deferred: the engine imports
    this module for Check/summarize.
    """
    from repro_torch.engine import gcn_layer as engine_gcn_layer
    from repro_torch.engine import make_backend

    if cfg.mode != mode:
        cfg = dataclasses.replace(cfg, mode=mode)
    dev = resolve_device(device)
    bk = make_backend(s, cfg, s_c=s_c if cfg.enabled else None, device=dev)
    return engine_gcn_layer(bk, torch.as_tensor(h).to(dev),
                            torch.as_tensor(w).to(dev), cfg)


def gcn_layer_fused_sparse(s: Any, h: Tensor, w: Tensor, cfg: ABFTConfig,
                           s_c: Optional[Tensor] = None, *,
                           device: DeviceLike = "cuda"
                           ) -> tuple[Tensor, Check]:
    """GCN-ABFT (eqs. 4–6) with a sparse aggregation operand.

    Identical check algebra to :func:`gcn_layer_fused`; ``s_c`` should be
    the offline precompute for static graphs (recomputed O(nnz) when not
    supplied, which is still cheap but wasteful across layers/steps).
    """
    h_out, checks = _engine_layer(s, h, w, cfg, s_c, "fused", device)
    return h_out, checks[0]


def gcn_layer_split_sparse(s: Any, h: Tensor, w: Tensor, cfg: ABFTConfig,
                           s_c: Optional[Tensor] = None, *,
                           device: DeviceLike = "cuda"
                           ) -> tuple[Tensor, tuple[Check, Check]]:
    """Baseline split ABFT (eqs. 2–3) over a sparse aggregation operand."""
    h_out, checks = _engine_layer(s, h, w, cfg, s_c, "split", device)
    return h_out, (checks[0], checks[1])


def gcn_layer_sparse(s: Any, h: Tensor, w: Tensor, cfg: ABFTConfig,
                     s_c: Optional[Tensor] = None, *,
                     device: DeviceLike = "cuda"
                     ) -> tuple[Tensor, list[Check]]:
    """Policy dispatch used by the sparse GCN model path."""
    return _engine_layer(s, h, w, cfg, s_c, cfg.mode, device)


# ---------------------------------------------------------------------------
# Segment reductions over a sorted stripe -> graph map.
#
# ``segments`` assigns each row-stripe to a graph slot; padding stripes
# carry the overflow id ``n`` and are dropped.  ``index_add_`` would do, but
# on CUDA it adds with atomics in an order that changes from run to run.
# The stripe count is small (hundreds), so each reducer instead builds the
# [n, n_stripes] membership mask and reduces along the stripe axis: one
# fixed summation order, exact zeros outside a segment, and a NaN stays in
# the segment that produced it (a one-hot matmul would spread it to every
# graph through 0 * NaN).
# ---------------------------------------------------------------------------

def _segment_mask(segments: Tensor, n: int) -> Tensor:
    ids = torch.arange(n, device=segments.device, dtype=segments.dtype)
    return segments.unsqueeze(0) == ids.unsqueeze(1)        # [n, n_stripes]


def segment_sum(v: Tensor, segments: Tensor, n: int) -> Tensor:
    """Σ of ``v``'s leading axis per segment id in ``[0, n)`` -> [n, ...]."""
    mask = _segment_mask(segments, n)
    mask = mask.reshape(mask.shape + (1,) * (v.ndim - 1))
    return torch.where(mask, v.unsqueeze(0), torch.zeros((), dtype=v.dtype,
                                                         device=v.device)
                       ).sum(dim=1)


def segment_any(f: Tensor, segments: Tensor, n: int) -> Tensor:
    """OR of bool ``f [n_stripes]`` per segment (empty segment -> False)."""
    return (_segment_mask(segments, n) & f.unsqueeze(0)).any(dim=1)


def segment_max(r: Tensor, segments: Tensor, n: int) -> Tensor:
    """max of ``r [n_stripes]`` per segment, floored at 0 so an empty
    segment reports 0 (a NaN member still reports NaN)."""
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    return torch.where(_segment_mask(segments, n), r.unsqueeze(0), zero
                       ).amax(dim=1)


# ---------------------------------------------------------------------------
# Aggregation
# ---------------------------------------------------------------------------

def summarize(checks: Sequence[Optional[Check]], cfg: ABFTConfig, *,
              device: Any = None) -> ABFTReport:
    """Reduce an arbitrary collection of checks to one report.  ``device``
    places the all-clear report when there is nothing to reduce."""
    checks = [c for c in checks if c is not None]
    if not checks or not cfg.enabled:
        z = torch.zeros((), dtype=torch.float32, device=device)
        return ABFTReport(flag=torch.zeros((), dtype=torch.bool,
                                           device=device),
                          max_rel=z, n_checks=z)
    flags, rels, n = [], [], 0
    for c in checks:
        d = c.diff()
        scale = c.actual.abs().clamp(min=1.0)
        rels.append((d / scale).max())
        flags.append(c.flag(cfg))
        n += int(c.actual.numel())
    dev = checks[0].actual.device
    return ABFTReport(
        flag=torch.stack(flags).any(),
        max_rel=torch.stack(rels).max().to(torch.float32),
        n_checks=torch.tensor(float(n), dtype=torch.float32, device=dev),
    )


def per_graph_report(checks: Sequence[Optional[Check]], cfg: ABFTConfig,
                     n: int, *, segments: Optional[Tensor] = None,
                     device: Any = None) -> tuple[Tensor, Tensor]:
    """Elementwise twin of :func:`summarize` for batched checks: one verdict
    per graph instead of one reduced step flag.

    Every check's fields must be [n] batched scalars (the dense batched
    backend and the packed block-ELL segmented epilogue both emit these) —
    OR, when ``segments`` (the [n_stripes] stripe → graph map) is given,
    stripe-granular checks whose fields match the segments shape: their
    per-stripe verdicts reduce onto the owning graphs (OR of flags, max of
    divergences; padding stripes carry id ``n`` — the overflow segment —
    and are dropped).  Returns (flags [n] bool, max_rel [n] f32) — OR / max
    across checks (i.e. across layers), *not* across graphs, so the serving
    layer can retry only the flagged graphs.
    """
    checks = [c for c in checks if c is not None]
    if not checks or not cfg.enabled:
        return (torch.zeros((n,), dtype=torch.bool, device=device),
                torch.zeros((n,), dtype=torch.float32, device=device))
    seg_shape = None if segments is None else tuple(segments.shape)
    flags, rels = None, None
    for c in checks:
        # dispatch on the check's DECLARED granularity, not on shape alone:
        # a packed batch whose stripe count happens to equal its slot count
        # would otherwise read stripe corners as per-graph verdicts and
        # retry the wrong graphs (adopting the corrupted one)
        shape = tuple(c.actual.shape)
        if c.granularity not in ("stripe", "slot") and shape == (n,):
            f, r = c.elementwise(cfg)
        elif c.granularity == "slot" and seg_shape is not None \
                and shape[:1] == seg_shape:
            # slot-granular corners [n_stripes, width]: reduce the slot axis
            # (OR / max) to per-stripe verdicts, then segment-reduce onto
            # the owning graphs exactly like stripe corners below
            fs, rs = c.elementwise(cfg)
            fs, rs = fs.any(dim=1), rs.amax(dim=1)
            f = segment_any(fs, segments, n)
            r = segment_max(rs, segments, n)
        elif c.granularity == "stripe" and seg_shape is not None \
                and shape == seg_shape:
            # stripe-granular corners: segment-reduce onto the graphs
            # (empty slots own no stripes -> False / 0)
            fs, rs = c.elementwise(cfg)
            f = segment_any(fs, segments, n)
            r = segment_max(rs, segments, n)
        else:
            # a scalar (or otherwise-shaped) check cannot be attributed to
            # one graph; silently broadcasting it would mark every graph
            # flagged and defeat the per-graph retry
            raise ValueError(
                f"per_graph_report needs [n={n}]-batched checks, got "
                f"shape {shape}; use a backend that emits "
                f"per-graph corners (dense batched / packed block_ell)")
        flags = f if flags is None else flags | f
        rels = r if rels is None else torch.maximum(rels, r)
    return flags, rels


def per_stripe_report(checks: Sequence[Optional[Check]], cfg: ABFTConfig,
                      n_stripes: int, *, device: Any = None
                      ) -> tuple[Tensor, Tensor]:
    """Finest-granularity report: one verdict per (check, row-stripe).

    Every check's fields must be [n_stripes] per-stripe corners (the
    block-ELL backends at ``granularity="stripe"``) or [n_stripes, width]
    slot corners (``granularity="slot"``; the slot axis reduces by OR/max —
    a stripe is flagged when any of its slots is).  Returns
    (flags [L, n_stripes] bool, max_rel [L, n_stripes] f32) with one row per
    check — the layer axis is preserved, NOT reduced, because the surgical
    retry must know *which layer's* stripe to re-execute (a fault at layer
    L only dirties downstream values computed from it).
    """
    checks = [c for c in checks if c is not None]
    if not checks or not cfg.enabled:
        return (torch.zeros((0, n_stripes), dtype=torch.bool, device=device),
                torch.zeros((0, n_stripes), dtype=torch.float32,
                            device=device))
    flags, rels = [], []
    for c in checks:
        shape = tuple(c.actual.shape)
        if c.granularity == "slot" and c.actual.ndim == 2 \
                and shape[0] == n_stripes:
            f, r = c.elementwise(cfg)
            f, r = f.any(dim=1), r.amax(dim=1)
        elif shape == (n_stripes,) and c.granularity == "stripe":
            f, r = c.elementwise(cfg)
        else:
            raise ValueError(
                f"per_stripe_report needs [n_stripes={n_stripes}] "
                f"stripe-granular checks, got shape {shape} "
                f"(granularity={c.granularity!r}); build the backend with "
                f"granularity='stripe'")
        flags.append(f)
        rels.append(r)
    return torch.stack(flags), torch.stack(rels)


def per_slot_report(checks: Sequence[Optional[Check]], cfg: ABFTConfig,
                    n_stripes: int, width: int, *, device: Any = None
                    ) -> tuple[Tensor, Tensor]:
    """Finest-granularity report: one verdict per (check, stripe, ell-slot).

    Slot-granular checks carry [n_stripes, width] corners (adjacent
    differences of the kernel's telescoped running sums — see
    ``slot_check_corners``); stripe-granular checks in the same forward
    (e.g. a layer that fell back to the two-pass kernel mid-network)
    contribute an all-False slab — they still flag at stripe granularity
    via :func:`per_stripe_report`, they just cannot attribute a slot.
    Returns (flags [L, n_stripes, width] bool, max_rel [...] f32).
    """
    checks = [c for c in checks if c is not None]
    if not checks or not cfg.enabled:
        return (torch.zeros((0, n_stripes, width), dtype=torch.bool,
                            device=device),
                torch.zeros((0, n_stripes, width), dtype=torch.float32,
                            device=device))
    flags, rels = [], []
    for c in checks:
        shape = tuple(c.actual.shape)
        if c.granularity == "slot" and shape == (n_stripes, width):
            f, r = c.elementwise(cfg)
        elif c.granularity == "stripe" and shape == (n_stripes,):
            dev = c.actual.device
            f = torch.zeros((n_stripes, width), dtype=torch.bool, device=dev)
            r = torch.zeros((n_stripes, width), dtype=torch.float32,
                            device=dev)
        else:
            raise ValueError(
                f"per_slot_report needs [n_stripes={n_stripes}, "
                f"width={width}] slot-granular checks, got shape "
                f"{shape} (granularity={c.granularity!r}); build "
                f"the backend with granularity='slot'")
        flags.append(f)
        rels.append(r)
    return torch.stack(flags), torch.stack(rels)


def np_size(x: Any) -> int:
    """Element count of a tensor or array."""
    return int(x.numel()) if isinstance(x, Tensor) else int(np.size(x))


def merge_reports(reports: Sequence[ABFTReport]) -> ABFTReport:
    """Combine reports from several blocks / steps."""
    reports = list(reports)
    if not reports:
        z = torch.zeros((), dtype=torch.float32)
        return ABFTReport(torch.zeros((), dtype=torch.bool), z, z)
    return ABFTReport(
        flag=torch.stack([r.flag for r in reports]).any(),
        max_rel=torch.stack([r.max_rel for r in reports]).max(),
        n_checks=torch.stack([r.n_checks for r in reports]).sum(),
    )
