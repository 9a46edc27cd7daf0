"""Streaming GCN serving: a bounded request queue, online first-fit packing
into canonical rung shapes, and double-buffered guarded dispatch — plus the
serving steps and the per-shape packed runner with its retry ladder, which
the closed-batch server (``launch/serve_gcn.py``) shares.

Counterpart of the JAX package's ``repro/engine/streaming.py``.

* **Canonical rungs** (:func:`plan_rungs` / :class:`RungTable`) — a small
  fixed set of packed shapes (stripe capacity x ELL width x slot count)
  chosen from a traffic profile.  Every batch is padded to its rung's
  EXACT shape (``pack_graphs(stripe_cap=, width_cap=)``), so the number of
  distinct step shapes is bounded by the rung table, not by whatever graph
  sizes happen to arrive together.
* **Online first-fit packing** (:class:`StreamingEngine.submit`) — each
  request is fitted to the smallest rung whose capacity admits it and
  appended to that rung's open bin; a bin seals (dispatches) when its
  slots fill or the next request would overflow the stripe capacity.
* **Double-buffered dispatch** — sealing a bin packs it on the host while
  the previous batch is still executing on the device (CUDA launches are
  asynchronous and the step never synchronizes); only then is the previous
  batch *adjudicated* (``ABFTGuard.adjudicate`` — the first host sync) and
  the new one dispatched.  The guard ladder (slot -> stripe -> graph ->
  restore) is unchanged.
* **Latency SLOs** — every request records enqueue, dispatch, and verdict
  times; :meth:`StreamingEngine.stats` reports p50/p99 enqueue->verdict
  latency per request, not just graphs/sec.
* **Flush-on-deadline**, **backpressure** (``queue_capacity``: a submit
  beyond it gets an explicit ``rejected`` verdict) and **oversized
  requests** (a dedicated power-of-two singleton shape, or a
  ``rejected_oversize`` verdict) keep the stream serving.

There is no ``jit`` here: PyTorch runs eagerly, so a "step" is a plain
closure.  :class:`PackedRunner` still keeps one step per distinct packed
shape, so ``compile_count`` goes on meaning "distinct shapes served" — the
quantity the rung table bounds — and the power-of-two retry ladder keeps
its bounded-shapes contract.
"""
from __future__ import annotations

import dataclasses
import logging
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.convert import params_to_device
from repro_torch.core.abft import ABFTConfig, per_graph_report, \
    per_slot_report, per_stripe_report, summarize
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine.api import Graph, fold_w_r, gcn_forward
from repro_torch.engine.backends import BlockEllBackend
from repro_torch.engine.batching import GraphBatch, PackedGraphs, \
    graph_pack_stats, pack_graphs
from repro_torch.kernels.gcn_fused.ops import FUSED_SMEM_BUDGET, \
    fused_layer_fits, fused_network_fits
from repro_torch.runtime import ABFTGuard, UnverifiableBatch
from repro_torch.runtime.abft_guard import _host

log = logging.getLogger(__name__)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------

def make_serve_step(params, cfg: ABFTConfig, *, device: DeviceLike = "cuda"):
    """(s, h0) -> (logits, metrics) batched dense engine step.

    The dense backend broadcasts over the leading batch axis, so the batch
    contributes batched scalar checks — reduced into one report AND kept
    per-graph for the guard's partial retry.
    """
    dev = resolve_device(device)

    def step(s, h0):
        logits, checks = gcn_forward(params, Graph(s=s, h0=h0), cfg,
                                     backend="dense", device=dev)
        report = summarize(checks, cfg, device=dev)
        gflags, grel = per_graph_report(checks, cfg, s.shape[0], device=dev)
        return logits, {"abft_flag": report.flag,
                        "abft_max_rel": report.max_rel,
                        "abft_n_checks": report.n_checks,
                        "abft_graph_flags": gflags,
                        "abft_graph_max_rel": grel}
    return step


def make_packed_serve_step(params, cfg: ABFTConfig, n_slots: int, *,
                           block_g: int = 128,
                           fused_layer: bool = False,
                           fused_network: bool = False,
                           vmem_budget: Optional[int] = None,
                           granularity: str = "graph",
                           inject=None):
    """(cols, vals, segments, h0) -> (logits, metrics) packed step.

    The packed block-ELL tensors are *arguments*, so every batch of the
    same packed shape runs this one step; the segmented epilogue's per-graph
    corners feed both the step report and the per-graph verdict vector.  The
    step runs on the device its arguments lie on and never synchronizes
    with it.  ``fused_layer=True`` runs each layer through the single-pass
    gcn_fused kernel (combination + aggregation + check in one sweep)
    instead of the two-pass combination-then-spmm path;
    ``fused_network=True`` goes further and runs the WHOLE forward in one
    ``gcn_network`` launch, falling back to the per-layer ladder when
    ``analysis.vmem.fused_network_fits`` declines.

    ``granularity="stripe"`` keeps the per-row-stripe corners: the metrics
    gain ``abft_stripe_flags`` / ``abft_stripe_max_rel`` ([checks,
    n_stripes] verdicts, the per-graph vector now segment-reduced from
    them), ``abft_h_layers`` (every layer's input activations), and
    ``abft_x_layers`` (two-pass layers' combination outputs) — the operands
    a surgical repair needs (the network kernel's activation buffers are
    the stash).  ``granularity="slot"`` refines to
    per-(stripe, ell-slot) telescope corners on the fused kernel path,
    adding ``abft_slot_flags`` / ``abft_slot_max_rel`` ([checks, n_stripes,
    width]); two-pass fallback layers degrade to stripe corners and
    contribute all-False slot slabs.  ``inject`` is the benchmark/CI
    accumulator fault hook, ``(layer, stripe, slot, delta)``, honoured by
    all three kernels.
    """
    want_localize = granularity in ("stripe", "slot")

    def step(cols, vals, segments, h0):
        dev = vals.device
        bk = BlockEllBackend.from_staged(cols, vals, segments, n_slots, cfg,
                                         block_g=block_g,
                                         fused_layer=fused_layer,
                                         fused_network=fused_network,
                                         vmem_budget=vmem_budget,
                                         granularity=granularity,
                                         inject=inject)
        if want_localize:
            logits, checks, h_layers, x_layers = gcn_forward(
                params, Graph(s=None, h0=h0), cfg, backend=bk,
                return_intermediates=True, return_x=True)
        else:
            # no surgical tier to feed: skip the operand stashes
            logits, checks = gcn_forward(
                params, Graph(s=None, h0=h0), cfg, backend=bk)
        report = summarize(checks, cfg, device=dev)
        metrics = {"abft_flag": report.flag,
                   "abft_max_rel": report.max_rel,
                   "abft_n_checks": report.n_checks}
        if want_localize:
            gflags, grel = per_graph_report(checks, cfg, n_slots,
                                            segments=segments, device=dev)
            sflags, srel = per_stripe_report(checks, cfg, vals.shape[0],
                                             device=dev)
            metrics.update(abft_stripe_flags=sflags,
                           abft_stripe_max_rel=srel,
                           abft_h_layers=h_layers,
                           abft_x_layers=x_layers)
            if granularity == "slot":
                slflags, slrel = per_slot_report(checks, cfg, vals.shape[0],
                                                 vals.shape[1], device=dev)
                metrics.update(abft_slot_flags=slflags,
                               abft_slot_max_rel=slrel)
        else:
            gflags, grel = per_graph_report(checks, cfg, n_slots, device=dev)
        metrics.update(abft_graph_flags=gflags, abft_graph_max_rel=grel)
        return logits, metrics
    return step


def packed_step_args(pb: PackedGraphs, device: DeviceLike = "cuda"
                     ) -> Tuple[Tensor, ...]:
    """The packed step's positional operands for one batch, staged on
    ``device``."""
    dev = resolve_device(device)
    return (torch.from_numpy(pb.bell.block_cols).to(dev),
            torch.from_numpy(pb.bell.values).to(dev),
            torch.from_numpy(pb.stripe_graph).to(dev),
            torch.from_numpy(pb.h0).to(dev))


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1) — the retry/singleton shape
    ladder's quantizer: distinct counts collapse onto O(log) shapes."""
    return 1 << max(0, int(n - 1).bit_length())


class PackedRunner:
    """Per-shape packed steps + the per-graph retry closure.

    ``_steps`` holds one entry per distinct packed shape; its length is the
    count of distinct shapes this runner has served (``compile_count`` —
    the name the JAX package gave it, where each shape cost one compile).
    ``params`` must live on ``device``.
    """

    def __init__(self, params, cfg: ABFTConfig, block_g: int,
                 fused_layer: bool = False, granularity: str = "graph",
                 fused_network: bool = False,
                 vmem_budget: Optional[int] = None,
                 inject=None, *, device: DeviceLike = "cuda"):
        self.params, self.cfg = params, cfg
        self.device = resolve_device(device)
        self.block_g = block_g
        self.fused_layer = fused_layer
        self.fused_network = fused_network
        self.vmem_budget = vmem_budget
        self.granularity = granularity
        # chaos hook: the kernel accumulator fault (layer, stripe, slot,
        # delta), carried by every step this runner builds — the device-side
        # injection surface of the fault tests
        self.inject = inject
        self._steps = {}

    @property
    def compile_count(self) -> int:
        return len(self._steps)

    def args_for(self, pb: PackedGraphs) -> Tuple[Tensor, ...]:
        return packed_step_args(pb, self.device)

    def step_for(self, pb: PackedGraphs):
        key = (pb.bell.values.shape, pb.h0.shape, pb.n_slots)
        if key not in self._steps:
            if self.fused_layer or self.fused_network:
                self._warn_fallbacks(pb)
            self._steps[key] = make_packed_serve_step(
                self.params, self.cfg, pb.n_slots, block_g=self.block_g,
                fused_layer=self.fused_layer,
                fused_network=self.fused_network,
                vmem_budget=self.vmem_budget,
                granularity=self.granularity,
                inject=self.inject)
        return self._steps[key]

    def _budget(self) -> int:
        return FUSED_SMEM_BUDGET if self.vmem_budget is None \
            else self.vmem_budget

    def _network_dims(self) -> list:
        layers = self.params["layers"]
        return ([int(layers[0]["w"].shape[0])]
                + [int(layer["w"].shape[1]) for layer in layers])

    def fusion_counts(self, pb: PackedGraphs) -> Dict[str, int]:
        """Per-batch fusion decisions, recomputed from the SAME static shape
        predicates the backend evaluates when a layer runs.  One
        whole-network hit subsumes the per-layer decisions; a network
        fallback drops to the per-layer ladder, whose hit/fallback split is
        evaluated layer by layer.  The network decision is the port's
        predicate (``analysis.vmem.fused_network_fits``), which differs from
        the JAX package's TPU predicate at wide models."""
        counts = {"fused_hits": 0, "fused_fallbacks": 0,
                  "network_hits": 0, "network_fallbacks": 0}
        if self.cfg.mode == "split":
            return counts
        if self.fused_network:
            if self._network_fits(pb):
                counts["network_hits"] = 1
                return counts
            counts["network_fallbacks"] = 1
        _nbm, _w, bm, bk = pb.bell.values.shape
        if self.fused_layer:
            for layer in self.params["layers"]:
                if fused_layer_fits(*layer["w"].shape, bm, bk,
                                    block_g=self.block_g,
                                    budget=self._budget()):
                    counts["fused_hits"] += 1
                else:
                    counts["fused_fallbacks"] += 1
        return counts

    def _network_fits(self, pb: PackedGraphs) -> bool:
        nbm, _w, bm, bk = pb.bell.values.shape
        return fused_network_fits(self._network_dims(), bm, nbm * bm, bk=bk,
                                  block_g=self.block_g,
                                  budget=self._budget())

    def _warn_fallbacks(self, pb: PackedGraphs):
        """The shared-memory-budget decision happens inside the step, where
        it is invisible to the operator — so surface it once per packed
        shape, from the layer widths we already know."""
        if self.fused_network:
            if self._network_fits(pb):
                return          # whole network fused; nothing falls back
            warnings.warn(
                "--fused-network: the whole-network kernel does not take "
                "these layer widths at this block shape and shared-memory "
                "budget (analysis.vmem.fused_network_fits); the batch runs "
                "the per-layer ladder instead")
        if not self.fused_layer:
            return
        _nbm, _w, bm, bk = pb.bell.values.shape
        wide = [tuple(layer["w"].shape) for layer in self.params["layers"]
                if not fused_layer_fits(*layer["w"].shape, bm, bk,
                                        block_g=self.block_g,
                                        budget=self._budget())]
        if wide:
            warnings.warn(
                f"--fused-layer: layer widths {wide} at block ({bm}, {bk}) "
                f"exceed the fused kernel's shared-memory budget; those "
                f"layers run the two-pass kernel instead")

    def _retry_shape(self, pb: PackedGraphs, items) -> Dict[str, int]:
        """Canonical sub-pack shape for a flagged subset: slot count,
        stripe capacity, and ELL width each rounded up a power-of-two
        ladder (respecting the parent's quantization multiples), so every
        flagged-graph count on a flaky host maps onto O(log) shapes that
        hit the ``_steps`` cache."""
        sq = max(pb.stripe_multiple, 1)
        wq = max(pb.width_multiple, 1)
        stats = [graph_pack_stats(s, pb.block) for s, _ in items]
        stripes = sum(st for st, _ in stats)
        width = max(w for _, w in stats)
        return {"n_slots": next_pow2(len(items)),
                "stripe_cap": sq * next_pow2(-(-stripes // sq)),
                "width_cap": wq * next_pow2(-(-width // wq))}

    def pack_retry(self, pb: PackedGraphs, items,
                   indices: Optional[Sequence[int]] = None) -> PackedGraphs:
        shape = self._retry_shape(pb, items)
        return pack_graphs(items, block=pb.block,
                           stripe_multiple=pb.stripe_multiple,
                           width_multiple=pb.width_multiple,
                           indices=indices, **shape)

    def retry_fn(self, pb: PackedGraphs):
        """retry(out, idx): re-pack ONLY the flagged graphs into a small
        block-diagonal system (same block size as the parent batch),
        re-run, and patch their logit rows back — the unflagged graphs'
        verified rows are untouched.  Sub-packs pad onto the power-of-two
        retry ladder (slots 1, 2, 4, …; stripes/width likewise), so a
        flaky chip retrying a different flagged count every batch meets
        O(log) shapes total, all shared through the ``_steps`` cache.  The
        patched logits stay a tensor on the device (a copy: the caller's
        ``out`` is not written to).

        ``abft_rows_recomputed`` counts LOGICAL rows (Σ n_nodes x layers):
        block/stripe/width quantization padding is shape bookkeeping, not
        recomputed work."""
        def retry(out, idx):
            items = [pb.items[i] for i in idx]
            sub = self.pack_retry(pb, items)
            sub_logits, sub_metrics = self.step_for(sub)(*self.args_for(sub))
            n_layers = len(self.params["layers"])
            k = len(idx)
            sub_metrics = {
                **sub_metrics,
                "abft_graph_flags": sub_metrics["abft_graph_flags"][:k],
                "abft_graph_max_rel": sub_metrics["abft_graph_max_rel"][:k],
                "abft_rows_recomputed":
                    int(sub.n_nodes.sum()) * n_layers}
            out = out.clone()
            for j, gi in enumerate(idx):
                o, n = int(pb.row_offsets[gi]), int(pb.n_nodes[gi])  # abftlint: sync-ok (host pack tables)
                so, sn = int(sub.row_offsets[j]), int(sub.n_nodes[j])  # abftlint: sync-ok (host pack tables)
                out[o:o + n] = sub_logits[so:so + sn]
            return out, sub_metrics
        return retry

    def stripe_retry_fn(self, pb: PackedGraphs):
        """Surgical tier: gather the flagged stripes' tile rows, re-execute
        them through the fused kernel against the SAME packed operands,
        splice the rows back, and re-verify — no re-packing, no whole-graph
        replay (``engine.localize.surgical_stripe_retry``)."""
        from repro_torch.engine.localize import surgical_stripe_retry

        def sretry(out, metrics):
            return surgical_stripe_retry(pb, self.params, self.cfg, out,
                                         metrics, block_g=self.block_g)
        return sretry

    def slot_retry_fn(self, pb: PackedGraphs):
        """Finest tier: repair from the per-(stripe, slot) telescope
        corners with row-level downstream propagation
        (``engine.localize.surgical_slot_retry``); the guard escalates to
        the stripe tier when the repair cannot be verified."""
        from repro_torch.engine.localize import surgical_slot_retry

        def slretry(out, metrics):
            return surgical_slot_retry(pb, self.params, self.cfg, out,
                                       metrics, block_g=self.block_g)
        return slretry


def dense_retry_fn(step, b: GraphBatch, device: DeviceLike = "cuda"):
    """retry(out, idx): re-run only the flagged slots as a smaller dense
    sub-batch and patch their logits back.  The sub-batch pads up the
    power-of-two slot ladder (1, 2, 4, …) with empty all-zero graphs —
    which contribute 0 = 0 to every check and can never flag — so distinct
    flagged counts share O(log) shapes of ``step`` instead of one each."""
    dev = resolve_device(device)

    def retry(out, idx):
        k = len(idx)
        pad = next_pow2(k)
        sub_s = np.zeros((pad,) + b.s.shape[1:], b.s.dtype)
        sub_h = np.zeros((pad,) + b.h0.shape[1:], b.h0.dtype)
        sub_s[:k] = b.s[idx]
        sub_h[:k] = b.h0[idx]
        sub_logits, sub_metrics = step(torch.from_numpy(sub_s).to(dev),
                                       torch.from_numpy(sub_h).to(dev))
        sub_metrics = {
            **sub_metrics,
            "abft_graph_flags": sub_metrics["abft_graph_flags"][:k],
            "abft_graph_max_rel": sub_metrics["abft_graph_max_rel"][:k]}
        out = out.clone()
        out[torch.as_tensor(idx, device=out.device)] = sub_logits[:k]
        return out, sub_metrics
    return retry


# ---------------------------------------------------------------------------
# canonical shape rungs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Rung:
    """One canonical packed shape: a batch padded against this rung always
    presents [stripe_cap stripes x width_cap ELL slots x n_slots graph
    segments] to its step."""

    stripe_cap: int
    width_cap: int
    n_slots: int


@dataclasses.dataclass(frozen=True)
class RungTable:
    """The fixed shape menu of a streaming server.

    ``fit`` returns the smallest rung admitting a request (by stripe count
    AND ELL width), or None — the oversize path.  The table's length bounds
    the server's steady-state count of distinct step shapes.
    """

    rungs: Tuple[Rung, ...]
    block: int
    stripe_multiple: int = 1
    width_multiple: int = 1

    def __len__(self) -> int:
        return len(self.rungs)

    def fit(self, stripes: int, width: int) -> Optional[Rung]:
        for r in self.rungs:
            if stripes <= r.stripe_cap and width <= r.width_cap:
                return r
        return None


def plan_rungs(profile: Sequence[Tuple[np.ndarray, np.ndarray]], *,
               n_slots: int, block: int = 32, stripe_multiple: int = 4,
               width_multiple: int = 4, max_rungs: int = 4) -> RungTable:
    """Choose canonical rungs from a traffic profile (a sample of (S, H0)
    pairs representative of the stream).

    The base rung's stripe capacity is the profile's mean stripe count x
    ``n_slots`` (a full bin of typical graphs), rounded up to the
    ``stripe_multiple`` quantum — the same capacity ``schedule_packs``
    fills closed batches toward.  Capacities then double until the largest
    profiled graph fits alone (so no profiled size is oversized), capped
    at ``max_rungs`` entries with the last rung forced large enough.
    Width is one shared cap: the profile's max, quantized.
    """
    if not profile:
        raise ValueError("plan_rungs needs a non-empty traffic profile")
    if n_slots < 1:
        raise ValueError(f"n_slots must be >= 1, got {n_slots}")
    stats = [graph_pack_stats(s, block) for s, _ in profile]
    stripes = [st for st, _ in stats]
    sq = max(stripe_multiple, 1)
    wq = max(width_multiple, 1)
    width_cap = -(-max(w for _, w in stats) // wq) * wq
    mean_up = -(-sum(stripes) // len(stripes))
    base = -(-mean_up * n_slots // sq) * sq
    need = -(-max(stripes) // sq) * sq      # largest single profiled graph
    caps = [base]
    while caps[-1] < need and len(caps) < max_rungs:
        caps.append(caps[-1] * 2)
    caps[-1] = max(caps[-1], need)
    rungs = tuple(Rung(stripe_cap=c, width_cap=width_cap, n_slots=n_slots)
                  for c in caps)
    return RungTable(rungs=rungs, block=block, stripe_multiple=sq,
                     width_multiple=wq)


# ---------------------------------------------------------------------------
# the streaming engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RequestResult:
    """Per-request verdict + latency accounting."""

    rid: int
    status: str                       # "served" | "rejected" |
    #                                   "rejected_oversize"
    flag: Optional[bool] = None       # final adopted ABFT verdict
    max_rel: float = 0.0
    logits: Optional[np.ndarray] = None
    reason: str = ""
    t_enqueue: float = 0.0
    t_dispatch: Optional[float] = None
    t_verdict: Optional[float] = None

    @property
    def latency(self) -> Optional[float]:
        """Enqueue -> verdict seconds (None until adjudicated)."""
        if self.t_verdict is None:
            return None
        return self.t_verdict - self.t_enqueue


@dataclasses.dataclass
class _OpenBin:
    rung: Rung
    items: List[Tuple[int, np.ndarray, np.ndarray]]  # (rid, s, h0)
    load: int = 0                     # total stripes parked here
    first_enqueue: float = 0.0


class StreamingEngine:
    """Continuous-traffic GCN serving with bounded step shapes and an
    explicit latency/backpressure contract.  See the module docstring for
    the architecture; the per-batch check/retry semantics are exactly
    ``launch/serve_gcn.py``'s (same :class:`PackedRunner`, same
    ``ABFTGuard`` ladder).

    Single-threaded and cooperative: ``submit`` packs and dispatches as
    bins fill, ``pump`` applies the flush deadline to a trickle stream,
    ``drain`` flushes everything and adjudicates the tail.  Completed
    verdicts are collected with ``take_results``.

    The engine owns a *backend degrade ladder* — level 0 is the configured
    backend (fused-network or fused-layer), falling back to the two-pass
    packed path and finally to the dense batched engine.  Three signals
    advance the ladder, each after draining the in-flight batch: (a) an
    unverifiable batch (the guard's persistent-fault escalation raised —
    the batch is re-dispatched on the fallback, so nothing is dropped),
    (b) eviction advice (``guard.suspect`` from sticky-site
    classification, or ``guard.should_evict()`` flag-rate), and (c) a
    ``StragglerWatchdog`` slow-streak around dispatch->adjudication
    (``watchdog=``), with ``hang_timeout=`` forcing adjudication of a
    wedged in-flight batch from ``pump``.  ``inject=`` is the level-0
    chaos hook (the kernel accumulator fault) — degraded levels are always
    built clean, which is what lets the ladder recover from a sticky
    backend fault.

    ``selfcheck_interval=`` adds a sampled-cadence check of the check
    path itself: every N dispatches the folded ``w_r`` operands are
    re-derived bitwise (:mod:`repro_torch.faults.selfcheck`) and a
    mismatch refolds them and discards every runner built on the stale
    fold.  ``checkpoint_dir=`` writes a checkpoint of the folded params at
    every degrade, before the ladder moves (:mod:`repro_torch.checkpoint`,
    the reference's layout; synchronous, the last three kept): its step is
    ``batches_dispatched`` and its ``extra`` the reason, the backend being
    left and its ladder level.

    ``params`` are moved to ``device``, which defaults to the GPU and
    raises when there is none (pass ``device="cpu"`` for the plain PyTorch
    versions of the kernels).
    """

    def __init__(self, params, cfg: ABFTConfig, rungs: RungTable, *,
                 guard: Optional[ABFTGuard] = None,
                 queue_capacity: int = 64,
                 flush_deadline: Optional[float] = None,
                 oversize_policy: str = "singleton",
                 block_g: Optional[int] = None,
                 fused_layer: bool = False,
                 fused_network: bool = False,
                 vmem_budget: Optional[int] = None,
                 granularity: str = "graph",
                 keep_logits: bool = True,
                 inject=None,
                 watchdog=None,
                 hang_timeout: Optional[float] = None,
                 checkpoint_dir: Optional[str] = None,
                 selfcheck_interval: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 device: DeviceLike = "cuda"):
        if oversize_policy not in ("singleton", "reject"):
            raise ValueError(f"oversize_policy {oversize_policy!r} not in "
                             f"('singleton', 'reject')")
        if granularity not in ("graph", "stripe", "slot"):
            raise ValueError(f"granularity {granularity!r} not in "
                             f"('graph', 'stripe', 'slot')")
        if queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")
        if hang_timeout is not None and hang_timeout <= 0:
            raise ValueError("hang_timeout must be > 0 (or None)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.rungs = rungs
        self.params = fold_w_r(params_to_device(params, device=self.device),
                               cfg)
        self.vmem_budget = vmem_budget
        self._block_g = rungs.block if block_g is None else block_g
        self._inject = inject
        # the backend degrade ladder: level 0 is the configured backend
        # (and the only level carrying the chaos inject hook); fusion
        # levels fall back to the two-pass packed path, which falls back
        # to the dense batched engine — the terminal, simplest backend.
        name0 = ("fused-network" if fused_network else
                 "fused-layer" if fused_layer else "two-pass")
        ladder = [{"name": name0, "fused_layer": fused_layer,
                   "fused_network": fused_network, "dense": False}]
        if fused_layer or fused_network:
            ladder.append({"name": "two-pass", "fused_layer": False,
                           "fused_network": False, "dense": False})
        ladder.append({"name": "dense", "fused_layer": False,
                       "fused_network": False, "dense": True})
        self._ladder = ladder
        self._degrade_level = 0
        self._level_runners: Dict[int, PackedRunner] = {}
        self._dense_step_fn = None
        self._dense_shapes: set = set()
        # shapes built by runners a self-check repair discarded: the
        # bounded-shapes accounting stays cumulative across rebuilds
        self._retired_compiles = 0
        self._selfcheck = None
        if selfcheck_interval is not None:
            from repro_torch.faults.selfcheck import CheckPathSelfCheck
            self._selfcheck = CheckPathSelfCheck(cfg,
                                                 interval=selfcheck_interval)
        self.guard = guard if guard is not None else ABFTGuard()
        self.watchdog = watchdog
        self.hang_timeout = hang_timeout
        self._ckpt = None
        if checkpoint_dir is not None:
            from repro_torch.checkpoint import CheckpointManager
            # synchronous writes: the save happens at the degrade moment,
            # where a half-written checkpoint racing the backend swap is
            # the last thing anyone wants
            self._ckpt = CheckpointManager(checkpoint_dir, keep=3,
                                           async_write=False)
        self.queue_capacity = queue_capacity
        self.flush_deadline = flush_deadline
        self.oversize_policy = oversize_policy
        self.granularity = granularity
        self.keep_logits = keep_logits
        self.clock = clock
        self._bins: Dict[Rung, _OpenBin] = {}
        # one in-flight batch, tagged by dispatch kind:
        #   {"kind": "packed", "runner", "pb", "args", "out", "metrics",
        #    "rids"}
        #   {"kind": "dense", "step", "batch", "args", "items", "out",
        #    "metrics", "rids"}
        self._inflight: Optional[Dict[str, Any]] = None
        self._inflight_t: Optional[float] = None
        self._results: Dict[int, RequestResult] = {}
        self._done: List[RequestResult] = []
        # adjudicated batches whose logits / max_rel are still device
        # tensors; copied to the host lazily in take_results (the stats
        # flush)
        self._pending_mat: List[Tuple[str, Any, Any, Any,
                                      List[Tuple[int, RequestResult]]]] = []
        self._next_rid = 0
        self.submitted = 0
        self.served = 0
        self.rejected = 0
        self.rejected_oversize = 0
        self.singleton_dispatches = 0
        self.batches_dispatched = 0
        self.fused_hits = 0
        self.fused_fallbacks = 0
        self.network_hits = 0
        self.network_fallbacks = 0
        self.degrades = 0
        self.failovers = 0
        self.dense_dispatches = 0
        self.hang_flushes = 0
        self.selfcheck_repairs = 0
        self._runner_for(0)           # eager level-0 runner (warmup path)

    # -- backend ladder ----------------------------------------------------

    @property
    def runner(self) -> PackedRunner:
        """The ACTIVE packed runner (the deepest packed level once the
        ladder has degraded all the way to dense)."""
        last_packed = len(self._ladder) - 2
        return self._runner_for(min(self._degrade_level, last_packed))

    def _runner_for(self, level: int) -> PackedRunner:
        spec = self._ladder[level]
        if spec["dense"]:
            raise ValueError("the dense ladder level has no packed runner")
        if level not in self._level_runners:
            self._level_runners[level] = PackedRunner(
                self.params, self.cfg, self._block_g,
                spec["fused_layer"], self.granularity,
                fused_network=spec["fused_network"],
                vmem_budget=self.vmem_budget,
                inject=self._inject if level == 0 else None,
                device=self.device)
        return self._level_runners[level]

    def _at_last_level(self) -> bool:
        return self._degrade_level >= len(self._ladder) - 1

    def _active_dense(self) -> bool:
        return self._ladder[self._degrade_level]["dense"]

    def _degrade(self, reason: str) -> None:
        """Swap to the next ladder level: checkpoint the folded params,
        advance, and reset the guard's per-backend state (its site
        classifications and rolling window describe the replaced execution
        path — lifetime counters stand)."""
        old = self._ladder[self._degrade_level]["name"]
        self._checkpoint(reason)
        self._degrade_level += 1
        self.degrades += 1
        self.guard.reset_backend_state()
        if self.watchdog is not None:
            # the streak judged the replaced backend; the fallback gets a
            # fresh verdict (the EWMA itself carries over: step-time scale
            # is a property of the workload more than the backend)
            self.watchdog.slow_streak = 0
        log.error("stream: degrading backend %s -> %s (%s); continuing "
                  "to serve", old,
                  self._ladder[self._degrade_level]["name"], reason)

    def _checkpoint(self, reason: str) -> None:
        if self._ckpt is None:
            return
        self._ckpt.save(self.batches_dispatched, self.params,
                        extra={"reason": reason,
                               "backend":
                                   self._ladder[self._degrade_level]["name"],
                               "degrade_level": self._degrade_level})

    def _failover(self, inf: Dict[str, Any], reason: str) -> None:
        """A batch the guard could not verify on this backend (persistent
        fault with the retry tiers and restore path exhausted): degrade
        and re-dispatch the SAME requests on the fallback, so the stream
        keeps serving with nothing dropped.  Raises only when the ladder
        is exhausted — the dense terminal backend failed too."""
        if self._at_last_level():
            raise RuntimeError(
                f"stream: backend ladder exhausted at "
                f"{self._ladder[-1]['name']!r} — {reason}")
        self.failovers += 1
        self._degrade(f"unverifiable batch: {reason}")
        now = self.clock()
        items = (list(inf["pb"].items) if inf["kind"] == "packed"
                 else inf["items"])
        rids = inf["rids"]
        if self._active_dense():
            self._dispatch_dense(items, rids, now)
        else:
            # packed operands are backend-independent: the same block-ELL
            # pack re-runs through the degraded level's kernels
            self._dispatch(inf["pb"], rids, now)

    # -- check-the-check ---------------------------------------------------

    def _maybe_selfcheck(self) -> None:
        """Sampled-cadence self-check of the checksum operands: re-derive
        every folded w_r bitwise; a mismatch means the CHECK path is
        corrupt (every verdict a lie), so refold and discard the runners
        that captured the stale fold."""
        if self._selfcheck is None:
            return
        bad = self._selfcheck.maybe_check(self.params,
                                          self.batches_dispatched)
        if bad:
            log.error("stream: check-path self-check tripped on layer(s) "
                      "%s — refolding w_r and rebuilding serve steps", bad)
            self.params = self._selfcheck.repair(self.params)
            self.selfcheck_repairs += 1
            self._rebuild_steps()

    def _rebuild_steps(self) -> None:
        """Discard every runner and the dense step after a params repair
        (each captured the params it was built with); the shape accounting
        stays cumulative so the bounded-shapes contract still reports
        honestly."""
        self._retired_compiles += (
            sum(r.compile_count for r in self._level_runners.values())
            + len(self._dense_shapes))
        self._level_runners = {}
        self._dense_step_fn = None
        self._dense_shapes = set()

    # -- intake ------------------------------------------------------------

    def warmup(self) -> int:
        """Run every rung's canonical shape once up front (a one-node empty
        graph padded to the rung) so the first real batches do not pay the
        kernel build and first-launch costs inside their measured latency.
        Returns the step-shape count afterwards."""
        feat = self.params["layers"][0]["w"].shape[0]
        probe = (np.zeros((1, 1), np.float32), np.zeros((1, feat),
                                                        np.float32))
        for r in self.rungs.rungs:
            pb = pack_graphs([probe], block=self.rungs.block,
                             n_slots=r.n_slots,
                             stripe_multiple=self.rungs.stripe_multiple,
                             width_multiple=self.rungs.width_multiple,
                             stripe_cap=r.stripe_cap, width_cap=r.width_cap)
            runner = self.runner
            _out, metrics = runner.step_for(pb)(*runner.args_for(pb))
            _host(metrics["abft_graph_flags"])   # warmup is the sync
        return self.compile_count

    def submit(self, s: np.ndarray, h0: np.ndarray, *,
               now: Optional[float] = None) -> int:
        """Enqueue one request; returns its request id.

        Backpressure and oversize rejections resolve *immediately* (the
        result is already in ``take_results`` when submit returns);
        admitted requests resolve when their batch is adjudicated.
        ``now`` overrides the clock (deterministic deadline tests).
        """
        now = self.clock() if now is None else now
        self._sweep_deadlines(now)
        rid = self._next_rid
        self._next_rid += 1
        self.submitted += 1
        res = RequestResult(rid=rid, status="served", t_enqueue=now)
        self._results[rid] = res
        s = np.asarray(s)
        h0 = np.asarray(h0)
        stripes, width = graph_pack_stats(s, self.rungs.block)
        rung = self.rungs.fit(stripes, width)
        if rung is None:
            self._take_oversized(rid, s, h0, stripes, width, now)
            return rid
        if self._queued() >= self.queue_capacity:
            self._finish_rejected(
                res, "rejected",
                f"queue full ({self.queue_capacity} requests parked)", now)
            self.rejected += 1
            return rid
        b = self._bins.get(rung)
        if b is not None and (len(b.items) >= rung.n_slots
                              or b.load + stripes > rung.stripe_cap):
            self._seal(rung, now)
            b = None
        if b is None:
            b = _OpenBin(rung=rung, items=[], first_enqueue=now)
            self._bins[rung] = b
        b.items.append((rid, s, h0))
        b.load += stripes
        if len(b.items) >= rung.n_slots or b.load >= rung.stripe_cap:
            self._seal(rung, now)
        return rid

    def pump(self, now: Optional[float] = None) -> None:
        """Advance time-driven work: flush bins past the deadline, and
        force adjudication of an in-flight batch that has been pending
        past ``hang_timeout`` (a hung dispatch must resolve — blocking on
        the device sync surfaces the wedge to the guard/watchdog instead
        of letting the stream silently stall behind it).  Call
        periodically on a trickle stream (``serve_stream`` calls it between
        arrivals)."""
        now = self.clock() if now is None else now
        if (self.hang_timeout is not None and self._inflight is not None
                and self._inflight_t is not None
                and now - self._inflight_t >= self.hang_timeout):
            self.hang_flushes += 1
            log.warning("stream: in-flight batch pending > hang_timeout="
                        "%.3fs; forcing adjudication", self.hang_timeout)
            self._resolve_inflight()
        self._sweep_deadlines(now)

    def drain(self, now: Optional[float] = None) -> List[RequestResult]:
        """Seal every open bin, adjudicate everything in flight, and return
        ALL completed results collected since the last ``take_results``."""
        now = self.clock() if now is None else now
        for rung in list(self._bins):
            self._seal(rung, now)
        self._drain_inflight()
        return self.take_results()

    def take_results(self) -> List[RequestResult]:
        """Completed verdicts since the last call (rid order)."""
        self._materialize_pending()
        done, self._done = self._done, []
        return sorted(done, key=lambda r: r.rid)

    # -- internals ---------------------------------------------------------

    def _queued(self) -> int:
        return sum(len(b.items) for b in self._bins.values())

    def _finish_rejected(self, res: RequestResult, status: str, reason: str,
                         now: float) -> None:
        res.status = status
        res.reason = reason
        res.t_verdict = now
        self._done.append(self._results.pop(res.rid))

    def _take_oversized(self, rid: int, s, h0, stripes: int, width: int,
                        now: float) -> None:
        res = self._results[rid]
        if self.oversize_policy == "reject":
            self._finish_rejected(
                res, "rejected_oversize",
                f"graph needs {stripes} stripes / width {width}; largest "
                f"rung is {self.rungs.rungs[-1]}", now)
            self.rejected_oversize += 1
            return
        if self._active_dense():
            # degraded to the terminal backend: the dense engine has no
            # rung limit, just its own power-of-two bucket ladder
            self.singleton_dispatches += 1
            self._dispatch_dense([(s, h0)], [rid], now)
            return
        # dedicated singleton shape: power-of-two quantized so repeat
        # offenders share step shapes; the request still runs fully checked
        sq, wq = self.rungs.stripe_multiple, self.rungs.width_multiple
        pb = pack_graphs([(s, h0)], block=self.rungs.block, n_slots=1,
                         stripe_multiple=sq, width_multiple=wq,
                         stripe_cap=sq * next_pow2(-(-stripes // sq)),
                         width_cap=wq * next_pow2(-(-width // wq)),
                         indices=[rid])
        self.singleton_dispatches += 1
        self._dispatch(pb, [rid], now)

    def _sweep_deadlines(self, now: float) -> None:
        if self.flush_deadline is None:
            return
        for rung, b in list(self._bins.items()):
            if b.items and now - b.first_enqueue >= self.flush_deadline:
                self._seal(rung, now)

    def _seal(self, rung: Rung, now: float) -> None:
        b = self._bins.pop(rung, None)
        if b is None or not b.items:
            return
        # pack on the host FIRST (overlaps the in-flight batch's device
        # execution), then adjudicate the previous batch, then dispatch
        rids = [rid for rid, _, _ in b.items]
        items = [(s, h0) for _, s, h0 in b.items]
        if self._active_dense():
            self._dispatch_dense(items, rids, now)
            return
        pb = pack_graphs(items,
                         block=self.rungs.block, n_slots=rung.n_slots,
                         stripe_multiple=self.rungs.stripe_multiple,
                         width_multiple=self.rungs.width_multiple,
                         stripe_cap=rung.stripe_cap,
                         width_cap=rung.width_cap, indices=rids)
        self._dispatch(pb, rids, now)

    def _drain_inflight(self) -> None:
        """Resolve the in-flight batch AND any batch a failover re-
        dispatched in its place, until the line is clear: a dispatcher
        about to install its own in-flight entry must never clobber an
        unresolved one (the re-dispatched batch would silently never be
        adjudicated and its requests would hang)."""
        while self._inflight is not None:
            self._resolve_inflight()

    def _dispatch(self, pb: PackedGraphs, rids: List[int],
                  now: float) -> None:
        self._drain_inflight()
        if self._active_dense():
            # the resolution above degraded the ladder to its terminal
            # level mid-seal; this batch must follow, not run packed on
            # the replaced backend
            self._dispatch_dense(list(pb.items), rids, now)
            return
        self._maybe_selfcheck()
        runner = self.runner
        step = runner.step_for(pb)
        args = runner.args_for(pb)
        out, metrics = step(*args)        # enqueued; no host sync
        t = self.clock()
        for rid in rids:
            self._results[rid].t_dispatch = t
        self.batches_dispatched += 1
        for key, n in runner.fusion_counts(pb).items():
            setattr(self, key, getattr(self, key) + n)
        self._inflight = {"kind": "packed", "runner": runner, "pb": pb,
                          "args": args, "out": out, "metrics": metrics,
                          "rids": rids}
        self._inflight_t = t
        if self.watchdog is not None:
            self.watchdog.start()

    def _dispatch_dense(self, items: List[Tuple[np.ndarray, np.ndarray]],
                        rids: List[int], now: float) -> None:
        """Terminal ladder level: serve a bin through the dense batched
        engine.  Slot count and node bucket quantize up the power-of-two
        ladder so repeat shapes share steps; pad slots are all-zero
        graphs, which contribute 0 = 0 to every check and can never
        flag."""
        self._drain_inflight()
        self._maybe_selfcheck()
        k = len(items)
        pad = next_pow2(k)
        bucket = next_pow2(max(s.shape[0] for s, _ in items))
        feat = items[0][1].shape[1]
        dt = np.result_type(*[s.dtype for s, _ in items])
        sub_s = np.zeros((pad, bucket, bucket), dt)
        sub_h = np.zeros((pad, bucket, feat),
                         np.result_type(*[h.dtype for _, h in items]))
        n_nodes = np.zeros(pad, np.int64)
        for i, (s, h0) in enumerate(items):
            n = s.shape[0]
            sub_s[i, :n, :n] = s
            sub_h[i, :n] = h0
            n_nodes[i] = n
        b = GraphBatch(s=sub_s, h0=sub_h, n_nodes=n_nodes, bucket=bucket,
                       indices=np.array(rids + [-1] * (pad - k)))
        if self._dense_step_fn is None:
            self._dense_step_fn = make_serve_step(self.params, self.cfg,
                                                  device=self.device)
        self._dense_shapes.add((pad, bucket, feat))
        step = self._dense_step_fn
        args = (torch.from_numpy(b.s).to(self.device),
                torch.from_numpy(b.h0).to(self.device))
        out, metrics = step(*args)
        t = self.clock()
        for rid in rids:
            self._results[rid].t_dispatch = t
        self.batches_dispatched += 1
        self.dense_dispatches += 1
        self._inflight = {"kind": "dense", "step": step, "batch": b,
                          "args": args, "items": list(items), "out": out,
                          "metrics": metrics, "rids": rids}
        self._inflight_t = t
        if self.watchdog is not None:
            self.watchdog.start()

    def _resolve_inflight(self) -> None:
        if self._inflight is None:
            return
        inf = self._inflight
        self._inflight = None
        self._inflight_t = None
        rids = inf["rids"]
        try:
            if inf["kind"] == "packed":
                runner, pb = inf["runner"], inf["pb"]
                stripe_retry = (runner.stripe_retry_fn(pb)
                                if self.granularity in ("stripe", "slot")
                                else None)
                slot_retry = (runner.slot_retry_fn(pb)
                              if self.granularity == "slot" else None)
                out, metrics = self.guard.adjudicate(
                    inf["out"], inf["metrics"], runner.retry_fn(pb),
                    stripe_retry_fn=stripe_retry,
                    slot_retry_fn=slot_retry,
                    replay=(runner.step_for(pb), inf["args"]))
            else:
                step, b = inf["step"], inf["batch"]
                out, metrics = self.guard.adjudicate(
                    inf["out"], inf["metrics"],
                    dense_retry_fn(step, b, self.device),
                    replay=(step, inf["args"]))
        except UnverifiableBatch as err:
            # the guard refused to adopt this batch on this backend
            # (persistent fault, restore path exhausted or absent):
            # degrade the ladder and re-dispatch the same requests there.
            # A kernel that fails to build or launch inside a repair raises
            # its own error and reaches the caller: it is no verdict on
            # the batch, and no reason to serve on plainer kernels
            if self.watchdog is not None:
                self.watchdog.stop()
            self._failover(inf, str(err))
            return
        slow_streak = False
        if self.watchdog is not None:
            self.watchdog.stop()
            slow_streak = self.watchdog.should_reshard()
        t = self.clock()
        # the verdict itself costs one bounded host read per batch: the
        # guard just adjudicated on these same graph flags
        gflags = _host(metrics["abft_graph_flags"], dtype=bool)
        batch: List[Tuple[int, RequestResult]] = []
        for k, rid in enumerate(rids):
            res = self._results.pop(rid)
            res.status = "served"
            res.flag = bool(gflags[k])  # abftlint: sync-ok (host array, verdict read)
            res.t_verdict = t
            batch.append((k, res))
            self._done.append(res)
            self.served += 1
        # logits and per-request max_rel are NOT read here: copying them
        # per request would block the dispatch loop on a device transfer
        # mid-stream.  They stay on the device until the caller collects
        # results (take_results).
        payload = inf["pb"] if inf["kind"] == "packed" else inf["batch"]
        self._pending_mat.append((inf["kind"], out,
                                  metrics.get("abft_graph_max_rel"),
                                  payload, batch))
        # eviction advice: a suspect guard (persistent site classified),
        # an over-threshold rolling flag rate, or a straggling-dispatch
        # streak all advise swapping this backend.  The in-flight batch
        # just drained, so degrade NOW and keep serving on the fallback.
        advice = []
        if self.guard.suspect:
            advice.append("guard suspect (persistent site classified)")
        elif self.guard.should_evict():
            advice.append("guard flag rate over evict threshold")
        if slow_streak:
            advice.append("watchdog slow-dispatch streak")
        if advice and not self._at_last_level():
            self._degrade("eviction advice: " + "; ".join(advice))

    def _materialize_pending(self) -> None:
        """The deferred device->host flush: one bulk transfer per
        adjudicated batch instead of per-request reads in the dispatch
        loop."""
        for kind, out, grel, payload, batch in self._pending_mat:
            out_np = _host(out) if self.keep_logits else None
            n_slots = (payload.n_slots if kind == "packed"
                       else payload.s.shape[0])
            grel_np = (np.zeros(n_slots, np.float32) if grel is None
                       else _host(grel, dtype=np.float32))
            for k, res in batch:
                res.max_rel = float(grel_np[k])  # abftlint: sync-ok (host array, stats flush)
                if out_np is None:
                    continue
                if kind == "packed":
                    o, n = payload.row_offsets[k], payload.n_nodes[k]
                    res.logits = out_np[o:o + n].copy()
                else:
                    res.logits = out_np[k, :payload.n_nodes[k]].copy()
        self._pending_mat = []

    # -- accounting --------------------------------------------------------

    @property
    def compile_count(self) -> int:
        """Distinct step shapes built so far, summed over every ladder
        level's runner plus the dense fallback's shape set — the
        bounded-shapes contract compares this against ``len(self.rungs)``
        (+ the O(log) singleton/retry/degrade ladder shapes when those
        paths fired).  The name is the JAX package's, where each shape cost
        one compile."""
        return (self._retired_compiles
                + sum(r.compile_count for r in self._level_runners.values())
                + len(self._dense_shapes))

    def stats(self, results: Optional[Sequence[RequestResult]] = None
              ) -> Dict[str, Any]:
        """Latency/throughput SLO summary over ``results`` (or everything
        completed-and-not-yet-taken — pass the collected results for a
        whole-run view)."""
        rs = list(results) if results is not None else list(self._done)
        lat = np.asarray([r.latency for r in rs
                          if r.status == "served" and r.latency is not None])
        served = [r for r in rs if r.status == "served"]
        span = ((max(r.t_verdict for r in served)
                 - min(r.t_enqueue for r in served))
                if served else 0.0)
        return {
            "submitted": self.submitted,
            "served": len(served),
            "rejected": sum(r.status == "rejected" for r in rs),
            "rejected_oversize": sum(r.status == "rejected_oversize"
                                     for r in rs),
            "flagged": sum(bool(r.flag) for r in served),
            "batches": self.batches_dispatched,
            "singleton_dispatches": self.singleton_dispatches,
            "compiles": self.compile_count,
            "rung_table_size": len(self.rungs),
            "latency_p50_ms": float(np.percentile(lat, 50) * 1e3)
            if lat.size else None,
            "latency_p99_ms": float(np.percentile(lat, 99) * 1e3)
            if lat.size else None,
            "latency_max_ms": float(lat.max() * 1e3) if lat.size else None,
            "graphs_per_sec": len(served) / span if span > 0 else None,
            "guard_flags": self.guard.flags,
            "guard_retries": self.guard.retries,
            "fused_hits": self.fused_hits,
            "fused_fallbacks": self.fused_fallbacks,
            "network_hits": self.network_hits,
            "network_fallbacks": self.network_fallbacks,
            "repair_tiers": self.guard.repair_tiers(),
            "backend_ladder": [lv["name"] for lv in self._ladder],
            "active_backend": self._ladder[self._degrade_level]["name"],
            "degrade_level": self._degrade_level,
            "degrades": self.degrades,
            "failovers": self.failovers,
            "dense_dispatches": self.dense_dispatches,
            "hang_flushes": self.hang_flushes,
            "watchdog_events": (self.watchdog.events
                                if self.watchdog is not None else 0),
            "selfcheck_runs": (self._selfcheck.checks_run
                               if self._selfcheck is not None else 0),
            "selfcheck_trips": (self._selfcheck.trips
                                if self._selfcheck is not None else 0),
            "selfcheck_repairs": self.selfcheck_repairs,
        }
