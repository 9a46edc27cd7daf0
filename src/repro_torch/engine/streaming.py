"""The serving steps and the per-shape packed runner with its retry ladder.

Counterpart of the step/runner half of the JAX package's
``repro/engine/streaming.py`` — the machinery the closed-batch server
(``launch/serve_gcn.py``) is a thin client of.  The continuous-traffic half
of that module (canonical rung tables, the request queue, online packing,
double-buffered dispatch) is not ported yet.

There is no ``jit`` here: PyTorch runs eagerly, so a "step" is a plain
closure.  :class:`PackedRunner` still keeps one step per distinct packed
shape, so ``compile_count`` goes on meaning "distinct shapes this runner has
served" and the power-of-two retry ladder keeps its bounded-shapes contract.
"""
from __future__ import annotations

import logging
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.abft import ABFTConfig, per_graph_report, \
    per_slot_report, per_stripe_report, summarize
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine.api import Graph, gcn_forward
from repro_torch.engine.backends import BlockEllBackend
from repro_torch.engine.batching import GraphBatch, PackedGraphs, \
    graph_pack_stats, pack_graphs
from repro_torch.kernels.gcn_fused.ops import FUSED_SMEM_BUDGET, \
    fused_layer_fits, fused_network_fits

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
    step runs on the device its arguments lie on.  ``fused_layer=True`` runs
    each layer through the single-pass gcn_fused kernel (combination +
    aggregation + check in one sweep) instead of the two-pass
    combination-then-spmm path.

    ``granularity="stripe"`` keeps the per-row-stripe corners: the metrics
    gain ``abft_stripe_flags`` / ``abft_stripe_max_rel`` ([checks,
    n_stripes] verdicts, the per-graph vector now segment-reduced from
    them), ``abft_h_layers`` (every layer's input activations), and
    ``abft_x_layers`` (two-pass layers' combination outputs) — the operands
    a surgical repair needs.  ``granularity="slot"`` refines to
    per-(stripe, ell-slot) telescope corners on the fused kernel path,
    adding ``abft_slot_flags`` / ``abft_slot_max_rel`` ([checks, n_stripes,
    width]); two-pass fallback layers degrade to stripe corners and
    contribute all-False slot slabs.  ``inject`` is the benchmark/CI
    accumulator fault hook, ``(layer, stripe, slot, delta)``, honoured by
    both kernels.
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
        if fused_network:
            raise NotImplementedError(
                "fused_network=True needs the whole-network kernel, which "
                "is not ported yet — ROADMAP B3 (slice 2); use "
                "fused_layer=True")
        self.params, self.cfg = params, cfg
        self.device = resolve_device(device)
        self.block_g = block_g
        self.fused_layer = fused_layer
        self.fused_network = False
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
            if self.fused_layer:
                self._warn_fallbacks(pb)
            self._steps[key] = make_packed_serve_step(
                self.params, self.cfg, pb.n_slots, block_g=self.block_g,
                fused_layer=self.fused_layer,
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
        evaluated layer by layer.  (The whole-network tier cannot be switched
        on yet, so its two counts stay 0.)"""
        counts = {"fused_hits": 0, "fused_fallbacks": 0,
                  "network_hits": 0, "network_fallbacks": 0}
        if self.cfg.mode == "split":
            return counts
        nbm, _w, bm, bk = pb.bell.values.shape
        if self.fused_network:
            if bm == bk and fused_network_fits(self._network_dims(), bm,
                                               nbm * bm,
                                               block_g=self.block_g,
                                               budget=self._budget()):
                counts["network_hits"] = 1
                return counts
            counts["network_fallbacks"] = 1
        if self.fused_layer:
            for layer in self.params["layers"]:
                if fused_layer_fits(*layer["w"].shape, bm, bk,
                                    block_g=self.block_g,
                                    budget=self._budget()):
                    counts["fused_hits"] += 1
                else:
                    counts["fused_fallbacks"] += 1
        return counts

    def _warn_fallbacks(self, pb: PackedGraphs):
        """The shared-memory-budget decision happens inside the step, where
        it is invisible to the operator — so surface it once per packed
        shape, from the layer widths we already know."""
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
                o, n = int(pb.row_offsets[gi]), int(pb.n_nodes[gi])
                so, sn = int(sub.row_offsets[j]), int(sub.n_nodes[j])
                out[o:o + n] = sub_logits[so:so + sn]
            return out, sub_metrics
        return retry

    def stripe_retry_fn(self, pb: PackedGraphs):
        """Surgical tier (re-execute only the flagged stripes' rows): needs
        the localization module, which is not ported yet."""
        raise NotImplementedError(
            "the stripe-surgical retry needs engine/localize.py, which is "
            "not ported yet — ROADMAP A7 (slice 2); serve with "
            "granularity='graph'")

    def slot_retry_fn(self, pb: PackedGraphs):
        """Finest surgical tier: needs the localization module, which is not
        ported yet."""
        raise NotImplementedError(
            "the slot-surgical retry needs engine/localize.py, which is "
            "not ported yet — ROADMAP A7 (slice 2); serve with "
            "granularity='graph'")


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
