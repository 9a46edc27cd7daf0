"""Chaos-campaign driver: sweep fault models across sites x kinds and
measure what the eq. 4-6 checks actually catch.

The port's counterpart of the JAX package's ``repro/faults/campaign.py``:
the same experiments, classifications, aggregates and payload keys, run on
the port's kernels.  Each experiment runs one
:class:`~repro_torch.faults.model.FaultModel` against a deterministic
synthetic serving workload and classifies every step:

* **detected**      — data-path corruption active AND the online check
  flagged (true positive); detection latency is steps from first firing
  to first flag.
* **sdc**           — data-path corruption active, outputs diverged from
  the clean reference, NO flag: a silent data corruption (the measured
  false-negative class — ``features``/``cols_table`` corrupt both sides
  of the check consistently, so ABFT is architecturally blind there and
  the campaign *measures* rather than asserts).
* **masked**        — corruption fired but the outputs match the clean
  reference bitwise (the flip landed somewhere the forward never used).
* **false_positive** — flag with clean data.  Finite check-path
  corruption (``w_r``/``s_c``) lands here by construction: the data path
  is untouched, every verdict is a lie.  The periodic self-check
  (:mod:`repro_torch.faults.selfcheck`) is the defense, and the campaign
  records its detections separately.
* **would-be false negative** — check-path corruption where the NAIVE
  comparison (``d > tau``: False for NaN) reports clean.  The shipped
  NaN-safe comparison (``~(d <= tau*scale)``) flags it, and the
  self-check catches the corruption at its root; the campaign reports
  the naive verdict recomputed host-side so the report shows what a
  naive implementation would have silently missed.

Every flagged step is also adjudicated through a real
:class:`~repro_torch.runtime.ABFTGuard` so the campaign reports the
repair-tier distribution (slot/stripe/graph/restore + persistent-site
escalations): retries re-read CLEAN operands for transient kinds and the
CORRUPTED operands for sticky kinds — a stuck-at cell re-corrupts every
re-execution, which is exactly what drives the guard's persistent
classification and the streaming engine's backend degrade.  An
escalation is the guard's :class:`~repro_torch.runtime.UnverifiableBatch`
and nothing else: any other error (a kernel that fails to build or
launch) reaches the caller.

The GCN lane's packed block-ELL two-pass path serves every site except
``s_c`` (a dense-path operand, served by per-graph dense forwards): on the
card each packed forward launches ``spmm_abft`` per layer, the accumulator
site through its ``inject=`` hook.  The clean packed batch is staged on
the device once; a site that corrupts a packed operand (``features`` ->
h0, ``cols_table`` -> the column table) corrupts a clone of that one
staged tensor.  The LM lane serves guarded prefill and decode steps, every
dense product on ``matmul_abft`` and the prefill attention on
``flash_checksum``.

Every entry point takes ``device=`` (default ``"cuda"``, which raises
without a GPU; ``device="cpu"`` runs the kernels' plain versions).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.abft import ABFTConfig, per_graph_report, summarize
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.faults.injectors import FaultInjector
from repro_torch.faults.model import (
    CHECK_PATH_SITES,
    FaultModel,
    lm_sweep_models,
    sweep_models,
)
from repro_torch.faults.selfcheck import verify_s_c, verify_w_r
from repro_torch.runtime import ABFTGuard, GuardConfig, UnverifiableBatch


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _stamp(dev: torch.device) -> Dict[str, Any]:
    """The payload's device stamp: the card's name, and whether its
    numbers come from the kernels (``authoritative``) or from their plain
    versions on the CPU (the counterpart of the reference's interpret
    mode)."""
    on_card = dev.type == "cuda"
    return {"backend": (torch.cuda.get_device_name(dev) if on_card
                        else "cpu"),
            "device": str(dev), "interpret": not on_card,
            "authoritative": on_card}


def _default_guard() -> GuardConfig:
    return GuardConfig(max_retries=1, max_restores=1, persistent_window=4,
                       persistent_threshold=2)


# ---------------------------------------------------------------------------
# eager forwards
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Staged:
    """The clean packed batch on the device, staged once per campaign."""

    pb: Any
    cols: torch.Tensor
    vals: torch.Tensor
    segments: torch.Tensor
    h0: torch.Tensor


def _packed_forward(params, cfg: ABFTConfig, st: _Staged, *, block_g: int,
                    inject=None, cols=None, h0=None, checks_out=None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One eager packed step: (logits, per-graph flags, per-graph max_rel).
    ``cols``/``h0`` override the staged operands (the features/cols_table
    corruption surface); ``inject`` is the kernel accumulator hook.  A
    ``checks_out`` list receives the step's per-layer checks."""
    from repro_torch.engine.api import Graph, gcn_forward
    from repro_torch.engine.backends import BlockEllBackend

    cols = st.cols if cols is None else cols
    h0 = st.h0 if h0 is None else h0
    bk = BlockEllBackend.from_staged(cols, st.vals, st.segments,
                                     st.pb.n_slots, cfg, block_g=block_g,
                                     inject=inject)
    logits, checks = gcn_forward(params, Graph(s=None, h0=h0), cfg,
                                 backend=bk)
    if checks_out is not None:
        checks_out.extend(checks)
    gflags, grel = per_graph_report(checks, cfg, st.pb.n_slots)
    return _np(logits), _np(gflags).astype(bool), \
        _np(grel).astype(np.float32)


def _dense_forward(params, cfg: ABFTConfig, graphs
                   ) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
    """Per-graph eager dense forwards over prebuilt Graph objects (the
    ``s_c`` site's path — the corruption lives on the Graph itself)."""
    from repro_torch.engine.api import gcn_forward

    outs, flags, rels = [], [], []
    for g in graphs:
        dev = g.s.device
        logits, checks = gcn_forward(params, g, cfg, backend="dense",
                                     device=dev)
        rep = summarize(checks, cfg, device=dev)
        outs.append(_np(logits))
        flags.append(bool(rep.flag))  # abftlint: sync-ok (eager campaign harness)
        rels.append(float(rep.max_rel))  # abftlint: sync-ok (eager campaign harness)
    return outs, np.array(flags), np.array(rels, np.float32)


def _make_dense_graphs(staged_items, cfg: ABFTConfig):
    """Graphs with an explicit (honest) staged s_c over the already-staged
    dense operands — the injector needs a stash to corrupt, and an
    explicit stash is trusted verbatim by the engine, which is exactly why
    the self-check must re-derive it."""
    from repro_torch.core.checksum import col_checksum
    from repro_torch.engine.api import Graph

    return [Graph(s=s, h0=h0, s_c=col_checksum(s, cfg.dtype))
            for s, h0 in staged_items]


# ---------------------------------------------------------------------------
# one experiment
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ExperimentResult:
    """Per-fault-model outcome record (JSON-ready via ``to_dict``)."""

    model: FaultModel
    steps: int
    fired_steps: List[int]
    flagged_steps: List[int]
    naive_flagged_steps: List[int]      # the would-be d > tau verdicts
    detected: bool
    detection_latency: Optional[int]
    sdc_steps: List[int]
    masked_steps: List[int]
    false_positive_steps: List[int]
    selfcheck_detected: bool
    selfcheck_step: Optional[int]
    would_be_false_negative: bool
    escalated: bool                     # guard refused to verify (evict)
    repair_tiers: Dict[str, Any]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["model"] = self.model.to_dict()
        d["label"] = self.model.label()
        return d


def _adjudicate(guard: ABFTGuard, out, gflags, grel, pb, rerun) -> bool:
    """Run one flagged step through the guard's repair ladder.  ``rerun``
    re-executes the batch (with corrupted operands for sticky kinds,
    clean for transient) and the retry patches only the flagged graphs'
    rows — the campaign's repair-tier distribution comes from these
    adjudications.  Returns True when the guard escalated (raised
    :class:`UnverifiableBatch`): eviction/degrade advice for the serving
    layer."""
    def retry(out, idx):
        logits2, gflags2, grel2 = rerun()
        out = np.asarray(out).copy()
        for gi in idx:
            o, n = pb.row_offsets[gi], pb.n_nodes[gi]
            out[o:o + n] = logits2[o:o + n]
        return out, {"abft_graph_flags": gflags2[idx],
                     "abft_graph_max_rel": grel2[idx]}

    metrics = {"abft_flag": bool(gflags.any()),
               "abft_max_rel": float(np.nanmax(grel, initial=0.0)),
               "abft_graph_flags": gflags, "abft_graph_max_rel": grel}
    try:
        guard.adjudicate(out, metrics, retry)
        return False
    except UnverifiableBatch:
        return True


def _adjudicate_dense(guard: ABFTGuard, outs, flags, rels, rerun) -> bool:
    """Dense-path analog of :func:`_adjudicate` (per-graph verdicts)."""
    def retry(out, idx):
        outs2, flags2, rels2 = rerun()
        return out, {"abft_graph_flags": flags2[idx],
                     "abft_graph_max_rel": rels2[idx]}

    metrics = {"abft_flag": bool(flags.any()),
               "abft_max_rel": float(np.nanmax(rels, initial=0.0)),
               "abft_graph_flags": flags, "abft_graph_max_rel": rels}
    try:
        guard.adjudicate(outs, metrics, retry)
        return False
    except UnverifiableBatch:
        return True


def run_experiment(model: FaultModel, *, params, cfg: ABFTConfig, staged,
                   dense_items, ref_packed, ref_dense, block_g: int,
                   n_steps: int, guard_cfg: Optional[GuardConfig] = None
                   ) -> ExperimentResult:
    """Run one fault model for ``n_steps`` serving steps and classify.

    ``staged`` is the clean packed batch on the device (as
    :func:`run_fault_campaign` stages it), ``dense_items`` the per-graph
    dense (S, H0) tensors of the ``s_c`` site (``None`` when no model
    needs them); ``ref_packed`` / ``ref_dense`` the clean forwards."""
    inj = FaultInjector(model)
    guard = ABFTGuard(guard_cfg if guard_cfg is not None
                      else _default_guard())
    dense_site = model.site == "s_c"
    fired_steps: List[int] = []
    flagged_steps: List[int] = []
    naive_steps: List[int] = []
    sdc_steps: List[int] = []
    masked_steps: List[int] = []
    fp_steps: List[int] = []
    selfcheck_step: Optional[int] = None
    escalations = 0

    ref_logits = ref_dense[0] if dense_site else ref_packed[0]

    for t in range(n_steps):
        fired = inj.fires(t)
        if fired:
            fired_steps.append(t)
        if dense_site:
            graphs = _make_dense_graphs(dense_items, cfg)
            if fired:
                # the fault hits one graph's staged checksum; graph 0 is
                # the deterministic target
                inj.apply_graph(graphs[0])
            outs, gflags, grel = _dense_forward(params, cfg, graphs)
            diverged = any(
                not np.array_equal(a, b) for a, b in zip(outs, ref_logits))
            if fired and selfcheck_step is None \
                    and verify_s_c(graphs[0], cfg):
                selfcheck_step = t
            rerun = (lambda: _dense_forward(params, cfg, graphs)) \
                if model.sticky else \
                (lambda: _dense_forward(params, cfg,
                                        _make_dense_graphs(dense_items,
                                                           cfg)))
        else:
            p_t, cols_t, h0_t, inject_t = params, None, None, None
            if fired:
                p_t = inj.apply_params(params)
                if model.site in ("features", "cols_table"):
                    cols_t, _vals, h0_t = inj.apply_batch(
                        staged.cols, staged.vals, staged.h0)
                if model.site != "features":
                    h0_t = None
                if model.site != "cols_table":
                    cols_t = None
                inject_t = inj.kernel_inject()
            outs, gflags, grel = _packed_forward(
                p_t, cfg, staged, block_g=block_g, inject=inject_t,
                cols=cols_t, h0=h0_t)
            diverged = not np.array_equal(outs, ref_logits)
            if fired and selfcheck_step is None and verify_w_r(p_t, cfg):
                selfcheck_step = t
            if model.sticky:
                rerun = (lambda: _packed_forward(
                    p_t, cfg, staged, block_g=block_g, inject=inject_t,
                    cols=cols_t, h0=h0_t))
            else:
                rerun = (lambda: _packed_forward(params, cfg, staged,
                                                 block_g=block_g))

        flagged = bool(gflags.any())  # abftlint: sync-ok (eager campaign harness)
        with np.errstate(invalid="ignore"):
            # the naive d > tau comparison, recomputed host-side: NaN
            # compares False, which is precisely the would-be silent
            # false negative the NaN-safe check closes
            naive = bool((grel > cfg.threshold).any())  # abftlint: sync-ok (host numpy)
        if flagged:
            flagged_steps.append(t)
        if naive:
            naive_steps.append(t)
        data_corrupt = fired and model.site not in CHECK_PATH_SITES
        if data_corrupt and not flagged:
            (sdc_steps if diverged else masked_steps).append(t)
        if not data_corrupt and flagged:
            fp_steps.append(t)
        if flagged:
            # adjudicate EVERY flagged step (a real serving layer degrades
            # after the first escalation; the campaign keeps going so a
            # sticky site recurs and the guard's persistent classification
            # is exercised and reported)
            if dense_site:
                escalations += _adjudicate_dense(guard, outs, gflags, grel,
                                                 rerun)
            else:
                escalations += _adjudicate(guard, outs, gflags, grel,
                                           staged.pb, rerun)

    detected_steps = [t for t in flagged_steps if t in fired_steps] \
        if model.site not in CHECK_PATH_SITES else flagged_steps
    detected = bool(detected_steps)
    latency = (detected_steps[0] - fired_steps[0]
               if detected and fired_steps else None)
    selfcheck_detected = selfcheck_step is not None
    would_be_fn = (model.check_path and bool(fired_steps)
                   and not naive_steps
                   and (detected or selfcheck_detected))
    return ExperimentResult(
        model=model, steps=n_steps, fired_steps=fired_steps,
        flagged_steps=flagged_steps, naive_flagged_steps=naive_steps,
        detected=detected, detection_latency=latency,
        sdc_steps=sdc_steps, masked_steps=masked_steps,
        false_positive_steps=fp_steps,
        selfcheck_detected=selfcheck_detected,
        selfcheck_step=selfcheck_step,
        would_be_false_negative=would_be_fn,
        escalated=escalations > 0,
        repair_tiers=guard.repair_tiers())


# ---------------------------------------------------------------------------
# the campaign
# ---------------------------------------------------------------------------

def _aggregate(experiments: List[ExperimentResult]) -> Dict[str, dict]:
    """Per-(site, kind) rates over the experiment grid."""
    groups: Dict[str, List[ExperimentResult]] = {}
    for e in experiments:
        groups.setdefault(f"{e.model.site}/{e.model.kind}", []).append(e)
    out = {}
    for key, es in sorted(groups.items()):
        n = len(es)
        lat = [e.detection_latency for e in es
               if e.detection_latency is not None]
        clean_steps = sum(
            e.steps - len(set(e.fired_steps)
                          if e.model.site not in CHECK_PATH_SITES
                          else set()) for e in es)
        fp_steps = sum(len(e.false_positive_steps) for e in es)
        out[key] = {
            "n": n,
            "detection_rate": sum(e.detected for e in es) / n,
            "sdc_rate": sum(bool(e.sdc_steps) for e in es) / n,  # abftlint: sync-ok (host lists)
            "masked_rate": sum(bool(e.masked_steps) for e in es) / n,  # abftlint: sync-ok (host lists)
            "false_positive_step_rate":
                fp_steps / clean_steps if clean_steps else 0.0,
            "mean_detection_latency":
                (sum(lat) / len(lat)) if lat else None,
            "selfcheck_detection_rate":
                sum(e.selfcheck_detected for e in es) / n,
            "would_be_false_negatives":
                sum(e.would_be_false_negative for e in es),
            "escalations": sum(e.escalated for e in es),
        }
    return out


def _tiers_total(experiments: List[ExperimentResult]) -> Dict[str, Any]:
    total: Dict[str, Any] = {"slot": 0, "stripe": 0, "graph": 0,
                             "restore": 0, "persistent_escalations": 0}
    persistent_sites: List[str] = []
    for e in experiments:
        for k in ("slot", "stripe", "graph", "restore",
                  "persistent_escalations"):
            total[k] += e.repair_tiers[k]
        persistent_sites.extend(e.repair_tiers["persistent_sites"])
    return {**total, "persistent_sites": sorted(set(persistent_sites))}


def gcn_workload(*, n_graphs: int = 4, n_lo: int = 12, n_hi: int = 32,
                 feat: int = 8, hidden: int = 16, n_out: int = 4,
                 block: int = 8, threshold: float = 1e-3, seed: int = 0,
                 device: DeviceLike = "cuda"):
    """The GCN lane's deterministic workload: (folded params on the
    device, ABFT config, the (S, H0) items, the clean packed batch staged
    on the device).  One fixed batch for the whole campaign — a single
    packed shape."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.engine.api import fold_w_r
    from repro_torch.engine.batching import pack_graphs, synth_graph_stream
    from repro_torch.engine.streaming import packed_step_args

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    params = {"layers": [
        {"w": (rng.normal(size=(feat, hidden)) * 0.3).astype(np.float32),
         "b": np.zeros(hidden, np.float32)},
        {"w": (rng.normal(size=(hidden, n_out)) * 0.3).astype(np.float32),
         "b": np.zeros(n_out, np.float32)}]}
    cfg = ABFTConfig(threshold=threshold)
    params = fold_w_r(params_from_numpy(params, device=dev), cfg)
    items = synth_graph_stream(n_graphs, n_lo=n_lo, n_hi=n_hi, feat=feat,
                               seed=seed)
    pb = pack_graphs(items, block=block, n_slots=n_graphs)  # abftlint: pack-ok (one pack a campaign, one shape)
    return params, cfg, items, _Staged(pb, *packed_step_args(pb, dev))


def run_fault_campaign(models: Optional[List[FaultModel]] = None, *,
                       n_graphs: int = 4, n_steps: int = 4,
                       n_lo: int = 12, n_hi: int = 32, feat: int = 8,
                       hidden: int = 16, n_out: int = 4, block: int = 8,
                       block_g: int = 128, threshold: float = 1e-3,
                       seed: int = 0,
                       guard_cfg: Optional[GuardConfig] = None,
                       verbose: bool = False,
                       device: DeviceLike = "cuda") -> dict:
    """Sweep ``models`` (default: :func:`sweep_models` grid) over a
    deterministic synthetic workload; returns the JSON-ready payload."""
    dev = resolve_device(device)
    if models is None:
        models = sweep_models(step=1, seed=seed)
    params, cfg, items, staged = gcn_workload(
        n_graphs=n_graphs, n_lo=n_lo, n_hi=n_hi, feat=feat, hidden=hidden,
        n_out=n_out, block=block, threshold=threshold, seed=seed,
        device=dev)
    pb = staged.pb

    # clean reference + clean control: the workload is deterministic and
    # eager, so one evaluation IS every clean step — any flag here is a
    # false positive on clean data and fails the campaign gate
    clean_checks = []
    ref_packed = _packed_forward(params, cfg, staged, block_g=block_g,
                                 checks_out=clean_checks)
    need_dense = any(m.site == "s_c" for m in models)
    dense_items = ([(torch.from_numpy(s).to(dev),
                     torch.from_numpy(h0).to(dev)) for s, h0 in items]
                   if need_dense else None)
    ref_dense = (_dense_forward(params, cfg,
                                _make_dense_graphs(dense_items, cfg))
                 if need_dense else None)
    clean_flags = int(ref_packed[1].sum()) + (
        int(ref_dense[1].sum()) if ref_dense is not None else 0)

    experiments = []
    for m in models:
        if verbose:
            print(f"fault_campaign: {m.label()} (seed={m.seed})")
        experiments.append(run_experiment(
            m, params=params, cfg=cfg, staged=staged,
            dense_items=dense_items, ref_packed=ref_packed,
            ref_dense=ref_dense, block_g=block_g, n_steps=n_steps,
            guard_cfg=guard_cfg))

    return {
        "benchmark": "fault_campaign",
        **_stamp(dev),
        "config": {"n_graphs": n_graphs, "n_steps": n_steps,
                   "n_lo": n_lo, "n_hi": n_hi, "feat": feat,
                   "hidden": hidden, "n_out": n_out, "block": block,
                   "threshold": threshold, "seed": seed,
                   "n_models": len(models)},
        "clean_control": {
            "flagged": clean_flags,
            "false_positive_rate":
                clean_flags / (pb.n_slots + (len(items) if need_dense
                                             else 0)),
        },
        # beyond the reference's keys: each layer's clean per-graph check
        # value and the threshold it is held to (tau * max(1, |actual|)),
        # so an accumulator delta can be read against the graph it hits
        "clean_checks": {
            "stripe_graph": pb.stripe_graph.tolist(),
            "actual": [None if c is None else _np(c.actual).tolist()
                       for c in clean_checks],
            "threshold": [None if c is None else
                          (threshold * np.maximum(
                              1.0, np.abs(_np(c.actual)))).tolist()
                          for c in clean_checks],
        },
        "experiments": [e.to_dict() for e in experiments],
        "by_site_kind": _aggregate(experiments),
        "repair_tiers_total": _tiers_total(experiments),
    }


# ---------------------------------------------------------------------------
# the LM lane — guarded transformer serving under the same fault grid
# ---------------------------------------------------------------------------

def run_lm_experiment(model: FaultModel, *, prefill, decode, master, fold,
                      ref_logits, ref_tokens, tokens, prompt_len: int,
                      n_steps: int,
                      guard_cfg: Optional[GuardConfig] = None
                      ) -> ExperimentResult:
    """Run one LM fault model over a prefill + decode trajectory.

    The trajectory replays the CLEAN reference's greedy tokens, so every
    step's operands match the reference bitwise and divergence is a pure
    fault signal.  Weight sites corrupt the working params (the fold
    stays pristine — the post-load memory-fault class the offline eq.-5
    fold makes detectable); ``attn_accumulator`` rides the ``attn_inject``
    operand and fires once per step (the transient convention — the
    guard's retry re-executes clean).  Every step runs through a real
    :class:`ABFTGuard` whose restore refolds from the master, so flagged
    steps come back repaired and the repair-tier distribution is real.
    The naive-comparison / self-check columns are GCN-lane concepts and
    stay empty here (LM sites are all data-path).  ``ref_logits`` are host
    arrays; ``tokens`` and ``ref_tokens`` live on the steps' device."""
    inj = FaultInjector(model)
    state = {"params": fold(master)}

    def restore():
        state["params"] = fold(master)
        return state["params"]

    guard = ABFTGuard(guard_cfg if guard_cfg is not None
                      else _default_guard(), restore_fn=restore)
    fired_steps: List[int] = []
    flagged_steps: List[int] = []
    sdc_steps: List[int] = []
    masked_steps: List[int] = []
    fp_steps: List[int] = []
    escalations = 0
    states = None

    for t in range(n_steps):          # t=0 prefill, t>=1 decode steps
        fired = inj.fires(t)
        if fired:
            fired_steps.append(t)
            if model.site in ("qkv_w", "mlp_w"):
                state["params"] = inj.apply_lm_params(state["params"])
        # fire-once box: a transient inject strikes the first attempt
        # only, so retries/replays re-execute clean
        box = {"v": float(inj.lm_inject()) if fired else 0.0}  # abftlint: sync-ok (host-side fault model)

        def pop():
            v, box["v"] = box["v"], 0.0
            return v

        flags0 = guard.flags
        try:
            if t == 0:
                (lg, states), _m = guard.run_step(
                    lambda params, batch: prefill(params, batch, pop()),
                    state["params"], {"tokens": tokens})
            else:
                (lg, states), _m = guard.run_step(
                    lambda params, st, tk, pos:
                        decode(params, st, tk, pos, pop()),
                    state["params"], states, ref_tokens[t - 1],
                    prompt_len + t - 1)
        except UnverifiableBatch:
            # guard refused to verify after max_restores — eviction
            # advice.  Recover with a clean unguarded step so the
            # trajectory (decode states) can continue.
            escalations += 1
            flagged_steps.append(t)
            state["params"] = fold(master)
            if t == 0:
                (lg, states), _m = prefill(state["params"],
                                           {"tokens": tokens})
            else:
                (lg, states), _m = decode(state["params"], states,
                                          ref_tokens[t - 1],
                                          prompt_len + t - 1)
            continue

        flagged = guard.flags > flags0
        if flagged:
            flagged_steps.append(t)
        diverged = not np.array_equal(_np(lg), ref_logits[t])
        if fired and not flagged:
            (sdc_steps if diverged else masked_steps).append(t)
        if not fired and flagged:
            fp_steps.append(t)

    detected_steps = [t for t in flagged_steps if t in fired_steps]
    detected = bool(detected_steps)
    latency = (detected_steps[0] - fired_steps[0]
               if detected and fired_steps else None)
    return ExperimentResult(
        model=model, steps=n_steps, fired_steps=fired_steps,
        flagged_steps=flagged_steps, naive_flagged_steps=[],
        detected=detected, detection_latency=latency,
        sdc_steps=sdc_steps, masked_steps=masked_steps,
        false_positive_steps=fp_steps,
        selfcheck_detected=False, selfcheck_step=None,
        would_be_false_negative=False,
        escalated=escalations > 0,
        repair_tiers=guard.repair_tiers())


def lm_reference_trajectory(prefill, decode, params, tokens, prompt_len: int,
                            n_decode: int):
    """The clean guarded trajectory every LM experiment replays: (host
    logits per step, greedy tokens fed to each decode step on the steps'
    device, clean flags)."""
    (lg, states), m0 = prefill(params, {"tokens": tokens})
    clean_flags = int(bool(m0["abft_flag"]))
    ref_logits = [_np(lg)]
    ref_tokens = []
    for i in range(n_decode):
        ref_tokens.append(
            torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None])
        (lg, states), mi = decode(params, states, ref_tokens[-1],
                                  prompt_len + i)
        clean_flags += int(bool(mi["abft_flag"]))  # abftlint: sync-ok (eager campaign harness)
        ref_logits.append(_np(lg))
    return ref_logits, ref_tokens, clean_flags


def run_lm_fault_campaign(models: Optional[List[FaultModel]] = None, *,
                          n_decode: int = 3, prompt_len: int = 8,
                          batch: int = 1, cache_len: int = 32,
                          threshold: float = 1e-3, seed: int = 0,
                          guard_cfg: Optional[GuardConfig] = None,
                          verbose: bool = False, cfg=None, master=None,
                          device: DeviceLike = "cuda") -> dict:
    """Sweep ``models`` (default: :func:`lm_sweep_models` grid) over a
    guarded LM serving trajectory; returns the JSON-ready payload in the
    same shape as :func:`run_fault_campaign`.

    By default the model is the smoke-sized gemma-2b with seeded random
    weights (the reference's lane); ``cfg``/``master`` (a model config and
    its unfolded params on ``device``) serve a model the caller already
    holds — gemma-2b at full width on the card.

    The LM lane's CI gate mirrors the GCN ``accumulator`` gate: every
    above-threshold ``attn_accumulator`` upset must be detected, and the
    clean control must not flag."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.engine.lm import (
        fold_lm_w_r,
        make_guarded_decode_step,
        make_guarded_prefill_step,
    )
    from repro_torch.models.transformer import init_model

    dev = resolve_device(device)
    if cfg is None:
        cfg = smoke_config(get_config("gemma-2b"))
    abft = ABFTConfig(mode="fused", threshold=threshold)
    if master is None:
        master = init_model(cfg, seed, device=dev)

    def fold(p):
        return fold_lm_w_r(p, cfg, abft)

    # one pair of steps shared by every experiment (same shapes throughout)
    prefill = make_guarded_prefill_step(cfg, abft, cache_len)
    decode = make_guarded_decode_step(cfg, abft)
    if models is None:
        models = lm_sweep_models(step=1, seed=seed)
    n_steps = 1 + n_decode

    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, size=(batch, prompt_len))
        .astype(np.int32)).to(dev)

    # clean reference trajectory — greedy tokens recorded so every
    # experiment replays identical operands; any flag here is a clean
    # false positive and fails the campaign gate
    ref_logits, ref_tokens, clean_flags = lm_reference_trajectory(
        prefill, decode, fold(master), tokens, prompt_len, n_decode)

    experiments = []
    for m in models:
        if verbose:
            print(f"lm_fault_campaign: {m.label()} (seed={m.seed})")
        experiments.append(run_lm_experiment(
            m, prefill=prefill, decode=decode, master=master, fold=fold,
            ref_logits=ref_logits, ref_tokens=ref_tokens, tokens=tokens,
            prompt_len=prompt_len, n_steps=n_steps, guard_cfg=guard_cfg))

    return {
        "benchmark": "lm_fault_campaign",
        **_stamp(dev),
        "config": {"model": cfg.name, "n_decode": n_decode,
                   "prompt_len": prompt_len, "batch": batch,
                   "cache_len": cache_len, "threshold": threshold,
                   "seed": seed, "n_models": len(models),
                   "n_layers": cfg.n_layers, "d_model": cfg.d_model},
        "clean_control": {
            "flagged": clean_flags,
            "false_positive_rate": clean_flags / n_steps,
        },
        "experiments": [e.to_dict() for e in experiments],
        "by_site_kind": _aggregate(experiments),
        "repair_tiers_total": _tiers_total(experiments),
    }
