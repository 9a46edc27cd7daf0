"""The surgical repair tiers of the port (``repro_torch.engine.localize``)
against the JAX package's, on the same packed batch with the same injected
accumulator fault: the same stripes and rows recomputed, the same all-False
graph flags, repaired logits within ``1e-5`` of the port's clean run (bit
for bit on the fused paths) and within ``1e-4`` of the reference's; and
the same escalations.  The JAX side runs its kernels in interpret mode, the
port its plain versions (``device="cpu"``)."""
import jax
import numpy as np
import pytest
import torch

from repro.core.abft import ABFTConfig as JConfig
from repro.core.gcn import init_gcn as j_init_gcn
from repro.engine import fold_w_r as j_fold
from repro.engine import localize as j_loc
from repro.engine import streaming as j_streaming
from repro.runtime import ABFTGuard as JGuard
from repro_torch import convert
from repro_torch.core.abft import ABFTConfig as TConfig
from repro_torch.engine import fold_w_r, pack_graphs, synth_graph_stream
from repro_torch.engine import localize as t_loc
from repro_torch.engine import streaming as t_streaming
from repro_torch.runtime import ABFTGuard as TGuard

DIMS = (12, 8, 8, 3)
BLOCK = 8
PATHS = {"network": dict(fused_network=True),
         "fused-layer": dict(fused_layer=True),
         "two-pass": dict()}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _setup(seed=3, dims=DIMS):
    """Three graphs of 2-3 stripes each (<= 8 stripes, width <= 4)."""
    stream = synth_graph_stream(3, n_lo=12, n_hi=22, feat=dims[0], seed=seed)
    pb = pack_graphs(stream, block=BLOCK)
    jcfg, tcfg = JConfig(), TConfig()
    jp = j_fold(j_init_gcn(jax.random.PRNGKey(seed), dims), jcfg)
    tp = fold_w_r(convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                            device="cpu"), tcfg)
    return pb, jp, tp, jcfg, tcfg


def _run(pb, jp, tp, jcfg, tcfg, granularity, path, inject):
    jr = j_streaming.PackedRunner(jp, jcfg, 128, granularity=granularity,
                                  inject=inject, **PATHS[path])
    tr = t_streaming.PackedRunner(tp, tcfg, 128, granularity=granularity,
                                  inject=inject, device="cpu",
                                  **PATHS[path])
    jout, jm = jr.step_for(pb)(*j_streaming.packed_step_args(pb))
    tout, tm = tr.step_for(pb)(*tr.args_for(pb))
    return (jr, jout, jm), (tr, tout, tm)


def _owner_stripe(pb, layer_stripe=1):
    """The second stripe of graph 0 (a graph spanning > 1 stripe)."""
    return int(pb.row_offsets[0]) // BLOCK + layer_stripe


@pytest.mark.parametrize("layer", [0, 1, 2])
@pytest.mark.parametrize("tier,path", [
    ("stripe", "network"), ("stripe", "fused-layer"), ("stripe", "two-pass"),
    ("slot", "network"), ("slot", "fused-layer")])
def test_surgical_tier_matches_reference(tier, path, layer):
    pb, jp, tp, jcfg, tcfg = _setup()
    stripe = _owner_stripe(pb)
    inject = (layer, stripe, 1, 40.0)
    (_, jout, jm), (_, tout, tm) = _run(pb, jp, tp, jcfg, tcfg, tier, path,
                                        inject)
    (_, jclean, _), (_, tclean, _) = _run(pb, jp, tp, jcfg, tcfg, tier,
                                          path, None)
    assert _np(tm["abft_graph_flags"]).tolist() == \
        np.asarray(jm["abft_graph_flags"]).tolist()
    assert _np(tm["abft_stripe_flags"])[layer, stripe]
    jfn = j_loc.surgical_slot_retry if tier == "slot" \
        else j_loc.surgical_stripe_retry
    tfn = t_loc.surgical_slot_retry if tier == "slot" \
        else t_loc.surgical_stripe_retry
    jrep, jsub = jfn(pb, jp, jcfg, jout, jm, block_g=128, interpret=True)
    trep, tsub = tfn(pb, tp, tcfg, tout, tm, block_g=128)
    for key in ("abft_rows_recomputed", "abft_stripes_recomputed"):
        assert tsub[key] == jsub[key], key
    assert tsub["abft_rows_recomputed"] >= BLOCK
    assert not tsub["abft_graph_flags"].any() and \
        not jsub["abft_graph_flags"].any()
    assert tsub["abft_graph_flags"].shape == (pb.n_slots,)
    np.testing.assert_allclose(tsub["abft_graph_max_rel"],
                               jsub["abft_graph_max_rel"], atol=1e-5)
    np.testing.assert_allclose(_np(trep), _np(tclean), atol=1e-5)
    np.testing.assert_allclose(_np(trep), np.asarray(jrep), atol=1e-4)
    if path != "two-pass":
        # the fused recompute runs each stripe through the same sweep as
        # the original run: the splice is bit for bit
        assert torch.equal(trep, tclean)
    assert not torch.equal(tout, tclean)        # the fault did reach out
    # the original stashes are untouched by the repair
    assert torch.equal(tm["abft_h_layers"][0], torch.from_numpy(pb.h0))


def test_slot_tier_reaches_no_more_rows_than_stripe_tier():
    pb, jp, tp, jcfg, tcfg = _setup(seed=7)
    stripe = _owner_stripe(pb, 0)
    rows = {}
    for tier in ("stripe", "slot"):
        _, (_, tout, tm) = _run(pb, jp, tp, jcfg, tcfg, tier, "network",
                                (0, stripe, 0, -3.0))
        fn = t_loc.surgical_slot_retry if tier == "slot" \
            else t_loc.surgical_stripe_retry
        rows[tier] = fn(pb, tp, tcfg, tout, tm)[1]["abft_rows_recomputed"]
    assert BLOCK <= rows["slot"] <= rows["stripe"]


def test_escalation_padding_stripe_flagged():
    pb, jp, tp, jcfg, tcfg = _setup()
    pb = pack_graphs(pb.items, block=BLOCK,
                     stripe_cap=pb.bell.n_block_rows + 1)
    pad = int(np.nonzero(pb.stripe_graph >= pb.n_slots)[0][0])
    (_, jout, jm), (_, tout, tm) = _run(pb, jp, tp, jcfg, tcfg, "stripe",
                                        "network", None)
    jm = dict(jm, abft_stripe_flags=np.zeros_like(jm["abft_stripe_flags"]))
    tm = dict(tm, abft_stripe_flags=torch.zeros_like(tm["abft_stripe_flags"]))
    jm["abft_stripe_flags"][1, pad] = True
    tm["abft_stripe_flags"][1, pad] = True
    jm["abft_graph_flags"] = np.ones(pb.n_slots, bool)
    tm["abft_graph_flags"] = torch.ones(pb.n_slots, dtype=torch.bool)
    _, jsub = j_loc.surgical_stripe_retry(pb, jp, jcfg, jout, jm,
                                          interpret=True)
    trep, tsub = t_loc.surgical_stripe_retry(pb, tp, tcfg, tout, tm)
    for key in ("abft_rows_recomputed", "abft_stripes_recomputed"):
        assert tsub[key] == jsub[key] == 0, key
    np.testing.assert_array_equal(tsub["abft_graph_flags"],
                                  jsub["abft_graph_flags"])
    assert tsub["abft_graph_flags"].all() and trep is tout


def test_escalation_layer_outside_the_fused_kernel_without_x():
    """A layer the fused kernel refuses, no stashed X: escalate rather than
    force that kernel.  Layer 0 is [2048, 1032]: over the reference's VMEM
    budget and outside the port's register tile (G = 1032 at block 8), so
    both engines ran it two-pass."""
    dims = (2048, 1032, 3)
    pb, jp, tp, jcfg, tcfg = _setup(seed=11, dims=dims)
    stripe = _owner_stripe(pb, 0)
    (_, jout, jm), (_, tout, tm) = _run(pb, jp, tp, jcfg, tcfg, "stripe",
                                        "fused-layer", (0, stripe, 0, 30.0))
    assert all(x is not None for x in tm["abft_x_layers"][:1])
    jm = {k: v for k, v in jm.items() if k != "abft_x_layers"}
    tm = {k: v for k, v in tm.items() if k != "abft_x_layers"}
    _, jsub = j_loc.surgical_stripe_retry(pb, jp, jcfg, jout, jm,
                                          interpret=True)
    trep, tsub = t_loc.surgical_stripe_retry(pb, tp, tcfg, tout, tm)
    assert tsub["abft_rows_recomputed"] == jsub["abft_rows_recomputed"] == 0
    np.testing.assert_array_equal(tsub["abft_graph_flags"],
                                  jsub["abft_graph_flags"])
    assert tsub["abft_graph_flags"].any() and trep is tout


@pytest.mark.parametrize("tier", ["stripe", "slot"])
def test_escalation_recompute_still_flagged(tier):
    """A corrupted folded w_r makes the recompute's own corners disagree:
    the repair must not adopt — the original flags go back to the guard."""
    pb, jp, tp, jcfg, tcfg = _setup(seed=5)
    stripe = _owner_stripe(pb, 0)
    (_, jout, jm), (_, tout, tm) = _run(pb, jp, tp, jcfg, tcfg, tier,
                                        "network", (1, stripe, 0, 30.0))
    jbad = {"layers": [dict(layer) for layer in jp["layers"]]}
    tbad = {"layers": [dict(layer) for layer in tp["layers"]]}
    jbad["layers"][1]["w_r"] = jbad["layers"][1]["w_r"] * 3.0
    tbad["layers"][1]["w_r"] = tbad["layers"][1]["w_r"] * 3.0
    jfn = j_loc.surgical_slot_retry if tier == "slot" \
        else j_loc.surgical_stripe_retry
    tfn = t_loc.surgical_slot_retry if tier == "slot" \
        else t_loc.surgical_stripe_retry
    _, jsub = jfn(pb, jbad, jcfg, jout, jm, interpret=True)
    trep, tsub = tfn(pb, tbad, tcfg, tout, tm)
    for key in ("abft_rows_recomputed", "abft_stripes_recomputed"):
        assert tsub[key] == jsub[key] > 0, key
    np.testing.assert_array_equal(tsub["abft_graph_flags"],
                                  jsub["abft_graph_flags"])
    assert tsub["abft_graph_flags"].any() and trep is tout


@pytest.mark.parametrize("tier", ["stripe", "slot"])
def test_guard_ladder_with_surgical_tiers_matches_reference(tier):
    """The guard adopts the surgical repair: same tier counts, clean
    adopted flags and logits as the reference's guard."""
    pb, jp, tp, jcfg, tcfg = _setup(seed=8)
    stripe = _owner_stripe(pb, 0)
    (jr, jout, jm), (tr, tout, tm) = _run(pb, jp, tp, jcfg, tcfg, tier,
                                          "network", (0, stripe, 1, 25.0))
    jg, tg = JGuard(), TGuard()
    jrep, jad = jg.adjudicate(
        jout, jm, jr.retry_fn(pb), stripe_retry_fn=jr.stripe_retry_fn(pb),
        slot_retry_fn=jr.slot_retry_fn(pb) if tier == "slot" else None)
    trep, tad = tg.adjudicate(
        tout, tm, tr.retry_fn(pb), stripe_retry_fn=tr.stripe_retry_fn(pb),
        slot_retry_fn=tr.slot_retry_fn(pb) if tier == "slot" else None)
    assert tg.repair_tiers() == jg.repair_tiers()
    assert (tg.retries, tg.recomputed_rows) == (jg.retries,
                                                jg.recomputed_rows)
    assert getattr(tg, f"{tier}_retries") > 0
    assert not _np(tad["abft_graph_flags"]).any()
    assert "abft_h_layers" not in tad
    np.testing.assert_allclose(_np(trep), np.asarray(jrep), atol=1e-4)


def test_gather_and_reach_helpers_match_reference():
    pb, *_ = _setup(seed=2)
    bell = pb.bell
    sub_t = t_loc.gather_stripe_system(bell, [2, 0])
    sub_j = j_loc.gather_stripe_system(bell, [2, 0])
    np.testing.assert_array_equal(sub_t.values, sub_j.values)
    np.testing.assert_array_equal(sub_t.block_cols, sub_j.block_cols)
    assert sub_t.shape == sub_j.shape
    for cols in (set(), {0}, {1, 3}):
        np.testing.assert_array_equal(t_loc._reachable_stripes(bell, cols),
                                      j_loc._reachable_stripes(bell, cols))
    rows = np.zeros(BLOCK, bool)
    rows[[1, 5]] = True
    for dirty in ({}, {0: rows}, {1: rows, 2: ~rows}):
        np.testing.assert_array_equal(
            t_loc._rows_reachable_stripes(bell, dirty),
            j_loc._rows_reachable_stripes(bell, dirty))
    flags = np.zeros((6, 4), bool)
    flags[3, 1] = True
    np.testing.assert_array_equal(t_loc._layer_stripe_flags(flags, 3),
                                  j_loc._layer_stripe_flags(flags, 3))
    with pytest.raises(ValueError):
        t_loc._layer_stripe_flags(flags, 4)
    with pytest.raises(ValueError):
        t_loc._layer_slot_flags(np.zeros((3, 4), bool), 3)
