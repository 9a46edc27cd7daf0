"""The slice as a whole: the closed-batch guarded server of the port
(``repro_torch.launch.serve_gcn.serve``) against the JAX package's, on the
same packed stream with the same weights (carried through
``repro_torch.convert``), clean and with an injected accumulator fault, on
the two-pass and the fused-layer path.  Logits within ``atol 1e-4``;
per-graph flags, guard counters, fusion counts and the count of distinct
step shapes exactly equal."""
import jax
import numpy as np
import pytest
import torch

from repro.core.abft import ABFTConfig as JConfig
from repro.core.gcn import init_gcn as j_init_gcn
from repro.engine import fold_w_r as j_fold
from repro.engine import make_batches as j_make_batches
from repro.engine import make_packed_batches as j_make_packed
from repro.engine import streaming as j_streaming
from repro.launch import serve_gcn as j_serve_mod
from repro.runtime import ABFTGuard as JGuard
from repro_torch import convert
from repro_torch.core.abft import ABFTConfig as TConfig
from repro_torch.engine import (fold_w_r, make_batches, make_packed_batches,
                                synth_graph_stream)
from repro_torch.engine import streaming as t_streaming
from repro_torch.launch import serve_gcn as t_serve_mod
from repro_torch.runtime import ABFTGuard as TGuard

DIMS = (9, 8, 5)
BLOCK = 8
ATOL = 1e-4


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _setup(n_graphs=6, batch=3, seed=0):
    stream = synth_graph_stream(n_graphs, n_lo=12, n_hi=40, feat=DIMS[0],
                                seed=seed)
    kw = dict(block=BLOCK, stripe_multiple=4, width_multiple=2)
    jp = j_init_gcn(jax.random.PRNGKey(seed), DIMS)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return (stream, j_make_packed(stream, batch, **kw),
            make_packed_batches(stream, batch, **kw), jp, tp)


class _Capture:
    """Stand-in for ``PackedRunner`` inside ``serve()``: builds the real
    runner (optionally with an ``inject`` hook — ``serve`` itself has no such
    argument on either side) and keeps it for inspection."""

    def __init__(self, cls, inject=None, **fixed):
        self.cls, self.inject, self.fixed, self.runner = cls, inject, fixed, None

    def __call__(self, *args, **kw):
        self.runner = self.cls(*args, inject=self.inject, **self.fixed, **kw)
        return self.runner


def _serve_both(monkeypatch, jb, tb, jp, tp, *, inject=None, mode="fused",
                **kw):
    jcap = _Capture(j_streaming.PackedRunner, inject)
    tcap = _Capture(t_streaming.PackedRunner, inject)
    monkeypatch.setattr(j_serve_mod, "PackedRunner", jcap)
    monkeypatch.setattr(t_serve_mod, "PackedRunner", tcap)
    jguard, tguard = JGuard(), TGuard()
    jstats = j_serve_mod.serve(jb, jp, JConfig(mode=mode), guard=jguard,
                               verbose=False, **kw)
    tstats = t_serve_mod.serve(tb, tp, TConfig(mode=mode), guard=tguard,
                               verbose=False, device="cpu", **kw)
    return jstats, tstats, jguard, tguard, jcap.runner, tcap.runner


def _same_stats(jstats, tstats, jguard, tguard):
    for key in ("graphs", "batches", "flags", "graph_retries",
                "stripe_retries", "slot_retries", "recomputed_rows",
                "fused_hits", "fused_fallbacks", "network_hits",
                "network_fallbacks", "repair_tiers"):
        assert tstats[key] == jstats[key], key
    np.testing.assert_array_equal(tstats["graph_flags"],
                                  jstats["graph_flags"])
    np.testing.assert_allclose(tstats["graph_max_rel"],
                               jstats["graph_max_rel"], atol=1e-5)
    for attr in ("steps", "flags", "retries", "graph_retries", "restores"):
        assert getattr(tguard, attr) == getattr(jguard, attr), attr


@pytest.mark.parametrize("mode", ["fused", "none", "split"])
@pytest.mark.parametrize("fused_layer", [False, True],
                         ids=["two-pass", "fused-layer"])
def test_serve_clean_stream(monkeypatch, fused_layer, mode):
    _stream, jb, tb, jp, tp = _setup()
    jstats, tstats, jg, tg, jr, tr = _serve_both(
        monkeypatch, jb, tb, jp, tp, mode=mode, fused_layer=fused_layer)
    _same_stats(jstats, tstats, jg, tg)
    assert tstats["flags"] == 0 and not tstats["graph_flags"].any()
    assert tr.compile_count == jr.compile_count
    want_hits = len(tb) * (len(DIMS) - 1) if fused_layer and mode != "split" \
        else 0
    assert tstats["fused_hits"] == want_hits


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("fused_layer", [False, True],
                         ids=["two-pass", "fused-layer"])
def test_serve_injected_fault_is_flagged_and_repaired(monkeypatch,
                                                      fused_layer, layer):
    _stream, jb, tb, jp, tp = _setup()
    # a stripe of the first batch's LAST graph, beyond every stripe of the
    # one-graph retry pack: the retry runs clean, as after a transient upset
    pb = tb[0]
    owner = pb.n_graphs - 1
    stripe = int(pb.row_offsets[owner]) // BLOCK
    inject = (layer, stripe, 0, 25.0)
    sub = t_streaming.PackedRunner(tp, TConfig(), 128, device="cpu"
                                   ).pack_retry(pb, [pb.items[owner]])
    assert stripe >= sub.bell.n_block_rows
    jstats, tstats, jg, tg, jr, tr = _serve_both(
        monkeypatch, jb, tb, jp, tp, inject=inject, fused_layer=fused_layer)
    _same_stats(jstats, tstats, jg, tg)
    assert tg.flags >= 1 and tg.graph_retries >= 1 and tg.restores == 0
    assert not tstats["graph_flags"].any()        # adopted verdicts are clean
    assert tr.compile_count == jr.compile_count   # retry ladder shapes too
    # and the repaired logits of the faulted batch equal the clean run's
    clean = t_streaming.PackedRunner(fold_w_r(tp, TConfig()), TConfig(), 128,
                                     fused_layer=fused_layer, device="cpu")
    want, _ = clean.step_for(pb)(*clean.args_for(pb))
    step, args = tr.step_for(pb), tr.args_for(pb)
    _, raw = step(*args)
    assert _np(raw["abft_graph_flags"]).tolist() == \
        [g == owner for g in range(pb.n_slots)]
    got, metrics = TGuard().run_step_graphs(step, tr.retry_fn(pb), *args)
    assert not _np(metrics["abft_graph_flags"]).any()
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


@pytest.mark.parametrize("fused_layer", [False, True],
                         ids=["two-pass", "fused-layer"])
def test_step_logits_and_verdicts_per_graph(fused_layer):
    _stream, jb, tb, jp, tp = _setup(seed=1)
    jcfg, tcfg = JConfig(), TConfig()
    jr = j_streaming.PackedRunner(j_fold(jp, jcfg), jcfg, 128, fused_layer)
    tr = t_streaming.PackedRunner(fold_w_r(tp, tcfg), tcfg, 128, fused_layer,
                                  device="cpu")
    for jpb, tpb in zip(jb, tb):
        jl, jm = jr.step_for(jpb)(*j_streaming.packed_step_args(jpb))
        tl, tm = tr.step_for(tpb)(*tr.args_for(tpb))
        for o, n in zip(tpb.row_offsets, tpb.n_nodes):
            np.testing.assert_allclose(_np(tl)[o:o + n],
                                       np.asarray(jl)[o:o + n], atol=ATOL)
        np.testing.assert_array_equal(_np(tm["abft_graph_flags"]),
                                      np.asarray(jm["abft_graph_flags"]))
        np.testing.assert_allclose(_np(tm["abft_graph_max_rel"]),
                                   np.asarray(jm["abft_graph_max_rel"]),
                                   atol=1e-5)
        assert bool(tm["abft_flag"]) == bool(jm["abft_flag"])
        assert float(tm["abft_n_checks"]) == float(jm["abft_n_checks"])
    assert tr.compile_count == jr.compile_count
    assert tr.fusion_counts(tb[0]) == jr.fusion_counts(jb[0])


@pytest.mark.parametrize("granularity", ["stripe", "slot"])
@pytest.mark.parametrize("fused_layer", [False, True],
                         ids=["two-pass", "fused-layer"])
def test_localizing_step_metrics(fused_layer, granularity):
    """The step computes stripe and slot reports and the operand stashes at
    those granularities, and the matching surgical retry repairs the
    injected fault as the reference's does."""
    _stream, jb, tb, jp, tp = _setup(seed=2)
    jcfg, tcfg = JConfig(), TConfig()
    inject = (1, 1, 0, 9.0)
    jr = j_streaming.PackedRunner(j_fold(jp, jcfg), jcfg, 128, fused_layer,
                                  granularity, inject=inject)
    tr = t_streaming.PackedRunner(fold_w_r(tp, tcfg), tcfg, 128, fused_layer,
                                  granularity, inject=inject, device="cpu")
    jl, jm = jr.step_for(jb[0])(*j_streaming.packed_step_args(jb[0]))
    tl, tm = tr.step_for(tb[0])(*tr.args_for(tb[0]))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL)
    assert set(tm) == set(jm)
    for key in ("abft_graph_flags", "abft_stripe_flags", "abft_slot_flags"):
        if key in jm:
            np.testing.assert_array_equal(_np(tm[key]), np.asarray(jm[key]))
    assert _np(tm["abft_stripe_flags"])[1, 1]
    for key in ("abft_h_layers", "abft_x_layers"):
        for a, b in zip(tm[key], jm[key]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATOL)
    fn = "slot_retry_fn" if granularity == "slot" else "stripe_retry_fn"
    tout, tsub = getattr(tr, fn)(tb[0])(tl, tm)
    jout, jsub = getattr(jr, fn)(jb[0])(jl, jm)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=ATOL)
    for key in ("abft_graph_flags", "abft_rows_recomputed",
                "abft_stripes_recomputed"):
        np.testing.assert_array_equal(np.asarray(tsub[key]),
                                      np.asarray(jsub[key]))


@pytest.mark.parametrize("path,granularity", [
    ({"fused_network": True}, "graph"), ({"fused_network": True}, "stripe"),
    ({"fused_network": True}, "slot"), ({"fused_layer": True}, "slot"),
    ({}, "stripe")],
    ids=["network-graph", "network-stripe", "network-slot",
         "fused-layer-slot", "two-pass-stripe"])
def test_serve_repair_tiers_match_reference(monkeypatch, path, granularity):
    """serve() with an injected accumulator upset, at every granularity and
    on the network path: the same stats, per-graph verdicts and repair-tier
    counts as the reference, and every adopted verdict clean."""
    _stream, jb, tb, jp, tp = _setup()
    pb = tb[0]
    owner = pb.n_graphs - 1
    inject = (0, int(pb.row_offsets[owner]) // BLOCK, 0, 25.0)
    jstats, tstats, jg, tg, jr, tr = _serve_both(
        monkeypatch, jb, tb, jp, tp, inject=inject, granularity=granularity,
        **path)
    _same_stats(jstats, tstats, jg, tg)
    assert tg.flags >= 1 and not tstats["graph_flags"].any()
    assert tr.compile_count == jr.compile_count
    if path.get("fused_network"):
        assert tstats["network_hits"] == len(tb)
        assert tstats["repair_tiers"][granularity] >= 1


def test_retry_ladder_shapes_are_powers_of_two():
    _stream, jb, tb, jp, tp = _setup(n_graphs=8, batch=8, seed=3)
    jr = j_streaming.PackedRunner(jp, JConfig(), 128)
    tr = t_streaming.PackedRunner(tp, TConfig(), 128, device="cpu")
    for k in (1, 2, 3, 5):
        items = tb[0].items[:k]
        assert tr._retry_shape(tb[0], items) == jr._retry_shape(jb[0], items)
        sub = tr.pack_retry(tb[0], items)
        assert sub.n_slots == t_streaming.next_pow2(k)
    assert [t_streaming.next_pow2(n) for n in (0, 1, 2, 3, 9)] == \
        [j_streaming.next_pow2(n) for n in (0, 1, 2, 3, 9)]


def test_serve_dense_buckets(monkeypatch):
    stream = synth_graph_stream(7, n_lo=12, n_hi=60, feat=DIMS[0], seed=4)
    jp = j_init_gcn(jax.random.PRNGKey(4), DIMS)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jstats, tstats, jg, tg, _, _ = _serve_both(
        monkeypatch, j_make_batches(stream, 4, [32, 64]),
        make_batches(stream, 4, [32, 64]), jp, tp)
    _same_stats(jstats, tstats, jg, tg)
    # a dense step's per-graph retry patches only the flagged slots
    tcfg = TConfig()
    b = make_batches(stream, 4, [32, 64])[0]
    step = t_streaming.make_serve_step(fold_w_r(tp, tcfg), tcfg, device="cpu")
    out, m = step(torch.from_numpy(b.s), torch.from_numpy(b.h0))
    retry = t_streaming.dense_retry_fn(step, b, "cpu")
    patched, sub = retry(torch.zeros_like(out), np.array([1, 2]))
    assert sub["abft_graph_flags"].shape == (2,)
    np.testing.assert_allclose(_np(patched[1:3]), _np(out[1:3]), atol=1e-6)
    assert float(patched[0].abs().sum()) == 0.0
    with pytest.raises(ValueError, match="row-stripes"):
        t_serve_mod.serve([b], tp, tcfg, verbose=False, granularity="stripe",
                          device="cpu")


def test_cli_prints_the_reference_lines_and_refuses_later_slices(capsys):
    stats = t_serve_mod.main(["--graphs", "8", "--batch", "4", "--backend",
                              "block_ell", "--block", "8", "--fused-layer",
                              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "=== serve_gcn: 8 graphs, batch 4, backend=block_ell" in out
    assert "allow_tf32=False" in out
    for line in ("served 8 graphs in 2 packed block_ell (fused-layer)",
                 "guard: steps=2 flags=0", "repair tiers: slot=0",
                 "fusion: network_hits=0 network_fallbacks=0 fused_hits=4"):
        assert line in out, line
    assert stats["graphs"] == 8 and not stats["graph_flags"].any()
    # the whole-network kernel and the surgical tiers, served
    for extra, kind in ((["--fused-network"], "(fused-network) batches"),
                        (["--check-granularity", "stripe"],
                         "[stripe corners]"),
                        (["--fused-network", "--check-granularity", "slot"],
                         "(fused-network) [slot corners]")):
        stats = t_serve_mod.main(["--graphs", "8", "--batch", "4",
                                  "--backend", "block_ell", "--block", "8",
                                  "--device", "cpu"] + extra)
        out = capsys.readouterr().out
        assert kind in out and "repair tiers: slot=0" in out, out
        assert stats["graphs"] == 8 and not stats["graph_flags"].any()
        if "--fused-network" in extra:
            assert "fusion: network_hits=2 network_fallbacks=0" in out
            assert stats["network_hits"] == 2
    for argv in (["--check-granularity", "stripe"], ["--fused-network"]):
        with pytest.raises(SystemExit):
            t_serve_mod.main(argv + ["--device", "cpu"])
        assert "needs --backend block_ell" in capsys.readouterr().err
    with pytest.raises(ValueError, match="granularity"):
        t_serve_mod.serve([], {}, TConfig(), granularity="layer",
                          device="cpu")
