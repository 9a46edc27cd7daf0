"""The port's streaming server (``repro_torch.engine.streaming``'s
``StreamingEngine``, ``plan_rungs``, ``RungTable``; ``launch/serve_stream``)
against the JAX package's, on the same submit / pump / drain sequence with
explicit clocks: the same per-request statuses and verdicts, logits within
``atol 1e-4``, the same batch, rejection, singleton, fusion and repair-tier
counts, step shapes bounded by the rung table, and at each degrade the
reference's checkpoint.  The JAX side runs its kernels in interpret mode,
the port its plain versions (``device="cpu"``)."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as j_load_checkpoint
from repro.core.abft import ABFTConfig as JConfig
from repro.core.gcn import init_gcn as j_init_gcn
from repro.engine import StreamingEngine as JEngine
from repro.engine import plan_rungs as j_plan_rungs
from repro.runtime import ABFTGuard as JGuard
from repro.runtime import GuardConfig as JGuardConfig
from repro_torch import convert
from repro_torch.checkpoint import load_checkpoint
from repro_torch.checkpoint.ckpt import _flatten
from repro_torch.core.abft import ABFTConfig as TConfig
from repro_torch.engine import (RungTable, StreamingEngine, plan_rungs,
                                synth_graph_stream)
from repro_torch.engine.streaming import Rung
from repro_torch.launch import serve_stream
from repro_torch.runtime import ABFTGuard as TGuard
from repro_torch.runtime import GuardConfig as TGuardConfig
from repro_torch.optim import tree_leaves
from repro_torch.runtime import StragglerWatchdog, UnverifiableBatch

DIMS = (8, 16, 4)
BLOCK = 8
ATOL = 1e-4
# each package folds w_r = W·e with its own sum: a few f32 roundings of
# row sums over 8 or 16 terms of |w| < 1
FOLD_RTOL = 1e-6
COUNTS = ("submitted", "served", "rejected", "rejected_oversize", "flagged",
          "batches", "singleton_dispatches", "compiles", "rung_table_size",
          "guard_flags", "guard_retries", "fused_hits", "fused_fallbacks",
          "network_hits", "network_fallbacks", "repair_tiers",
          "backend_ladder", "active_backend", "degrade_level", "degrades",
          "failovers", "dense_dispatches", "hang_flushes")


def _stream(n=12, seed=0, n_lo=10, n_hi=30):
    return synth_graph_stream(n, n_lo=n_lo, n_hi=n_hi, feat=DIMS[0],
                              seed=seed)


def _params(seed=0):
    jp = j_init_gcn(jax.random.PRNGKey(seed), DIMS)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def _engines(stream, *, n_slots=4, guard_cfg=None, ckpt=None, **kw):
    """(the reference's engine, the port's) on one stream's rungs;
    ``ckpt``: a directory under which each writes its checkpoints
    (``ref/``, ``port/``)."""
    jp, tp = _params()
    jr = j_plan_rungs(stream[:4], n_slots=n_slots, block=BLOCK)
    tr = plan_rungs(stream[:4], n_slots=n_slots, block=BLOCK)
    jg = JGuard(JGuardConfig(**guard_cfg)) if guard_cfg else JGuard()
    tg = TGuard(TGuardConfig(**guard_cfg)) if guard_cfg else TGuard()
    jkw, tkw = dict(kw), dict(kw)
    if ckpt is not None:
        jkw["checkpoint_dir"] = str(ckpt / "ref")
        tkw["checkpoint_dir"] = str(ckpt / "port")
    return (JEngine(jp, JConfig(), jr, guard=jg, **jkw),
            StreamingEngine(tp, TConfig(), tr, guard=tg, device="cpu", **tkw))


def _drive(engine, stream, dt=0.01):
    """Submit every request at a fixed clock step, pumping between
    arrivals, then drain: the same sequence for either engine."""
    results, now = [], 0.0
    for s, h0 in stream:
        engine.submit(s, h0, now=now)
        now += dt
        engine.pump(now=now)
        results.extend(engine.take_results())
    results.extend(engine.drain(now=now))
    return results


def _same(jres, tres, jeng, teng):
    assert [r.rid for r in tres] == [r.rid for r in jres]
    for j, t in zip(jres, tres):
        assert (t.status, t.flag) == (j.status, j.flag), t.rid
        assert (t.logits is None) == (j.logits is None), t.rid
        if j.logits is not None:
            np.testing.assert_allclose(t.logits, j.logits, atol=ATOL,
                                       err_msg=f"rid {t.rid}")
        np.testing.assert_allclose(t.max_rel, j.max_rel, atol=1e-5)
    jstats, tstats = jeng.stats(jres), teng.stats(tres)
    for key in COUNTS:
        assert tstats[key] == jstats[key], key
    return tstats


def test_plan_rungs_and_fit_match_reference():
    stream = _stream(40, seed=3, n_lo=6, n_hi=60)
    for n_slots, max_rungs in ((4, 4), (8, 2), (1, 4)):
        j = j_plan_rungs(stream[:16], n_slots=n_slots, block=BLOCK,
                         max_rungs=max_rungs)
        t = plan_rungs(stream[:16], n_slots=n_slots, block=BLOCK,
                       max_rungs=max_rungs)
        assert [vars(r) for r in t.rungs] == [vars(r) for r in j.rungs]
        assert (t.block, t.stripe_multiple, t.width_multiple, len(t)) == \
            (j.block, j.stripe_multiple, j.width_multiple, len(j))
        for stripes in (1, 5, 9, 17, 33, 200):
            for width in (1, 4, 5):
                a, b = t.fit(stripes, width), j.fit(stripes, width)
                assert (a is None) == (b is None)
                if a is not None:
                    assert vars(a) == vars(b)
    with pytest.raises(ValueError, match="profile"):
        plan_rungs([], n_slots=4)
    with pytest.raises(ValueError, match="n_slots"):
        plan_rungs(stream[:2], n_slots=0)
    table = RungTable(rungs=(Rung(8, 4, 4), Rung(16, 4, 4)), block=BLOCK)
    assert table.fit(9, 4) == table.rungs[1] and table.fit(4, 5) is None


@pytest.mark.parametrize("path,granularity", [
    ({}, "graph"), ({"fused_layer": True}, "stripe"),
    ({"fused_network": True}, "graph"), ({"fused_network": True}, "slot")],
    ids=["two-pass", "fused-layer-stripe", "network", "network-slot"])
def test_stream_matches_reference(path, granularity):
    stream = _stream(12)
    jeng, teng = _engines(stream, flush_deadline=0.025,
                          granularity=granularity, **path)
    assert teng.warmup() == jeng.warmup() == len(teng.rungs)
    tres = _drive(teng, stream)
    jres = _drive(jeng, stream)
    stats = _same(jres, tres, jeng, teng)
    assert stats["served"] == 12 and stats["flagged"] == 0
    assert stats["compiles"] <= stats["rung_table_size"]
    if path.get("fused_network"):
        assert stats["network_hits"] == stats["batches"] > 0


@pytest.mark.parametrize("path", [{}, {"fused_network": True}],
                         ids=["two-pass", "network"])
def test_sticky_fault_degrades_the_ladder_like_the_reference(path,
                                                             tmp_path):
    """A stuck accumulator in the level-0 backend: retries re-execute
    through the same poisoned backend, the guard escalates with no restore
    path, and the engine fails the batch over down its ladder — every
    request is still served, with the same verdicts as the reference.  At
    every degrade both engines checkpoint their folded params: the same
    step dirs with the same ``extra``; the weights bit for bit, each
    package's own fold of ``w_r`` within ``FOLD_RTOL``."""
    stream = _stream(12)
    jeng, teng = _engines(stream, inject=(0, 0, 0, 100.0),
                          guard_cfg=dict(max_retries=1, max_restores=1,
                                         persistent_window=4,
                                         persistent_threshold=2),
                          ckpt=tmp_path, **path)
    tres = _drive(teng, stream)
    jres = _drive(jeng, stream)
    stats = _same(jres, tres, jeng, teng)
    assert stats["served"] == stats["submitted"] == 12
    assert stats["degrades"] >= 1 and stats["failovers"] >= 1
    assert not any(r.flag for r in tres)
    steps = [sorted(d for d in os.listdir(tmp_path / who)
                    if d.startswith("step_")) for who in ("ref", "port")]
    assert steps[0] == steps[1] and 1 <= len(steps[1]) <= stats["degrades"]
    for step in steps[1]:
        ref, port = (json.load(open(tmp_path / who / step / "manifest.json"))
                     for who in ("ref", "port"))
        assert port == ref
        assert port["extra"]["backend"] in stats["backend_ladder"]
        assert port["extra"]["degrade_level"] < stats["degrade_level"]
    jsaved, jstep = j_load_checkpoint(str(tmp_path / "ref"), jeng.params)
    tsaved, tstep = load_checkpoint(str(tmp_path / "port"), teng.params)
    assert tstep == jstep == int(steps[1][-1][len("step_"):])
    jleaves = jax.tree_util.tree_flatten_with_path(jsaved)[0]
    tleaves = _flatten(tsaved)
    assert [k for k, _ in tleaves] == [
        "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in kp)
        for kp, _ in jleaves]
    for (key, t), (_, j) in zip(tleaves, jleaves):
        if key.endswith("w_r"):
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       rtol=FOLD_RTOL, atol=FOLD_RTOL)
        else:
            assert t.numpy().tobytes() == np.asarray(j).tobytes(), key
    for (_, t), want in zip(tleaves, tree_leaves(teng.params)):
        assert torch.equal(t, want)


@pytest.mark.parametrize("granularity,tier", [
    ("graph", "retry_fn"), ("stripe", "stripe_retry_fn"),
    ("slot", "slot_retry_fn")])
def test_kernel_failure_inside_a_repair_reaches_the_caller(granularity, tier):
    """A kernel that fails to build or launch inside a repair is no verdict
    on the batch: the engine raises it and does not degrade to plainer
    kernels (only the guard's own refusal, UnverifiableBatch, does)."""
    stream = _stream(4)
    _j, eng = _engines(stream, fused_network=True, granularity=granularity,
                       inject=(0, 0, 0, 100.0))

    def refused(pb):
        def fn(*args):
            raise RuntimeError("gcn_fused_kernel: kernel launch refused")
        return fn
    setattr(eng.runner, tier, refused)
    with pytest.raises(RuntimeError, match="launch refused") as err:
        _drive(eng, stream)
    assert not isinstance(err.value, UnverifiableBatch)
    assert eng.degrades == eng.failovers == 0
    assert eng.stats()["active_backend"] == eng.stats()["backend_ladder"][0]


def test_guard_refusal_is_its_own_exception():
    guard = TGuard(TGuardConfig(max_retries=1))

    def retry(out, idx):
        return out, {"abft_graph_flags": torch.ones(len(idx),
                                                    dtype=torch.bool)}
    metrics = {"abft_graph_flags": torch.tensor([True, False])}
    with pytest.raises(UnverifiableBatch, match="no replay"):
        guard.adjudicate(torch.zeros(2, 3), metrics, retry)
    assert issubclass(UnverifiableBatch, RuntimeError)


def test_backpressure_rejects_like_the_reference():
    stream = _stream(10, seed=5)
    jeng, teng = _engines(stream, n_slots=8, queue_capacity=2)
    for eng in (jeng, teng):
        for s, h0 in stream:
            eng.submit(s, h0, now=0.0)
    tres, jres = teng.drain(now=1.0), jeng.drain(now=1.0)
    stats = _same(jres, tres, jeng, teng)
    assert stats["rejected"] == 8 and stats["served"] == 2
    assert all("queue full" in r.reason for r in tres
               if r.status == "rejected")


@pytest.mark.parametrize("policy", ["singleton", "reject"])
def test_oversize_requests_like_the_reference(policy):
    stream = list(_stream(8, seed=6, n_lo=6, n_hi=20))
    big = synth_graph_stream(1, n_lo=200, n_hi=200, feat=DIMS[0],
                             seed=105)[0]
    jeng, teng = _engines(stream, oversize_policy=policy)
    tres = _drive(teng, stream[:4] + [big] + stream[4:])
    jres = _drive(jeng, stream[:4] + [big] + stream[4:])
    stats = _same(jres, tres, jeng, teng)
    big_res = {r.rid: r for r in tres}[4]     # results come in verdict order
    if policy == "singleton":
        assert big_res.status == "served" and stats["singleton_dispatches"]
        assert stats["compiles"] <= stats["rung_table_size"] + 1
    else:
        assert big_res.status == "rejected_oversize"
        assert stats["rejected_oversize"] == 1


def test_deadline_flush_and_hang_timeout():
    stream = _stream(4, seed=7)
    t = {"now": 0.0}
    _jeng, eng = _engines(stream, flush_deadline=1.0, hang_timeout=5.0,
                          watchdog=StragglerWatchdog(warmup=1),
                          clock=lambda: t["now"])
    eng.submit(*stream[0])
    assert eng.batches_dispatched == 0           # bin open, under deadline
    t["now"] = 1.5
    eng.pump()                                   # deadline: seal + dispatch
    assert eng.batches_dispatched == 1 and eng._inflight is not None
    t["now"] = 10.0                              # the dispatch "hangs"
    eng.pump()
    assert eng.hang_flushes == 1 and eng._inflight is None
    results = eng.take_results() + eng.drain()
    assert [r.status for r in results] == ["served"]
    assert results[0].latency == pytest.approx(10.0)


def test_dense_fallback_matches_packed_logits():
    stream = _stream(6)
    _j, packed = _engines(stream)
    _j, dense = _engines(stream)
    while not dense._active_dense():
        dense._degrade("test: force dense")
    rp = {r.rid: r for r in _drive(packed, stream)}
    rd = {r.rid: r for r in _drive(dense, stream)}
    assert dense.stats()["active_backend"] == "dense"
    assert dense.dense_dispatches >= 1
    for rid in rp:
        assert rp[rid].status == rd[rid].status == "served"
        assert not rd[rid].flag
        np.testing.assert_allclose(rp[rid].logits, rd[rid].logits,
                                   atol=2e-5, rtol=2e-4)


def test_options_that_need_later_slices_raise():
    stream = _stream(2)
    _jp, tp = _params()
    rungs = plan_rungs(stream, n_slots=2, block=BLOCK)
    for bad in (dict(oversize_policy="explode"), dict(granularity="layer"),
                dict(queue_capacity=0), dict(hang_timeout=0.0)):
        with pytest.raises(ValueError):
            StreamingEngine(tp, TConfig(), rungs, device="cpu", **bad)


def test_engine_selfcheck_repairs_corrupted_fold_midstream():
    """A NaN stuck in layer 0's folded w_r, in both engines mid-stream:
    the periodic self-check finds it, refolds, discards the runners that
    captured the stale fold, and every request is served — with the same
    statuses, flags and counters as the reference."""
    from repro.faults import FaultInjector as JInjector
    from repro.faults import FaultModel as JModel
    from repro.faults import verify_w_r as j_verify_w_r
    from repro_torch.faults import FaultInjector, FaultModel, verify_w_r

    stream = _stream(12)
    jeng, teng = _engines(stream, selfcheck_interval=1)
    for eng, inj, verify in (
            (jeng, JInjector(JModel(site="w_r", kind="stuck",
                                    stuck_value=float("nan"))),
             j_verify_w_r),
            (teng, FaultInjector(FaultModel(site="w_r", kind="stuck",
                                            stuck_value=float("nan"))),
             verify_w_r)):
        assert inj.fires(0)
        eng.params = inj.apply_params(eng.params)
        assert verify(eng.params, eng.cfg) == [0]
    stale = teng._level_runners[0]
    jres, tres = _drive(jeng, stream), _drive(teng, stream)
    stats = _same(jres, tres, jeng, teng)
    jstats = jeng.stats(jres)
    for key in ("selfcheck_runs", "selfcheck_trips", "selfcheck_repairs"):
        assert stats[key] == jstats[key], key
    assert stats["selfcheck_trips"] >= 1
    assert stats["selfcheck_repairs"] >= 1
    assert verify_w_r(teng.params, teng.cfg) == []     # refolded
    assert all(r is not stale for r in teng._level_runners.values())
    assert stats["served"] == len(stream)
    assert all(r.status == "served" for r in tres)


def test_selfcheck_interval_validation():
    stream = _stream(4)
    _jp, tp = _params()
    rungs = plan_rungs(stream, n_slots=4, block=BLOCK)
    with pytest.raises(ValueError):
        StreamingEngine(tp, TConfig(), rungs, selfcheck_interval=0,
                        device="cpu")
    with pytest.raises(ValueError):
        StreamingEngine(tp, TConfig(), rungs, hang_timeout=0.0,
                        device="cpu")


def test_stats_surface_the_selfcheck_counters():
    stream = _stream(4)
    jeng, teng = _engines(stream)
    stats = _same(_drive(jeng, stream), _drive(teng, stream), jeng, teng)
    for key in ("repair_tiers", "backend_ladder", "active_backend",
                "degrade_level", "degrades", "failovers",
                "dense_dispatches", "hang_flushes", "watchdog_events",
                "selfcheck_runs", "selfcheck_trips", "selfcheck_repairs"):
        assert key in stats, key
    assert stats["selfcheck_runs"] == stats["selfcheck_trips"] == 0
    assert stats["selfcheck_repairs"] == 0


def test_step_never_synchronizes_and_params_move_to_the_device():
    """Dispatch only enqueues: the first host read of a batch is the
    guard's adjudication.  The engine holds its params on its device."""
    stream = _stream(4)
    _j, eng = _engines(stream, fused_network=True)
    assert all(layer["w"].device == torch.device("cpu")
               for layer in eng.params["layers"])
    seen = []
    real = eng.guard.adjudicate

    def spy(out, metrics, *a, **kw):
        seen.append(isinstance(metrics["abft_graph_flags"], torch.Tensor))
        return real(out, metrics, *a, **kw)
    eng.guard.adjudicate = spy
    for s, h0 in stream:
        eng.submit(s, h0, now=0.0)
    assert eng._inflight is not None and not seen   # dispatched, unread
    eng.drain(now=0.0)
    assert seen == [True]


def test_cli_serves_and_asserts_bounded_step_shapes(capsys):
    stats = serve_stream.main(["--graphs", "24", "--slots", "4", "--block",
                               "8", "--fused-network", "--check-granularity",
                               "slot", "--assert-bounded-compiles",
                               "--device", "cpu"])
    out = capsys.readouterr().out
    assert "=== serve_stream: 24 requests, slots 4, block 8" in out
    for line in ("served 24/24 requests", "latency enqueue->verdict: p50",
                 "distinct step shapes vs rung table", "repair tiers: slot=0",
                 "fusion: network_hits="):
        assert line in out, line
    assert stats["served"] == 24 and stats["compiles"] <= \
        stats["rung_table_size"]
    assert stats["network_hits"] == stats["batches"]
