"""The port's fault stack (``repro_torch.faults`` and
``repro_torch.launch.campaign``) against the JAX package's ``repro.faults``.

* the fault-model grids are the same models (``to_dict`` lists equal);
* the injectors corrupt the same coordinates to the same bits — every
  site, kind and bit (0–31 of an f32, 0–63 of an f64, the sign bits
  included) — numpy operands on the reference side, torch tensors (cloned
  on their device, the master untouched) on the port's;
* the check-path self-check gives the same verdicts and cadence;
* the GCN campaign gives equal payloads (every step list, the detection,
  latency, self-check, would-be-false-negative and escalation verdicts,
  the repair tiers, the aggregates and the clean control) on the
  reference's six-model fixture and on the smoke grid;
* the LM campaign, on smoke-sized gemma-2b with the reference's master
  carried across by ``convert.lm_params_from_numpy``, classifies every
  ``lm_sweep_models(reps=1)`` model as the reference does, its clean
  trajectory's logits within ``atol 1e-4``;
* only the guard's ``UnverifiableBatch`` counts as an escalation: a
  kernel-wrapper error raised inside a campaign step reaches the caller.

The reference runs its Pallas kernels in interpret mode, the port its plain
versions (``device="cpu"``); one ``cuda``-marked case runs the GCN smoke
campaign on the card."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as J
from repro.core.abft import ABFTConfig as JConfig
from repro_torch import convert
from repro_torch import faults as T
from repro_torch.core.abft import ABFTConfig as TConfig
from repro_torch.faults import campaign as t_campaign
from repro_torch.faults.injectors import flip_bits_tensor
from repro_torch.faults.model import lm_sweep_models as t_lm_sweep
from repro_torch.launch import campaign as t_cli
from repro_torch.runtime import UnverifiableBatch

ATOL = 1e-4


def _pair(**kw):
    return J.FaultModel(**kw), T.FaultModel(**kw)


def _bits(a) -> np.ndarray:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    if a.dtype.kind == "f":
        return a.view({4: np.uint32, 8: np.uint64}[a.dtype.itemsize])
    return a


def _same_bits(t, j):
    np.testing.assert_array_equal(_bits(t), _bits(j))


# ---------------------------------------------------------------------------
# fault models
# ---------------------------------------------------------------------------

def test_model_grids_equal_the_reference():
    from repro.faults.model import lm_sweep_models as j_lm_sweep
    for kw in ({}, {"reps": 1}, {"reps": 3, "step": 2, "bit": 7, "seed": 5}):
        assert [m.to_dict() for m in T.sweep_models(**kw)] == \
            [m.to_dict() for m in J.sweep_models(**kw)]
        assert [m.to_dict() for m in t_lm_sweep(**kw)] == \
            [m.to_dict() for m in j_lm_sweep(**kw)]
    for name in ("SITES", "KINDS", "TIMINGS", "CHECK_PATH_SITES",
                 "CONSISTENT_SITES"):
        assert getattr(T, name) == getattr(J, name)
    m = T.FaultModel(site="w_r", kind="stuck", stuck_value=float("nan"))
    assert m.sticky and m.check_path and m.to_dict()["stuck_value"] == "nan"


@pytest.mark.parametrize("bad", [
    dict(site="nonsense"), dict(site="weights", kind="nonsense"),
    dict(site="weights", timing="nonsense"),
    dict(site="weights", timing="bernoulli", p=0.0),
    dict(site="weights", bit=64), dict(site="weights", kind="multi"),
    dict(site="weights", n_upsets=2), dict(site="weights", stuck_value=1.0),
    dict(site="accumulator", delta=float("inf"))])
def test_model_validation_equals_the_reference(bad):
    for cls in (J.FaultModel, T.FaultModel):
        with pytest.raises(ValueError):
            cls(**bad)


# ---------------------------------------------------------------------------
# injectors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.int64])
def test_flip_bits_tensor_equals_flip_bits(dtype):
    rng = np.random.default_rng(0)
    a = (rng.normal(size=(3, 5)) * 10).astype(dtype)
    width = 8 * a.dtype.itemsize
    # numpy's integer flip cannot build the sign-bit mask of its own width
    bits = range(width) if a.dtype.kind == "f" else range(width - 1)
    for bit in bits:
        for idx in (0, 7, 14):
            want = J.flip_bits(a, idx, bit)
            got = flip_bits_tensor(torch.from_numpy(a), idx, bit)
            assert got.dtype == torch.from_numpy(a).dtype
            _same_bits(got, want)
            _same_bits(T.flip_bits(a, idx, bit), want)
            back = flip_bits_tensor(got, idx, bit)
            _same_bits(back, a)                 # an involution


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["bitflip", "stuck", "multi"])
def test_corrupt_array_at_every_bit(dtype, kind):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(6, 7)).astype(dtype)
    master = torch.from_numpy(a.copy())
    for bit in range(8 * a.dtype.itemsize):
        extra = {"n_upsets": 3} if kind == "multi" else {}
        jm, tm = _pair(site="weights", kind=kind, bit=bit, seed=bit,
                       **extra)
        ji, ti = J.FaultInjector(jm), T.FaultInjector(tm)
        assert ji.fires(0) == ti.fires(0)
        for _step in range(2):      # the second pass re-applies a latch
            want = ji.corrupt_array("w", a)
            got = ti.corrupt_array("w", master)
            assert got.dtype == master.dtype
            _same_bits(got, want)
        assert [i for i, _ in ti._stuck.get("w", [])] == \
            [int(i) for i, _ in ji._stuck.get("w", [])]
    np.testing.assert_array_equal(master.numpy(), a)     # master intact


def _gcn_trees():
    """Folded GCN params, each package folded by its own ``fold_w_r`` (the
    two folds sum in different orders: the injector comparisons below
    start the reference from the port's bits)."""
    from repro.engine.api import fold_w_r as j_fold
    from repro_torch.engine.api import fold_w_r as t_fold
    rng = np.random.default_rng(0)
    p = {"layers": [
        {"w": (rng.normal(size=(5, 6)) * 0.3).astype(np.float32),
         "b": np.zeros(6, np.float32)},
        {"w": (rng.normal(size=(6, 3)) * 0.3).astype(np.float32),
         "b": np.zeros(3, np.float32)}]}
    jp = j_fold(p, JConfig())
    tp = t_fold(convert.params_from_numpy(p, device="cpu"), TConfig())
    return jp, tp


KIND_VARIANTS = [dict(kind="bitflip"), dict(kind="stuck"),
                 dict(kind="stuck", stuck_value=float("nan")),
                 dict(kind="stuck", stuck_value=7.0),
                 dict(kind="multi", n_upsets=2)]


@pytest.mark.parametrize("site", ["weights", "w_r", "features",
                                  "cols_table", "s_c"])
@pytest.mark.parametrize("variant", range(len(KIND_VARIANTS)))
def test_gcn_site_hooks_equal_the_reference(site, variant):
    from repro.engine.api import Graph as JGraph
    from repro_torch.engine.api import Graph as TGraph
    kw = KIND_VARIANTS[variant]
    _jp, tp = _gcn_trees()
    jp = convert.params_to_numpy(tp)
    rng = np.random.default_rng(2)
    cols = (np.arange(24, dtype=np.int32).reshape(4, 6) % 5)
    h0 = rng.normal(size=(9, 5)).astype(np.float32)
    s = np.abs(rng.normal(size=(9, 9))).astype(np.float32)
    s_c = s.sum(axis=0)
    t_cols, t_h0 = torch.from_numpy(cols.copy()), torch.from_numpy(h0.copy())
    for layer in (0, 1):
        jm, tm = _pair(site=site, layer=layer, bit=29, seed=4 + layer, **kw)
        ji, ti = J.FaultInjector(jm), T.FaultInjector(tm)
        for t in range(3):
            assert ji.fires(t) == ti.fires(t)
            jq, tq = ji.apply_params(jp), ti.apply_params(tp)
            for jl, tl in zip(jq["layers"], tq["layers"]):
                _same_bits(tl["w"], jl["w"])
                _same_bits(tl["w_r"], jl["w_r"])
            if site == "cols_table" and kw.get("stuck_value") is not None \
                    and math.isnan(kw["stuck_value"]):
                # no column index is stuck at NaN: both refuse alike
                for inj, c, h in ((ji, cols, h0), (ti, t_cols, t_h0)):
                    with pytest.raises(ValueError):
                        inj.apply_batch(c, None, h)
                break
            jc, _, jh = ji.apply_batch(cols, None, h0)
            tc, _, th = ti.apply_batch(t_cols, None, t_h0)
            assert isinstance(tc, torch.Tensor) and tc.dtype == torch.int32
            _same_bits(tc, jc)
            _same_bits(th, jh)
            jg = ji.apply_graph(JGraph(s=s, h0=h0, s_c=s_c.copy()))
            tg = ti.apply_graph(TGraph(s=torch.from_numpy(s),
                                       h0=t_h0, s_c=torch.from_numpy(s_c)))
            assert isinstance(tg.s_c, torch.Tensor)
            _same_bits(tg.s_c, jg.s_c)
            assert ji.kernel_inject() == ti.kernel_inject()
        # the masters were never written
        np.testing.assert_array_equal(t_cols.numpy(), cols)
        np.testing.assert_array_equal(t_h0.numpy(), h0)
    _j, fresh = _gcn_trees()
    for a, b in zip(tp["layers"], fresh["layers"]):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["w_r"],
                                                            b["w_r"])


def _lm_tree(seed=0):
    rng = np.random.default_rng(seed)
    unit = {"attn": {"wq": {"w": rng.normal(size=(3, 4, 2, 5))
                            .astype(np.float32)}},
            "mlp": {"wi": {"w": rng.normal(size=(3, 4, 2, 6))
                           .astype(np.float32)}}}
    return {"segments": [{"b0": unit}]}


@pytest.mark.parametrize("site", ["qkv_w", "mlp_w", "attn_accumulator"])
@pytest.mark.parametrize("variant", range(len(KIND_VARIANTS)))
def test_lm_site_hooks_equal_the_reference(site, variant):
    kw = KIND_VARIANTS[variant]
    if site == "attn_accumulator" and kw.get("stuck_value") is not None:
        kw = {"kind": "stuck"}
    jtree = _lm_tree()
    ttree = convert.params_from_numpy(_lm_tree(), device="cpu")
    for layer in (0, 2):
        jm, tm = _pair(site=site, layer=layer, bit=31, seed=layer, **kw)
        ji, ti = J.FaultInjector(jm), T.FaultInjector(tm)
        for t in range(3):
            assert ji.fires(t) == ti.fires(t)
            jq, tq = ji.apply_lm_params(jtree), ti.apply_lm_params(ttree)
            for blk, name in (("attn", "wq"), ("mlp", "wi")):
                got = tq["segments"][0]["b0"][blk][name]["w"]
                assert isinstance(got, torch.Tensor)
                _same_bits(got, jq["segments"][0]["b0"][blk][name]["w"])
            assert ji.lm_inject() == ti.lm_inject()
    for blk, name in (("attn", "wq"), ("mlp", "wi")):     # master intact
        np.testing.assert_array_equal(
            ttree["segments"][0]["b0"][blk][name]["w"].numpy(),
            _lm_tree()["segments"][0]["b0"][blk][name]["w"])


def test_timing_equals_the_reference():
    for kw in (dict(kind="bitflip", step=2), dict(kind="stuck", step=2),
               dict(timing="bernoulli", p=0.3, seed=1),
               dict(kind="stuck", timing="bernoulli", p=0.2, seed=9)):
        jm, tm = _pair(site="weights", **kw)
        ji, ti = J.FaultInjector(jm), T.FaultInjector(tm)
        want = [ji.fires(i) for i in range(16)]
        assert [ti.fires(i) for i in range(16)] == want
        assert [ti.fires(i) for i in range(16)] == \
            [ji.fires(i) for i in range(16)]
        assert ti.first_fired_step == ji.first_fired_step


# ---------------------------------------------------------------------------
# the check-path self-check
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("corrupt", [
    dict(site="w_r", kind="bitflip", layer=1),
    dict(site="w_r", kind="stuck", stuck_value=float("nan"), layer=0),
    dict(site="w_r", kind="stuck", stuck_value=0.0, layer=1),
    dict(site="weights", kind="bitflip", layer=0)])
def test_selfcheck_verdicts_equal_the_reference(corrupt):
    jp, tp = _gcn_trees()
    jcfg, tcfg = JConfig(threshold=1e-3), TConfig(threshold=1e-3)
    assert T.verify_w_r(tp, tcfg) == J.verify_w_r(jp, jcfg) == []
    jm, tm = _pair(**corrupt)
    ji, ti = J.FaultInjector(jm), T.FaultInjector(tm)
    assert ji.fires(0) and ti.fires(0)
    jbad, tbad = ji.apply_params(jp), ti.apply_params(tp)
    want = J.verify_w_r(jbad, jcfg)
    assert T.verify_w_r(tbad, tcfg) == want == [corrupt["layer"]]
    jsc, tsc = J.CheckPathSelfCheck(jcfg, 1), T.CheckPathSelfCheck(tcfg, 1)
    assert tsc.maybe_check(tbad, 0) == jsc.maybe_check(jbad, 0)
    assert (tsc.trips, tsc.last_bad) == (jsc.trips, jsc.last_bad)
    assert T.verify_w_r(tsc.repair(tbad), tcfg) == []
    assert T.verify_w_r(T.refold(tbad, tcfg), tcfg) == []
    assert T.verify_w_r(tp, TConfig(mode="none")) == []


def test_selfcheck_cadence_equals_the_reference():
    jp, tp = _gcn_trees()
    jsc = J.CheckPathSelfCheck(JConfig(), interval=4)
    tsc = T.CheckPathSelfCheck(TConfig(), interval=4)
    ran = [tsc.maybe_check(tp, t) is not None for t in range(9)]
    assert ran == [jsc.maybe_check(jp, t) is not None for t in range(9)]
    assert ran == [True, False, False, False, True, False, False, False,
                   True]
    assert (tsc.checks_run, tsc.trips) == (jsc.checks_run, jsc.trips) \
        == (3, 0)
    with pytest.raises(ValueError):
        T.CheckPathSelfCheck(TConfig(), interval=0)


@pytest.mark.parametrize("stuck", [float("nan"), 3.0, None])
def test_s_c_selfcheck_equals_the_reference(stuck):
    from repro.core.abft import sparse_col_checksum
    from repro.engine.api import Graph as JGraph
    from repro_torch.core.checksum import col_checksum
    from repro_torch.engine.api import Graph as TGraph
    s = np.abs(np.random.default_rng(3).normal(size=(6, 6))) \
        .astype(np.float32)
    jg = JGraph(s=jnp.asarray(s), h0=jnp.ones((6, 4), jnp.float32),
                s_c=sparse_col_checksum(jnp.asarray(s), jnp.float32))
    ts = torch.from_numpy(s)
    tg = TGraph(s=ts, h0=torch.ones(6, 4), s_c=col_checksum(ts,
                                                            torch.float32))
    assert not T.verify_s_c(tg, TConfig()) and not J.verify_s_c(jg,
                                                                 JConfig())
    kind = "bitflip" if stuck is None else "stuck"
    jm, tm = _pair(site="s_c", kind=kind, stuck_value=stuck, seed=2)
    ji, ti = J.FaultInjector(jm), T.FaultInjector(tm)
    assert ji.fires(0) and ti.fires(0)
    ji.apply_graph(jg)
    ti.apply_graph(tg)
    assert T.verify_s_c(tg, TConfig()) == J.verify_s_c(jg, JConfig()) \
        is True


# ---------------------------------------------------------------------------
# the GCN campaign
# ---------------------------------------------------------------------------

def _six(mod):
    """The reference test's fixture models (``tests/test_faults.py``)."""
    M = mod.FaultModel
    return [
        M(site="accumulator", kind="bitflip", step=1, delta=100.0),
        M(site="accumulator", kind="stuck", step=1, delta=100.0),
        M(site="weights", kind="stuck", step=1, stuck_value=7.0, seed=2),
        M(site="features", kind="bitflip", step=1, bit=30, seed=3),
        M(site="w_r", kind="stuck", step=1, stuck_value=float("nan"),
          seed=6),
        M(site="s_c", kind="stuck", step=1, stuck_value=float("nan"),
          seed=7)]


def _same_payload(tp, jp):
    assert tp["experiments"] == jp["experiments"]
    for key in ("by_site_kind", "clean_control", "repair_tiers_total",
                "config", "benchmark"):
        assert tp[key] == jp[key], key


@pytest.fixture(scope="module")
def six_payloads():
    return (t_campaign.run_fault_campaign(_six(T), n_steps=4, device="cpu"),
            J.run_fault_campaign(_six(J), n_steps=4))


def test_gcn_campaign_equals_the_reference(six_payloads):
    tp, jp = six_payloads
    _same_payload(tp, jp)
    assert (tp["backend"], tp["device"], tp["interpret"],
            tp["authoritative"]) == ("cpu", "cpu", True, False)


def test_gcn_campaign_verdicts(six_payloads):
    """The reference test's assertions, on the port's payload."""
    tp, _ = six_payloads
    for kind in ("bitflip", "stuck"):
        agg = tp["by_site_kind"][f"accumulator/{kind}"]
        assert agg["detection_rate"] == 1.0
        assert agg["mean_detection_latency"] == 0.0
    assert tp["by_site_kind"]["accumulator/stuck"]["escalations"] == 1
    assert tp["clean_control"] == {"flagged": 0, "false_positive_rate": 0.0}
    for site in ("w_r", "s_c"):
        [e] = [e for e in tp["experiments"] if e["model"]["site"] == site]
        assert e["would_be_false_negative"] and e["selfcheck_detected"]
        assert e["naive_flagged_steps"] == [] and e["flagged_steps"]
        assert e["false_positive_steps"]
    [e] = [e for e in tp["experiments"] if e["model"]["site"] == "weights"]
    assert e["escalated"] and e["repair_tiers"]["persistent_sites"]
    assert tp["repair_tiers_total"]["graph"] > 0


def test_gcn_campaign_reports_its_clean_checks(six_payloads):
    """The payload's clean per-graph checks are those of a fresh clean
    forward on the same workload, each held to tau * max(1, |actual|)."""
    from repro_torch.engine.api import Graph, gcn_forward
    from repro_torch.engine.backends import BlockEllBackend

    clean = six_payloads[0]["clean_checks"]
    params, cfg, _items, st = t_campaign.gcn_workload(device="cpu")
    bk = BlockEllBackend.from_staged(st.cols, st.vals, st.segments,
                                     st.pb.n_slots, cfg)
    _, checks = gcn_forward(params, Graph(s=None, h0=st.h0), cfg,
                            backend=bk)
    assert clean["stripe_graph"] == st.pb.stripe_graph.tolist()
    assert len(clean["actual"]) == len(checks) == 2
    for layer, c in enumerate(checks):
        actual = c.actual.numpy()
        assert actual.shape == (st.pb.n_slots,)
        np.testing.assert_array_equal(
            np.asarray(clean["actual"][layer], actual.dtype), actual)
        assert clean["threshold"][layer] == (
            cfg.threshold * np.maximum(1.0, np.abs(actual))).tolist()


def test_gcn_smoke_grid_equals_the_reference():
    tp = t_campaign.run_fault_campaign(T.sweep_models(reps=1),
                                       device="cpu")
    jp = J.run_fault_campaign(J.sweep_models(reps=1))
    _same_payload(tp, jp)


def test_a_wrapper_error_inside_a_campaign_step_reaches_the_caller(
        monkeypatch):
    """Only the guard's refusal is an escalation: a kernel that fails to
    launch during the retry must not be counted as one."""
    from repro_torch.kernels.spmm_abft import ops
    real, calls = ops.spmm_abft_packed, []

    def failing(*args, **kw):
        calls.append(1)
        if len(calls) > 4:          # the flagged step's retry
            raise RuntimeError("spmm_abft: launch failed")
        return real(*args, **kw)

    monkeypatch.setattr(ops, "spmm_abft_packed", failing)
    with pytest.raises(RuntimeError, match="launch failed") as err:
        t_campaign.run_fault_campaign(
            [T.FaultModel(site="accumulator", step=1, delta=100.0)],
            n_steps=2, device="cpu")
    assert not isinstance(err.value, UnverifiableBatch)
    assert len(calls) == 5


def test_cli_smoke_gates_exit_zero(capsys):
    payload = t_cli.main(["--device", "cpu", "--smoke", "--assert-gates",
                          "--json", ""])
    out = capsys.readouterr().out
    assert "gates: accumulator detection 100%" in out
    assert not t_cli.gate_failures(payload, "gcn")
    bad = {**payload, "clean_control": {"flagged": 1}}
    assert t_cli.gate_failures(bad, "gcn")


def test_cli_writes_its_own_json_name(tmp_path, monkeypatch):
    import json
    monkeypatch.chdir(tmp_path)
    t_cli.main(["--device", "cpu", "--smoke", "--steps", "2"])
    [path] = list(tmp_path.iterdir())
    assert path.name == "BENCH_torch_fault_campaign.json"
    assert json.loads(path.read_text())["benchmark"] == "fault_campaign"


def test_campaign_raises_without_a_gpu_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_campaign.run_fault_campaign([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_campaign.run_lm_fault_campaign([])


@pytest.mark.cuda
def test_gcn_smoke_campaign_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import runtime
    runtime.reset_counts()
    payload = t_campaign.run_fault_campaign(T.sweep_models(reps=1),
                                            device="cuda")
    assert runtime.launch_counts()["spmm_abft"] > 0
    assert payload["authoritative"] and not payload["interpret"]
    assert not t_cli.gate_failures(payload, "gcn")
    cpu = t_campaign.run_fault_campaign(T.sweep_models(reps=1),
                                        device="cpu")
    for e, c in zip(payload["experiments"], cpu["experiments"]):
        for key in ("flagged_steps", "detected", "escalated",
                    "selfcheck_detected", "would_be_false_negative"):
            assert e[key] == c[key], (e["label"], key)


# ---------------------------------------------------------------------------
# the LM campaign
# ---------------------------------------------------------------------------

PROMPT, CACHE, N_DECODE = 8, 32, 3


@pytest.fixture(scope="module")
def lm_lanes():
    from repro.configs import get_config as jget_config
    from repro.configs import smoke_config as jsmoke_config
    from repro.engine.lm import fold_lm_w_r as jfold
    from repro.engine.lm import make_guarded_decode_step as jdec
    from repro.engine.lm import make_guarded_prefill_step as jpre
    from repro.models.transformer import init_model as jinit_model
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.engine.lm import (fold_lm_w_r, make_guarded_decode_step,
                                       make_guarded_prefill_step)

    jcfg = jsmoke_config(jget_config("gemma-2b"))
    cfg = smoke_config(get_config("gemma-2b"))
    jmaster = jinit_model(jcfg, jax.random.PRNGKey(0))
    master = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jmaster),
                                          cfg, device="cpu")
    jabft = JConfig(mode="fused", dtype=jnp.float32, threshold=1e-3)
    abft = TConfig(mode="fused", threshold=1e-3)
    tokens = np.random.default_rng(0).integers(
        1, cfg.vocab_size, size=(1, PROMPT)).astype(np.int32)

    # the reference's clean trajectory, as its campaign records it
    jprefill, jdecode = jpre(jcfg, jabft, CACHE), jdec(jcfg, jabft)

    def jfold_fn(p):
        return jfold(p, jcfg, jabft)

    jtokens = jnp.asarray(tokens)
    p0 = jfold_fn(jmaster)
    (lg, states), _m = jprefill(p0, {"tokens": jtokens})
    jref_logits, jref_tokens = [np.asarray(lg)], []
    for i in range(N_DECODE):
        nxt = np.asarray(lg[:, -1].argmax(-1)).astype(np.int32)[:, None]
        jref_tokens.append(jnp.asarray(nxt))
        (lg, states), _m = jdecode(p0, states, jref_tokens[-1], PROMPT + i)
        jref_logits.append(np.asarray(lg))

    prefill = make_guarded_prefill_step(cfg, abft, CACHE)
    decode = make_guarded_decode_step(cfg, abft)

    def fold_fn(p):
        return fold_lm_w_r(p, cfg, abft)

    ttokens = torch.from_numpy(tokens)
    ref_logits, ref_tokens, clean_flags = \
        t_campaign.lm_reference_trajectory(prefill, decode, fold_fn(master),
                                           ttokens, PROMPT, N_DECODE)
    common = dict(prompt_len=PROMPT, n_steps=1 + N_DECODE)
    return dict(
        j=dict(prefill=jprefill, decode=jdecode, master=jmaster,
               fold=jfold_fn, ref_logits=jref_logits,
               ref_tokens=jref_tokens, tokens=jtokens, **common),
        t=dict(prefill=prefill, decode=decode, master=master, fold=fold_fn,
               ref_logits=ref_logits, ref_tokens=ref_tokens,
               tokens=ttokens, **common),
        clean_flags=clean_flags)


def test_lm_clean_trajectory_matches_the_reference(lm_lanes):
    assert lm_lanes["clean_flags"] == 0
    for t, j in zip(lm_lanes["t"]["ref_logits"], lm_lanes["j"]["ref_logits"]):
        np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)
    for t, j in zip(lm_lanes["t"]["ref_tokens"], lm_lanes["j"]["ref_tokens"]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


CLASSIFY = ("fired_steps", "flagged_steps", "detected", "detection_latency",
            "sdc_steps", "masked_steps", "false_positive_steps", "escalated",
            "repair_tiers")


@pytest.mark.parametrize("index", range(5))
def test_lm_experiment_classifies_like_the_reference(lm_lanes, index):
    from repro.faults.campaign import run_lm_experiment as j_run
    from repro.faults.model import lm_sweep_models as j_lm_sweep
    jm, tm = j_lm_sweep(reps=1)[index], t_lm_sweep(reps=1)[index]
    assert jm.to_dict() == tm.to_dict()
    je = j_run(jm, **lm_lanes["j"]).to_dict()
    te = t_campaign.run_lm_experiment(tm, **lm_lanes["t"]).to_dict()
    for key in CLASSIFY:
        assert te[key] == je[key], key
    assert te["detected"] and te["detection_latency"] == 0


def test_lm_campaign_payload_and_cli(capsys):
    payload = t_cli.main(["--lane", "lm", "--device", "cpu", "--smoke",
                          "--assert-gates", "--json", ""])
    assert "attn_accumulator/qkv_w/mlp_w detection 100%" in \
        capsys.readouterr().out
    assert payload["benchmark"] == "lm_fault_campaign"
    assert payload["config"]["n_models"] == 5
    assert payload["clean_control"]["flagged"] == 0
    assert math.isclose(payload["by_site_kind"]["attn_accumulator/bitflip"][
        "detection_rate"], 1.0)


def test_an_lm_step_error_reaches_the_caller(lm_lanes):
    def failing_decode(*args, **kw):
        raise RuntimeError("matmul_abft: launch failed")

    lane = dict(lm_lanes["t"], decode=failing_decode)
    with pytest.raises(RuntimeError, match="launch failed") as err:
        t_campaign.run_lm_experiment(T.FaultModel(site="qkv_w", step=1),
                                     **lane)
    assert not isinstance(err.value, UnverifiableBatch)
