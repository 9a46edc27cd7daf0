"""The port's recurrent blocks — RWKV6's time and channel mix, the RG-LRU
block — against the JAX package's, function by function.

Inputs come from a numpy seed and weights from the reference's own init
(carried across as numpy arrays), at d 128: two RWKV heads of 64, RG-LRU
gate blocks of 8.  Every function runs on one token and on 37, from the zero
state and from a non-zero one; outputs and states must agree within
``atol 1e-4``, every check's two sides within ``atol 1e-4 + rtol 1e-6``
(the same f32 sums in another order).  Within the port: the grouped gate
product's plain version is each group's single plain product bit for bit,
a prompt run in two parts with the state carried equals it run at once
(``atol 1e-5``), and decode steps reproduce the prefill of the longer
prompt.  A bit flipped in a gate weight after load flags nothing in either
package (ROADMAP C8: the gates' ``b_r`` are summed from the weights they
multiply), while the same flip in ``proj_x`` flags the same op in both.
``chip_smoke.py``'s launch shapes, counts and op ids, which it derives from
the block pattern, equal what a smoke twin's steps launch and report.
Everything runs on the CPU (the kernels' plain versions)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.core.abft import ABFTConfig as JABFTConfig
from repro.core.abft import per_op_report as jper_op_report
from repro.engine.lm import fold_lm_w_r as jfold_lm_w_r
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv6
from repro.models.transformer import init_model as jinit_model
from repro.models.transformer import model_prefill as jmodel_prefill
from repro_torch import convert
from repro_torch.analysis.vmem import matmul_tile
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.abft import ABFTConfig, per_op_report
from repro_torch.engine.lm import fold_lm_w_r
from repro_torch.kernels import runtime
from repro_torch.kernels.matmul_abft.kernel import (
    matmul_abft_grouped_plain, matmul_abft_plain)
from repro_torch.models import rglru, rwkv6
from repro_torch.models.transformer import (_index, init_model,
                                            layer_apply_seq, model_decode,
                                            model_prefill)

ATOL = 1e-4
D, B = 128, 2
TS = [1, 37]
STATES = ["zero", "carried"]
JABFT = JABFTConfig(mode="fused", dtype=jnp.float32, threshold=1e-3,
                    relative=True)
ABFT = ABFTConfig(mode="fused", threshold=1e-3, relative=True)


def _cfgs(name):
    return (dataclasses.replace(jsmoke_config(jget_config(name)), d_model=D),
            dataclasses.replace(smoke_config(get_config(name)), d_model=D))


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _params(jinit, jcfg, seed=0):
    """The reference's init (numpy leaves), its jnp copy and the port's."""
    np_p = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(seed), jcfg))
    return (jax.tree.map(jnp.asarray, np_p),
            convert.params_from_numpy(np_p, device="cpu"))


def _close(got, want, what, atol=ATOL, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=what)


def _close_checks(got, want):
    assert len(got) == len(want)
    for i, (c, jc) in enumerate(zip(got, want)):
        _close(c.predicted, jc.predicted, f"check {i} predicted", rtol=1e-6)
        _close(c.actual, jc.actual, f"check {i} actual", rtol=1e-6)
        assert not bool(c.flag(ABFT)) and not bool(jc.flag(JABFT))


def _both(a):
    return jnp.asarray(a), torch.from_numpy(a.copy())


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", TS)
def test_ddlerp_matches_the_reference(t):
    jcfg, _ = _cfgs("rwkv6-7b")
    jp, p = _params(jrwkv6.init_rwkv_time_mix, jcfg)
    jx, x = _both(_rand(1, B, t, D))
    jxp, xp = _both(_rand(2, B, t, D))
    for i, (got, want) in enumerate(zip(rwkv6._ddlerp(p, x, xp),
                                        jrwkv6._ddlerp(jp, jx, jxp))):
        _close(got, want, f"stream {i}")


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("t", TS)
def test_wkv_scan_matches_the_reference(t, state):
    h, hd = D // rwkv6.HEAD_SIZE, rwkv6.HEAD_SIZE
    rng = np.random.default_rng(3)
    r, k, v = (_rand(s, B, t, h, hd) for s in (4, 5, 6))
    w = rng.uniform(0.5, 1.0, (B, t, h, hd)).astype(np.float32)
    u = _rand(7, h, hd, scale=0.5)
    s0 = (np.zeros((B, h, hd, hd), np.float32) if state == "zero"
          else _rand(8, B, h, hd, hd, scale=0.5))
    jout, jst = jrwkv6._wkv_scan(*(jnp.asarray(a) for a in (r, k, v, w, u,
                                                            s0)))
    out, st = rwkv6._wkv_scan(*(torch.from_numpy(a) for a in (r, k, v, w, u,
                                                               s0)))
    assert out.shape == (B, t, h, hd) and st.shape == (B, h, hd, hd)
    _close(out, jout, "out")
    _close(st, jst, "state")


@pytest.mark.parametrize("chunk", [1, 8])
def test_wkv_scan_in_chunks_is_the_scan_at_once(chunk, monkeypatch):
    """``kᵀv`` and ``u·kᵀv`` made ``WKV_CHUNK`` steps at a time: the same
    bits as all 37 steps at once (the default chunk holds them all), and
    the reference's within ``atol 1e-4``."""
    h, hd = D // rwkv6.HEAD_SIZE, rwkv6.HEAD_SIZE
    r, k, v = (_rand(s, B, 37, h, hd) for s in (4, 5, 6))
    w = np.random.default_rng(3).uniform(0.5, 1.0, (B, 37, h, hd)).astype(
        np.float32)
    u, s0 = _rand(7, h, hd, scale=0.5), _rand(8, B, h, hd, hd, scale=0.5)
    args = [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]
    assert rwkv6.WKV_CHUNK >= 37
    whole = rwkv6._wkv_scan(*args)
    monkeypatch.setattr(rwkv6, "WKV_CHUNK", chunk)
    parts = rwkv6._wkv_scan(*args)
    assert all(torch.equal(x, y) for x, y in zip(parts, whole))
    jout, jst = jrwkv6._wkv_scan(*(jnp.asarray(a) for a in (r, k, v, w, u,
                                                            s0)))
    _close(parts[0], jout, "out")
    _close(parts[1], jst, "state")


def _rwkv_state(state, seed):
    h = D // rwkv6.HEAD_SIZE
    if state == "zero":
        return (np.zeros((B, D), np.float32),
                np.zeros((B, h, 64, 64), np.float32))
    return _rand(seed, B, D), _rand(seed + 1, B, h, 64, 64, scale=0.5)


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("t", TS)
def test_rwkv_time_mix_matches_the_reference(t, state):
    jcfg, cfg = _cfgs("rwkv6-7b")
    jp, p = _params(jrwkv6.init_rwkv_time_mix, jcfg)
    jx, x = _both(_rand(10, B, t, D))
    xp, s0 = _rwkv_state(state, 11)
    jy, jlast, jst, jchecks = jrwkv6.rwkv_time_mix(
        jp, jx, jcfg, JABFT, jnp.asarray(xp), jnp.asarray(s0))
    y, last, st, checks = rwkv6.rwkv_time_mix(
        p, x, cfg, ABFT, torch.from_numpy(xp), torch.from_numpy(s0))
    _close(y, jy, "y")
    _close(last, jlast, "last x")
    _close(st, jst, "state")
    assert len(checks) == 5                   # r, k, v, g, o
    _close_checks(checks, jchecks)


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("t", TS)
def test_rwkv_channel_mix_matches_the_reference(t, state):
    jcfg, cfg = _cfgs("rwkv6-7b")
    jp, p = _params(jrwkv6.init_rwkv_channel_mix, jcfg)
    jx, x = _both(_rand(12, B, t, D))
    xp = _rwkv_state(state, 13)[0]
    jy, jlast, jchecks = jrwkv6.rwkv_channel_mix(jp, jx, jcfg, JABFT,
                                                 jnp.asarray(xp))
    y, last, checks = rwkv6.rwkv_channel_mix(p, x, cfg, ABFT,
                                             torch.from_numpy(xp))
    _close(y, jy, "y")
    _close(last, jlast, "last x")
    assert len(checks) == 2
    _close_checks(checks, jchecks)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _rglru_state(state, seed, k=4):
    if state == "zero":
        return (np.zeros((B, D), np.float32),
                np.zeros((B, k - 1, D), np.float32))
    return _rand(seed, B, D), _rand(seed + 1, B, k - 1, D)


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("t", TS)
def test_conv1d_matches_the_reference(t, state):
    jx, x = _both(_rand(20, B, t, D))
    jw, w = _both(_rand(21, 4, D, scale=0.3))
    jb, b = _both(_rand(22, D, scale=0.1))
    hist = _rglru_state(state, 23)[1]
    jy, jh = jrglru._conv1d(jx, jw, jb, jnp.asarray(hist))
    y, h = rglru._conv1d(x, w, b, torch.from_numpy(hist))
    _close(y, jy, "y")
    _close(h, jh, "history")


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("t", TS)
def test_rglru_scan_matches_the_reference(t, state):
    rng = np.random.default_rng(24)
    x = _rand(25, B, t, D)
    i_gate = rng.uniform(0.0, 1.0, (B, t, D)).astype(np.float32)
    a = rng.uniform(0.0, 1.0, (B, t, D)).astype(np.float32)
    h0 = _rglru_state(state, 26)[0]
    jys, jh = jrglru._rglru_scan(*(jnp.asarray(v) for v in (x, i_gate, a,
                                                            h0)))
    ys, h = rglru._rglru_scan(*(torch.from_numpy(v) for v in (x, i_gate, a,
                                                               h0)))
    _close(ys, jys, "ys")
    _close(h, jh, "h")


@pytest.mark.parametrize("t", TS)
def test_block_diag_dense_matches_the_reference(t):
    jcfg, _ = _cfgs("recurrentgemma-9b")
    jp, p = _params(jrglru.init_rglru_block, jcfg)
    assert p["gate_x"]["w"].shape == (rglru.GATE_BLOCKS, 8, 8)
    jx, x = _both(_rand(27, B, t, D))
    jy, jchecks = jrglru._block_diag_dense(jp["gate_x"], jx, JABFT)
    y, checks = rglru._block_diag_dense(p["gate_x"], x, ABFT)
    _close(y, jy, "y")
    _close_checks(checks, jchecks)
    bare, none = rglru._block_diag_dense(p["gate_x"], x,
                                         ABFTConfig(mode="none"))
    assert torch.equal(bare, y) and none == []


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("t", TS)
def test_rglru_block_matches_the_reference(t, state):
    jcfg, cfg = _cfgs("recurrentgemma-9b")
    jp, p = _params(jrglru.init_rglru_block, jcfg)
    jx, x = _both(_rand(28, B, t, D))
    h0, hist = _rglru_state(state, 29)
    jy, jst, jchecks = jrglru.rglru_block(
        jp, jx, jcfg, JABFT, {"h": jnp.asarray(h0),
                              "conv": jnp.asarray(hist)})
    y, st, checks = rglru.rglru_block(
        p, x, cfg, ABFT, {"h": torch.from_numpy(h0),
                          "conv": torch.from_numpy(hist)})
    _close(y, jy, "y")
    assert sorted(st) == sorted(jst) == ["conv", "h"]
    for key in st:
        assert st[key].dtype == torch.float32
        _close(st[key], jst[key], key)
    assert len(checks) == 5       # proj_x, proj_gate, gate_x, gate_a, proj_out
    _close_checks(checks, jchecks)


@pytest.mark.parametrize("m", [1, 37])
@pytest.mark.parametrize("r", [8, 256])
def test_grouped_gate_plain_is_each_group_s_single_plain(r, m):
    """The gate product as the port serves it (16 groups of [M, r] @ [r, r];
    r 256 is recurrentgemma-9b's): group g's C, block sums and extra column
    are the single plain product's, bit for bit."""
    g = rglru.GATE_BLOCKS
    a = torch.from_numpy(_rand(30, g, m, r))
    w = torch.from_numpy(_rand(31, g, r, r, scale=r ** -0.5))
    br = w.sum(-1)
    c, sums, extra = matmul_abft_grouped_plain(a, w, br)
    for i in range(g):
        ci, si, ei = matmul_abft_plain(a[i], w[i], br[i])
        assert torch.equal(c[i], ci) and torch.equal(sums[i], si)
        assert torch.equal(extra[i], ei)


# ---------------------------------------------------------------------------
# state carried within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", [1, 20])
@pytest.mark.parametrize("name,btype", [("rwkv6-7b", "rwkv"),
                                        ("recurrentgemma-9b", "rglru")])
def test_a_prompt_in_two_parts_equals_it_at_once(name, btype, split):
    """layer_apply_seq over 37 tokens from the zero state, and over the
    first ``split`` then the rest from the state the first part left."""
    _, cfg = _cfgs(name)
    params = init_model(cfg, 0, device="cpu")
    lp = _index(params["segments"][0], 0)["b0"]      # layer 0
    x = torch.from_numpy(_rand(32, B, 37, D))
    full, _, _, st_full = layer_apply_seq(lp, x, btype, cfg, ABFT, None,
                                          None, None, True, 1)
    first, _, _, st = layer_apply_seq(lp, x[:, :split], btype, cfg, ABFT,
                                      None, None, None, True, 1)
    rest, _, _, st2 = layer_apply_seq(lp, x[:, split:], btype, cfg, ABFT,
                                      None, None, st, True, 1)
    np.testing.assert_allclose(torch.cat([first, rest], 1).numpy(),
                               full.numpy(), atol=1e-5, rtol=0)
    for key in st_full:
        np.testing.assert_allclose(st2[key].numpy(), st_full[key].numpy(),
                                   atol=1e-5, rtol=0, err_msg=key)


@pytest.mark.parametrize("name", ["rwkv6-7b", "recurrentgemma-9b"])
def test_decode_matches_prefill(name):
    """The smoke twin's decode steps, from the state a prefill of 8 tokens
    left, reproduce the last logits of a prefill of 10 (recurrentgemma's
    local window of 16 covers both)."""
    cfg = smoke_config(get_config(name))
    params = init_model(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(33).integers(
        1, cfg.vocab_size, size=(B, 10)).astype(np.int32))
    full, _, rep = model_prefill(params, cfg, {"tokens": tokens}, ABFT, 12)
    assert not bool(rep.flag)
    _, states, _ = model_prefill(params, cfg, {"tokens": tokens[:, :8]},
                                 ABFT, 12)
    for i in (8, 9):
        logits, states, rep = model_decode(params, cfg, states,
                                           tokens[:, i:i + 1], i, ABFT)
        assert not bool(rep.flag)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), atol=ATOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# a weight flip after load (ROADMAP C8)
# ---------------------------------------------------------------------------

def _with_leaf(tree, block, name, w):
    """``tree`` with segment 0's ``b0[block][name]["w"]`` replaced (a fault
    after load: the fold has already been taken)."""
    seg = dict(tree["segments"][0])
    b0 = dict(seg["b0"])
    blk = dict(b0[block])
    blk[name] = dict(blk[name], w=w)
    b0[block], seg["b0"] = blk, b0
    return dict(tree, segments=[seg] + list(tree["segments"][1:]))


@pytest.mark.parametrize("leaf,flagged", [("gate_x", False),
                                          ("gate_a", False),
                                          ("proj_x", True)])
def test_gate_weight_flip_flags_as_in_the_reference(leaf, flagged):
    """Bit 26 of one weight of layer 0 (x or / 2^8) flipped after load, the
    same bits in both packages: in a gate it changes the logits and flags
    nothing in either (its b_r is summed from the flipped weights); in
    proj_x, whose w_r was folded at load, both flag the same op."""
    name = "recurrentgemma-9b"
    jcfg, cfg = jsmoke_config(jget_config(name)), smoke_config(
        get_config(name))
    np_params = jax.tree.map(np.asarray,
                             jinit_model(jcfg, jax.random.PRNGKey(0)))
    jfolded = jfold_lm_w_r(jax.tree.map(jnp.asarray, np_params), jcfg, JABFT)
    folded = fold_lm_w_r(convert.lm_params_from_numpy(np_params, cfg,
                                                      device="cpu"),
                         cfg, ABFT)
    good = np_params["segments"][0]["b0"]["rglru"][leaf]["w"]
    bad = good.copy()
    bad.view(np.int32)[(0,) * bad.ndim] ^= 1 << 26
    tokens = np.random.default_rng(34).integers(
        1, cfg.vocab_size, size=(B, 12)).astype(np.int32)
    runs = []
    for w in (good, bad):
        jl, _, _, jchecks = jmodel_prefill(
            _with_leaf(jfolded, "rglru", leaf, jnp.asarray(w)), jcfg,
            {"tokens": jnp.asarray(tokens)}, JABFT, 16, return_checks=True)
        tl, _, _, tchecks = model_prefill(
            _with_leaf(folded, "rglru", leaf, torch.from_numpy(w.copy())),
            cfg, {"tokens": torch.from_numpy(tokens)}, ABFT, 16,
            return_checks=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        jids, jflags, _ = jper_op_report(jchecks, JABFT)
        ids, flags, _ = per_op_report(tchecks, ABFT)
        assert ids == tuple(jids)
        assert flags.tolist() == np.asarray(jflags).tolist()
        runs.append((tl, flags))
    assert not torch.equal(runs[0][0], runs[1][0])
    assert not runs[0][1].any()
    assert bool(runs[1][1].any()) == flagged


@pytest.mark.parametrize("name", ["rwkv6-7b", "recurrentgemma-9b"])
def test_serve_lm_reports_the_accumulator_upset_as_the_reference(name):
    """``serve_lm --inject-at 1`` on the smoke twins, in both packages:
    recurrentgemma's upset lands in an attention accumulator and is
    detected and repaired bit for bit; rwkv6 has no attention, so the upset
    reaches no site — nothing flags, in the reference as in the port, and
    the clean gate holds."""
    from repro.launch import serve_lm as jserve_lm
    from repro_torch.launch import serve_lm
    argv = ["--arch", name, "--new", "3", "--prompt", "20",
            "--inject-at", "1", "--json", ""]
    got = serve_lm.main(argv + ["--device", "cpu"])
    want = jserve_lm.main(argv)
    assert got["clean"]["bitwise_identical"] and got["clean"]["flags"] == 0
    for key in ("detected", "repaired_bitwise"):
        assert got["fault"][key] == want["fault"][key], key
    assert got["fault"]["detected"] == (name == "recurrentgemma-9b")
    assert got["fault"]["repaired_bitwise"]


# ---------------------------------------------------------------------------
# chip_smoke.py's counts, against what a step launches
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,n_layers", [
    ("rwkv6-7b", 4), ("recurrentgemma-9b", 3), ("recurrentgemma-9b", 5),
    ("recurrentgemma-9b", 8), ("gemma-2b", 2), ("deepseek-moe-16b", 2)])
def test_chip_smoke_counts_are_what_a_step_launches(name, n_layers,
                                                    monkeypatch):
    """The launch shapes, launch counts and op ids ``chip_smoke.py`` derives
    from the block pattern (and gates the card's run on) equal what a
    guarded prefill and decode step of the smoke twin launch and report."""
    from repro_torch.kernels.matmul_abft import ops
    cs = _chip_smoke()
    cfg = dataclasses.replace(smoke_config(get_config(name)),
                              n_layers=n_layers)
    seen = {"single": {}, "grouped": {}}
    single, grouped = ops.matmul_abft_kernel, ops.matmul_abft_grouped_kernel

    def note(kind, key, step):
        seen[kind].setdefault(key, {"prefill": 0, "decode": 0})[step] += 1

    def rec_single(a, b, br=None, *, trans_b=False):
        note("single", (a.shape[0], a.shape[1],
                        b.shape[0] if trans_b else b.shape[1], trans_b),
             seen["step"])
        return single(a, b, br, trans_b=trans_b)

    def rec_grouped(a, b, br=None, *, trans_b=False, rows=None):
        note("grouped", (*a.shape, b.shape[2]), seen["step"])
        return grouped(a, b, br, trans_b=trans_b, rows=rows)
    monkeypatch.setattr(ops, "matmul_abft_kernel", rec_single)
    monkeypatch.setattr(ops, "matmul_abft_grouped_kernel", rec_grouped)
    params = init_model(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(35).integers(
        1, cfg.vocab_size, size=(B, 20)).astype(np.int32))
    seen["step"] = "prefill"
    flash0 = runtime.plain_counts()["flash_checksum"]
    _, states, _, checks = model_prefill(params, cfg, {"tokens": tokens},
                                         ABFT, 22, return_checks=True)
    flash = runtime.plain_counts()["flash_checksum"] - flash0
    ids = per_op_report(checks, ABFT)[0]
    seen["step"] = "decode"
    _, _, _, dchecks = model_decode(params, cfg, states, tokens[:, :1], 20,
                                    ABFT, return_checks=True)
    assert seen["single"] == cs.lm_matmul_shapes(cfg, B, 20)
    assert seen["grouped"] == cs.lm_grouped_shapes(cfg, B, 20)
    want = cs.lm_step_launches(cfg)
    assert want["matmul_abft"] == sum(c["prefill"]
                                      for c in seen["single"].values())
    assert want["matmul_abft_grouped"] == sum(
        c["prefill"] for c in seen["grouped"].values())
    assert want["flash_checksum"] == flash
    assert list(ids) == cs.lm_op_ids(cfg) == list(
        per_op_report(dchecks, ABFT)[0])


@pytest.mark.parametrize("m,k,n", [(1, 256, 300), (70, 32, 260)])
def test_chip_smoke_block_sum_rule_rejects_one_wrong_element(m, k, n):
    """``chip_smoke.py``'s rule for B4's block sums (``check_block_sums``)
    passes a block sum that differs from the yardstick's past ``1e-4`` but
    is its own C's float64 sum to f32 rounding, and rejects one that drops
    or doubles a typical element of its tile: at M 1 (64-element tiles)
    and at a full 64 x 128 tile, outputs of rms 128 and 45."""
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(41)
    a = torch.randn(m, k, generator=gen) * 8
    b = torch.randn(k, n, generator=gen)
    c, sums, _ = matmul_abft_plain(a, b)
    cs.check_block_sums(torch, "plain", c, sums, sums.clone())
    # the yardstick 1.5 tolerances off: only the witness passes the sums
    off = sums - 1.5 * (cs.OUT_ATOL + cs.OUT_RTOL * sums.abs())
    got = cs.check_block_sums(torch, "cancelled", c, sums, off)
    assert got["over_tol"] == sums.numel() and got["max_witness_ratio"] < 1
    tm, tn = matmul_tile(m)
    tile = c[:tm, :tn].flatten()
    typical = tile[tile.abs().argsort()[tile.numel() // 2]]   # median |c|
    for sign in (-1.0, 1.0):                     # dropped, doubled
        bad = sums.clone()
        bad[0, 0] += sign * typical
        with pytest.raises(AssertionError, match="block sums over"):
            cs.check_block_sums(torch, "planted", c, bad, sums)
