"""The port's mixture-of-experts block and the grouped ``matmul_abft``
against the JAX package.

``moe_block`` runs the reference's and the port's on the same numpy weights
and inputs (the smoke widths: d 64, 8 experts top-2, expert width 32), in
both ABFT modes, with and without a shared expert, at the published
capacity factor 1.25 and at 0.5 so that tokens are dropped: the routing
(experts, slot positions, kept) must be equal before any value is
compared, then ``y``, the aux loss and every check's two sides within
``atol 1e-4``, in the reference's order.  The reference's property tests
run on the port with the reference's hypothesis settings.  The grouped
kernel's plain version must equal the single product's, group by group,
bit for bit; on a GPU the kernel itself must (``cuda`` marker).  A flipped
bit in an expert weight after load flags nothing in either package: neither
folds expert weights, so the flip enters both sides of every check."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need hypothesis (requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.core.abft import ABFTConfig as JABFTConfig  # noqa: E402
from repro.core.abft import per_op_report as jper_op_report  # noqa: E402
from repro.engine.lm import fold_lm_w_r as jfold_lm_w_r  # noqa: E402
from repro.models.common import dense as jdense  # noqa: E402
from repro.models.moe import moe_block as jmoe_block  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.models.transformer import model_prefill as jmodel_prefill  # noqa: E402,E501
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import ModelConfig, MoECfg  # noqa: E402
from repro_torch.core.abft import ABFTConfig, per_op_report  # noqa: E402
from repro_torch.engine.lm import fold_lm_w_r  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.matmul_abft.kernel import (  # noqa: E402
    matmul_abft_grouped_kernel, matmul_abft_grouped_plain,
    matmul_abft_kernel, matmul_abft_plain)
from repro_torch.kernels.matmul_abft.ops import matmul_abft_grouped  # noqa: E402,E501
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import (init_model,  # noqa: E402
                                            model_decode, model_prefill)

ATOL = 1e-4
MOE_ARCHS = ["deepseek-moe-16b", "qwen3-moe-30b-a3b"]


def _cfgs(name, capacity_factor=None):
    jcfg = jsmoke_config(jget_config(name))
    cfg = smoke_config(get_config(name))
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return jcfg, cfg


def _abfts(mode):
    return (JABFTConfig(mode=mode, dtype=jnp.float32, threshold=1e-3,
                        relative=True),
            ABFTConfig(mode=mode, threshold=1e-3, relative=True))


def _moe_params(jcfg, seed):
    """The reference's init of one MoE block (numpy leaves), and the port's
    copy of it."""
    from repro.models.moe import init_moe as jinit_moe
    np_p = jax.tree.map(np.asarray, jinit_moe(jax.random.PRNGKey(seed), jcfg))
    return np_p, convert.params_from_numpy(np_p, device="cpu")


def _reference_routing(np_p, x, jcfg, jabft):
    """The reference's (experts, slot positions, kept) for ``x``, step by
    step as ``repro.models.moe.moe_block`` computes them."""
    mc = jcfg.moe
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    logits, _ = jdense(jax.tree.map(jnp.asarray, np_p["router"]), xt, jabft)
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, experts = jax.lax.top_k(probs, mc.top_k)
    flat = experts.reshape(-1)
    onehot = jax.nn.one_hot(flat, mc.n_experts, dtype=jnp.int32)
    slot = (jnp.cumsum(onehot, axis=0) * onehot - 1).max(axis=1)
    from repro.models.moe import _capacity as jcapacity
    return (np.asarray(experts), np.asarray(slot),
            np.asarray(slot < jcapacity(xt.shape[0], mc)))


def _port_routing(p, x, cfg, abft):
    xt = torch.from_numpy(x.reshape(-1, x.shape[-1]))
    _, _, experts, _ = moe.route(p, xt, cfg, abft)
    _, slot, keep, _ = moe.assign(experts, cfg.moe)
    return experts.numpy(), slot.numpy(), keep.numpy()


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("name", MOE_ARCHS)
@pytest.mark.parametrize("mode", ["fused", "split"])
def test_moe_block_matches_the_reference(mode, name, capacity_factor):
    """deepseek's twin has a shared expert, qwen3's none; at 0.5 (and, for
    these inputs, at 1.25) some assignments are dropped."""
    jcfg, cfg = _cfgs(name, capacity_factor)
    jabft, abft = _abfts(mode)
    np_p, p = _moe_params(jcfg, 0)
    x = np.random.default_rng(1).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    want_route = _reference_routing(np_p, x, jcfg, jabft)
    got_route = _port_routing(p, x, cfg, abft)
    for got, want in zip(got_route, want_route):
        assert np.array_equal(got, want)
    assert not want_route[2].all()                  # drops are exercised
    jy, jchecks, jaux = jmoe_block(jax.tree.map(jnp.asarray, np_p),
                                   jnp.asarray(x), jcfg, jabft)
    y, checks, aux = moe.moe_block(p, torch.from_numpy(x), cfg, abft)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=ATOL, rtol=0)
    want_n = 1 + 2 + (1 if mode == "fused" else 2) + \
        (3 if cfg.moe.n_shared else 0)
    assert len(checks) == len(jchecks) == want_n
    for c, jc in zip(checks, jchecks):
        np.testing.assert_allclose(float(c.predicted), float(jc.predicted),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(float(c.actual), float(jc.actual),
                                   atol=ATOL, rtol=0)
    jids, jflags, _ = jper_op_report(jchecks, jabft)
    ids, flags, _ = per_op_report(checks, abft)
    assert ids == tuple(jids) and not flags.any() and not np.any(jflags)


def test_moe_block_unchecked_output_is_the_checked_one():
    """mode="none" launches the expert products without the extra column
    and emits no check; y is the same bits."""
    jcfg, cfg = _cfgs("deepseek-moe-16b")
    _, p = _moe_params(jcfg, 2)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 16, cfg.d_model)).astype(np.float32))
    y, checks, aux = moe.moe_block(p, x, cfg, ABFTConfig(mode="fused"))
    y0, checks0, aux0 = moe.moe_block(p, x, cfg, ABFTConfig(mode="none"))
    assert torch.equal(y, y0) and torch.equal(aux, aux0)
    assert checks0 == [] and len(checks) == 7


# ---------------------------------------------------------------------------
# the reference's property tests, on the port
# ---------------------------------------------------------------------------

def mk_cfg(n_experts, top_k, capf=8.0, shared=0):
    return ModelConfig(
        name="t", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
        d_ff=48, vocab_size=64, dtype="float32",
        moe=MoECfg(n_experts=n_experts, top_k=top_k, d_ff_expert=16,
                   n_shared=shared, d_ff_shared=16,
                   capacity_factor=capf))


@settings(max_examples=12, deadline=None)
@given(n_experts=st.sampled_from([4, 8]),
       top_k=st.integers(1, 3),
       b=st.integers(1, 3),
       t=st.sampled_from([4, 8]),
       seed=st.integers(0, 50))
def test_moe_fused_check_clean(n_experts, top_k, b, t, seed):
    """On clean data, the fused combine checksum must agree."""
    cfg = mk_cfg(n_experts, top_k)
    abft = ABFTConfig(mode="fused", threshold=1e-2, relative=True)
    p = moe.init_moe(torch.Generator().manual_seed(seed), cfg)
    x = torch.randn((b, t, cfg.d_model),
                    generator=torch.Generator().manual_seed(seed + 1))
    y, checks, aux = moe.moe_block(p, x, cfg, abft)
    assert y.shape == x.shape
    assert torch.isfinite(y).all() and torch.isfinite(aux)
    for c in checks:
        scale = max(1.0, abs(float(c.actual)))
        assert abs(float(c.predicted) - float(c.actual)) / scale < 1e-2


def test_moe_combine_detects_corruption():
    """Corrupting the combine output must trip the fused chain check."""
    cfg = mk_cfg(8, 2)
    abft = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    _, checks, _ = moe.moe_block(p, x, cfg, abft)
    combine_chk = checks[-1]
    bad_actual = combine_chk.actual + 50.0
    assert abs(float(combine_chk.predicted) - float(bad_actual)) > 10.0


@settings(max_examples=15, deadline=None)
@given(tokens=st.integers(1, 200), top_k=st.integers(1, 8),
       n_experts=st.sampled_from([8, 64, 128]),
       capf=st.floats(0.5, 4.0))
def test_capacity_bounds(tokens, top_k, n_experts, capf):
    from repro.models.moe import _capacity as jcapacity
    cfg_moe = MoECfg(n_experts=n_experts, top_k=top_k, d_ff_expert=8,
                     capacity_factor=capf)
    cap = moe._capacity(tokens, cfg_moe)
    assert cap >= top_k                       # never below top_k
    assert cap * n_experts >= tokens * top_k * capf * 0.5  # sane sizing
    assert cap == jcapacity(tokens, cfg_moe)


def test_moe_dropless_equals_dense_sum():
    """With capacity ≥ all assignments, Y must equal the explicit per-token
    gated sum of expert outputs (routing correctness oracle)."""
    cfg = mk_cfg(4, 2, capf=64.0)
    p = moe.init_moe(torch.Generator().manual_seed(3), cfg)
    x = torch.randn((1, 6, cfg.d_model),
                    generator=torch.Generator().manual_seed(4))
    y, _, _ = moe.moe_block(p, x, cfg, ABFTConfig(mode="none"))

    xt = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xt @ p["router"]["w"], -1)
    gv, ge = torch.topk(probs, 2)
    gv = gv / gv.sum(-1, keepdim=True)
    ref = torch.zeros_like(xt)
    for n in range(xt.shape[0]):
        for j in range(2):
            e = int(ge[n, j])
            up = xt[n] @ p["w_up"][e]
            gt = xt[n] @ p["w_gate"][e]
            ref[n] += gv[n, j] * ((torch.nn.functional.silu(gt) * up)
                                  @ p["w_down"][e])
    np.testing.assert_allclose(y.reshape(-1, cfg.d_model).numpy(),
                               ref.numpy(), rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# the grouped matmul_abft
# ---------------------------------------------------------------------------

GROUPED_SHAPES = [(1, 33, 65), (6, 100, 72), (8, 70, 130), (16, 2050, 130),
                  (17, 33, 65), (120, 70, 130), (129, 99, 131)]


def _grouped_operands(g, m, k, n, dtype, trans_b, seed):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn((g, m, k), generator=gen).to(dtype)
    b = (torch.randn((g, n, k) if trans_b else (g, k, n), generator=gen)
         * k ** -0.5).to(dtype)
    br = b.float().sum(dim=1 if trans_b else 2).contiguous()
    return a, b, br


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", GROUPED_SHAPES)
def test_grouped_plain_is_each_group_s_single_plain(m, k, n, dtype,
                                                    trans_b):
    """Ragged M, N and K on both tile paths (M <= 16 thin, split K; M > 16
    wide): group g's C, block sums and extra column are bit for bit the
    single product's; without b_r, C is the same bits and no extra."""
    g = 3
    a, b, br = _grouped_operands(g, m, k, n, dtype, trans_b, m + k + n)
    c, sums, extra = matmul_abft_grouped_plain(a, b, br, trans_b=trans_b)
    assert c.shape == (g, m, n) and extra.shape == (g, m, 1)
    for i in range(g):
        ci, si, ei = matmul_abft_plain(a[i], b[i], br[i], trans_b=trans_b)
        assert torch.equal(c[i], ci) and torch.equal(sums[i], si)
        assert torch.equal(extra[i], ei)
    c0, sums0, extra0 = matmul_abft_grouped_plain(a, b, None,
                                                  trans_b=trans_b)
    assert torch.equal(c0, c) and torch.equal(sums0, sums) and extra0 is None


def test_grouped_op_check_is_the_reference_s_batched_einsum_check():
    """matmul_abft_grouped's corners: Σ extra = Σ_e (eᵀA_e)·(W_e e) and
    Σ block sums = Σ C, as the reference's up/gate checks compute them."""
    a, b, br = _grouped_operands(4, 12, 64, 48, torch.float32, False, 5)
    c, chk, extra = matmul_abft_grouped(a, b, br)
    pred = jnp.einsum("ed,edf->", jnp.asarray(a.numpy()).sum(1),
                      jnp.asarray(b.numpy()))
    np.testing.assert_allclose(float(chk.predicted), float(pred), atol=ATOL)
    np.testing.assert_allclose(float(chk.actual), float(c.sum()), atol=ATOL)
    assert extra.shape == (4, 12) and not bool(chk.flag(ABFTConfig()))
    c2, none, none2 = matmul_abft_grouped(a, b)
    assert torch.equal(c2, c) and none is None and none2 is None


def test_grouped_wrapper_refuses_what_the_kernel_does_not_take():
    from repro_torch.kernels.matmul_abft.kernel import _check_grouped
    with pytest.raises(ValueError, match="3-D"):
        _check_grouped(torch.ones(2, 3), torch.ones(3, 4), None, False)
    with pytest.raises(ValueError, match="group count"):
        _check_grouped(torch.ones(2, 2, 3), torch.ones(3, 3, 4), None, False)
    with pytest.raises(ValueError, match="G x K"):
        _check_grouped(torch.ones(2, 2, 3), torch.ones(2, 3, 4),
                       torch.ones(2, 4), False)
    with pytest.raises(ValueError, match="float32"):
        _check_grouped(torch.ones(2, 2, 3), torch.ones(2, 3, 4),
                       torch.ones(2, 3, dtype=torch.float64), False)
    with pytest.raises(ValueError, match="share one of"):
        _check_grouped(torch.ones(2, 2, 3),
                       torch.ones(2, 3, 4, dtype=torch.float64), None, False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_grouped_kernel_is_each_group_s_single_launch(dtype):
    """On the card: the grouped launch against its plain version and, bit
    for bit, against one single launch a group, on both tile paths."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (torch.cuda.is_available() "
                    "is false)")
    tol = ATOL if dtype == torch.float32 else 2e-2
    for m, k, n in GROUPED_SHAPES:
        a, b, br = (t.cuda() for t in _grouped_operands(
            5, m, k, n, dtype, False, m * k))
        got = matmul_abft_grouped_kernel(a, b, br)
        want = matmul_abft_grouped_plain(a, b, br)
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   atol=tol, rtol=tol)
        torch.testing.assert_close(got[1], want[1], atol=ATOL, rtol=ATOL)
        torch.testing.assert_close(got[2], want[2], atol=ATOL, rtol=ATOL)
        for i in range(a.shape[0]):
            # a group's slice of the stack need not start 16-byte aligned
            # (b_r at K % 4 != 0); the single launch takes its own copy
            single = matmul_abft_kernel(a[i].clone(), b[i].clone(),
                                        br[i].clone())
            assert all(torch.equal(x[i], y) for x, y in zip(got, single))


# ---------------------------------------------------------------------------
# the MoE models
# ---------------------------------------------------------------------------

def test_fold_folds_the_router_and_shared_experts_only():
    """Both packages fold the router's and the shared MLP's ``w`` and leave
    the stacked expert weights alone (they are not ``"w"`` leaves)."""
    jcfg, cfg = _cfgs("deepseek-moe-16b")
    jabft, abft = _abfts("fused")
    np_params = jax.tree.map(np.asarray,
                             jinit_model(jcfg, jax.random.PRNGKey(0)))
    params = convert.lm_params_from_numpy(np_params, cfg, device="cpu")
    folded = fold_lm_w_r(params, cfg, abft)["segments"][0]["b0"]["moe"]
    jfolded = jfold_lm_w_r(jax.tree.map(jnp.asarray, np_params), jcfg,
                           jabft)["segments"][0]["b0"]["moe"]
    assert sorted(folded) == sorted(jfolded)
    assert sorted(folded["router"]) == ["w", "w_r"]
    for name in ("wi", "wg", "wo"):
        assert sorted(folded["shared"][name]) == ["w", "w_r"]
        np.testing.assert_allclose(folded["shared"][name]["w_r"].numpy(),
                                   np.asarray(jfolded["shared"][name]["w_r"]),
                                   atol=1e-5)
    for name in ("w_up", "w_gate", "w_down"):
        assert isinstance(folded[name], torch.Tensor)
        assert folded[name] is params["segments"][0]["b0"]["moe"][name]
    assert folded["w_up"].shape == (cfg.n_layers, 8, 64, 32)


def test_params_from_the_reference_are_shape_checked():
    jcfg, cfg = _cfgs("qwen3-moe-30b-a3b")
    np_params = jax.tree.map(np.asarray,
                             jinit_model(jcfg, jax.random.PRNGKey(0)))
    params = convert.lm_params_from_numpy(np_params, cfg, device="cpu")
    assert "shared" not in params["segments"][0]["b0"]["moe"]
    seg = dict(np_params["segments"][0])
    b0 = dict(seg["b0"])
    b0["moe"] = dict(b0["moe"], w_up=b0["moe"]["w_up"][:, :4])
    seg["b0"] = b0
    with pytest.raises(ValueError, match="w_up"):
        convert.lm_params_from_numpy(dict(np_params, segments=[seg]), cfg,
                                     device="cpu")


def _with_w_up(tree, w_up):
    """``tree`` with layer-stack 0's ``w_up`` leaf replaced (a fault after
    load: the fold has already been taken)."""
    seg = dict(tree["segments"][0])
    b0 = dict(seg["b0"])
    b0["moe"] = dict(b0["moe"], w_up=w_up)
    seg["b0"] = b0
    return dict(tree, segments=[seg])


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_expert_weight_flip_flags_as_in_the_reference(name):
    """A bit flip in one expert's w_up after load (the same bits in both
    packages) changes the logits but flags nothing in either: the expert
    b_r are summed from the corrupted weights on every call."""
    jcfg, cfg = _cfgs(name)
    jabft, abft = _abfts("fused")
    np_params = jax.tree.map(np.asarray,
                             jinit_model(jcfg, jax.random.PRNGKey(0)))
    jfolded = jfold_lm_w_r(jax.tree.map(jnp.asarray, np_params), jcfg,
                           jabft)
    folded = fold_lm_w_r(convert.lm_params_from_numpy(np_params, cfg,
                                                      device="cpu"),
                         cfg, abft)
    bad = np_params["segments"][0]["b0"]["moe"]["w_up"].copy()
    bad.view(np.int32)[0, 3, 5, 7] ^= 1 << 26          # x or / 2^8
    tokens = np.random.default_rng(0).integers(
        1, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    runs = []
    for w_up in (np_params["segments"][0]["b0"]["moe"]["w_up"], bad):
        jl, _, _, jchecks = jmodel_prefill(
            _with_w_up(jfolded, jnp.asarray(w_up)), jcfg,
            {"tokens": jnp.asarray(tokens)}, jabft, 16, return_checks=True)
        tl, _, _, tchecks = model_prefill(
            _with_w_up(folded, torch.from_numpy(w_up.copy())), cfg,
            {"tokens": torch.from_numpy(tokens)}, abft, 16,
            return_checks=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        jids, jflags, _ = jper_op_report(jchecks, jabft)
        ids, flags, _ = per_op_report(tchecks, abft)
        assert ids == tuple(jids)
        assert flags.tolist() == np.asarray(jflags).tolist()
        assert not flags.any()
        runs.append(tl)
    assert not torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_decode_matches_prefill_at_a_dropless_capacity(name):
    """The port's decode steps reproduce its prefill of the longer prompt
    (the reference's test_decode_matches_forward): prefill and decode route
    N and B tokens, so capacity is raised to 16 there, as the reference
    raises it, for no assignment to be dropped in either."""
    _, cfg = _cfgs(name, 16.0)
    abft = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    params = init_model(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, size=(2, 10)).astype(np.int32))
    full, _, rep = model_prefill(params, cfg, {"tokens": tokens}, abft, 12)
    assert not bool(rep.flag)
    _, states, _ = model_prefill(params, cfg, {"tokens": tokens[:, :8]},
                                 abft, 12)
    for i in (8, 9):
        logits, states, rep = model_decode(params, cfg, states,
                                           tokens[:, i:i + 1], i, abft)
        assert not bool(rep.flag)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), atol=ATOL,
                               rtol=0)


def test_serve_lm_runs_the_moe_twins_on_the_cpu():
    from repro_torch.launch import serve_lm
    runtime.reset_counts()
    for name in MOE_ARCHS:
        out = serve_lm.main(["--arch", name, "--device", "cpu", "--new", "3",
                             "--assert-clean", "--inject-at", "1"])
        assert out["clean"] == {"bitwise_identical": True, "flags": 0}
        assert out["fault"]["detected"] and out["fault"]["repaired_bitwise"]
    assert runtime.plain_counts()["matmul_abft_grouped"] > 0
    assert not any(runtime.launch_counts().values())
