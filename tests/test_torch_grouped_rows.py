"""The grouped ``matmul_abft`` with per-group row counts, and the MoE block
that passes them.

A counted launch takes group g's rows at or past ``rows[g]`` as zero rows
of A.  Its plain version must be, bit for bit, the launch without counts on
A with those rows zeroed (hypothesis over G, M on both sides of the
thin/wide boundary, K, N and counts from 0 to M, in float32, bfloat16 and
float64), whatever the dead rows hold; a zero row's extra entry is NaN
exactly where the full product's is (a non-finite ``b_r``).  The wrapper
refuses counts of the wrong shape, dtype, device or range.  ``moe_block``'s
counts are each expert's kept assignments (the highest slot kept, plus
one), and non-finite weights planted in an expert that no token reaches
flag exactly as the JAX reference's checks do, in both ABFT modes.  On a
GPU (``cuda`` marker) the kernel with counts equals its plain version and,
bit for bit, the launch without counts on the zeroed A."""
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
from repro.models.common import dense as jdense  # noqa: E402
from repro.models.moe import init_moe as jinit_moe  # noqa: E402
from repro.models.moe import moe_block as jmoe_block  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import MoECfg  # noqa: E402
from repro_torch.core.abft import ABFTConfig, per_op_report  # noqa: E402
from repro_torch.kernels.matmul_abft.kernel import (  # noqa: E402
    _check_grouped, matmul_abft_grouped_kernel, matmul_abft_grouped_plain,
    zero_dead_rows)
from repro_torch.kernels.matmul_abft.ops import (  # noqa: E402
    GroupedMatmulAbftFunction)
from repro_torch.models import moe  # noqa: E402

ATOL = 1e-4
MOE_ARCHS = ["deepseek-moe-16b", "qwen3-moe-30b-a3b"]
DTYPES = [torch.float32, torch.bfloat16, torch.float64]


def _operands(g, m, k, n, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn((g, m, k), generator=gen).to(dtype)
    b = (torch.randn((g, k, n), generator=gen) * k ** -0.5).to(dtype)
    br = b.to(torch.float64 if dtype == torch.float64 else torch.float32
              ).sum(dim=2).contiguous()
    return a, b, br


def _same(x, y):
    """Equal bits, NaN where NaN."""
    return torch.equal(torch.isnan(x), torch.isnan(y)) and torch.equal(
        torch.nan_to_num(x, nan=0.0), torch.nan_to_num(y, nan=0.0))


@settings(max_examples=30, deadline=None)
@given(g=st.integers(1, 4), m=st.sampled_from([1, 3, 16, 17, 40, 129]),
       k=st.integers(1, 70), n=st.integers(1, 70),
       dtype=st.sampled_from(DTYPES), data=st.data())
def test_counted_plain_is_the_uncounted_one_on_zeroed_rows(g, m, k, n,
                                                           dtype, data):
    """C, block sums and extra column of a counted launch are bit for bit
    those of the launch without counts on A with the dead rows zeroed;
    garbage in the dead rows (huge values, NaN) changes nothing."""
    counts = data.draw(st.lists(st.sampled_from([0, m, *range(m + 1)]),
                                min_size=g, max_size=g))
    rows = torch.tensor(counts, dtype=torch.int32)
    a, b, br = _operands(g, m, k, n, dtype, g + m + k + n)
    a_z = zero_dead_rows(a, rows)
    dead = torch.arange(m)[None, :] >= rows[:, None]
    garbage = a.masked_fill(dead[..., None], float("nan"))
    garbage[:, ::2] = torch.where(dead[:, ::2, None],
                                  torch.full_like(a[:, ::2], 3e38), a[:, ::2])
    want = matmul_abft_grouped_plain(a_z, b, br)
    for x in (a, garbage):
        got = matmul_abft_grouped_plain(x, b, br, rows=rows)
        assert all(torch.equal(u, v) for u, v in zip(got, want))
    c, sums, none = matmul_abft_grouped_plain(garbage, b, None, rows=rows)
    assert none is None and torch.equal(c, want[0]) and torch.equal(
        sums, want[1])
    assert not c.masked_select(dead[..., None]).any()


@pytest.mark.parametrize("m", [6, 40])
@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_zero_row_extra_is_nan_where_the_full_product_s_is(bad, m):
    """A non-finite B element of an idle group (and of a live group with
    dead rows) makes every zero row's extra entry NaN, as 0·b_r does in the
    full product on the zeroed A; the other groups' stay finite."""
    a, b, _ = _operands(3, m, 40, 24, torch.float32, m)
    b[0].view(-1)[7] = bad                      # group 0: idle
    b[1].view(-1)[11] = bad                     # group 1: 2 live rows
    br = b.sum(dim=2).contiguous()
    rows = torch.tensor([0, 2, m], dtype=torch.int32)
    got = matmul_abft_grouped_plain(a, b, br, rows=rows)
    full = matmul_abft_grouped_plain(zero_dead_rows(a, rows), b, br)
    assert _same(got[2], full[2])
    assert torch.isnan(got[2][0]).all() and torch.isnan(got[2][1, 2:]).all()
    assert torch.isfinite(got[2][2]).all()


def test_the_wrapper_refuses_bad_counts():
    a, b = torch.ones(3, 5, 4), torch.ones(3, 4, 2)
    ok = torch.tensor([0, 5, 2], dtype=torch.int32)
    assert _check_grouped(a, b, None, False, rows=ok) == (3, 5, 2, 4)
    for rows, match in (
            (torch.tensor([0, 5], dtype=torch.int32), "int32"),
            (torch.tensor([[0, 5, 2]], dtype=torch.int32), "int32"),
            (torch.tensor([0, 5, 2]), "int32"),
            (torch.tensor([0, 5, 2], dtype=torch.int32, device="meta"),
             "lie on"),
            (torch.tensor([0, 9, 5, 9, 2, 9], dtype=torch.int32)[::2],
             "contiguous"),
            (torch.tensor([0, 6, 2], dtype=torch.int32), r"\[0, 5\]"),
            (torch.tensor([-1, 5, 2], dtype=torch.int32), r"\[0, 5\]")):
        with pytest.raises(ValueError, match=match):
            _check_grouped(a, b, None, False, rows=rows)
        with pytest.raises(ValueError, match=match):
            matmul_abft_grouped_kernel(a, b, None, rows=rows)
    with pytest.raises(ValueError, match="as it lies"):
        matmul_abft_grouped_kernel(a, b.transpose(1, 2).contiguous(), None,
                                   trans_b=True, rows=ok)


def _grads(fn, a, b, dc):
    xs = [a.clone().requires_grad_(True), b.clone().requires_grad_(True)]
    return fn(*xs), torch.autograd.grad(fn(*xs), xs, dc)


@pytest.mark.parametrize("g,m,k,n,counts", [
    (2, 8, 4, 3, (3, 8)),                   # the case that found the fault
    (3, 6, 70, 33, (0, 6, 2)),              # thin path (M <= 16)
    (4, 17, 33, 20, (17, 0, 16, 1)),        # wide path, either side of 16
    (3, 40, 9, 65, (39, 0, 40)),
])
def test_counted_backward_is_autograd_of_the_zeroed_product(g, m, k, n,
                                                            counts):
    """With counts and non-zero dead rows in A and dC, the Function's
    gradients are autograd's of ``zero_dead_rows(a, rows) @ b``: dA's dead
    rows exactly +0, dB without the dead rows of A."""
    a, b, _ = _operands(g, m, k, n, torch.float32, g + m + k + n)
    dc = torch.randn((g, m, n), generator=torch.Generator().manual_seed(m))
    rows = torch.tensor(counts, dtype=torch.int32)
    dead = torch.arange(m)[None, :] >= rows[:, None]
    assert (a.masked_select(dead[..., None]) != 0).all() and dead.any()
    c, (da, db) = _grads(lambda x, y: GroupedMatmulAbftFunction.apply(
        x, y, None, rows)[0], a, b, dc)
    want_c, (want_da, want_db) = _grads(
        lambda x, y: zero_dead_rows(x, rows) @ y, a, b, dc)
    for got, want in ((c, want_c), (da, want_da), (db, want_db)):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=ATOL)
    dead_da = da.masked_select(dead[..., None])
    assert not dead_da.any() and not torch.signbit(dead_da).any()


def test_uncounted_backward_keeps_its_launches():
    """Without counts the backward is the two launches it always was, bit
    for bit: dA = dC·Bᵀ with ``trans_b`` on B as it lies, dB = Aᵀ·dC on a
    contiguous transposed copy of A."""
    a, b, _ = _operands(3, 17, 33, 20, torch.float32, 5)
    dc = torch.randn((3, 17, 20), generator=torch.Generator().manual_seed(6))
    _, (da, db) = _grads(lambda x, y: GroupedMatmulAbftFunction.apply(
        x, y, None, None)[0], a, b, dc)
    assert torch.equal(da, matmul_abft_grouped_kernel(dc, b, None,
                                                      trans_b=True)[0])
    assert torch.equal(db, matmul_abft_grouped_kernel(
        a.transpose(1, 2).contiguous(), dc)[0])


@settings(max_examples=20, deadline=None)
@given(tokens=st.integers(1, 64), top_k=st.integers(1, 4),
       n_experts=st.sampled_from([4, 8, 16]), capf=st.sampled_from(
           [0.25, 0.5, 1.25, 4.0]), seed=st.integers(0, 2 ** 16))
def test_expert_rows_are_each_expert_s_kept_slots(tokens, top_k, n_experts,
                                                  capf, seed):
    """``expert_rows`` = max(slot) + 1 over each expert's kept
    assignments (0 for an expert none reaches), in int32."""
    mc = MoECfg(n_experts=n_experts, top_k=min(top_k, n_experts),
                d_ff_expert=8, capacity_factor=capf)
    gen = torch.Generator().manual_seed(seed)
    experts = torch.stack([torch.randperm(n_experts, generator=gen)[
        :mc.top_k] for _ in range(tokens)])
    flat, slot, keep, cap = moe.assign(experts, mc)
    rows = moe.expert_rows(flat, keep, n_experts)
    assert rows.dtype == torch.int32 and rows.shape == (n_experts,)
    want = np.zeros(n_experts, np.int64)
    for e, s, kept in zip(flat.tolist(), slot.tolist(), keep.tolist()):
        if kept:
            want[e] = max(want[e], s + 1)
    assert rows.tolist() == want.tolist() and int(rows.max()) <= cap


def _idle_expert(np_p, x, jcfg, jabft):
    """An expert that no kept assignment of the reference's routing of
    ``x`` reaches."""
    from repro.models.moe import _capacity as jcapacity
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    logits, _ = jdense(jax.tree.map(jnp.asarray, np_p["router"]), xt, jabft)
    _, experts = jax.lax.top_k(jax.nn.softmax(logits.astype(jnp.float32)),
                               jcfg.moe.top_k)
    flat = np.asarray(experts).reshape(-1)
    onehot = np.eye(jcfg.moe.n_experts, dtype=np.int64)[flat]
    slot = (np.cumsum(onehot, axis=0) * onehot - 1).max(axis=1)
    keep = slot < jcapacity(xt.shape[0], jcfg.moe)
    live = set(flat[keep].tolist())
    idle = [e for e in range(jcfg.moe.n_experts) if e not in live]
    assert idle, "every expert is reached: no idle one to plant in"
    return idle[0]


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
@pytest.mark.parametrize("leaf", ["w_up", "w_gate", "w_down"])
@pytest.mark.parametrize("name", MOE_ARCHS)
@pytest.mark.parametrize("mode", ["fused", "split"])
def test_non_finite_weights_of_an_idle_expert_flag_as_in_the_reference(
        mode, name, leaf, bad):
    """The reference's einsum gives 0·NaN = NaN in an idle expert's rows;
    the counted launch skips them but its extra column is NaN there all the
    same: the up and gate checks flag, the down product's only in split
    mode (the fused combine gathers no idle row), in both packages."""
    jcfg = jsmoke_config(jget_config(name))
    cfg = smoke_config(get_config(name))
    jabft = JABFTConfig(mode=mode, dtype=jnp.float32, threshold=1e-3,
                        relative=True)
    abft = ABFTConfig(mode=mode, threshold=1e-3, relative=True)
    np_p = jax.tree.map(np.asarray, jinit_moe(jax.random.PRNGKey(0), jcfg))
    x = np.random.default_rng(3).standard_normal(
        (1, 2, cfg.d_model)).astype(np.float32)
    e = _idle_expert(np_p, x, jcfg, jabft)
    w = np_p[leaf].copy()
    w[e, 1, 2] = bad
    np_p = dict(np_p, **{leaf: w})
    p = convert.params_from_numpy(np_p, device="cpu")
    jy, jchecks, _ = jmoe_block(jax.tree.map(jnp.asarray, np_p),
                                jnp.asarray(x), jcfg, jabft)
    y, checks, _ = moe.moe_block(p, torch.from_numpy(x), cfg, abft)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    jids, jflags, _ = jper_op_report(jchecks, jabft)
    ids, flags, _ = per_op_report(checks, abft)
    assert ids == tuple(jids)
    assert flags.tolist() == np.asarray(jflags).tolist()
    assert bool(flags.any()) == (leaf != "w_down" or mode == "split")


COUNT_SHAPES = [(8, 6, 70, 130), (5, 16, 2050, 130), (4, 17, 33, 65),
                (6, 120, 70, 130), (3, 129, 99, 131)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_counted_launch_is_the_uncounted_one_on_zeroed_rows(dtype):
    """On the card, both tile paths, ragged shapes: with counts (all 0, all
    M, one full group among empty ones, and counts on either side of 16 and
    64) the kernel agrees with its plain version and is bit for bit the
    launch without counts on the zeroed A, also on garbage dead rows; a
    second run is bit for bit the first."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (torch.cuda.is_available() "
                    "is false)")
    tol = ATOL if dtype == torch.float32 else 2e-2
    for g, m, k, n in COUNT_SHAPES:
        a, b, br = (t.cuda() for t in _operands(g, m, k, n, dtype, m * k))
        edge = [[0] * g, [m] * g, [m] + [0] * (g - 1),
                [min(m, c) for c in (15, 16, 17, 63, 64, 65, 1, m)][:g]
                + [m // 2] * max(0, g - 8)]
        for counts in edge:
            rows = torch.tensor(counts, dtype=torch.int32, device="cuda")
            dead = torch.arange(m, device="cuda")[None, :] >= rows[:, None]
            garbage = a.masked_fill(dead[..., None], 1e30)
            got = matmul_abft_grouped_kernel(garbage, b, br, rows=rows)
            bare = matmul_abft_grouped_kernel(zero_dead_rows(a, rows), b, br)
            assert all(_same(x, y) for x, y in zip(got, bare)), counts
            want = matmul_abft_grouped_plain(garbage, b, br, rows=rows)
            torch.testing.assert_close(got[0].float(), want[0].float(),
                                       atol=tol, rtol=tol)
            torch.testing.assert_close(got[2], want[2], atol=ATOL, rtol=ATOL)
            again = matmul_abft_grouped_kernel(garbage, b, br, rows=rows)
            assert all(torch.equal(x, y) for x, y in zip(got, again))
