"""B4's wide Bᵀ path (``matmul_abft`` with ``trans_b`` at M > 16): a train
step's dA = dC·Bᵀ and the tied LM head's training forward.

The JAX package's ``matmul_abft`` takes B as it lies only, so the port's
transposed product is held against it on the transposed B (the JAX side in
interpret mode, its tests' tolerances: f32 ``c`` within ``rtol 2e-5, atol
1.6e-4``, bf16 ``2e-2 / 0.16``; corners within ``1e-4`` of ``max(1,
|actual|)``).  ``chip_smoke.py``'s ``matmul_bt`` table must hold every Bᵀ
launch a train step makes (the dA of each layer product and the tied
head), and its float64 witness for the extra column must pass rounding and
reject a wrong entry.  On a GPU (``cuda`` marker) the kernel's Bᵀ launch is
bit for bit the same launch on a transposed copy of B (C, block sums,
extra; single and grouped, f32 and bf16)."""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul_abft import ops as jmm
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.abft import ABFTConfig
from repro_torch.data import SyntheticLM
from repro_torch.kernels.matmul_abft import kernel as tmk
from repro_torch.kernels.matmul_abft import ops as tmm
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.optim import AdamWConfig

# M > 16, both sides of the 128-row and 128-column blocks, K not a multiple
# of 4 (the scalar tail) and of 32 (a partial last chunk)
SHAPES = [(40, 64, 256), (129, 70, 130), (200, 100, 72), (255, 99, 131)]
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def _np(seed, shape, scale=1.0):
    return np.random.default_rng(seed).normal(0, scale, size=shape).astype(
        np.float32)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_bt_product_matches_the_jax_op_on_the_transposed_b(m, k, n, dtypes):
    tdt, jdt = dtypes
    a, bt = _np(m + 3, (m, k)), _np(n + 5, (n, k), k ** -0.5)
    jc, jchk = jmm.matmul_abft(jnp.asarray(a).astype(jdt),
                               jnp.asarray(bt.T).astype(jdt), interpret=True)
    tc, tchk = tmm.matmul_abft(torch.from_numpy(a).to(tdt),
                               torch.from_numpy(bt).to(tdt), trans_b=True)
    tol = 2e-2 if tdt == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(tc.float().numpy(),
                               np.asarray(jc.astype(jnp.float32)), rtol=tol,
                               atol=tol * 8)
    for got, want in ((tchk.predicted, jchk.predicted),
                      (tchk.actual, jchk.actual)):
        assert abs(float(got) - float(want)) <= 1e-4 * max(1.0,
                                                          abs(float(want)))


def test_chip_smoke_bt_table_is_every_bt_launch_of_a_train_step():
    """A smoke gemma-2b train step on the CPU makes exactly the Bᵀ launches
    at M > 16 that ``chip_smoke.py``'s ``matmul_bt`` derives from
    ``lm_matmul_shapes``: the dA of every prefill product at M > 16 (K and
    N swapped, unchecked) and the tied head's forward over every position
    (checked)."""
    cs = _chip_smoke()
    cfg = smoke_config(get_config("gemma-2b"))
    batch, seq = 2, 32
    abft = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    step = make_train_step(cfg, abft, AdamWConfig(), total_steps=10,
                           warmup=2)
    state = init_train_state(cfg, 0, device="cpu")
    b0 = {k: torch.as_tensor(v) for k, v in next(SyntheticLM(
        cfg.vocab_size, seq, batch, seed=0).batches()).items()}
    seen, real = {}, tmm.matmul_abft_kernel

    def spy(a, b, br=None, *, trans_b=False):
        if trans_b and a.shape[0] > 16:
            key = (a.shape[0], a.shape[1], b.shape[0], br is not None)
            seen[key] = seen.get(key, 0) + 1
        return real(a, b, br, trans_b=trans_b)
    tmm.matmul_abft_kernel = spy
    try:
        step(state, b0)
    finally:
        tmm.matmul_abft_kernel = real
    want = {(m, n, k, False): c["prefill"] for (m, k, n, tb), c in
            cs.lm_matmul_shapes(cfg, batch, seq).items()
            if m > 16 and not tb}
    want[batch * seq, cfg.d_model, cfg.padded_vocab, True] = 1
    assert seen == want


@pytest.mark.parametrize("m,k", [(6, 300), (64, 2048)])
def test_chip_smoke_extra_rule_passes_rounding_and_rejects_a_wrong_entry(
        m, k):
    """``check_extra`` passes an extra column off the yardstick past
    ``1e-4`` where it is the float64 product to f32 rounding (an entry
    that cancels next to a b_r of |500|), and rejects one entry moved by
    a typical |a b_r| term, dropped or doubled."""
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(31)
    a = torch.randn(m, k, generator=gen)
    br = torch.randn(k, generator=gen) * 500
    _, _, extra = tmk.matmul_abft_plain(a, torch.ones(k, 3), br)
    cs.check_extra(torch, "plain", a, br, extra, extra.clone())
    off = extra - 1.5 * (cs.OUT_ATOL + cs.OUT_RTOL * extra.abs())
    got = cs.check_extra(torch, "rounded", a, br, extra, off)
    assert got["over_tol"] == m and got["max_witness_ratio"] < 1
    term = (a[0] * br).abs().median()
    for sign in (-1.0, 1.0):
        bad = extra.clone()
        bad[0, 0] += sign * term
        with pytest.raises(AssertionError, match="entries over"):
            cs.check_extra(torch, "planted", a, br, bad, extra)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_bt_launch_is_the_b_path_on_a_transposed_copy(dtype):
    """The Bᵀ launch (single and grouped) gives the same C, block sums and
    extra column as the launch on a transposed copy of B, bit for bit, at
    ragged shapes and at gemma-2b's q/o dA (M 1024, K = N 2048)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    for m, k, n in SHAPES + [(1024, 2048, 2048), (300, 256, 384)]:
        a = torch.from_numpy(_np(m, (m, k))).to(dtype).cuda()
        b = torch.from_numpy(_np(n, (n, k), k ** -0.5)).to(dtype).cuda()
        br = b.float().sum(0).contiguous()
        got = tmk.matmul_abft_kernel(a, b, br, trans_b=True)
        same = tmk.matmul_abft_kernel(a, b.t().contiguous(), br)
        assert all(torch.equal(x, y) for x, y in zip(got, same)), (m, k, n)
        want = tmk.matmul_abft_plain(a, b, br, trans_b=True)
        tol = 1e-4 if dtype == torch.float32 else 3e-2
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   atol=tol, rtol=tol)
    g, m, k, n = 5, 129, 70, 130
    a = torch.from_numpy(_np(1, (g, m, k))).to(dtype).cuda()
    b = torch.from_numpy(_np(2, (g, n, k), k ** -0.5)).to(dtype).cuda()
    br = b.float().sum(1).contiguous()
    got = tmk.matmul_abft_grouped_kernel(a, b, br, trans_b=True)
    same = tmk.matmul_abft_grouped_kernel(a, b.transpose(1, 2).contiguous(),
                                          br)
    assert all(torch.equal(x, y) for x, y in zip(got, same))
