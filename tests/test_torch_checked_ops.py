"""The checked-op kernels and protocol pieces of the port against the JAX
package.

On the CPU the port's wrappers run each kernel's plain PyTorch version; the
JAX side runs the Pallas kernels in interpret mode, as its own tests do
(``tests/test_kernels.py``), at a trimmed set of those tests' shapes and
with their tolerances: f32 ``c`` within ``rtol 2e-5, atol 1.6e-4``, bf16
within ``2e-2 / 0.16``; flash f32 ``o`` within ``2e-4 / 8e-4``, bf16
``3e-2 / 0.12``, ``o_extra`` twice / eight times those.  The checksum
corners agree within ``1e-4`` of ``max(1, |actual|)`` (the same f32 sums in
another order).  The CUDA kernels are held against the same plain versions
on a GPU (the ``cuda``-marked cases, and ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import abft as jabft
from repro.kernels.flash_checksum import ops as jflash
from repro.kernels.matmul_abft import ops as jmm
from repro_torch.analysis import vmem
from repro_torch.configs import get_config
from repro_torch.core import abft as tabft
from repro_torch.kernels import runtime
from repro_torch.kernels.flash_checksum import kernel as tfk
from repro_torch.kernels.flash_checksum import ops as tflash
from repro_torch.kernels.flash_checksum.ref import flash_checksum_ref
from repro_torch.kernels.matmul_abft import kernel as tmk
from repro_torch.kernels.matmul_abft import ops as tmm
from repro_torch.kernels.matmul_abft.ref import matmul_abft_ref

JCFG = jabft.ABFTConfig(mode="fused", threshold=1e-3, relative=True)
TCFG = tabft.ABFTConfig(mode="fused", threshold=1e-3, relative=True)
TOFF = tabft.ABFTConfig(mode="none")
CORNER_RTOL = 1e-4


def _np(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, scale, size=shape)).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _corner_close(got, want, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= CORNER_RTOL * max(1.0, abs(want)), \
        f"{what}: {got} vs {want}"


DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


# ---------------------------------------------------------------------------
# matmul_abft
# ---------------------------------------------------------------------------

# M > 16: the wide path's 128-row blocks, one row past one block (129) and
# one row short of two (255), with K and N not multiples of 4 (the scalar
# tail of the cp.async ring) and N past one 128-column tile
WIDE_EDGES = [(129, 70, 130), (255, 99, 131)]


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (200, 100, 72),
                                   (2, 256, 136)] + WIDE_EDGES)
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_matmul_abft_matches_the_jax_op(m, k, n, dtypes):
    tdt, jdt = dtypes
    a, b = _np(m * 7 + 1, (m, k)), _np(n * 13 + 2, (k, n))
    jc, jchk = jmm.matmul_abft(_j(a, jdt), _j(b, jdt), interpret=True)
    tc, tchk = tmm.matmul_abft(_t(a, tdt), _t(b, tdt))
    tol = 2e-2 if tdt == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(_f32(tc), _f32(jc), rtol=tol, atol=tol * 8)
    assert tchk.granularity == jchk.granularity == "layer"
    _corner_close(tchk.predicted, jchk.predicted, "predicted")
    _corner_close(tchk.actual, jchk.actual, "actual")
    assert not bool(tchk.flag(tabft.ABFTConfig(threshold=0.2)))


@pytest.mark.parametrize("m,k,n", [(40, 24, 16), (3, 70, 130)] + WIDE_EDGES)
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_matmul_abft_plain_against_the_dense_oracle(m, k, n, dtypes):
    """Raw outputs of the plain version (the kernel's function) against the
    dense oracle, plain and transposed B, with and without the column."""
    tdt, _ = dtypes
    a, b = _t(_np(1, (m, k)), tdt), _t(_np(2, (k, n)), tdt)
    br = b.to(torch.float32).sum(1)
    c_ref, actual_ref, extra_ref = matmul_abft_ref(a, b, br[:, None])
    tol = 2e-2 if tdt == torch.bfloat16 else 2e-5
    for trans in (False, True):
        bb = b.t().contiguous() if trans else b
        c, sums, extra = tmk.matmul_abft_plain(a, bb, br, trans_b=trans)
        np.testing.assert_allclose(_f32(c), _f32(c_ref), rtol=tol,
                                   atol=tol * 8)
        _corner_close(sums.sum(), actual_ref, "block sums")
        np.testing.assert_allclose(_f32(extra), _f32(extra_ref), rtol=1e-5,
                                   atol=1e-4)
        tm, tn = tmk.matmul_tile(m)
        assert tuple(sums.shape) == (-(-m // tm), -(-n // tn))
        c2, _, extra2 = tmk.matmul_abft_plain(a, bb, None, trans_b=trans)
        assert extra2 is None and torch.equal(c2, c)


# M <= 16 (decode steps, the LM head): the thin split-K path.  K not a
# multiple of 32 (2050, 33, 100) or of the split, N not a multiple of 4
# (130, 65), K of a transposed B not a multiple of 4 (33).
THIN = [(2, 16384, 64, False), (16, 2050, 130, False), (1, 33, 65, True),
        (2, 100, 72, True)]


@pytest.mark.parametrize("m,k,n,trans", THIN,
                         ids=["2x16384x64", "16x2050x130", "1x33x65T",
                              "2x100x72T"])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_thin_matmul_plain_matches_the_jax_op_and_float64(m, k, n, trans,
                                                          dtypes):
    """The plain version in the split-K association against the JAX op
    (interpret mode, B as [K, N]: it has no transposed operand) with the
    tolerances above, and against a float64 product of the same (rounded)
    operands: f32 C within 1e-4 + 1e-5 |C|, bf16 C within its rounding
    (2^-8 |C|) + 1e-4; ``extra`` within 1e-4 + 1e-5 |extra|."""
    tdt, jdt = dtypes
    a = _np(m * 3 + k, (m, k))
    b = _np(n * 5 + k, (k, n), k ** -0.5)
    ta = _t(a, tdt)
    tb = _t(b.T if trans else b, tdt)
    b32 = tb.to(torch.float32)
    br = b32.sum(dim=0 if trans else 1).contiguous()
    c, sums, extra = tmk.matmul_abft_plain(ta, tb, br, trans_b=trans)
    assert c.dtype == tdt and tuple(c.shape) == (m, n)
    assert tuple(sums.shape) == (1, -(-n // 64))
    jc, jchk = jmm.matmul_abft(_j(a, jdt), _j(b, jdt), jnp.asarray(br.numpy()),
                               block_m=16, block_n=128, block_k=512,
                               interpret=True)
    tol = 2e-2 if tdt == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(_f32(c), _f32(jc), rtol=tol, atol=tol * 8)
    _corner_close(sums.sum(), jchk.actual, "actual")
    _corner_close(extra.sum(), jchk.predicted, "predicted")
    a64 = ta.to(torch.float64)
    ref = a64 @ (b32.t() if trans else b32).to(torch.float64)
    err = (c.to(torch.float64) - ref).abs()
    rel = 2.0 ** -8 if tdt == torch.bfloat16 else 1e-5
    assert bool((err <= 1e-4 + rel * ref.abs()).all()), float(err.max())
    ex_ref = a64 @ br.to(torch.float64)[:, None]
    assert bool(((extra.to(torch.float64) - ex_ref).abs()
                 <= 1e-4 + 1e-5 * ex_ref.abs()).all())
    c2, _, ex2 = tmk.matmul_abft_plain(ta, tb, None, trans_b=trans)
    assert ex2 is None and torch.equal(c2, c)


def test_matmul_splits_cover_k_and_fill_the_card():
    """Every split is a whole number of 32-wide chunks (the last ends at
    K), the splits cover K, and every gemma-2b decode shape (M = 2) makes
    >= 264 (column tile, split) items — 2 per H100 SM, the resident blocks
    of the f32 M <= 2 kernel, so each launch fills the card — where K has
    enough chunks: q/o 64 splits x 8 tiles = 512 items (one split per
    chunk: K 2048 allows no more splits), k/v 64 x 1 = 64 (likewise),
    gate/up 8 x 64 = 512, down 64 x 8 = 512, the tied head 1 x 1000 =
    1000."""
    cfg = get_config("gemma-2b")
    d, hq = cfg.d_model, cfg.n_heads * cfg.hd
    hkv, ff, vocab = cfg.n_kv_heads * cfg.hd, cfg.d_ff, cfg.padded_vocab
    decode = {(d, hq): (64, 512), (d, hkv): (64, 64), (d, ff): (8, 512),
              (ff, d): (64, 512), (hq, d): (64, 512), (d, vocab): (1, 1000)}
    for (k, n), (splits, items) in decode.items():
        tiles = -(-n // vmem.MATMUL_THIN_N)
        assert vmem.matmul_splits(2, n, k) == splits
        assert splits * tiles == items
        assert items >= 2 * vmem.MATMUL_SMS == 264 or \
            splits == -(-k // vmem.MATMUL_BLOCK_K)
        assert items <= vmem.MATMUL_MAX_ITEMS or splits == 1
    shapes = [(m, k, n) for m in (1, 2, 7, 16) for k in (1, 31, 33, 2050,
                                                         16384)
              for n in (1, 65, 256, 2049)] + [(m, k, n) for m, k, n, _ in THIN]
    for m, k, n in shapes:
        kc, splits = vmem.matmul_split_k(m, n, k), vmem.matmul_splits(m, n, k)
        assert kc % vmem.MATMUL_BLOCK_K == 0 and kc > 0
        bounds = [(s * kc, min((s + 1) * kc, k)) for s in range(splits)]
        assert bounds[0][0] == 0 and bounds[-1][1] == k
        assert all(lo < hi for lo, hi in bounds)
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    for m in (17, 1024):
        assert vmem.matmul_splits(m, 2048, 16384) == 1
        assert vmem.matmul_split_k(m, 2048, 16384) == 16384


def test_matmul_abft_detects_corruption():
    a, b = _t(_np(3, (128, 128))), _t(_np(4, (128, 128)))
    c, chk = tmm.matmul_abft(a, b)
    bad = c.clone()
    bad[7, 9] += 100.0
    assert abs(float(chk.predicted) - float(bad.sum())) > 50.0


def test_matmul_abft_kernel_op_conforms():
    a, b = _t(_np(7, (40, 24), 0.3)), _t(_np(8, (24, 16), 0.3))
    op = tmm.MatmulAbftOp()
    out, chk = op(TCFG, a, b)
    assert isinstance(chk, tabft.Check) and chk.granularity == "layer"
    np.testing.assert_allclose(out.numpy(), (a @ b).numpy(), atol=1e-4,
                               rtol=1e-4)
    assert not bool(chk.flag(TCFG))
    folded = op.fold({"w": b}, TCFG)
    out2, chk2 = op(TCFG, a, b, w_r=folded["w_r"])
    assert not bool(chk2.flag(TCFG)) and torch.equal(out2, out)
    out3, chk3 = op(TOFF, a, b)
    assert chk3 is None and torch.equal(out3, out)
    # JAX's op on the same numbers gives the same verdict corners
    jout, jchk = jmm.MatmulAbftOp(block_m=16, block_n=16, block_k=16,
                                  interpret=True)(JCFG, _j(a.numpy()),
                                                  _j(b.numpy()))
    _corner_close(chk.predicted, jchk.predicted, "predicted")
    _corner_close(chk.actual, jchk.actual, "actual")


# ---------------------------------------------------------------------------
# flash_checksum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,kh,t,s,dh", [
    (2, 4, 2, 128, 256, 64),     # GQA, T < S
    (1, 4, 1, 128, 128, 32),     # MQA
    (1, 2, 2, 100, 128, 64),     # q padding path on the JAX side
    (1, 2, 1, 160, 160, 32),     # a query tile of 5 key blocks: parts 3 + 2
])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_flash_checksum_matches_the_jax_op(b, h, kh, t, s, dh, dtypes):
    tdt, jdt = dtypes
    q, k = _np(1, (b, t, h, dh)), _np(2, (b, s, kh, dh))
    v, w_or = _np(3, (b, s, kh, dh)), _np(4, (h, dh))
    jo, jex = jflash.flash_attention_checksum(
        _j(q, jdt), _j(k, jdt), _j(v, jdt), _j(w_or), causal=True,
        block_q=128, block_k=128, interpret=True)
    to, tex = tflash.flash_attention_checksum(_t(q, tdt), _t(k, tdt),
                                              _t(v, tdt), _t(w_or))
    tol = 3e-2 if tdt == torch.bfloat16 else 2e-4
    np.testing.assert_allclose(_f32(to), _f32(jo), rtol=tol, atol=tol * 4)
    np.testing.assert_allclose(_f32(tex), _f32(jex), rtol=tol * 2,
                               atol=tol * 8)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_flash_checksum_plain_against_the_materialized_oracle(dtypes):
    """The plain version (the kernel's function, model layout, the KV head
    indexed per query head) against the materialized-A oracle in the TPU
    kernel's per-(batch·head) layout; the column leaves o unchanged."""
    tdt, _ = dtypes
    b, t, h, kh, dh = 2, 70, 4, 2, 16
    q = _t(_np(5, (b, t, h, dh)), tdt)
    k, v = _t(_np(6, (b, t, kh, dh)), tdt), _t(_np(7, (b, t, kh, dh)), tdt)
    vr = _t(_np(8, (b, t, h)), tdt)
    o, ex = tfk.flash_checksum_plain(q, k, v, vr)
    g = h // kh

    def per_head(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, t, -1)
    o_ref, ex_ref = flash_checksum_ref(
        per_head(q), per_head(k.repeat_interleave(g, 2)),
        per_head(v.repeat_interleave(g, 2)),
        vr.permute(0, 2, 1).reshape(b * h, t, 1))
    tol = 3e-2 if tdt == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(_f32(per_head(o)), _f32(o_ref), rtol=tol,
                               atol=tol * 4)
    np.testing.assert_allclose(_f32(ex.permute(0, 2, 1)).reshape(b * h, t),
                               _f32(ex_ref)[..., 0], rtol=tol * 2,
                               atol=tol * 8)
    o2, ex2 = tfk.flash_checksum_plain(q, k, v, None)
    assert ex2 is None and torch.equal(o2, o)


def test_flash_checksum_equals_chain_identity():
    """Σ o_extra must equal eᵀ(A·V·W_o)e computed the slow way."""
    b, h, t, dh, d = 1, 2, 128, 64, 96
    q, k, v = (_t(_np(s, (b, t, h, dh))) for s in (11, 12, 13))
    wo = _t(_np(14, (h * dh, d)))
    w_or = tflash.fold_w_or(wo, h, dh)
    o, ex = tflash.flash_attention_checksum(q, k, v, w_or)
    out = o.reshape(b, t, h * dh) @ wo
    np.testing.assert_allclose(float(ex.sum()), float(out.sum()), rtol=1e-4)
    np.testing.assert_allclose(
        w_or.numpy(), np.asarray(jflash.fold_w_or(_j(wo.numpy()), h, dh)),
        rtol=1e-6, atol=1e-5)


def test_flash_attention_op_checks_the_whole_chain():
    b, h, t, dh, d = 1, 4, 40, 16, 32
    q, k = _t(_np(21, (b, t, h, dh))), _t(_np(22, (b, t, 1, dh)))
    v, wo = _t(_np(23, (b, t, 1, dh))), _t(_np(24, (h * dh, d), 0.2))
    op = tflash.FlashAttentionOp()
    out, chk = op(TCFG, q, k, v, wo)
    assert tuple(out.shape) == (b, t, d) and not bool(chk.flag(TCFG))
    out_off, none = op(TOFF, q, k, v, wo)
    assert none is None and torch.equal(out_off, out)
    jout, jchk = jflash.FlashAttentionOp(block_q=128, block_k=128,
                                         interpret=True)(
        JCFG, *(_j(x.numpy()) for x in (q, k, v, wo)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4)
    _corner_close(chk.predicted, jchk.predicted, "predicted")
    _corner_close(chk.actual, jchk.actual, "actual")


# ---------------------------------------------------------------------------
# protocol pieces: reference ops, per-op report, NaN-safe verdicts
# ---------------------------------------------------------------------------

def _rand(seed, *shape, scale=0.3):
    return _np(seed, shape, scale)


def test_matmul_op_matches_the_jax_reference_op():
    a, b = _rand(0, 24, 16), _rand(1, 16, 8)
    out, chk = tabft.MatmulOp()(TCFG, _t(a), _t(b))
    jout, jchk = jabft.MatmulOp()(JCFG, _j(a), _j(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    _corner_close(chk.predicted, jchk.predicted, "predicted")
    _corner_close(chk.actual, jchk.actual, "actual")
    assert not bool(chk.flag(TCFG))
    bad = out.double().clone()
    bad[3, 4] += 10.0
    assert abs(float(chk.predicted) - float(bad.sum())) > TCFG.threshold
    out_off, chk_off = tabft.MatmulOp()(TOFF, _t(a), _t(b))
    assert chk_off is None and torch.equal(out_off, out)
    br = tabft.fold_w_r_tree({"w": _t(b)}, TCFG)["w_r"]
    _, chk_f = tabft.MatmulOp()(TCFG, _t(a), _t(b), b_r=br)
    _corner_close(chk_f.predicted, jchk.predicted, "folded predicted")


def test_chain_op_folded_w_r_matches_the_jax_reference_op():
    mats = [_rand(2, 20, 12), _rand(3, 12, 10), _rand(4, 10, 6)]
    tm = [_t(m) for m in mats]
    out, chk = tabft.ChainOp()(TCFG, *tm)
    folded = tabft.fold_w_r_tree({"w": tm[-1]}, TCFG)
    out_f, chk_f = tabft.ChainOp()(TCFG, *tm, w_r=folded["w_r"])
    assert torch.equal(out_f, out)
    jout, jchk = jabft.ChainOp()(JCFG, *(_j(m) for m in mats))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    for c in (chk, chk_f):
        _corner_close(c.predicted, jchk.predicted, "predicted")
        _corner_close(c.actual, jchk.actual, "actual")
        assert not bool(c.flag(TCFG))
    ref = tabft.check_chain(tm, out, TCFG)
    _corner_close(chk_f.predicted, ref.predicted, "vs check_chain")


@pytest.mark.parametrize("checks", [
    [(1.0, 1.0), None, ([2.0, 3.0], [2.0, 3.5])],       # layer 1 corrupted
    [([1.0, 2.0, 3.0], [1.0, 2.0, 3.0]), (5.0, 5.1), None,
     ([0.0, 1.0], [float("nan"), 1.0])],
    [None],
])
def test_per_op_report_matches_the_jax_reference(checks):
    def build(mod, arr):
        return [None if c is None else
                mod.Check(predicted=arr(c[0]), actual=arr(c[1]))
                for c in checks]
    tids, tflags, trels = tabft.per_op_report(
        build(tabft, lambda x: torch.tensor(x, dtype=torch.float32)), TCFG)
    jids, jflags, jrels = jabft.per_op_report(
        build(jabft, lambda x: jnp.asarray(x, jnp.float32)), JCFG)
    assert tids == jids
    assert tflags.tolist() == np.asarray(jflags).tolist()
    np.testing.assert_allclose(trels.numpy(), np.asarray(jrels), atol=1e-7)
    if checks == [None]:
        assert tids == () and tflags.shape == (0,)


def test_per_op_report_expands_stacked_checks():
    scalar = tabft.Check(predicted=torch.tensor(1.0),
                         actual=torch.tensor(1.0))
    stacked = tabft.Check(predicted=torch.tensor([2.0, 3.0]),
                          actual=torch.tensor([2.0, 3.5]))
    ids, flags, rels = tabft.per_op_report([scalar, None, stacked], TCFG,
                                           prefix="op")
    assert ids == ("op0", "op1:L0", "op1:L1")
    assert flags.tolist() == [False, False, True]
    assert float(rels[2]) > TCFG.threshold
    assert tabft.per_op_report([scalar], TOFF)[0] == ()


def test_nan_divergence_flags_where_naive_compare_is_silent():
    c = tabft.Check(predicted=torch.tensor(float("nan")),
                    actual=torch.tensor(1.0))
    d = float(np.abs(np.nan - 1.0))
    assert not (d > TCFG.threshold)          # the naive verdict: silent
    assert bool(c.flag(TCFG))                # the shipped verdict: flags
    f, _rel = c.elementwise(TCFG)
    assert bool(f.all())


def test_flash_chain_check_is_nan_safe_check():
    o_extra = torch.tensor([1.0, 2.0, 3.0])
    out = torch.tensor([[1.5, 1.5], [1.0, 2.0]])
    chk = tflash.chain_check(o_extra, out)
    assert isinstance(chk, tabft.Check) and chk.granularity == "layer"
    assert not bool(chk.flag(TCFG))
    bad = out.clone()
    bad[0, 0] = float("nan")
    assert bool(tflash.chain_check(o_extra, bad).flag(TCFG))


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (needs a GPU and nvcc)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_checked_op_kernels_match_plain_versions(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    runtime.reset_counts()
    # the wide path at its block edges (B and B^T) and at a prefill width
    # (gemma-2b's q/o: M 1024, K 2048, N 2048)
    shapes = [(2, 2048, 300, True), (200, 100, 72, False),
              (1024, 256, 384, False), (1024, 2048, 2048, False)] + THIN + [
        (m, k, n, trans) for m, k, n in WIDE_EDGES for trans in (False, True)]
    for m, k, n, trans in shapes:
        a = _t(_np(m, (m, k)), dtype).to(dev)
        b = _t(_np(n, (n, k) if trans else (k, n), k ** -0.5), dtype).to(dev)
        br = b.float().sum(0 if trans else 1).contiguous()
        got = tmk.matmul_abft_kernel(a, b, br, trans_b=trans)
        want = tmk.matmul_abft_plain(a, b, br, trans_b=trans)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w.float(), atol=tol,
                                       rtol=tol)
        again = tmk.matmul_abft_kernel(a, b, br, trans_b=trans)
        assert all(torch.equal(g, h) for g, h in zip(got, again))
        assert torch.equal(tmk.matmul_abft_kernel(a, b, None,
                                                  trans_b=trans)[0], got[0])
    # flash: GQA, gemma-2b's served prefill (MQA, dh 256), T < S, ragged T
    # with a narrow dh, and a dh whose rows are not whole 16-byte pieces
    flash_shapes = [(2, 100, 100, 4, 2, 64), (2, 512, 512, 8, 1, 256),
                    (2, 128, 256, 4, 2, 64), (1, 70, 70, 4, 4, 16),
                    (1, 33, 50, 2, 2, 70)]
    for b, t, s, h, kh, dh in flash_shapes:
        q = _t(_np(1, (b, t, h, dh)), dtype).to(dev)
        kk, v = (_t(_np(x, (b, s, kh, dh)), dtype).to(dev) for x in (2, 3))
        vr = _t(_np(4, (b, s, h)), dtype).to(dev)
        got = tfk.flash_checksum_kernel(q, kk, v, vr)
        want = tfk.flash_checksum_plain(q, kk, v, vr)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w.float(), atol=2 * tol,
                                       rtol=2 * tol)
        assert torch.equal(tfk.flash_checksum_kernel(q, kk, v, None)[0],
                           got[0])
        again = tfk.flash_checksum_kernel(q, kk, v, vr)
        assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert runtime.launch_counts()["matmul_abft"] == 3 * len(shapes)
    assert runtime.launch_counts()["flash_checksum"] == 3 * len(flash_shapes)
    # the library's cut is the one analysis.vmem models
    lib = runtime.load_library()
    assert (lib.flash_checksum_block_q(), lib.flash_checksum_block_k()) == \
        (vmem.FLASH_BLOCK_Q, vmem.FLASH_BLOCK_K)
    for dh in (16, 64, 70, 128, 256):
        assert lib.flash_checksum_head_tile(dh) == vmem.flash_head_tile(dh)
        assert lib.flash_checksum_smem_bytes(dh) == vmem.flash_smem_bytes(dh)
