"""B5 (``flash_checksum``) with a sliding window, against the JAX package.

Key j is valid for query i iff ``j <= i`` and ``j > i - window`` (the
reference's ``models/attention.py`` mask).  On the CPU the port's wrapper
runs the plain version, which walks each query tile's key blocks from the
block of its first row's earliest key through its diagonal, cut into the
kernel's parts (``analysis.vmem.flash_part_start``); it is held against the
JAX package's ``streaming_attention`` with the same window and against a
dense masked softmax in float64, at windows of 1, one key block and either
side of it, and past T, over ragged T and GQA.  f32 ``o`` within
``atol 2e-5``, ``o_extra`` within ``1e-4`` (sums of up to ~10 here: a few
f32 spacings).  The part starts are held against a brute-force recount of
each tile's valid key blocks.  The CUDA kernel is held against the plain
version on a GPU (the ``cuda``-marked case, and ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import streaming_attention as jstreaming
from repro_torch.analysis import vmem
from repro_torch.kernels import runtime
from repro_torch.kernels.flash_checksum import kernel as tfk

# (b, t, h, kh, dh): ragged T (not a multiple of the 32-key block) with GQA,
# and a T past three blocks with MQA
SHAPES = [(1, 70, 4, 2, 16), (2, 100, 4, 1, 32)]
WINDOWS = [1, 31, 32, 33, 200]          # 200: past T, the causal mask alone


def _np(seed, shape):
    return np.random.default_rng(seed).normal(0, 1, size=shape).astype(
        np.float32)


def _operands(b, t, h, kh, dh):
    return (_np(1, (b, t, h, dh)), _np(2, (b, t, kh, dh)),
            _np(3, (b, t, kh, dh)), _np(4, (b, t, h)))


def _dense_f64(q, k, v, vr, window):
    """Softmax over the valid keys of each query, materialized, float64."""
    b, t, h, dh = q.shape
    g = h // k.shape[2]
    kk, vv = (np.repeat(x.astype(np.float64), g, axis=2) for x in (k, v))
    sc = np.einsum("bthd,bshd->bhts", q.astype(np.float64), kk) * dh ** -0.5
    i, j = np.arange(t)[:, None], np.arange(t)[None, :]
    valid = (j <= i) & (j > i - window)
    sc = np.where(valid, sc, -np.inf)
    a = np.exp(sc - sc.max(-1, keepdims=True))
    a /= a.sum(-1, keepdims=True)
    o = np.einsum("bhts,bshd->bthd", a, vv)
    ex = np.einsum("bhts,bsh->bth", a, vr.astype(np.float64))
    return o, ex


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("shape", SHAPES, ids=["t70-gqa", "t100-mqa"])
def test_windowed_plain_matches_the_jax_streaming_attention(shape, window):
    b, t, h, kh, dh = shape
    q, k, v, vr = _operands(*shape)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))
    jo, jex, _, _ = jstreaming(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vr),
        q_positions=jnp.asarray(pos), k_positions=jnp.asarray(pos),
        causal=True, window=window, chunk=32)
    to, tex = tfk.flash_checksum_plain(*(torch.from_numpy(x)
                                         for x in (q, k, v, vr)),
                                       window=window)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(tex.numpy(), np.asarray(jex), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("shape", SHAPES, ids=["t70-gqa", "t100-mqa"])
def test_windowed_plain_matches_a_dense_masked_softmax(shape, window):
    q, k, v, vr = _operands(*shape)
    o_ref, ex_ref = _dense_f64(q, k, v, vr, window)
    to, tex = tfk.flash_checksum_plain(*(torch.from_numpy(x)
                                         for x in (q, k, v, vr)),
                                       window=window)
    np.testing.assert_allclose(to.numpy(), o_ref, atol=2e-5, rtol=0)
    np.testing.assert_allclose(tex.numpy(), ex_ref, atol=1e-4, rtol=0)
    # the column leaves o alone; a window past T is the causal mask
    o2, ex2 = tfk.flash_checksum_plain(*(torch.from_numpy(x)
                                         for x in (q, k, v)), window=window)
    assert ex2 is None and torch.equal(o2, to)
    if window >= shape[1]:
        o3, ex3 = tfk.flash_checksum_plain(*(torch.from_numpy(x)
                                             for x in (q, k, v, vr)))
        assert torch.equal(o3, to) and torch.equal(ex3, tex)


@pytest.mark.parametrize("t,window", [(257, w) for w in (0, 1, 31, 32, 33,
                                                         100, 300)]
                         + [(512, 0), (5120, 4096)])
def test_part_starts_match_a_brute_force_recount(t, window):
    """For self-attention over T = S keys, each query tile's first and end
    key block are those of the keys some row of it may see, and the parts
    split that range evenly, the earlier parts taking the extra blocks."""
    bq, bk, parts = vmem.FLASH_BLOCK_Q, vmem.FLASH_BLOCK_K, vmem.FLASH_PARTS
    i, j = np.arange(t)[:, None], np.arange(t)[None, :]
    valid = j <= i
    if window:
        valid &= j > i - window
    n_qt, n_kb = -(-t // bq), -(-t // bk)
    pad = np.zeros((n_qt * bq, n_kb * bk), bool)
    pad[:t, :t] = valid
    seen = pad.reshape(n_qt, bq, n_kb, bk).any(axis=(1, 3))   # [tile, block]
    for qt in range(n_qt):
        blocks = np.flatnonzero(seen[qt])
        lo, hi = int(blocks[0]), int(blocks[-1]) + 1
        assert vmem.flash_first_block(qt, t, True, window) == lo
        assert vmem.flash_key_blocks(qt, t, True) == hi
        starts = [vmem.flash_part_start(qt, t, True, p, window)
                  for p in range(parts + 1)]
        assert starts[0] == lo and starts[-1] == hi
        sizes = np.diff(starts)
        assert sizes.min() >= 0 and sizes.max() - sizes.min() <= 1
        assert list(sizes) == sorted(sizes, reverse=True)
    # window 0 is the parent's cut: no tile starts past block 0
    if not window:
        assert all(vmem.flash_first_block(qt, t) == 0 for qt in range(n_qt))


def test_a_window_needs_the_causal_mask():
    q, k, v, vr = (torch.from_numpy(x) for x in _operands(1, 40, 2, 1, 16))
    with pytest.raises(ValueError, match="only with the causal mask"):
        tfk.flash_checksum_plain(q, k, v, vr, causal=False, window=8)
    with pytest.raises(ValueError, match="must be >= 0"):
        tfk.flash_checksum_kernel(q, k, v, vr, window=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_windowed_kernel_matches_the_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    runtime.reset_counts()
    # ragged T with GQA at every window of the CPU tests and more; danube's
    # head dim (120: the 128 tile with 8 zero columns); a dh of partial
    # 16-byte pieces
    cases = [((1, 257, 4, 2, 64), w) for w in (1, 31, 32, 33, 100, 300)] + [
        ((1, 200, 8, 2, 120), 64), ((2, 100, 4, 1, 70), 33)]
    for (b, t, h, kh, dh), window in cases:
        q, k, v, vr = (torch.from_numpy(x).to(dtype).to(dev)
                       for x in _operands(b, t, h, kh, dh))
        got = tfk.flash_checksum_kernel(q, k, v, vr, window=window)
        want = tfk.flash_checksum_plain(q, k, v, vr, window=window)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w.float(), atol=2 * tol,
                                       rtol=2 * tol)
        again = tfk.flash_checksum_kernel(q, k, v, vr, window=window)
        assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert runtime.launch_counts()["flash_checksum"] == 2 * len(cases)
    lib = runtime.load_library()
    for t, window in ((257, 33), (5120, 4096), (512, 0)):
        for qt in range(-(-t // vmem.FLASH_BLOCK_Q)):
            for p in range(vmem.FLASH_PARTS + 1):
                assert lib.flash_checksum_part_start(qt, t, 1, p, window) == \
                    vmem.flash_part_start(qt, t, True, p, window)
