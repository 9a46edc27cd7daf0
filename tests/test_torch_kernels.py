"""The two ported kernels against the TPU originals.

On the CPU the port's wrappers run each kernel's plain PyTorch version; the
JAX side runs the Pallas kernels in interpret mode, as its own tests do.
The same numpy inputs go through both.  ``atol 1e-5`` on every raw output
and on ``predicted/actual`` (same f32 arithmetic, different summation
order).  The CUDA kernels themselves are held against the same plain
versions on a GPU (``chip_smoke.py``; the ``cuda``-marked test below)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gcn_fused import kernel as jfk
from repro.kernels.gcn_fused import ops as jfo
from repro.kernels.spmm_abft import kernel as jsk
from repro.kernels.spmm_abft import ops as jso
from repro.kernels.spmm_abft.layout import dense_to_block_ell as j_to_bell
from repro_torch.engine.batching import pack_graphs, synth_graph_stream
from repro_torch.kernels.gcn_fused import kernel as tfk
from repro_torch.kernels.gcn_fused import ops as tfo
from repro_torch.kernels.gcn_fused.ref import gcn_fused_ref
from repro_torch.kernels.spmm_abft import kernel as tsk
from repro_torch.kernels.spmm_abft import ops as tso
from repro_torch.kernels.spmm_abft.layout import dense_to_block_ell
from repro_torch.kernels.spmm_abft.ref import spmm_abft_ref

ATOL = 1e-5
RAW = ("out", "stripe_sums", "extra", "slot_acts", "slot_preds")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=1e-5,
                               err_msg=what)


def _adj(n, seed, density=0.12):
    r = np.random.default_rng(seed)
    a = (r.random((n, n)) < density).astype(np.float32)
    a = np.maximum(a, a.T)
    np.fill_diagonal(a, 1.0)
    d = a.sum(1)
    return (a / np.sqrt(d)[:, None] / np.sqrt(d)[None, :]).astype(np.float32)


def _problem(n=44, f=13, g=7, block=8, seed=0, bk=None):
    """One graph: S [n, n] as block-ELL (numpy buffers are shared by both
    sides), features, weights."""
    r = np.random.default_rng(seed)
    s = _adj(n, seed)
    bell = dense_to_block_ell(s, block, bk or block)
    return dict(s=s, bell=bell, jbell=j_to_bell(s, block, bk or block),
                h=r.normal(0, 0.5, (n, f)).astype(np.float32),
                w=r.normal(0, 0.3, (f, g)).astype(np.float32))


def _padded_table(bell, extra_stripes=2, extra_width=3):
    """The kernel-level operands with padding stripes and padding slots
    (column-block 0, zero values) appended."""
    nbm, width, bm, bk = bell.values.shape
    vals = np.zeros((nbm + extra_stripes, width + extra_width, bm, bk),
                    np.float32)
    cols = np.zeros((nbm + extra_stripes, width + extra_width), np.int32)
    vals[:nbm, :width], cols[:nbm, :width] = bell.values, bell.block_cols
    return cols, vals


# ---------------------------------------------------------------------------
# raw kernel outputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inject", [None, (2, 1, 4.0), (0, 0, -1.5)])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("block,g", [(8, 8), (16, 4)])
def test_spmm_abft_kernel_raw_outputs(block, g, padded, inject):
    p = _problem(n=50, g=g, block=block, seed=block)
    cols, vals = _padded_table(p["bell"]) if padded else \
        (p["bell"].block_cols, p["bell"].values)
    k = p["bell"].padded_cols
    r = np.random.default_rng(1)
    x = r.normal(size=(k, g)).astype(np.float32)
    xr = r.normal(size=(k, 1)).astype(np.float32)
    want = jsk.spmm_abft_kernel(jnp.asarray(cols), jnp.asarray(vals),
                                jnp.asarray(x), jnp.asarray(xr),
                                interpret=True, inject=inject)
    before = tsk.spmm_abft_plain.calls
    got = tsk.spmm_abft_kernel(_t(cols), _t(vals), _t(x), _t(xr),
                               inject=inject)
    assert tsk.spmm_abft_plain.calls == before + 1     # CPU -> plain version
    assert len(got) == len(want) == 3
    for name, a, b in zip(RAW, got, want):
        assert tuple(a.shape) == tuple(b.shape), name
        _close(a, b, f"{name} inject={inject}")
    if padded:                       # padding stripes compare 0 = 0
        nbm, bm = p["bell"].n_block_rows, block
        assert float(got[1][nbm:].abs().max()) == 0.0
        assert float(got[2][nbm * bm:].abs().max()) == 0.0


@pytest.mark.parametrize("kw", [
    dict(), dict(inject=(1, 1, 3.0)), dict(with_check=False),
    dict(with_slots=True), dict(with_slots=True, inject=(2, 0, -2.0)),
    dict(with_check=False, inject=(0, 1, 1.0))],
    ids=["clean", "inject", "nocheck", "slots", "slots-inject",
         "nocheck-inject"])
@pytest.mark.parametrize("padded", [False, True])
def test_gcn_fused_kernel_raw_outputs(padded, kw):
    p = _problem(n=44, f=13, g=8, block=8, seed=3)
    cols, vals = _padded_table(p["bell"]) if padded else \
        (p["bell"].block_cols, p["bell"].values)
    k = p["bell"].padded_cols
    h = np.zeros((k, 13), np.float32)
    h[:44] = p["h"]
    w = p["w"]
    wr = w.sum(1, keepdims=True).astype(np.float32)
    want = jfk.gcn_fused_kernel(jnp.asarray(cols), jnp.asarray(vals),
                                jnp.asarray(h), jnp.asarray(w),
                                jnp.asarray(wr), interpret=True, **kw)
    got = tfk.gcn_fused_kernel(_t(cols), _t(vals), _t(h), _t(w), _t(wr),
                               **kw)
    assert len(got) == len(want) == (5 if kw.get("with_slots") else 3)
    for name, a, b in zip(RAW, got, want):
        assert tuple(a.shape) == tuple(b.shape), name
        _close(a, b, f"{name} {kw}")
    if kw.get("with_check") is False:
        assert float(got[2].abs().max()) == 0.0
    if kw.get("with_slots"):         # the last telescope IS the stripe sum
        _close(got[3][:, -1], got[1][:, 0])


def test_kernel_wrappers_reject_bad_shapes():
    p = _problem()
    cols, vals = _t(p["bell"].block_cols), _t(p["bell"].values)
    k = p["bell"].padded_cols
    with pytest.raises(ValueError):
        tsk.spmm_abft_kernel(cols, vals, torch.zeros(k + 1, 8),
                             torch.zeros(k + 1, 1))
    with pytest.raises(ValueError):
        tsk.spmm_abft_kernel(cols[:, :1], vals, torch.zeros(k, 8),
                             torch.zeros(k, 1))
    with pytest.raises(ValueError):
        tfk.gcn_fused_kernel(cols, vals, torch.zeros(k, 5), torch.zeros(4, 8),
                             torch.zeros(5, 1))


def test_plain_versions_agree_with_dense_oracles():
    p = _problem(n=40, f=11, g=8, block=8, seed=5)
    bell = p["bell"]
    x = p["h"] @ p["w"]
    xr = x.sum(1, keepdims=True)
    out, chk = tso.spmm_abft(bell, _t(x), None)
    ref_out, ref_actual, ref_extra = spmm_abft_ref(_t(bell.todense()), _t(x),
                                                   _t(xr))
    _close(out, ref_out)
    _close(chk.actual, ref_actual)
    _close(chk.predicted, ref_extra.sum())
    out, chk = tfo.gcn_fused_layer(bell, _t(p["h"]), _t(p["w"]),
                                   _t(p["w"].sum(1)))
    ref_out, pred, actual = gcn_fused_ref(bell, p["h"], p["w"])
    _close(out, ref_out)
    np.testing.assert_allclose(float(chk.predicted), pred, atol=1e-4)
    np.testing.assert_allclose(float(chk.actual), actual, atol=1e-4)


# ---------------------------------------------------------------------------
# wrappers, every granularity
# ---------------------------------------------------------------------------

def _check_close(tc, jc, what=""):
    if jc is None:
        assert tc is None
        return
    assert tc.granularity == jc.granularity
    assert tuple(tc.predicted.shape) == tuple(jc.predicted.shape), what
    _close(tc.predicted, jc.predicted, what + " predicted")
    _close(tc.actual, jc.actual, what + " actual")


@pytest.mark.parametrize("inject", [None, (1, 0, 2.5)])
@pytest.mark.parametrize("granularity", ["layer", "stripe"])
@pytest.mark.parametrize("carried", [False, True])
def test_spmm_abft_wrapper(granularity, carried, inject):
    p = _problem(n=37, f=9, g=7, block=8, seed=7)
    x = p["h"] @ p["w"]
    xr = (p["h"] @ p["w"].sum(1))[:, None].astype(np.float32) \
        if carried else None
    jout, jchk = jso.spmm_abft(p["jbell"], jnp.asarray(x),
                               None if xr is None else jnp.asarray(xr),
                               interpret=True, granularity=granularity,
                               inject=inject)
    tout, tchk = tso.spmm_abft(p["bell"], _t(x),
                               None if xr is None else _t(xr),
                               granularity=granularity, inject=inject)
    assert tuple(tout.shape) == (37, 7)
    _close(tout, jout)
    _check_close(tchk, jchk, granularity)


@pytest.mark.parametrize("inject", [None, (2, 1, -3.0)])
@pytest.mark.parametrize("granularity", ["layer", "stripe", "slot"])
@pytest.mark.parametrize("checked", [True, False])
def test_gcn_fused_layer_wrapper(granularity, checked, inject):
    p = _problem(n=37, f=9, g=7, block=8, seed=8)
    w_r = p["w"].sum(1).astype(np.float32) if checked else None
    jout, jchk = jfo.gcn_fused_layer(
        p["jbell"], jnp.asarray(p["h"]), jnp.asarray(p["w"]),
        None if w_r is None else jnp.asarray(w_r), interpret=True,
        granularity=granularity, inject=inject)
    tout, tchk = tfo.gcn_fused_layer(
        p["bell"], _t(p["h"]), _t(p["w"]),
        None if w_r is None else _t(w_r), granularity=granularity,
        inject=inject)
    assert tuple(tout.shape) == (37, 7)
    _close(tout, jout)
    _check_close(tchk, jchk, granularity)


def _packed(block=8, seed=9, feat=9):
    stream = synth_graph_stream(3, n_lo=12, n_hi=40, feat=feat, seed=seed)
    return pack_graphs(stream, block=block, n_slots=4, stripe_multiple=4,
                       width_multiple=2)


@pytest.mark.parametrize("inject", [None, (3, 0, 5.0)])
@pytest.mark.parametrize("granularity", ["graph", "stripe", "slot"])
@pytest.mark.parametrize("checked", [True, False])
def test_packed_wrappers(granularity, checked, inject):
    pb = _packed()
    r = np.random.default_rng(11)
    w = r.normal(0, 0.3, (9, 6)).astype(np.float32)
    w_r = w.sum(1).astype(np.float32) if checked else None
    cols, vals = pb.bell.block_cols, pb.bell.values
    seg, h = pb.stripe_graph, pb.h0
    # single-pass
    jout, jchk = jfo.gcn_fused_packed(
        jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(h), jnp.asarray(w),
        None if w_r is None else jnp.asarray(w_r), jnp.asarray(seg),
        num_segments=pb.n_slots, interpret=True, granularity=granularity,
        inject=inject)
    tout, tchk = tfo.gcn_fused_packed(
        _t(cols), _t(vals), _t(h), _t(w), None if w_r is None else _t(w_r),
        _t(seg), num_segments=pb.n_slots, granularity=granularity,
        inject=inject)
    _close(tout, jout)
    _check_close(tchk, jchk, f"fused {granularity}")
    if granularity == "slot":
        return                       # the two-pass kernel has no slot corners
    # two-pass
    x = h @ w
    xr = None if w_r is None else (h @ w_r)[:, None].astype(np.float32)
    jout, jchk = jso.spmm_abft_packed(
        jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x),
        None if xr is None else jnp.asarray(xr), jnp.asarray(seg),
        num_segments=pb.n_slots, interpret=True, granularity=granularity,
        inject=inject)
    tout, tchk = tso.spmm_abft_packed(
        _t(cols), _t(vals), _t(x), None if xr is None else _t(xr), _t(seg),
        num_segments=pb.n_slots, granularity=granularity, inject=inject)
    _close(tout, jout)
    _check_close(tchk, jchk, f"two-pass {granularity}")
    if inject is not None and checked and granularity == "graph":
        owner = int(seg[inject[0]])
        diff = (tchk.predicted - tchk.actual).abs()
        assert int(diff.argmax()) == owner and float(diff[owner]) > 4.0


def test_packed_operand_validation_and_row_fitting():
    pb = _packed()
    vals = _t(pb.bell.values)
    with pytest.raises(ValueError, match="covers"):
        tso.validate_packed_operands(vals, vals.shape[0] * 8 - 1, "x")
    with pytest.raises(ValueError, match="square"):
        tso.validate_packed_operands(torch.zeros(2, 2, 8, 16), 16, "x")
    x = torch.arange(12.0).reshape(6, 2)
    assert tso.fit_rows(x, 4).shape == (4, 2)
    assert tso.fit_rows(x, 6) is x
    padded = tso.fit_rows(x, 9)
    assert padded.shape == (9, 2) and float(padded[6:].abs().sum()) == 0.0
    np.testing.assert_array_equal(
        padded.numpy(), np.asarray(jso.fit_rows(jnp.asarray(x.numpy()), 9)))
    assert tso.pad_features(x, 4).shape == (6, 4)


def test_prepare_operands_pad_to_the_register_tile_quantum():
    """The reference pads G to 128 lanes; the port to a multiple of 8 — and
    ``block_g`` does not change that."""
    p = _problem(n=37, f=9, g=7, block=8, seed=12)
    x = _t(p["h"] @ p["w"])
    for block_g in (128, 8):
        xp, xrp = tso.prepare_operands(p["bell"], x, None, block_g)
        assert xp.shape == (p["bell"].padded_cols, 8) and xp.is_contiguous()
        assert xrp.shape == (p["bell"].padded_cols, 1)
        _close(xrp[:37, 0], x.sum(1))
    hp, wp, wrp = tfo.prepare_fused_operands(p["bell"], _t(p["h"]),
                                             _t(p["w"]), None, 128)
    assert hp.shape == (p["bell"].padded_cols, 9)     # F is not padded
    assert wp.shape == (9, 8) and wrp.shape == (9, 1)
    assert float(wrp.abs().sum()) == 0.0


def test_slot_corners_telescope():
    acts = np.cumsum(np.random.default_rng(0).normal(size=(5, 4)), axis=1
                     ).astype(np.float32)
    preds = acts + 1e-3
    jc = jfo.slot_check_corners(jnp.asarray(acts), jnp.asarray(preds))
    tc = tfo.slot_check_corners(_t(acts), _t(preds))
    _check_close(tc, jc, "slot")


# ---------------------------------------------------------------------------
# on a GPU: the CUDA kernels against the same plain versions
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no "
                    "interpret mode)")
    pb = _packed(block=32, feat=21)
    dev = torch.device("cuda")
    cols, vals = _t(pb.bell.block_cols).to(dev), _t(pb.bell.values).to(dev)
    h = _t(pb.h0).to(dev)
    r = np.random.default_rng(2)
    w = _t(r.normal(0, 0.3, (21, 8)).astype(np.float32)).to(dev)
    wr = w.sum(1, keepdim=True)
    x, xr = (h @ w).contiguous(), (h @ wr).contiguous()
    n0 = tsk.spmm_abft_kernel.launches
    for inject in (None, (1, 0, 2.0)):
        got = tsk.spmm_abft_kernel(cols, vals, x, xr, inject=inject)
        want = tsk.spmm_abft_plain(cols, vals, x, xr, inject=inject)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    assert tsk.spmm_abft_kernel.launches == n0 + 2
    # B1's other shapes: G = 72, 128-row blocks (2 k-parts a stripe, one
    # cluster), a one-stripe system, 16-row blocks (chunks of 16 k-columns
    # through the 64-byte swizzle), tall blocks cut into row slices (192: 2
    # slices x 3 k-parts, 256: 2 x 4); a second run bit for bit
    big = _packed(block=128, feat=21)
    bc, bv = _t(big.bell.block_cols).to(dev), _t(big.bell.values).to(dev)
    more = {b: _packed(block=b, feat=21) for b in (16, 192, 256)}
    dev_more = {b: (_t(p_.bell.block_cols).to(dev),
                    _t(p_.bell.values).to(dev)) for b, p_ in more.items()}
    for c_, v_ in ((cols, vals), (bc, bv), (bc[:1].contiguous(),
                                            bv[:1].contiguous()),
                   *dev_more.values()):
        k = (int(c_.max()) + 1) * v_.shape[3]      # rows the tiles reach
        for g in (8, 16, 72):
            xg = _t(r.normal(size=(k, g)).astype(np.float32)).to(dev)
            xrg = _t(r.normal(size=(k, 1)).astype(np.float32)).to(dev)
            got = tsk.spmm_abft_kernel(c_, v_, xg, xrg, inject=(0, 0, 1.5))
            again = tsk.spmm_abft_kernel(c_, v_, xg, xrg, inject=(0, 0, 1.5))
            want = tsk.spmm_abft_plain(c_, v_, xg, xrg, inject=(0, 0, 1.5))
            for a, a2, b in zip(got, again, want):
                torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
                assert torch.equal(a, a2)
    # the surgical repair's replay: a gathered sub-system of scattered
    # stripes equals those stripes of the full launch bit for bit
    from repro_torch.engine.localize import gather_stripe_system
    for p_, c_, v_ in ((pb, cols, vals), (big, bc, bv),
                       *((more[b], *dev_more[b]) for b in more)):
        nbm, bm = v_.shape[0], v_.shape[2]
        idx = sorted({0, nbm // 2, nbm - 1})
        sub = gather_stripe_system(p_.bell, idx)
        k = nbm * v_.shape[3]
        xg = _t(r.normal(size=(k, 16)).astype(np.float32)).to(dev)
        xrg = _t(r.normal(size=(k, 1)).astype(np.float32)).to(dev)
        full = tsk.spmm_abft_kernel(c_, v_, xg, xrg)
        part = tsk.spmm_abft_kernel(_t(sub.block_cols).to(dev),
                                    _t(sub.values).to(dev), xg, xrg)
        rows = torch.cat([torch.arange(i * bm, (i + 1) * bm) for i in idx])
        assert torch.equal(part[0], full[0][rows.to(dev)])
        assert torch.equal(part[1], full[1][torch.tensor(idx, device=dev)])
        assert torch.equal(part[2], full[2][rows.to(dev)])
    for kw in (dict(), dict(with_check=False),
               dict(with_slots=True, inject=(2, 1, -1.0))):
        got = tfk.gcn_fused_kernel(cols, vals, h, w, wr, **kw)
        want = tfk.gcn_fused_plain(cols, vals, h, w, wr, **kw)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [5, 33, 1433])
def test_cuda_fused_two_phases_match_plain(f):
    """B2's two phases at ragged F (the combination's chunks of 32 zero-fill
    the end), G 8 / 16 / 24, square blocks 16 / 32 / 128 and bk != bm, each
    case with and without the check, with the inject hook and the slot
    telescopes: within 1e-4 of the plain version, a second run bit for bit,
    and a gathered stripe sub-system bit for bit the full launch's rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no "
                    "interpret mode)")
    from repro_torch.engine.localize import gather_stripe_system
    dev = torch.device("cuda")
    r = np.random.default_rng(f)
    layouts = [_packed(block=b, feat=f).bell for b in (16, 32, 128)]
    layouts.append(_problem(n=70, f=f, block=6, bk=8)["bell"])
    for bell in layouts:
        cols = _t(bell.block_cols).to(dev)
        vals = _t(bell.values).to(dev)
        nbm, width, bm, bk = vals.shape
        k = max(bell.padded_cols, bk)
        h = _t(r.normal(0, 0.5, (k, f)).astype(np.float32)).to(dev)
        for g in (8, 16, 24):
            w = _t(r.normal(0, 0.3, (f, g)).astype(np.float32)).to(dev)
            wr = w.sum(1, keepdim=True).contiguous()
            for kw in (dict(), dict(with_check=False),
                       dict(inject=(nbm // 2, width // 2, 3.0)),
                       dict(with_slots=True, inject=(0, 0, -2.0))):
                got = tfk.gcn_fused_kernel(cols, vals, h, w, wr, **kw)
                again = tfk.gcn_fused_kernel(cols, vals, h, w, wr, **kw)
                want = tfk.gcn_fused_plain(cols, vals, h, w, wr, **kw)
                assert len(got) == len(want)
                for a, a2, b in zip(got, again, want):
                    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
                    assert torch.equal(a, a2)
                if kw.get("with_check") is False:
                    assert float(got[2].abs().max()) == 0.0
            idx = sorted({0, nbm // 2, nbm - 1})
            sub = gather_stripe_system(bell, idx)
            full = tfk.gcn_fused_kernel(cols, vals, h, w, wr,
                                        with_slots=True)
            part = tfk.gcn_fused_kernel(_t(sub.block_cols).to(dev),
                                        _t(sub.values).to(dev), h, w, wr,
                                        with_slots=True)
            rows = torch.cat([torch.arange(i * bm, (i + 1) * bm)
                              for i in idx]).to(dev)
            sel = torch.tensor(idx, device=dev)
            for name, p_, f_ in zip(RAW, part, full):
                want = f_[rows] if name in ("out", "extra") else f_[sel]
                assert torch.equal(p_, want), name
