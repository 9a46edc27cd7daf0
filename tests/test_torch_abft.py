"""Parity of the port's checksum algebra (``repro_torch.core``) with the JAX
package's (``repro.core``): same numpy inputs, made from a seed, through
both; values within ``atol 1e-5`` (same f32 arithmetic, different summation
order), flags and verdicts exactly equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import abft as jabft
from repro.core import checksum as jck
from repro_torch.core import abft as tabft
from repro_torch.core import checksum as tck

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _rng(seed=0):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# checksums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["col_checksum", "row_checksum",
                                  "total_checksum"])
@pytest.mark.parametrize("shape", [(7, 5), (3, 6, 4)])
def test_checksum_primitives(name, shape):
    a = _rng(1).normal(size=shape).astype(np.float32)
    want = getattr(jck, name)(jnp.asarray(a), jnp.float32)
    got = getattr(tck, name)(_t(a), torch.float32)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_kahan_sum(axis):
    a = (_rng(2).normal(size=(40, 9)) * 1e3).astype(np.float32)
    want = jck.kahan_sum(jnp.asarray(a), axis)
    got = tck.kahan_sum(_t(a), axis)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)
    # compensated: closer to the f64 sum than f32 rounding of each step
    np.testing.assert_allclose(_np(got), a.astype(np.float64).sum(axis),
                               rtol=1e-6)


def test_kahan_total_and_chain_checksum():
    r = _rng(3)
    a = r.normal(size=(12, 8)).astype(np.float32)
    b = r.normal(size=(8, 6)).astype(np.float32)
    c = r.normal(size=(6, 5)).astype(np.float32)
    np.testing.assert_allclose(_np(tck.kahan_total(_t(a))),
                               np.asarray(jck.kahan_total(jnp.asarray(a))),
                               atol=ATOL)
    want = jck.fused_chain_checksum((jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(c)))
    got = tck.fused_chain_checksum((_t(a), _t(b), _t(c)))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(_np(got), (a @ b @ c).sum(), rtol=1e-4)
    np.testing.assert_allclose(
        _np(tck.predicted_matmul_checksum(_t(a), _t(b))),
        np.asarray(jck.predicted_matmul_checksum(jnp.asarray(a),
                                                 jnp.asarray(b))), rtol=1e-5)


# ---------------------------------------------------------------------------
# Check: flags incl. NaN and +-inf corners
# ---------------------------------------------------------------------------

CORNERS = {
    "clean": ([1.0, 20.0, -3.0], [1.0, 20.0, -3.0]),
    "below_tau": ([1.0, 2000.0], [1.0005, 2001.0]),
    "above_tau": ([1.0, 2000.0], [1.01, 2000.0]),
    "nan_pred": ([np.nan, 1.0], [1.0, 1.0]),
    "nan_actual": ([1.0, 1.0], [1.0, np.nan]),
    "inf_actual": ([1.0, 5.0], [np.inf, 5.0]),
    "neg_inf_actual": ([1.0, 5.0], [-np.inf, 5.0]),
    "inf_both": ([np.inf, 5.0], [np.inf, 5.0]),
    "inf_pred": ([-np.inf, 5.0], [2.0, 5.0]),
    "scalar": (3.0, 3.5),
}


@pytest.mark.parametrize("relative", [True, False])
@pytest.mark.parametrize("corner", sorted(CORNERS))
def test_check_flag_and_elementwise(corner, relative):
    p, a = (np.asarray(v, np.float32) for v in CORNERS[corner])
    jcfg = jabft.ABFTConfig(threshold=1e-3, relative=relative)
    tcfg = tabft.ABFTConfig(threshold=1e-3, relative=relative)
    jc = jabft.Check(jnp.asarray(p), jnp.asarray(a))
    tc = tabft.Check(_t(p), _t(a))
    assert bool(tc.flag(tcfg)) == bool(jc.flag(jcfg))
    jf, jr = jc.elementwise(jcfg)
    tf, tr = tc.elementwise(tcfg)
    np.testing.assert_array_equal(_np(tf), np.asarray(jf))
    np.testing.assert_allclose(_np(tr), np.asarray(jr), atol=ATOL,
                               equal_nan=True)
    assert tr.dtype == torch.float32


def test_check_rejects_unknown_granularity_and_mode():
    with pytest.raises(ValueError):
        tabft.Check(torch.zeros(()), torch.zeros(()), granularity="tile")
    with pytest.raises(ValueError):
        tabft.ABFTConfig(mode="both")
    assert tabft.GRANULARITIES == jabft.GRANULARITIES
    assert tabft.MODES == jabft.MODES
    assert not tabft.ABFTConfig(mode="none").enabled


# ---------------------------------------------------------------------------
# check_matmul / check_chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kahan", [False, True])
@pytest.mark.parametrize("batched", [False, True])
def test_check_matmul_and_chain(kahan, batched):
    r = _rng(4)
    lead = (3,) if batched else ()
    a = r.normal(size=lead + (10, 6)).astype(np.float32)
    b = r.normal(size=(6, 4)).astype(np.float32)
    c = a @ b
    jcfg = jabft.ABFTConfig(kahan=kahan)
    tcfg = tabft.ABFTConfig(kahan=kahan)
    jc = jabft.check_matmul(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                            jcfg)
    tc = tabft.check_matmul(_t(a), _t(b), _t(c), tcfg)
    np.testing.assert_allclose(_np(tc.predicted), np.asarray(jc.predicted),
                               atol=ATOL)
    np.testing.assert_allclose(_np(tc.actual), np.asarray(jc.actual),
                               atol=ATOL)
    # folded b_r gives the same prediction
    b_r = tabft.fold_w_r_tree({"w": _t(b)}, tcfg)["w_r"]
    tc2 = tabft.check_matmul(_t(a), _t(b), _t(c), tcfg, b_r=b_r)
    np.testing.assert_allclose(_np(tc2.predicted), _np(tc.predicted),
                               atol=ATOL)
    d = r.normal(size=(4, 5)).astype(np.float32)
    out = c @ d
    jch = jabft.check_chain([jnp.asarray(a), jnp.asarray(b), jnp.asarray(d)],
                            jnp.asarray(out), jcfg)
    tch = tabft.check_chain([_t(a), _t(b), _t(d)], _t(out), tcfg)
    np.testing.assert_allclose(_np(tch.predicted), np.asarray(jch.predicted),
                               atol=1e-4)
    np.testing.assert_allclose(_np(tch.actual), np.asarray(jch.actual),
                               atol=1e-4)
    assert not bool(tch.flag(tcfg))


# ---------------------------------------------------------------------------
# folds
# ---------------------------------------------------------------------------

def _params_np(seed=5, dims=(9, 6, 4)):
    r = _rng(seed)
    return {"layers": [{"w": r.normal(size=(i, o)).astype(np.float32)}
                       for i, o in zip(dims[:-1], dims[1:])]}


@pytest.mark.parametrize("mode", ["none", "split", "fused"])
def test_fold_w_r_tree_parity(mode):
    pn = _params_np()
    jp = jabft.fold_w_r_tree(
        {"layers": [{"w": jnp.asarray(layer["w"])} for layer in pn["layers"]]},
        jabft.ABFTConfig(mode=mode))
    tp = tabft.fold_w_r_tree(
        {"layers": [{"w": _t(layer["w"])} for layer in pn["layers"]]},
        tabft.ABFTConfig(mode=mode))
    for jl, tl in zip(jp["layers"], tp["layers"]):
        assert ("w_r" in tl) == ("w_r" in jl) == (mode != "none")
        if mode != "none":
            assert tl["w_r"].dtype == torch.float32
            np.testing.assert_allclose(_np(tl["w_r"]), np.asarray(jl["w_r"]),
                                       atol=ATOL)


def test_fold_w_r_tree_numpy_leaves_and_lead_axes():
    cfg = tabft.ABFTConfig()
    w = _rng(6).normal(size=(3, 5, 4, 2)).astype(np.float32)
    out = tabft.fold_w_r_tree({"blk": ({"w": w}, {"b": 1})}, cfg, lead_axes=1)
    assert isinstance(out["blk"], tuple) and out["blk"][1] == {"b": 1}
    w_r = out["blk"][0]["w_r"]
    assert isinstance(w_r, np.ndarray) and w_r.shape == (3, 5)
    np.testing.assert_allclose(w_r, w.reshape(3, 5, -1).sum(-1), atol=ATOL)
    want = jabft.fold_w_r_tree({"w": w}, jabft.ABFTConfig(), lead_axes=1)
    np.testing.assert_allclose(w_r, np.asarray(want["w_r"]), atol=ATOL)


def test_stale_fold_raises_on_both_sides():
    w = _rng(7).normal(size=(5, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="stale precision"):
        jabft.resolve_w_r(jnp.asarray(w),
                          jnp.asarray(w.sum(1)).astype(jnp.bfloat16),
                          jabft.ABFTConfig())
    with pytest.raises(ValueError, match="stale precision"):
        tabft.resolve_w_r(_t(w), _t(w.sum(1)).to(torch.float64),
                          tabft.ABFTConfig())
    with pytest.raises(ValueError, match="stale precision"):
        tabft.resolve_w_r(_t(w), _t(w.sum(1)),
                          tabft.ABFTConfig(dtype=torch.float64))
    assert tabft.resolve_w_r(_t(w), _t(w.sum(1)),
                             tabft.ABFTConfig(mode="none")) is None
    got = tabft.resolve_w_r(_t(w), None, tabft.ABFTConfig())
    np.testing.assert_allclose(_np(got), w.sum(1), atol=ATOL)


# ---------------------------------------------------------------------------
# report reducers
# ---------------------------------------------------------------------------

def _pair(p, a, gran):
    p, a = np.asarray(p, np.float32), np.asarray(a, np.float32)
    return (jabft.Check(jnp.asarray(p), jnp.asarray(a), gran),
            tabft.Check(_t(p), _t(a), gran))


def _faulty(shape, seed, n_faults=2, nan=False):
    r = _rng(seed)
    a = r.normal(scale=5.0, size=shape).astype(np.float32)
    p = a + r.normal(scale=1e-6, size=shape).astype(np.float32)
    flat = p.reshape(-1)
    for i in r.choice(flat.size, size=n_faults, replace=False):
        flat[i] += 3.0
    if nan:
        flat[0] = np.nan
    return p, a


@pytest.mark.parametrize("nan", [False, True])
def test_summarize_and_merge(nan):
    jcfg, tcfg = jabft.ABFTConfig(), tabft.ABFTConfig()
    pairs = [_pair(*_faulty((6,), 10, nan=nan), "graph"),
             _pair(*_faulty((), 11, n_faults=0), "layer"),
             _pair(*_faulty((4, 3), 12, n_faults=0), "slot")]
    jr = jabft.summarize([None] + [j for j, _ in pairs], jcfg)
    tr = tabft.summarize([None] + [t for _, t in pairs], tcfg)
    assert bool(tr.flag) == bool(jr.flag) is True
    np.testing.assert_allclose(_np(tr.max_rel), np.asarray(jr.max_rel),
                               atol=ATOL, equal_nan=True)
    assert float(tr.n_checks) == float(jr.n_checks) == 6 + 1 + 12
    clean_j = jabft.summarize([pairs[1][0]], jcfg)
    clean_t = tabft.summarize([pairs[1][1]], tcfg)
    jm = jabft.merge_reports([jr, clean_j])
    tm = tabft.merge_reports([tr, clean_t])
    assert bool(tm.flag) == bool(jm.flag)
    assert float(tm.n_checks) == float(jm.n_checks)
    # nothing to reduce -> all-clear, on both sides
    for checks, cfg in (([], tcfg), ([pairs[0][1]],
                                     tabft.ABFTConfig(mode="none"))):
        rep = tabft.summarize(checks, cfg)
        assert not bool(rep.flag) and float(rep.n_checks) == 0.0
    assert not bool(tabft.merge_reports([]).flag)


SEGMENTS = np.array([0, 0, 1, 1, 1, 3, 3, 4, 4], np.int32)   # 4 = overflow
N_SLOTS = 4                                                   # slot 2 empty


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("gran", ["graph", "stripe", "slot"])
def test_per_graph_report(gran, nan):
    jcfg, tcfg = jabft.ABFTConfig(), tabft.ABFTConfig()
    shape = {"graph": (N_SLOTS,), "stripe": SEGMENTS.shape,
             "slot": SEGMENTS.shape + (3,)}[gran]
    pairs = [_pair(*_faulty(shape, 20 + i, n_faults=i, nan=nan and i == 1),
                   gran) for i in range(3)]
    kw_j = {} if gran == "graph" else {"segments": jnp.asarray(SEGMENTS)}
    kw_t = {} if gran == "graph" else {"segments": _t(SEGMENTS)}
    jf, jr = jabft.per_graph_report([j for j, _ in pairs] + [None], jcfg,
                                    N_SLOTS, **kw_j)
    tf, tr = tabft.per_graph_report([t for _, t in pairs] + [None], tcfg,
                                    N_SLOTS, **kw_t)
    np.testing.assert_array_equal(_np(tf), np.asarray(jf))
    np.testing.assert_allclose(_np(tr), np.asarray(jr), atol=ATOL,
                               equal_nan=True)
    assert tf.shape == (N_SLOTS,) and tf.dtype == torch.bool


def test_per_graph_report_rejects_unattributable_and_empty():
    tcfg = tabft.ABFTConfig()
    _, scalar = _pair(1.0, 1.0, "layer")
    with pytest.raises(ValueError, match="per_graph_report needs"):
        tabft.per_graph_report([scalar], tcfg, N_SLOTS)
    # a stripe check whose length equals n must not be read as per-graph
    _, stripe = _pair(np.zeros(N_SLOTS), np.zeros(N_SLOTS), "stripe")
    with pytest.raises(ValueError, match="per_graph_report needs"):
        tabft.per_graph_report([stripe], tcfg, N_SLOTS)
    f, r = tabft.per_graph_report([], tcfg, 3)
    assert f.shape == r.shape == (3,) and not f.any()


@pytest.mark.parametrize("gran", ["stripe", "slot"])
def test_per_stripe_and_slot_report(gran):
    jcfg, tcfg = jabft.ABFTConfig(), tabft.ABFTConfig()
    ns, width = 9, 3
    shape = (ns,) if gran == "stripe" else (ns, width)
    pairs = [_pair(*_faulty(shape, 30 + i, n_faults=i + 1), gran)
             for i in range(2)]
    jf, jr = jabft.per_stripe_report([j for j, _ in pairs], jcfg, ns)
    tf, tr = tabft.per_stripe_report([t for _, t in pairs], tcfg, ns)
    np.testing.assert_array_equal(_np(tf), np.asarray(jf))
    np.testing.assert_allclose(_np(tr), np.asarray(jr), atol=ATOL)
    jf, jr = jabft.per_slot_report([j for j, _ in pairs], jcfg, ns, width)
    tf, tr = tabft.per_slot_report([t for _, t in pairs], tcfg, ns, width)
    np.testing.assert_array_equal(_np(tf), np.asarray(jf))
    np.testing.assert_allclose(_np(tr), np.asarray(jr), atol=ATOL)
    assert tf.shape == (2, ns, width)


def test_stripe_and_slot_reports_reject_wrong_granularity():
    tcfg = tabft.ABFTConfig()
    _, graph = _pair(np.zeros(4), np.zeros(4), "graph")
    with pytest.raises(ValueError, match="per_stripe_report needs"):
        tabft.per_stripe_report([graph], tcfg, 4)
    with pytest.raises(ValueError, match="per_slot_report needs"):
        tabft.per_slot_report([graph], tcfg, 4, 2)
    f, r = tabft.per_stripe_report([], tcfg, 4)
    assert f.shape == (0, 4)
    f, r = tabft.per_slot_report([], tcfg, 4, 2)
    assert f.shape == (0, 4, 2)


def test_segment_reducers_keep_a_nan_in_its_segment():
    seg = _t(SEGMENTS)
    v = torch.arange(9, dtype=torch.float32)
    v[3] = float("nan")
    s = tabft.segment_sum(v, seg, N_SLOTS)
    assert torch.isnan(s[1]) and not torch.isnan(s[[0, 2, 3]]).any()
    assert s[0] == 1.0 and s[2] == 0.0 and s[3] == 11.0
    m = tabft.segment_max(v, seg, N_SLOTS)
    assert torch.isnan(m[1]) and m[0] == 1.0 and m[2] == 0.0 and m[3] == 6.0
    f = tabft.segment_any(v > 4.5, seg, N_SLOTS)
    assert f.tolist() == [False, False, False, True]
    rows = torch.ones((9, 2))
    assert tabft.segment_sum(rows, seg, N_SLOTS).tolist() == \
        [[2, 2], [3, 3], [0, 0], [2, 2]]
