"""The port's layer API and sparse path against the JAX package's.

The paper's own comparison — two split ABFT checks against one GCN-ABFT
check (``core/abft.py`` ``gcn_layer_{split,fused}`` and their sparse twins)
— the ``core/gcn.py`` forward, loss and sparse helpers, ``Coo.to_sparse``
and the ``"bcoo"`` backend (``torch.sparse.mm`` over a COO or CSR tensor),
each fed the same seeded numpy inputs as the reference.  The JAX side runs
its BCOO products and, where a layer reaches one, its Pallas kernel in
interpret mode; the port its plain versions (``device="cpu"``).
Tolerances: outputs, logits and ``predicted``/``actual`` within ``atol
1e-4``; flags equal; gradients within ``atol 1e-5``.  Mirrors
``tests/test_sparse_abft.py:94-231`` where the cases repeat."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import abft as jabft
from repro.core import gcn as jgcn
from repro.core.abft import ABFTConfig as JConfig
from repro.core.datasets import Coo as JCoo
from repro.core.datasets import make_reduced as j_make_reduced
from repro.kernels.spmm_abft import ops as j_spmm_ops
from repro_torch import convert
from repro_torch.core import abft as tabft
from repro_torch.core import gcn as tgcn
from repro_torch.core.abft import ABFTConfig as TConfig
from repro_torch.core.datasets import Coo, make_reduced
from repro_torch.engine import backend_names, infer_backend, make_backend
from repro_torch.engine.backends import BcooBackend
from repro_torch.kernels.gcn_fused import ops as fused_ops
from repro_torch.kernels.spmm_abft import ops as spmm_ops

ATOL = 1e-4
LAYOUTS = {"coo": torch.sparse_coo, "csr": torch.sparse_csr}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _cfgs(mode="fused", **kw):
    return (JConfig(mode=mode, threshold=1e-3, relative=True, **kw),
            TConfig(mode=mode, threshold=1e-3, relative=True, **kw))


def _params(dims, seed=0):
    jp = jgcn.init_gcn(jax.random.PRNGKey(seed), dims)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return jp, tp


def _same_check(tc, jc):
    np.testing.assert_allclose(_np(tc.predicted), np.asarray(jc.predicted),
                               atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(_np(tc.actual), np.asarray(jc.actual),
                               atol=ATOL, rtol=1e-5)


def _random_graph(seed, n, avg_deg=4):
    rng = np.random.default_rng(seed)
    m = n * avg_deg // 2
    e = rng.integers(0, n, size=(3 * m + 16, 2), dtype=np.int64)
    e = e[e[:, 0] != e[:, 1]]
    return np.unique(np.sort(e, axis=1), axis=0)[:m]


@pytest.fixture(scope="module")
def cora():
    """Reduced Cora (scale 8) in both packages, with weights."""
    tds, jds = make_reduced("cora", 8, seed=0), j_make_reduced("cora", 8,
                                                               seed=0)
    jp, tp = _params(tds.stats.layer_dims, seed=0)
    return tds, jds, jp, tp


# ---------------------------------------------------------------------------
# the layer API: split (two checks) against fused (one), dense and sparse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("operand", ["dense", "coo", "csr"])
@pytest.mark.parametrize("flow", ["split", "fused"])
def test_layer_api_matches_reference(cora, flow, operand):
    tds, jds, jp, tp = cora
    jcfg, tcfg = _cfgs()
    h = tds.features.todense()
    w = tp["layers"][0]["w"]
    if operand == "dense":
        s_t, s_j = tds.s.todense(), jnp.asarray(jds.s.todense())
        t_fn = getattr(tabft, f"gcn_layer_{flow}")
        j_fn = getattr(jabft, f"gcn_layer_{flow}")
    else:
        s_t, s_j = tds.s.to_sparse("cpu", LAYOUTS[operand]), jds.s.to_bcoo()
        t_fn = getattr(tabft, f"gcn_layer_{flow}_sparse")
        j_fn = getattr(jabft, f"gcn_layer_{flow}_sparse")
    t_out, t_chk = t_fn(s_t, h, w, tcfg, device="cpu")
    j_out, j_chk = j_fn(s_j, jnp.asarray(h), jp["layers"][0]["w"], jcfg)
    np.testing.assert_allclose(_np(t_out), np.asarray(j_out), atol=ATOL)
    t_chk = t_chk if flow == "split" else (t_chk,)
    j_chk = j_chk if flow == "split" else (j_chk,)
    assert len(t_chk) == len(j_chk) == (2 if flow == "split" else 1)
    for tc, jc in zip(t_chk, j_chk):
        _same_check(tc, jc)
        assert not bool(tc.flag(tcfg)) and not bool(jc.flag(jcfg))


def test_split_and_fused_layers_agree(cora):
    """The paper's comparison: the same output, two checks against one."""
    tds, _, _, tp = cora
    _, tcfg = _cfgs()
    s = tds.s.to_sparse("cpu")
    h, w = tds.features.todense(), tp["layers"][0]["w"]
    out_s, checks = tabft.gcn_layer_split(s, h, w, tcfg, device="cpu")
    out_f, chk = tabft.gcn_layer_fused(s, h, w, tcfg, device="cpu")
    assert torch.equal(out_s, out_f) and len(checks) == 2
    assert abs(float(chk.predicted - chk.actual)) <= \
        1e-4 * max(1.0, abs(float(chk.actual)))


@pytest.mark.parametrize("mode", ["none", "split", "fused"])
def test_layer_policy_dispatch_matches_reference(cora, mode):
    tds, jds, jp, tp = cora
    jcfg, tcfg = _cfgs(mode)
    h = tds.features.todense()
    s_c = tgcn.precompute_s_c(tds.s.to_sparse("cpu"), tcfg)
    t_out, t_checks = tabft.gcn_layer_sparse(
        tds.s.to_sparse("cpu"), h, tp["layers"][0]["w"], tcfg, s_c,
        device="cpu")
    j_out, j_checks = jabft.gcn_layer_sparse(
        jds.s.to_bcoo(), jnp.asarray(h), jp["layers"][0]["w"], jcfg)
    np.testing.assert_allclose(_np(t_out), np.asarray(j_out), atol=ATOL)
    assert len(t_checks) == len(j_checks) == {"none": 0, "split": 2,
                                              "fused": 1}[mode]
    for tc, jc in zip(t_checks, j_checks):
        _same_check(tc, jc)
    t_out, t_checks = tabft.gcn_layer(tds.s.todense(), h,
                                      tp["layers"][0]["w"], tcfg,
                                      device="cpu")
    assert len(t_checks) == len(j_checks)
    np.testing.assert_allclose(_np(t_out), np.asarray(j_out), atol=ATOL)


def test_checked_matmul_and_np_size():
    rng = np.random.default_rng(4)
    a = rng.normal(0, 0.5, (9, 7)).astype(np.float32)
    b = rng.normal(0, 0.5, (7, 5)).astype(np.float32)
    for mode in ("none", "split", "fused"):
        jcfg, tcfg = _cfgs(mode)
        tc, tchk = tabft.checked_matmul(torch.from_numpy(a),
                                        torch.from_numpy(b), tcfg)
        jc, jchk = jabft.checked_matmul(jnp.asarray(a), jnp.asarray(b), jcfg)
        np.testing.assert_allclose(_np(tc), np.asarray(jc), atol=1e-6)
        assert (tchk is None) == (jchk is None) == (mode == "none")
        if tchk is not None:
            _same_check(tchk, jchk)
    assert tabft.np_size(torch.zeros(3, 4)) == jabft.np_size(
        jnp.zeros((3, 4))) == 12
    assert tabft.np_size(np.zeros(())) == 1


# ---------------------------------------------------------------------------
# core/gcn.py: sparse == dense == the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["none", "split", "fused"])
@pytest.mark.parametrize("seed,n", [(0, 96), (7, 200), (13, 333)])
def test_sparse_matches_dense_gcn(seed, n, mode):
    edges = _random_graph(seed, n)
    rng = np.random.default_rng(seed + 1)
    s_dense = tgcn.normalized_adjacency_dense(edges, n)
    s_sp = tgcn.normalized_adjacency_sparse(edges, n, device="cpu")
    np.testing.assert_allclose(_np(s_sp.to_dense()), s_dense, atol=1e-7)
    np.testing.assert_array_equal(
        _np(s_sp.to_dense()),
        np.asarray(jgcn.normalized_adjacency_bcoo(edges, n).todense()))
    h0 = rng.normal(0, 0.5, size=(n, 24)).astype(np.float32)
    jp, tp = _params((24, 16, 5), seed)
    jcfg, tcfg = _cfgs(mode)
    logits_d, rep_d = tgcn.gcn_apply(tp, s_dense, h0, tcfg, device="cpu")
    s_c = tgcn.precompute_s_c(s_sp, tcfg) if tcfg.enabled else None
    logits_s, rep_s = tgcn.gcn_apply_sparse(tp, s_sp, h0, tcfg, s_c,
                                            device="cpu")
    logits_j, rep_j = jgcn.gcn_apply(jp, jnp.asarray(s_dense),
                                     jnp.asarray(h0), jcfg)
    np.testing.assert_allclose(_np(logits_s), _np(logits_d), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(_np(logits_s), np.asarray(logits_j),
                               atol=ATOL)
    for rep in (rep_d, rep_s):
        assert bool(rep.flag) is bool(rep_j.flag) is False
        assert int(rep.n_checks) == int(rep_j.n_checks)


@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_dataset_sparse_matches_dense(cora, layout):
    """End-to-end over the reduced Cora dataset, both packages."""
    tds, jds, jp, tp = cora
    _, tcfg = _cfgs()
    jcfg, _ = _cfgs()
    s_np, h_np, labels = tgcn.dataset_to_dense(tds)
    s_sp, h_sp, labels_sp = tgcn.dataset_to_sparse(tds, device="cpu")
    assert s_sp.layout == torch.sparse_coo and h_sp.device.type == "cpu"
    s_sp = tds.s.to_sparse("cpu", LAYOUTS[layout])
    np.testing.assert_array_equal(labels_sp, labels)
    logits_d, _ = tgcn.gcn_apply(tp, s_np, h_np, tcfg, device="cpu")
    logits_s, rep = tgcn.gcn_apply_sparse(
        tp, s_sp, h_sp, tcfg, tgcn.precompute_s_c(s_sp, tcfg), device="cpu")
    j_s, j_h, _ = jgcn.dataset_to_sparse(jds)
    logits_j, rep_j = jgcn.gcn_apply_sparse(jp, j_s, j_h, jcfg)
    np.testing.assert_allclose(_np(logits_s), _np(logits_d), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(_np(logits_s), np.asarray(logits_j),
                               atol=ATOL)
    assert not bool(rep.flag) and not bool(rep_j.flag)
    assert float(rep.max_rel) <= 1e-4


@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_offline_s_c_matches_online(layout):
    tds = make_reduced("citeseer", 8, seed=1)
    jds = j_make_reduced("citeseer", 8, seed=1)
    _, tcfg = _cfgs()
    s_sp = tds.s.to_sparse("cpu", LAYOUTS[layout])
    offline = tgcn.precompute_s_c(s_sp, tcfg)
    assert offline.dtype == torch.float32 and offline.device == s_sp.device
    assert torch.equal(offline, tabft.sparse_col_checksum(s_sp))
    np.testing.assert_allclose(
        _np(offline), np.asarray(jabft.sparse_col_checksum(jds.s.to_bcoo())),
        atol=1e-6)
    np.testing.assert_allclose(_np(offline).astype(np.float64),
                               tds.s.col_sums(), atol=1e-5)
    dense = tabft.sparse_col_checksum(tds.s.todense())
    np.testing.assert_allclose(_np(dense), _np(offline), atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("operand", ["dense", "coo", "csr"])
def test_gcn_loss_and_gradient_match_reference(cora, operand, masked):
    """The masked mean NLL and its autograd gradient on the dense and
    sparse backends against ``jax.grad`` of the reference's loss."""
    tds, jds, jp, tp = cora
    jcfg, tcfg = _cfgs()
    s_np, h_np, labels = tgcn.dataset_to_dense(tds)
    mask = (np.arange(len(labels)) % 3 == 0) if masked else None
    s_t = s_np if operand == "dense" else tds.s.to_sparse("cpu",
                                                       LAYOUTS[operand])
    params = {"layers": [{"w": layer["w"].clone().requires_grad_(True)}
                         for layer in tp["layers"]]}
    loss, rep = tgcn.gcn_loss(params, s_t, h_np, labels, mask, tcfg,
                              device="cpu")
    loss.backward()

    def j_loss(p):
        return jgcn.gcn_loss(p, jnp.asarray(s_np), jnp.asarray(h_np),
                             jnp.asarray(labels),
                             None if mask is None else jnp.asarray(mask),
                             jcfg)[0]

    j_val, j_grad = jax.value_and_grad(j_loss)(jp)
    np.testing.assert_allclose(loss.item(), float(j_val), atol=1e-5)
    for tl, jl in zip(params["layers"], j_grad["layers"]):
        np.testing.assert_allclose(_np(tl["w"].grad), np.asarray(jl["w"]),
                                   atol=1e-5)
    assert not bool(rep.flag)


def test_to_sparse_keeps_duplicate_entries():
    """Duplicates are kept (COO) or summed (CSR); either way the product
    accumulates them, as BCOO does."""
    rng = np.random.default_rng(5)
    row = np.array([0, 1, 1, 3, 3, 3, 2])
    col = np.array([2, 0, 0, 1, 1, 3, 2])
    data = rng.normal(size=row.size).astype(np.float32)
    coo, jcoo = Coo(data, row, col, (4, 5)), JCoo(data, row, col, (4, 5))
    x = rng.normal(size=(5, 3)).astype(np.float32)
    want = np.asarray(jcoo.to_bcoo() @ jnp.asarray(x))
    for layout in LAYOUTS.values():
        s = coo.to_sparse("cpu", layout)
        assert s.layout == layout and tuple(s.shape) == (4, 5)
        np.testing.assert_allclose(_np(s.to_dense()), coo.todense(),
                                   atol=1e-7)
        np.testing.assert_allclose(
            _np(tabft.sparse_matmul(s, torch.from_numpy(x))), want,
            atol=1e-6)
    assert coo.to_sparse("cpu")._nnz() == row.size       # uncoalesced
    np.testing.assert_allclose(_np(tabft.sparse_col_checksum(
        coo.to_sparse("cpu"))), coo.col_sums(), atol=1e-6)


def test_fused_sparse_layer_detects_fault():
    """Core-path (sparse) fused layer check catches a corrupted H_out."""
    ds = make_reduced("cora", scale=8, seed=2)
    s_sp, h_sp, _ = tgcn.dataset_to_sparse(ds, device="cpu")
    _, tp = _params(ds.stats.layer_dims, seed=2)
    _, tcfg = _cfgs()
    h_out, chk = tabft.gcn_layer_fused_sparse(s_sp, h_sp,
                                              tp["layers"][0]["w"], tcfg,
                                              device="cpu")
    bad = _np(h_out).astype(np.float64)
    bad[11, 7] += 10.0 * max(float(np.abs(bad).max()), 1.0)
    assert abs(float(chk.predicted) - float(bad.sum())) > 1e-4
    assert abs(float(chk.predicted) - float(chk.actual)) < 1e-4


# ---------------------------------------------------------------------------
# the "bcoo" backend and the kernel-path shims
# ---------------------------------------------------------------------------

def test_bcoo_backend_registry_and_validation(cora):
    tds, _, _, tp = cora
    _, tcfg = _cfgs()
    s = tds.s.to_sparse("cpu")
    assert backend_names() == ("bcoo", "block_ell", "dense")
    for layout in LAYOUTS.values():
        s_l = tds.s.to_sparse("cpu", layout)
        assert infer_backend(s_l) == "bcoo"
        bk = make_backend(s_l, tcfg, device="cpu")
        assert isinstance(bk, BcooBackend) and bk.s_c.shape == (s.shape[1],)
    assert infer_backend(tds.s.todense()) == "dense"
    with pytest.raises(ValueError, match="does not support partition"):
        make_backend(s, tcfg, partition=object(), device="cpu")
    with pytest.raises(ValueError, match="granularity"):
        make_backend(s, tcfg, granularity="stripe", device="cpu")
    with pytest.raises(TypeError, match="torch sparse"):
        make_backend(tds.s.todense(), tcfg, backend="bcoo", device="cpu")
    with pytest.raises(TypeError):
        make_backend(s, tcfg, block_g=128, device="cpu")
    off = make_backend(s, TConfig(mode="none"), device="cpu")
    assert off.s_c is None
    out, chk = off.aggregate(torch.ones(s.shape[1], 2), None)
    assert chk is None and tuple(out.shape) == (s.shape[0], 2)


def test_layer_fused_sparse_kernel_matches_reference(cora):
    tds, jds, jp, tp = cora
    h = tds.features.todense()
    w = tp["layers"][0]["w"]
    bell = tds.s.to_block_ell(16, 16)
    t_out, t_chk = spmm_ops.gcn_layer_fused_sparse_kernel(
        bell, h, w, w_r=w.sum(dim=1, keepdim=True), device="cpu")
    j_out, j_chk = j_spmm_ops.gcn_layer_fused_sparse_kernel(
        jds.s.to_block_ell(16, 16), jnp.asarray(h), jp["layers"][0]["w"],
        interpret=True, block_g=16)
    np.testing.assert_allclose(_np(t_out), np.asarray(j_out), atol=ATOL)
    _same_check(t_chk, j_chk)
    # and the engine's sparse layer gives the same output
    s_out, s_chk = tabft.gcn_layer_fused_sparse(tds.s.to_sparse("cpu"), h, w,
                                                _cfgs()[1], device="cpu")
    np.testing.assert_allclose(_np(t_out), _np(s_out), atol=1e-5)


def test_auto_wrappers_and_byte_model_names(cora):
    tds, _, _, tp = cora
    bell = tds.s.to_block_ell(16, 16)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(bell.shape[1], 8)).astype(
        np.float32))
    a, ca = spmm_ops.spmm_abft_auto(bell, x)
    b, cb = spmm_ops.spmm_abft(bell, x)
    assert torch.equal(a, b) and torch.equal(ca.predicted, cb.predicted)
    h = torch.from_numpy(tds.features.todense())
    w = tp["layers"][0]["w"]
    a, ca = fused_ops.gcn_fused_auto(bell, h, w, w.sum(1))
    b, cb = fused_ops.gcn_fused_layer(bell, h, w, w.sum(1))
    assert torch.equal(a, b) and torch.equal(ca.actual, cb.actual)
    f, g = tds.stats.layer_dims[:2]
    assert fused_ops.hbm_bytes_twopass(bell, f, g, block_g=128) == \
        fused_ops.schedule_bytes_twopass(bell, f, g)
    assert fused_ops.hbm_bytes_fused(bell, f, g) == \
        fused_ops.schedule_bytes_fused(bell, f, g)
    dims = list(tds.stats.layer_dims)
    assert fused_ops.hbm_bytes_network(bell, dims, stash_acts=True) == \
        fused_ops.schedule_bytes_network(bell, dims)


# ---------------------------------------------------------------------------
# on a GPU
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_sparse_forward_matches_cpu(cora):
    """The sparse path on the card against the CPU's, and a second run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tds, _, _, tp = cora
    _, tcfg = _cfgs()
    s, h, _ = tgcn.dataset_to_sparse(tds, device="cpu")
    want, _ = tgcn.gcn_apply_sparse(tp, s, h, tcfg, device="cpu")
    gp = convert.params_to_device(tp, device="cuda")
    s_g, h_g, _ = tgcn.dataset_to_sparse(tds, device="cuda")
    got, rep = tgcn.gcn_apply_sparse(gp, s_g, h_g, tcfg, device="cuda")
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)
    assert not bool(rep.flag)
