"""The port's engine (``repro_torch.engine``) against the JAX package's:
``gcn_forward`` / ``gcn_apply`` over {dense, block_ell} x {none, split, fused}
x {two-pass, fused_layer}, with the weights carried across through
``repro_torch.convert``.  The JAX side runs its Pallas kernels in interpret
mode, the port its plain versions (``device="cpu"``).  Logits within
``atol 1e-4``, ``predicted/actual`` within ``1e-4``, flags exactly equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.abft import ABFTConfig as JConfig
from repro.core.gcn import init_gcn as j_init_gcn
from repro.engine import Graph as JGraph
from repro.engine import fold_w_r as j_fold
from repro.engine import gcn_apply as j_apply
from repro.engine import gcn_forward as j_forward
from repro.kernels.spmm_abft.layout import dense_to_block_ell as j_to_bell
from repro_torch import convert
from repro_torch.core.abft import ABFTConfig as TConfig
from repro_torch.core.gcn import init_gcn as t_init_gcn
from repro_torch.engine import Graph as TGraph
from repro_torch.engine import (backend_names, fold_w_r, gcn_apply,
                                gcn_forward, make_backend, pack_graphs,
                                synth_graph_stream)
from repro_torch.engine import Partition
from repro_torch.engine.backends import (BcooBackend, BlockEllBackend,
                                         DenseBackend)
from repro_torch.launch.mesh import make_graph_mesh
from repro_torch.kernels.spmm_abft.layout import dense_to_block_ell

DIMS = (13, 16, 12, 5)          # three layers
ATOL = 1e-4


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _graph(n=45, seed=0):
    s, h0 = synth_graph_stream(1, n_lo=n, n_hi=n, feat=DIMS[0], seed=seed)[0]
    return s, h0


def _params(seed=0):
    """JAX-initialised weights, exported to numpy, carried into the port."""
    jp = j_init_gcn(jax.random.PRNGKey(seed), DIMS)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return jp, tp


def _same_checks(tchecks, jchecks):
    assert len(tchecks) == len(jchecks)
    for tc, jc in zip(tchecks, jchecks):
        assert tc.granularity == jc.granularity
        np.testing.assert_allclose(_np(tc.predicted), np.asarray(jc.predicted),
                                   atol=ATOL, rtol=1e-5)
        np.testing.assert_allclose(_np(tc.actual), np.asarray(jc.actual),
                                   atol=ATOL, rtol=1e-5)


def _operands(backend, s, block=8):
    if backend == "dense":
        return jnp.asarray(s), s
    return j_to_bell(s, block, block), dense_to_block_ell(s, block, block)


VARIANTS = [("dense", {}), ("block_ell", {}),
            ("block_ell", {"fused_layer": True})]


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("mode", ["none", "split", "fused"])
@pytest.mark.parametrize("backend,opts", VARIANTS,
                         ids=["dense", "two-pass", "fused-layer"])
def test_gcn_apply_parity(backend, opts, mode, folded):
    s, h0 = _graph()
    jp, tp = _params()
    jcfg, tcfg = JConfig(mode=mode), TConfig(mode=mode)
    if folded:
        jp, tp = j_fold(jp, jcfg), fold_w_r(tp, tcfg)
    js, ts = _operands(backend, s)
    jopts = dict(opts, interpret=True) if backend == "block_ell" else {}
    jlogits, jrep = j_apply(jp, JGraph(js, jnp.asarray(h0)), jcfg,
                            backend=backend, **jopts)
    tlogits, trep = gcn_apply(tp, TGraph(ts, h0), tcfg, backend=backend,
                              device="cpu", **opts)
    assert tuple(tlogits.shape) == (45, DIMS[-1])
    np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits), atol=ATOL)
    assert bool(trep.flag) == bool(jrep.flag) is False
    assert float(trep.n_checks) == float(jrep.n_checks)
    np.testing.assert_allclose(float(trep.max_rel), float(jrep.max_rel),
                               atol=1e-5)


@pytest.mark.parametrize("granularity", ["layer", "stripe", "slot"])
@pytest.mark.parametrize("mode", ["split", "fused"])
@pytest.mark.parametrize("fused_layer", [False, True],
                         ids=["two-pass", "fused-layer"])
def test_forward_checks_and_intermediates(fused_layer, mode, granularity):
    s, h0 = _graph(seed=1)
    jp, tp = _params(1)
    jcfg, tcfg = JConfig(mode=mode), TConfig(mode=mode)
    js, ts = _operands("block_ell", s)
    kw = dict(backend="block_ell", fused_layer=fused_layer,
              granularity=granularity, return_intermediates=True,
              return_x=True)
    jl, jc, jh, jx = j_forward(jp, JGraph(js, jnp.asarray(h0)), jcfg,
                               interpret=True, **kw)
    tl, tc, th, tx = gcn_forward(tp, TGraph(ts, h0), tcfg, device="cpu", **kw)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL)
    _same_checks(tc, jc)
    assert len(th) == len(jh) == len(tx) == len(jx) == len(DIMS) - 1
    for a, b in zip(th, jh):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATOL)
    for a, b in zip(tx, jx):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATOL)
    # the fused hook never materializes X; the split baseline always does
    assert all(x is None for x in tx) == (fused_layer and mode != "split")


@pytest.mark.parametrize("layer", [0, 1, 2])
@pytest.mark.parametrize("fused_layer", [False, True],
                         ids=["two-pass", "fused-layer"])
def test_inject_at_each_layer(fused_layer, layer):
    s, h0 = _graph(seed=2)
    jp, tp = _params(2)
    jcfg, tcfg = JConfig(), TConfig()
    js, ts = _operands("block_ell", s)
    kw = dict(backend="block_ell", fused_layer=fused_layer,
              granularity="stripe", inject=(layer, 2, 1, 7.0))
    jl, jc = j_forward(jp, JGraph(js, jnp.asarray(h0)), jcfg, interpret=True,
                       **kw)
    tl, tc = gcn_forward(tp, TGraph(ts, h0), tcfg, device="cpu", **kw)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL)
    _same_checks(tc, jc)
    for ell, (t, j) in enumerate(zip(tc, jc)):
        tf, _ = t.elementwise(tcfg)
        jf, _ = j.elementwise(jcfg)
        np.testing.assert_array_equal(_np(tf), np.asarray(jf))
        want = np.zeros(tf.shape[0], bool)
        want[2] = ell == layer          # exactly the injected layer's stripe
        np.testing.assert_array_equal(_np(tf), want)


@pytest.mark.parametrize("mode", ["split", "fused"])
@pytest.mark.parametrize("fused_layer", [False, True],
                         ids=["two-pass", "fused-layer"])
def test_packed_backend_per_graph_checks(fused_layer, mode):
    stream = synth_graph_stream(3, n_lo=12, n_hi=40, feat=DIMS[0], seed=3)
    pb = pack_graphs(stream, block=8, n_slots=4, stripe_multiple=4,
                     width_multiple=2)
    from repro.engine.batching import pack_graphs as j_pack
    jpb = j_pack(stream, block=8, n_slots=4, stripe_multiple=4,
                 width_multiple=2)
    jp, tp = _params(3)
    jcfg, tcfg = JConfig(mode=mode), TConfig(mode=mode)
    jl, jc = j_forward(jp, JGraph(jpb, jnp.asarray(jpb.h0)), jcfg,
                       backend="block_ell", fused_layer=fused_layer,
                       interpret=True)
    tl, tc = gcn_forward(tp, TGraph(pb, pb.h0), tcfg, backend="block_ell",
                         fused_layer=fused_layer, device="cpu")
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL)
    _same_checks(tc, jc)
    assert all(tuple(c.actual.shape) == (4,) for c in tc)


def test_dense_batched_backend_and_s_c_stash():
    stream = synth_graph_stream(3, n_lo=20, n_hi=20, feat=DIMS[0], seed=4)
    s = np.stack([a for a, _ in stream])
    h0 = np.stack([h for _, h in stream])
    jp, tp = _params(4)
    jl, jc = j_forward(jp, JGraph(jnp.asarray(s), jnp.asarray(h0)), JConfig(),
                       backend="dense", granularity="graph")
    g = TGraph(s, h0)
    tl, tc = gcn_forward(tp, g, TConfig(), backend="dense",
                         granularity="graph", device="cpu")
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL)
    _same_checks(tc, jc)
    assert g.s_c is not None and g._s_c_auto and g.n == 20
    stashed = g.s_c
    gcn_forward(tp, g, TConfig(), backend="dense", device="cpu")
    assert g.s_c is stashed                     # reused, not recomputed
    gcn_forward(tp, g, TConfig(dtype=torch.float64), backend="dense",
                device="cpu")
    assert g.s_c is not stashed and g.s_c.dtype == torch.float64


def test_fused_layer_budget_fallback_counts():
    s, h0 = _graph(seed=5)
    _, tp = _params(5)
    bell = dense_to_block_ell(s, 8, 8)
    bk = make_backend(bell, TConfig(), backend="block_ell", fused_layer=True,
                      device="cpu")
    gcn_forward(tp, TGraph(bell, h0), TConfig(), backend=bk)
    assert (bk.fused_hits, bk.fused_fallbacks) == (3, 0)
    tight = make_backend(bell, TConfig(), backend="block_ell",
                         fused_layer=True, vmem_budget=64, device="cpu")
    a, _ = gcn_forward(tp, TGraph(bell, h0), TConfig(), backend=tight)
    assert (tight.fused_hits, tight.fused_fallbacks) == (0, 3)
    b, _ = gcn_forward(tp, TGraph(bell, h0), TConfig(), backend="block_ell",
                       device="cpu")
    np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)


def test_backend_registry_and_validation():
    s, h0 = _graph(seed=6)
    bell = dense_to_block_ell(s, 8, 8)
    cfg = TConfig()
    assert backend_names() == ("bcoo", "block_ell", "dense")
    assert isinstance(make_backend(bell, cfg, device="cpu"), BlockEllBackend)
    assert isinstance(make_backend(s, cfg, device="cpu"), DenseBackend)
    sparse = torch.from_numpy(s).to_sparse()
    assert isinstance(make_backend(sparse, cfg, device="cpu"), BcooBackend)
    with pytest.raises(ValueError, match="unknown engine backend"):
        make_backend(s, cfg, backend="csr", device="cpu")
    with pytest.raises(TypeError):
        make_backend(s, cfg, backend="block_ell", device="cpu")
    with pytest.raises(TypeError):
        make_backend(s, cfg, backend="dense", block_g=128, device="cpu")
    with pytest.raises(ValueError, match="granularity"):
        make_backend(s, cfg, backend="dense", granularity="stripe",
                     device="cpu")
    with pytest.raises(ValueError, match="granularity"):
        make_backend(bell, cfg, granularity="graph", device="cpu")
    with pytest.raises(ValueError, match="inject is"):
        make_backend(bell, cfg, inject=(0, 1, 2.0), device="cpu")
    net = make_backend(bell, cfg, fused_network=True, device="cpu")
    assert isinstance(net, BlockEllBackend) and net.fused_network
    part = Partition(make_graph_mesh(2, device="cpu"))
    sharded = make_backend(bell, cfg, partition=part, device="cpu")
    assert sharded.partition is part
    assert sharded.bell.n_block_rows % 2 == 0
    bk = make_backend(bell, cfg, device="cpu")
    assert bk.network(None, [], [], cfg) is NotImplemented
    with pytest.raises(ValueError, match="single-graph"):
        bk.aggregate(torch.zeros(2, 45, 3), None)
    # CheckedOp surface: calling the backend runs one checked layer
    _, tp = _params(6)
    out, chk = bk(cfg, torch.from_numpy(h0), tp["layers"][0]["w"])
    assert tuple(out.shape) == (45, DIMS[1]) and not bool(chk.flag(cfg))
    # fused_network=True: the whole forward through the network hook
    a, _ = gcn_forward(tp, TGraph(bell, h0), cfg, backend=net)
    b, _ = gcn_forward(tp, TGraph(bell, h0), cfg, backend=bk)
    assert (net.network_hits, net.network_fallbacks) == (1, 0)
    np.testing.assert_allclose(_np(a), _np(b), atol=1e-5)


def test_convert_round_trip_and_torch_init():
    jp, tp = _params(7)
    back = convert.params_to_numpy(fold_w_r(tp, TConfig()))
    for jl, bl in zip(jp["layers"], back["layers"]):
        assert isinstance(bl["w"], np.ndarray) and bl["w"].dtype == np.float32
        np.testing.assert_array_equal(bl["w"], np.asarray(jl["w"]))
        np.testing.assert_allclose(bl["w_r"], np.asarray(jl["w"]).sum(1),
                                   atol=1e-5)
    again = convert.params_from_numpy(back, device="cpu")
    assert again["layers"][0]["w_r"].dtype == torch.float32
    gen = torch.Generator().manual_seed(0)
    p1 = t_init_gcn(gen, DIMS, device="cpu")
    p2 = t_init_gcn(torch.Generator().manual_seed(0), DIMS, device="cpu")
    for a, b, (fin, fout) in zip(p1["layers"], p2["layers"],
                                 zip(DIMS[:-1], DIMS[1:])):
        assert torch.equal(a["w"], b["w"]) and a["w"].shape == (fin, fout)
        assert float(a["w"].abs().max()) <= (6.0 / (fin + fout)) ** 0.5
