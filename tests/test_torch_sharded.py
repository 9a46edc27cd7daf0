"""Stripe sharding of the port's block-ELL backend (``engine/sharded.py``,
``launch/mesh.py``) against the JAX package's.

The port's ``partition=`` at 2 and 4 shards, on the two-pass (B1) and
fused-layer (B2) paths, against the reference's unsharded block-ELL path and
against the reference's ``Partition`` over ``make_graph_mesh(1)`` (the JAX
CPU has one device in process; the 8-device case stays the reference's own
subprocess test): logits and ``predicted``/``actual`` within ``atol 1e-4``,
flags equal.  Within the port, sharded output rows and stripe corners equal
the unsharded run's bit for bit, layer corners within ``rtol 1e-6`` (the
shard partials add in another order), and the reference's refusals (slot
corners, ``inject=``, packed batches) and ``network()``'s decline hold.  The
JAX side runs its Pallas kernels in interpret mode, the port its plain
versions (``device="cpu"``).  Mirrors ``tests/test_sharded_engine.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.abft import ABFTConfig as JConfig
from repro.core.gcn import init_gcn as j_init_gcn
from repro.core.datasets import make_reduced as j_make_reduced
from repro.engine import Graph as JGraph
from repro.engine import Partition as JPartition
from repro.engine import gcn_forward as j_forward
from repro.launch.mesh import make_graph_mesh as j_make_graph_mesh
from repro_torch import convert
from repro_torch.core.abft import ABFTConfig as TConfig
from repro_torch.core.datasets import make_reduced
from repro_torch.core.fault import flip_bit_f32
from repro_torch.engine import Graph, Partition, gcn_forward, make_backend
from repro_torch.engine import pack_graphs, synth_graph_stream
from repro_torch.engine import sharded_gcn_fused, sharded_spmm_abft
from repro_torch.kernels.spmm_abft.layout import pad_block_rows
from repro_torch.kernels.spmm_abft.ops import device_block_ell
from repro_torch.launch.mesh import (GraphMesh, GraphShardingRules,
                                     make_graph_mesh)

ATOL = 1e-4
BLOCK = 16
PATHS = {"two_pass": {}, "fused_layer": {"fused_layer": True}}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _part(n):
    return Partition(make_graph_mesh(n, device="cpu"))


@pytest.fixture(scope="module")
def cora():
    """Reduced Cora (scale 8) at block 16 — 22 stripes, so 2 shards split
    it evenly and 4 pad it to 24 — with weights from the reference."""
    tds, jds = make_reduced("cora", 8, seed=0), j_make_reduced("cora", 8,
                                                               seed=0)
    jp = j_init_gcn(jax.random.PRNGKey(0), tds.stats.layer_dims)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    h0 = tds.features.todense()
    return (tds.s.to_block_ell(BLOCK, BLOCK), jds.s.to_block_ell(BLOCK, BLOCK),
            h0, jp, tp)


def _t_forward(cora, path, granularity="layer", partition=None):
    bell, _, h0, _, tp = cora
    return gcn_forward(tp, Graph(bell, h0), TConfig(), backend="block_ell",
                       granularity=granularity, partition=partition,
                       device="cpu", **PATHS[path])


def _j_forward(cora, path, granularity="layer", partition=None):
    _, jbell, h0, jp, _ = cora
    return j_forward(jp, JGraph(jbell, jnp.asarray(h0)), JConfig(),
                     backend="block_ell", block_g=BLOCK,
                     granularity=granularity, partition=partition,
                     **PATHS[path])


def _close_to_reference(t_logits, t_checks, j_logits, j_checks):
    np.testing.assert_allclose(_np(t_logits), np.asarray(j_logits),
                               atol=ATOL)
    assert len(t_checks) == len(j_checks) == 2
    for tc, jc in zip(t_checks, j_checks):
        n = np.asarray(jc.actual).size
        assert tc.granularity == jc.granularity
        for field in ("predicted", "actual"):
            got = _np(getattr(tc, field)).reshape(-1)
            np.testing.assert_allclose(got[:n], np.asarray(
                getattr(jc, field)).reshape(-1), atol=ATOL, rtol=1e-5)
            assert not np.any(got[n:])         # padding stripes: 0 = 0
        assert not bool(tc.flag(TConfig())) and not bool(jc.flag(JConfig()))


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("path", list(PATHS))
def test_partition_matches_reference_unsharded(cora, path, n_shards):
    _close_to_reference(*_t_forward(cora, path, partition=_part(n_shards)),
                        *_j_forward(cora, path))


@pytest.mark.parametrize("granularity", ["layer", "stripe"])
@pytest.mark.parametrize("path", list(PATHS))
def test_partition_matches_reference_partition(cora, path, granularity):
    """The port's 4 shards against the reference's shard_map over a
    one-device mesh (the JAX CPU's only device)."""
    jpart = JPartition(j_make_graph_mesh(1), "graph")
    _close_to_reference(
        *_t_forward(cora, path, granularity, partition=_part(4)),
        *_j_forward(cora, path, granularity, partition=jpart))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("granularity", ["layer", "stripe"])
@pytest.mark.parametrize("path", list(PATHS))
def test_sharded_equals_unsharded_bitwise(cora, path, granularity, n_shards):
    """Output rows and stripe corners bit for bit; layer corners, whose
    shard partials add in another order, within rtol 1e-6."""
    base_logits, base_checks = _t_forward(cora, path, granularity)
    logits, checks = _t_forward(cora, path, granularity, _part(n_shards))
    assert torch.equal(logits, base_logits)
    for c, b in zip(checks, base_checks):
        assert c.granularity == b.granularity == granularity
        if granularity == "stripe":
            nbm = b.actual.shape[0]
            assert torch.equal(c.predicted[:nbm], b.predicted)
            assert torch.equal(c.actual[:nbm], b.actual)
            assert not c.actual[nbm:].any() and not c.predicted[nbm:].any()
        else:
            for got, want in ((c.predicted, b.predicted),
                              (c.actual, b.actual)):
                assert torch.allclose(got, want, rtol=1e-6, atol=0.0)


def test_partition_refusals_and_network_decline(cora):
    """The reference's error cases (``engine/backends.py:329-369``), and
    ``network()`` declining so the per-layer ladder runs."""
    bell, _, h0, _, tp = cora
    cfg, part = TConfig(), _part(2)
    with pytest.raises(ValueError, match="slot"):
        make_backend(bell, cfg, partition=part, granularity="slot",
                     device="cpu")
    with pytest.raises(ValueError, match="inject"):
        make_backend(bell, cfg, partition=part, inject=(0, 1, 0, 5.0),
                     device="cpu")
    stream = synth_graph_stream(2, n_lo=20, n_hi=30, feat=8, seed=1)
    packed = pack_graphs(stream, block=8)
    with pytest.raises(ValueError, match="packed"):
        make_backend(packed, cfg, partition=part, device="cpu")
    with pytest.raises(ValueError, match="dense backend"):
        make_backend(bell.todense(), cfg, partition=part, device="cpu")
    bk = make_backend(bell, cfg, partition=part, fused_network=True,
                      fused_layer=True, device="cpu")
    assert bk.bell.n_block_rows % 2 == 0
    assert bk.network(torch.from_numpy(h0), [], [], cfg) is NotImplemented
    logits, checks = gcn_forward(tp, Graph(bell, h0), cfg, backend=bk)
    assert (bk.network_hits, bk.network_fallbacks) == (0, 0)
    assert (bk.fused_hits, bk.fused_fallbacks) == (2, 0)
    base, _ = _t_forward(cora, "fused_layer")
    assert torch.equal(logits, base) and len(checks) == 2


def test_fault_in_one_shard_trips_the_global_check(cora):
    """A high exponent-bit flip in X rows of shard 1's stripes flags the
    summed check (``tests/test_sharded_engine.py`` ``_fault_case``)."""
    bell, _, h0, _, tp = cora
    cfg = TConfig(mode="fused", threshold=1e-4, relative=False)
    bk = make_backend(bell, cfg, partition=_part(4), device="cpu")
    w = tp["layers"][0]["w"]
    h = torch.from_numpy(h0)
    x, x_r = h @ w, h @ w.sum(dim=1)
    _, clean = bk.aggregate(x, x_r)
    assert float((clean.predicted - clean.actual).abs()) < 1e-4 / 4
    per = bk.bell.n_block_rows // 4 * BLOCK
    x_np = _np(x).copy()
    rows = np.arange(per, 2 * per)
    ri, j = np.argwhere(np.abs(x_np[rows]) >= 1e-2)[3]
    x_np[rows[ri], j] = flip_bit_f32(np.float32(x_np[rows[ri], j]), 27)
    _, bad = bk.aggregate(torch.from_numpy(x_np), x_r)
    assert float((bad.predicted - bad.actual).abs()) > 1e-4
    assert bool(bad.flag(cfg))


def test_sharded_functions_without_a_check(cora):
    bell, _, h0, _, tp = cora
    padded = pad_block_rows(bell, 4)
    cols, vals = device_block_ell(padded, "cpu")
    h, w = torch.from_numpy(h0), tp["layers"][0]["w"]
    out, chk = sharded_spmm_abft(padded, cols, vals, h @ w, None, _part(4))
    assert chk is None and tuple(out.shape) == (bell.shape[0], w.shape[1])
    fused, chk = sharded_gcn_fused(padded, cols, vals, h, w, None, _part(4))
    assert chk is None
    np.testing.assert_allclose(_np(fused), _np(out), atol=1e-5)


def test_staged_tables_are_shared_by_backends(cora):
    """``staged=``: backends over one padded layout share one staged copy
    and run as if they had staged it themselves."""
    bell, _, h0, _, tp = cora
    padded = pad_block_rows(bell, 4)
    staged = device_block_ell(padded, "cpu")
    for n in (1, 4):
        bk = make_backend(padded, TConfig(), partition=_part(n),
                          staged=staged, device="cpu")
        assert bk.vals is staged[1] and bk.cols is staged[0]
        logits, _ = gcn_forward(tp, Graph(padded, h0), TConfig(), backend=bk)
        base, _ = _t_forward(cora, "two_pass")
        assert torch.equal(logits, base)
    with pytest.raises(ValueError, match="padded for the partition"):
        make_backend(bell, TConfig(), partition=_part(4),
                     staged=device_block_ell(bell, "cpu"), device="cpu")


def test_graph_mesh_and_rules():
    mesh = make_graph_mesh(3, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.axis_names == ("graph",) and mesh.shape == {"graph": 3}
    assert make_graph_mesh(device="cpu").shape == {"graph": 1}
    with pytest.raises(ValueError):
        make_graph_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="axis"):
        Partition(mesh, "rows")
    part = Partition(GraphMesh((torch.device("cpu"),) * 2, "g"), "g")
    assert part.n_shards == 2 and len(part.mesh.devices) == 2
    rules = GraphShardingRules(mesh)
    t = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    slabs = rules.split_stripes(t)
    assert [s.shape[0] for s in slabs] == [2, 2, 2]
    assert slabs[1].data_ptr() == t[2:4].data_ptr()      # views, no copy
    assert torch.equal(rules.gather_rows(slabs), t)
    reps = rules.replicate(t)
    assert len(reps) == 3 and all(r is reps[0] for r in reps)
    parts = [torch.tensor(1.0), torch.tensor(2.0), torch.tensor(3.0)]
    assert float(rules.psum(parts)) == 6.0
    with pytest.raises(ValueError, match="pad_block_rows"):
        rules.split_stripes(torch.zeros(5, 2))


# ---------------------------------------------------------------------------
# on a GPU: B1 and B2 launched on a slab against the full launch
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
def test_cuda_slab_launch_matches_full_launch(cora, path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no "
                    "interpret mode)")
    bell, _, h0, _, tp = cora
    dev = torch.device("cuda")
    gp = convert.params_to_device(tp, device="cuda")
    graph = Graph(pad_block_rows(bell, 4), torch.from_numpy(h0).to(dev))
    for gran in ("layer", "stripe"):
        base, base_checks = gcn_forward(gp, graph, TConfig(),
                                        backend="block_ell", device="cuda",
                                        granularity=gran, **PATHS[path])
        part = Partition(make_graph_mesh(4, device="cuda"))
        got, checks = gcn_forward(gp, graph, TConfig(), backend="block_ell",
                                  device="cuda", granularity=gran,
                                  partition=part, **PATHS[path])
        assert torch.equal(got, base)
        if gran == "stripe":
            for c, b in zip(checks, base_checks):
                assert torch.equal(c.predicted, b.predicted)
                assert torch.equal(c.actual, b.actual)
