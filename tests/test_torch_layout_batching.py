"""The port keeps its own numpy copies of the block-ELL layout, the batching
and the synthetic data of the JAX package (it may import nothing of
``repro``).  Each copy must give arrays EQUAL to the reference's
(``np.array_equal``) on the same inputs."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import datasets as jds
from repro.core import gcn as jgcn
from repro.engine import batching as jb
from repro.kernels.spmm_abft import layout as jl
from repro_torch.core import datasets as tds
from repro_torch.core import gcn as tgcn
from repro_torch.engine import batching as tb
from repro_torch.kernels.spmm_abft import layout as tl


def _same_bell(a, b):
    assert a.shape == b.shape
    assert a.values.dtype == b.values.dtype == np.float32
    assert a.block_cols.dtype == b.block_cols.dtype == np.int32
    assert np.array_equal(a.values, b.values)
    assert np.array_equal(a.block_cols, b.block_cols)
    for prop in ("block_m", "block_k", "n_block_rows", "width", "padded_rows",
                 "padded_cols", "nnz_tiles", "fill"):
        assert getattr(a, prop) == getattr(b, prop), prop


def _sparse(seed, m, k, density=0.08):
    r = np.random.default_rng(seed)
    return (r.normal(size=(m, k)) * (r.random((m, k)) < density)
            ).astype(np.float32)


@pytest.mark.parametrize("m,k,bm,bk", [(40, 40, 8, 8), (50, 37, 16, 8),
                                       (33, 64, 32, 32), (5, 5, 8, 8)])
def test_dense_and_coo_to_block_ell(m, k, bm, bk):
    a = _sparse(m + k, m, k)
    jbell = jl.dense_to_block_ell(a, bm, bk)
    tbell = tl.dense_to_block_ell(a, bm, bk)
    _same_bell(tbell, jbell)
    assert np.array_equal(tbell.todense(), a)
    assert np.array_equal(tbell.col_sums(), jbell.col_sums())
    # COO with duplicates (summed)
    r, c = np.nonzero(a)
    r2, c2 = np.concatenate([r, r[:5]]), np.concatenate([c, c[:5]])
    d2 = np.concatenate([a[r, c], np.ones(min(5, r.size), np.float32)])
    _same_bell(tl.coo_to_block_ell(r2, c2, d2, a.shape, bm, bk),
               jl.coo_to_block_ell(r2, c2, d2, a.shape, bm, bk))


def test_empty_matrix_layout():
    a = np.zeros((10, 10), np.float32)
    _same_bell(tl.dense_to_block_ell(a, 8, 8), jl.dense_to_block_ell(a, 8, 8))


@pytest.mark.parametrize("fn,arg", [("pad_block_rows", 4), ("pad_width", 7),
                                    ("pad_block_rows_to", 9),
                                    ("pad_block_rows", 1), ("pad_width", 0)])
def test_pad_helpers(fn, arg):
    a = _sparse(3, 40, 40)
    jbell, tbell = jl.dense_to_block_ell(a, 8, 8), tl.dense_to_block_ell(a, 8, 8)
    if fn == "pad_width" and arg == 0:
        with pytest.raises(ValueError):
            tl.pad_width(tbell, 0)
        with pytest.raises(ValueError):
            tl.pad_block_rows_to(tbell, 1)
        return
    _same_bell(getattr(tl, fn)(tbell, arg), getattr(jl, fn)(jbell, arg))


@pytest.mark.parametrize("width_multiple", [1, 4])
def test_stack_block_ell(width_multiple):
    mats = [_sparse(s, n, n, 0.15) for s, n in ((1, 24), (2, 16), (3, 40))]
    jbells = [jl.dense_to_block_ell(m, 8, 8) for m in mats]
    tbells = [tl.dense_to_block_ell(m, 8, 8) for m in mats]
    offs = np.cumsum([0] + [b.n_block_rows for b in jbells[:-1]]).tolist()
    _same_bell(tl.stack_block_ell(tbells, offs, width_multiple=width_multiple),
               jl.stack_block_ell(jbells, offs, width_multiple=width_multiple))
    with pytest.raises(ValueError):
        tl.stack_block_ell([], [])
    with pytest.raises(ValueError):
        tl.stack_block_ell(tbells, offs[:-1])
    with pytest.raises(ValueError):
        tl.stack_block_ell([tbells[0], tl.dense_to_block_ell(mats[1], 16, 8)],
                           [0, 3])


def _same_stream(a, b):
    assert len(a) == len(b)
    for (sa, ha), (sb, hb) in zip(a, b):
        assert np.array_equal(sa, sb) and np.array_equal(ha, hb)
        assert sa.dtype == sb.dtype and ha.dtype == hb.dtype


@pytest.mark.parametrize("kw", [dict(), dict(n_lo=10, n_hi=50, feat=9,
                                             avg_deg=6, seed=3)])
def test_synth_graph_stream(kw):
    _same_stream(tb.synth_graph_stream(7, **kw), jb.synth_graph_stream(7, **kw))


def test_normalized_adjacency_dense():
    e = np.random.default_rng(0).integers(0, 30, size=(60, 2))
    e = e[e[:, 0] != e[:, 1]]
    assert np.array_equal(tgcn.normalized_adjacency_dense(e, 30),
                          jgcn.normalized_adjacency_dense(e, 30))


def _same_pack(a, b):
    _same_bell(a.bell, b.bell)
    for f in ("stripe_graph", "h0", "n_nodes", "row_offsets", "indices"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.n_slots, a.n_graphs, a.block, a.stripe_multiple,
            a.width_multiple) == (b.n_slots, b.n_graphs, b.block,
                                  b.stripe_multiple, b.width_multiple)
    _same_stream(a.items, b.items)


@pytest.mark.parametrize("kw", [
    dict(block=8),
    dict(block=16, n_slots=6, stripe_multiple=4, width_multiple=4),
    dict(block=8, stripe_cap=40, width_cap=16, indices=[5, 3, 9, 1]),
    dict(block=32, n_slots=4, stripe_multiple=2),
])
def test_pack_graphs(kw):
    stream = jb.synth_graph_stream(4, n_lo=20, n_hi=70, feat=5, seed=2)
    _same_pack(tb.pack_graphs(stream, **kw), jb.pack_graphs(stream, **kw))


def test_pack_graphs_raises_like_the_reference():
    stream = tb.synth_graph_stream(3, n_lo=20, n_hi=40, feat=5)
    for mod in (tb, jb):
        with pytest.raises(ValueError):
            mod.pack_graphs([])
        with pytest.raises(ValueError):
            mod.pack_graphs(stream, n_slots=2)
        with pytest.raises(ValueError):
            mod.pack_graphs(stream, block=8, stripe_cap=2)
        with pytest.raises(ValueError):
            mod.pack_graphs(stream, block=8, width_cap=1)
        bad = stream[:2] + [(stream[2][0], stream[2][1][:, :3])]
        with pytest.raises(ValueError, match="feature dim"):
            mod.pack_graphs(bad)


@pytest.mark.parametrize("schedule", ["size", "arrival"])
@pytest.mark.parametrize("block,sm,wm", [(8, 1, 1), (16, 4, 4)])
def test_make_packed_batches(schedule, block, sm, wm):
    stream = jb.synth_graph_stream(11, n_lo=15, n_hi=90, feat=6, seed=4)
    kw = dict(block=block, stripe_multiple=sm, width_multiple=wm,
              schedule=schedule)
    jbatches = jb.make_packed_batches(stream, 4, **kw)
    tbatches = tb.make_packed_batches(stream, 4, **kw)
    assert len(tbatches) == len(jbatches)
    for a, b in zip(tbatches, jbatches):
        _same_pack(a, b)
    with pytest.raises(ValueError):
        tb.make_packed_batches(stream, 4, schedule="random")


def test_schedule_packs_and_pack_stats():
    stripes = [9, 1, 4, 4, 7, 2, 2, 8, 3]
    for bs, q in ((3, 1), (4, 4), (2, 2)):
        assert tb.schedule_packs(stripes, bs, q) == \
            jb.schedule_packs(stripes, bs, q)
    assert tb.schedule_packs([], 4) == []
    for s, _ in jb.synth_graph_stream(4, n_lo=10, n_hi=60, seed=5):
        assert tb.graph_pack_stats(s, 8) == jb.graph_pack_stats(s, 8)
    assert tb.graph_pack_stats(np.zeros((5, 5), np.float32), 8) == (1, 1)


def test_dense_bucketing():
    stream = jb.synth_graph_stream(9, n_lo=10, n_hi=60, feat=4, seed=6)
    jbatches = jb.make_batches(stream, 4, [32, 64])
    tbatches = tb.make_batches(stream, 4, [32, 64])
    assert len(tbatches) == len(jbatches)
    for a, b in zip(tbatches, jbatches):
        for f in ("s", "h0", "n_nodes", "indices"):
            assert np.array_equal(getattr(a, f), getattr(b, f))
        assert a.bucket == b.bucket and a.n_graphs == b.n_graphs
    s, h = stream[0]
    for x, y in zip(tb.pad_graph(s, h, 64), jb.pad_graph(s, h, 64)):
        assert np.array_equal(x, y) and x.dtype == y.dtype
    with pytest.raises(ValueError):
        tb.pick_bucket(100, [32, 64])
    with pytest.raises(ValueError):
        tb.pad_graph(s, h, 4)


def test_reduced_dataset_copy_is_equal():
    a, b = tds.make_reduced("cora", 16, seed=1), jds.make_reduced("cora", 16,
                                                                  seed=1)
    assert dataclasses.astuple(a.stats) == dataclasses.astuple(b.stats)
    assert {k: dataclasses.astuple(v) for k, v in tds.STATS.items()} == \
        {k: dataclasses.astuple(v) for k, v in jds.STATS.items()}
    for f in ("data", "row", "col"):
        assert np.array_equal(getattr(a.s, f), getattr(b.s, f))
        assert np.array_equal(getattr(a.features, f), getattr(b.features, f))
    assert np.array_equal(a.labels, b.labels)
    _same_bell(a.s.to_block_ell(16, 16), b.s.to_block_ell(16, 16))
    for x, y in zip(tgcn.dataset_to_dense(a), jgcn.dataset_to_dense(b)):
        assert np.array_equal(x, y)
    want = np.asarray(b.s.to_bcoo().todense())
    for layout in (torch.sparse_coo, torch.sparse_csr):
        s = a.s.to_sparse(device="cpu", layout=layout)
        assert s.layout == layout
        assert np.array_equal(s.to_dense().numpy(), want)
