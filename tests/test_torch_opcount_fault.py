"""The paper's evaluation in the port against the JAX package's: Table II's
operation counts (``repro_torch.core.opcount``) and Table I's bit-flip
campaign (``repro_torch.core.fault``).

Both modules are numpy copies, so the comparison is exact: every op count
is the same integer for every dataset, and the same seeds give the same
``CampaignSummary`` field by field (floats compared with ``==``).  The
port's copy of the synthetic datasets makes the same graphs, so the
reference's ``GraphDataset`` is never handed to the port."""
import dataclasses

import numpy as np
import pytest

from repro.core import datasets as j_datasets
from repro.core import fault as j_fault
from repro.core import opcount as j_opcount
from repro_torch.core import datasets as t_datasets
from repro_torch.core import fault as t_fault
from repro_torch.core import opcount as t_opcount

NAMES = sorted(t_datasets.STATS)


def test_the_port_has_the_reference_statistics():
    assert NAMES == sorted(j_datasets.STATS)
    for name in NAMES:
        assert dataclasses.asdict(t_datasets.STATS[name]) == \
            dataclasses.asdict(j_datasets.STATS[name])


@pytest.mark.parametrize("name", NAMES)
def test_op_counts_equal_the_reference(name):
    tst, jst = t_datasets.STATS[name], j_datasets.STATS[name]
    tl, jl = t_opcount.gcn_layer_shapes(tst), j_opcount.gcn_layer_shapes(jst)
    assert [dataclasses.asdict(x) for x in tl] == \
        [dataclasses.asdict(x) for x in jl]
    for t, j in zip(tl, jl):
        assert t.h_dense == j.h_dense
        assert t_opcount.true_ops(t) == j_opcount.true_ops(j)
        for h_static in (False, True):
            assert t_opcount.split_check_ops(t, h_static) == \
                j_opcount.split_check_ops(j, h_static)
        assert t_opcount.fused_check_ops(t) == j_opcount.fused_check_ops(j)
    tc, jc = t_opcount.gcn_op_counts(name), j_opcount.gcn_op_counts(name)
    for f in ("name", "true_out", "split_check", "fused_check",
              "split_total", "fused_total", "check_savings",
              "total_savings"):
        assert getattr(tc, f) == getattr(jc, f), f
    for mode in ("split", "fused", "none"):
        assert [dataclasses.asdict(s)
                for s in t_opcount.fault_sites(tst, mode)] == \
            [dataclasses.asdict(s) for s in j_opcount.fault_sites(jst, mode)]


def test_the_papers_savings_claim_holds_in_both():
    """Table II: fused checking saves more than 21 % of the split
    baseline's checksum operations, on average over the four graphs."""
    t_all, j_all = t_opcount.all_gcn_op_counts(), j_opcount.all_gcn_op_counts()
    assert sorted(t_all) == sorted(j_all) == NAMES
    t_avg = np.mean([c.check_savings for c in t_all.values()])
    j_avg = np.mean([c.check_savings for c in j_all.values()])
    assert t_avg == j_avg
    assert t_avg > 0.21


@pytest.mark.parametrize("dims", [(64, 4, 32, 256), (512, 8, 64, 1024)])
def test_chain_counts_equal_the_reference(dims):
    assert t_opcount.attention_chain_counts(*dims) == \
        j_opcount.attention_chain_counts(*dims)
    t, k, e_cap, dff = dims[0], 2, dims[0] // 2, dims[3]
    assert t_opcount.moe_chain_counts(t, k, e_cap, dff, dims[2]) == \
        j_opcount.moe_chain_counts(t, k, e_cap, dff, dims[2])


# ---------------------------------------------------------------------------
# Table I: the prefix-delta bit-flip campaign
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    tds = t_datasets.make_reduced("cora", scale=8, seed=0)
    jds = j_datasets.make_reduced("cora", scale=8, seed=0)
    return t_fault.NumpyGCN(tds, seed=0), j_fault.NumpyGCN(jds, seed=0)


def test_reduced_cora_and_its_forward_match(models):
    tm, jm = models
    for f in ("data", "row", "col"):
        np.testing.assert_array_equal(getattr(tm.ds.s, f),
                                      getattr(jm.ds.s, f))
    np.testing.assert_array_equal(tm.ds.labels, jm.ds.labels)
    np.testing.assert_array_equal(tm.logits, jm.logits)
    np.testing.assert_array_equal(tm.s_c, jm.s_c)
    for tl, jl in zip(tm.layers, jm.layers):
        for f in ("x", "h_out", "w_r", "x_r"):
            np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f))
        assert (tl.sum_x, tl.sum_hout, tl.pred1, tl.pred2) == \
            (jl.sum_x, jl.sum_hout, jl.pred1, jl.pred2)


@pytest.mark.parametrize("mode", ["split", "fused"])
@pytest.mark.parametrize("mm_bias", [1.0, 8.0])
def test_run_campaigns_equals_the_reference(models, mode, mm_bias):
    tm, jm = models
    ts = t_fault.run_campaigns(tm, mode, 300, seed=1, mm_bias=mm_bias)
    js = j_fault.run_campaigns(jm, mode, 300, seed=1, mm_bias=mm_bias)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.n == 300 and ts.mode == mode


def test_single_outcomes_equal_the_reference(models):
    tm, jm = models
    trng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(50):
        to = t_fault.run_campaign(tm, "fused", trng)
        jo = j_fault.run_campaign(jm, "fused", jrng)
        assert dataclasses.asdict(to) == dataclasses.asdict(jo)


def test_trained_weights_equal_the_reference(models):
    tm, jm = models
    tw = t_fault.train_weights_numpy(tm.ds, epochs=5, seed=3)
    jw = j_fault.train_weights_numpy(jm.ds, epochs=5, seed=3)
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t_fault.glorot_weights((8, 4, 3), seed=2),
                    j_fault.glorot_weights((8, 4, 3), seed=2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("width", [32, 64])
def test_bit_flips_are_involutions_and_match(width):
    rng = np.random.default_rng(width)
    if width == 32:
        vals = rng.normal(size=16).astype(np.float32)
        t_flip, j_flip, u = t_fault.flip_bit_f32, j_fault.flip_bit_f32, \
            np.uint32
    else:
        vals = rng.normal(size=16)
        t_flip, j_flip, u = t_fault.flip_bit_f64, j_fault.flip_bit_f64, \
            np.uint64
    for x in vals:
        for bit in range(width):
            y = t_flip(x, bit)
            assert np.asarray(y).view(u) == np.asarray(j_flip(x, bit)).view(u)
            assert np.asarray(y).view(u) != np.asarray(x).view(u)
            back = t_flip(y, bit)
            assert np.asarray(back).view(u) == np.asarray(x).view(u)
