"""Guarded GAT serving in the port against the JAX package's
(``tests/test_gat_abft.py`` mirrored).

Both packages run one set of numpy weights (drawn by the JAX ``init_gat``,
carried across by ``repro_torch.convert.gat_params_from_numpy``) on one
numpy graph: ``gat_layer``'s output and both check corners agree within
``atol 1e-4`` (the same f32 sums in another order), and the multi-layer
forward's flags, the serve step's ``gat{i}`` ids and the engine's repairs
agree.  Within the port: the single fused corner equals the split
composition of the last multiply, an exponent bit flip in the served
output trips the check at the Table I thresholds while a sub-threshold
delta stays silent, a corrupted W after the fold flags, guarded ==
unguarded bit for bit, and the engine's retry and restore return the clean
output bit for bit.  Every dense product goes through the ``matmul_abft``
wrapper — two a layer, its plain version on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.abft import ABFTConfig as JABFTConfig
from repro.engine.gat import GATEngine as JGATEngine
from repro.engine.gat import fold_gat_w_r as jfold_gat_w_r
from repro.engine.gat import gat_forward as jgat_forward
from repro.engine.gat import gat_layer as jgat_layer
from repro.engine.gat import init_gat as jinit_gat
from repro.engine.gat import make_gat_serve_step as jmake_gat_serve_step
from repro_torch import convert
from repro_torch.core.abft import ABFTConfig, check_matmul
from repro_torch.core.fault import THRESHOLDS, flip_bit_f32
from repro_torch.engine import (GATEngine, GATLayerOp, fold_gat_w_r,
                                gat_forward, gat_layer, init_gat,
                                make_gat_serve_step)
from repro_torch.faults.injectors import flip_bits_tensor
from repro_torch.kernels import runtime

CFG = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
JCFG = JABFTConfig(mode="fused", threshold=1e-3, relative=True)
OFF = ABFTConfig(mode="none")
DIMS = (12, 16, 8, 4)
ATOL = 1e-4


def random_adj(seed, n, p=0.25):
    """Symmetric random adjacency with self-loops (nonzero = edge)."""
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < p
    a = np.logical_or(a, a.T)
    np.fill_diagonal(a, True)
    return a.astype(np.float32)


def random_inputs(seed, n, f, scale=0.5):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, scale, size=(n, f)).astype(np.float32),
            random_adj(seed + 1, n))


def np_params(seed, dims):
    return jax.tree.map(np.asarray, jinit_gat(jax.random.PRNGKey(seed),
                                              dims))


def both(seed, dims):
    """(JAX params, the port's params) on the same numpy weights."""
    p = np_params(seed, dims)
    return (jax.tree.map(jnp.asarray, p),
            convert.gat_params_from_numpy(p, dims, device="cpu"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# against the JAX layer and forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n", [(0, 24), (1, 48), (2, 96)])
def test_gat_layer_matches_the_jax_layer(seed, n):
    jp, tp = both(seed, (8, 6))
    h, adj = random_inputs(seed + 10, n, 8)
    jout, jchk = jgat_layer(jp["layers"][0], jnp.asarray(h),
                            jnp.asarray(adj), JCFG)
    tout, tchk = gat_layer(tp["layers"][0], _t(h), _t(adj), CFG)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    for got, want in ((tchk.predicted, jchk.predicted),
                      (tchk.actual, jchk.actual)):
        np.testing.assert_allclose(float(got), float(want), atol=ATOL,
                                   rtol=1e-6)
    assert not bool(tchk.flag(CFG)) and not bool(jchk.flag(JCFG))
    # the protocol op is the same layer
    out2, chk2 = GATLayerOp()(CFG, _t(h), _t(adj), tp["layers"][0])
    assert torch.equal(out2, tout) and torch.equal(chk2.predicted,
                                                   tchk.predicted)


@pytest.mark.parametrize("seed,n", [(0, 24), (1, 48), (2, 96)])
def test_chain_equals_split_composition(seed, n):
    _, tp = both(seed, (8, 6))
    p = tp["layers"][0]
    h, adj = (_t(x) for x in random_inputs(seed + 10, n, 8))
    out, chk = gat_layer(p, h, adj, CFG)
    # split composition: eq. 2-3 on the LAST multiply A @ X with its true
    # left operand (the softmaxed attention matrix)
    x = h @ p["w"]
    scores = (x @ p["a_l"])[:, None] + (x @ p["a_r"])[None, :]
    scores = torch.nn.functional.leaky_relu(scores, 0.2)
    att = torch.softmax(torch.where(adj > 0, scores,
                                    torch.full_like(scores, -1e30)), dim=-1)
    np.testing.assert_allclose((att @ x).numpy(), out.numpy(), atol=1e-6)
    split = check_matmul(att, x, out, CFG)
    ref = float(out.double().sum())
    scale = max(1.0, abs(ref))
    assert abs(float(chk.predicted) - float(split.predicted)) / scale < 1e-4
    assert abs(float(chk.predicted) - ref) / scale < 1e-4
    assert not bool(chk.flag(CFG))


def test_multilayer_forward_clean_and_injected():
    jp, tp = both(5, DIMS)
    jp, tp = jfold_gat_w_r(jp, JCFG), fold_gat_w_r(tp, CFG)
    h, adj = random_inputs(50, 40, DIMS[0])
    jout, jchecks = jgat_forward(jp, jnp.asarray(h), jnp.asarray(adj), JCFG)
    tout, tchecks = gat_forward(tp, _t(h), _t(adj), CFG)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    assert len(tchecks) == len(DIMS) - 1
    assert not any(bool(c.flag(CFG)) for c in tchecks)
    for target in range(len(DIMS) - 1):
        _, jchecks = jgat_forward(jp, jnp.asarray(h), jnp.asarray(adj), JCFG,
                                  inject_layer=target, inject_delta=7.0)
        _, tchecks = gat_forward(tp, _t(h), _t(adj), CFG,
                                 inject_layer=target, inject_delta=7.0)
        flagged = [i for i, c in enumerate(tchecks) if bool(c.flag(CFG))]
        assert flagged == [target] == [
            i for i, c in enumerate(jchecks) if bool(c.flag(JCFG))]
        for tc, jc in zip(tchecks, jchecks):
            np.testing.assert_allclose(float(tc.actual), float(jc.actual),
                                       atol=ATOL, rtol=1e-6)


# ---------------------------------------------------------------------------
# bit-flip sweep at Table I thresholds
# ---------------------------------------------------------------------------

def _gat_fault_property(seed, threshold):
    _, tp = both(seed, (12, 16))
    # small feature magnitudes keep the f32 accumulation noise of the two
    # checksum corners under tau/4 at the tightest Table I threshold
    h, _ = random_inputs(seed + 20, 48, 12, scale=0.1)
    adj = random_adj(seed + 21, 48)
    out, chk = gat_layer(tp["layers"][0], _t(h), _t(adj), CFG)
    clean_div = abs(float(chk.predicted) - float(chk.actual))
    assert clean_div < threshold / 4, (clean_div, threshold)
    rng = np.random.default_rng(seed)
    out_np = out.numpy().copy()
    big = np.argwhere(np.abs(out_np) >= 1e-3)
    assert big.size, "attention collapsed every value below threshold"
    i, j = big[int(rng.integers(len(big)))]
    old = out_np[i, j]
    new = flip_bit_f32(np.float32(old), 27)
    delta = float(new) - float(old)
    out_np[i, j] = new
    div = abs(float(chk.predicted) - float(out_np.astype(np.float64).sum()))
    assert div > threshold, (div, delta, threshold)
    assert abs(div - abs(delta)) < max(1e-5 * abs(delta), threshold / 4)


@pytest.mark.parametrize("threshold", list(THRESHOLDS[:2]))   # 1e-4, 1e-5
@pytest.mark.parametrize("seed", [0, 5])
def test_bitflip_detected(seed, threshold):
    _gat_fault_property(seed, threshold)


def test_small_fault_below_threshold_is_silent():
    _, tp = both(3, (12, 16))
    h, adj = random_inputs(30, 48, 12)
    out, chk = gat_layer(tp["layers"][0], _t(h), _t(adj), CFG)
    bad = out.double().clone()
    bad[5, 3] += 2e-5                          # below tau = 1e-4
    assert abs(float(chk.predicted) - float(bad.sum())) < 1e-4


def test_weight_corruption_after_fold_flags():
    _, tp = both(4, (12, 16))
    params = fold_gat_w_r(tp, CFG)
    h, adj = (_t(x) for x in random_inputs(40, 48, 12))
    p = dict(params["layers"][0])
    assert tuple(p["w_r"].shape) == (12,)
    p["w"] = flip_bits_tensor(p["w"], 37, 30)
    _out, chk = gat_layer(p, h, adj, CFG)      # w_r predates the corruption
    assert bool(chk.flag(CFG))


# ---------------------------------------------------------------------------
# the guarded engine and the serve step
# ---------------------------------------------------------------------------

def test_guarded_equals_unguarded_bit_for_bit_on_two_products_a_layer():
    _, tp = both(8, DIMS)
    h, adj = (_t(x) for x in random_inputs(80, 40, DIMS[0]))
    runtime.reset_counts()
    ref, checks = gat_forward(tp, h, adj, OFF)
    assert checks == [None] * (len(DIMS) - 1)
    assert runtime.plain_counts()["matmul_abft"] == 2 * (len(DIMS) - 1)
    eng = GATEngine(CFG, tp)
    runtime.reset_counts()
    out, m = eng.forward(h, adj)
    assert torch.equal(out, ref) and not bool(m["abft_flag"])
    assert runtime.plain_counts()["matmul_abft"] == 2 * (len(DIMS) - 1)


def test_engine_retries_and_restores_bit_for_bit():
    p = np_params(6, DIMS)
    jeng = JGATEngine(JCFG, jax.tree.map(jnp.asarray, p))
    eng = GATEngine(CFG, convert.gat_params_from_numpy(p, DIMS,
                                                       device="cpu"))
    h, adj = random_inputs(60, 40, DIMS[0])
    jref, jm = jeng.forward(jnp.asarray(h), jnp.asarray(adj))
    ref, m = eng.forward(_t(h), _t(adj))
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), atol=ATOL,
                               rtol=0)
    assert m["abft_op_ids"] == jm["abft_op_ids"] == tuple(
        f"gat{i}" for i in range(len(DIMS) - 1))
    assert eng.guard.flags == 0
    for layer in range(len(DIMS) - 1):
        flags0, retries0 = eng.guard.flags, eng.guard.retries
        out, _ = eng.forward(_t(h), _t(adj), inject_layer=layer,
                             inject_delta=9.0)
        jeng.forward(jnp.asarray(h), jnp.asarray(adj), inject_layer=layer,
                     inject_delta=9.0)
        assert eng.guard.flags == flags0 + 1
        assert eng.guard.retries == retries0 + 1       # transient: retried
        assert torch.equal(out, ref)
    stats, jstats = eng.stats(), jeng.stats()
    assert {k: stats[k] for k in ("flags", "retries", "restores")} == \
        {k: jstats[k] for k in ("flags", "retries", "restores")} == \
        {"flags": len(DIMS) - 1, "retries": len(DIMS) - 1, "restores": 0}
    # a bit flip in layer 1's W after the fold: a corrupted clone replaces
    # the working leaf (the master shares the tensor and stays pristine);
    # the flag persists through the retries, the guard refolds from the
    # master and replays
    layers = list(eng.params["layers"])
    layers[1] = dict(layers[1], w=flip_bits_tensor(layers[1]["w"], 5, 30))
    eng.params = dict(eng.params, layers=layers)
    out, m = eng.forward(_t(h), _t(adj))
    assert eng.guard.restores == 1 and torch.equal(out, ref)
    assert not bool(m["abft_flag"])
    assert torch.equal(eng.params["layers"][1]["w"],
                       eng._master["layers"][1]["w"])


def test_serve_step_per_op_verdicts():
    p = np_params(7, DIMS)
    jp = jfold_gat_w_r(jax.tree.map(jnp.asarray, p), JCFG)
    tp = fold_gat_w_r(convert.gat_params_from_numpy(p, DIMS, device="cpu"),
                      CFG)
    h, adj = random_inputs(70, 32, DIMS[0])
    step, jstep = make_gat_serve_step(CFG), jmake_gat_serve_step(JCFG)
    _out, m = step(tp, _t(h), _t(adj))
    _jout, jm = jstep(jp, jnp.asarray(h), jnp.asarray(adj))
    assert m["abft_op_ids"] == tuple(jm["abft_op_ids"]) == \
        ("gat0", "gat1", "gat2")
    assert not m["abft_op_flags"].any()
    np.testing.assert_allclose(m["abft_op_rel"].numpy(),
                               np.asarray(jm["abft_op_rel"]), atol=1e-5)
    _out, m = step(tp, _t(h), _t(adj), inject_layer=1, inject_delta=9.0)
    _jout, jm = jstep(jp, jnp.asarray(h), jnp.asarray(adj), inject_layer=1,
                      inject_delta=9.0)
    assert m["abft_op_flags"].tolist() == [False, True, False] == \
        np.asarray(jm["abft_op_flags"]).tolist()


# ---------------------------------------------------------------------------
# weights and devices
# ---------------------------------------------------------------------------

def test_gat_params_from_numpy_checks_shapes():
    p = np_params(9, DIMS)
    tp = convert.gat_params_from_numpy(p, DIMS, device="cpu")
    back = convert.params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="do not match"):
        convert.gat_params_from_numpy(p, (12, 16, 8, 5), device="cpu")
    shapes = init_gat(None, DIMS, device="meta")
    assert [tuple(x["w"].shape) for x in shapes["layers"]] == \
        [(12, 16), (16, 8), (8, 4)]


@pytest.mark.parametrize("entry", ["init_gat", "engine", "convert"])
def test_a_cuda_request_without_a_gpu_raises(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device resolves")
    gen = torch.Generator().manual_seed(0)
    calls = {
        "init_gat": lambda: init_gat(gen, DIMS),
        "engine": lambda: GATEngine.init(CFG, gen, DIMS),
        "convert": lambda: convert.gat_params_from_numpy(np_params(0, DIMS),
                                                         DIMS),
    }
    with pytest.raises(RuntimeError, match="device='cuda' requested"):
        calls[entry]()
