"""The port's optimizer stack (``repro_torch.optim``) against the JAX
package's ``repro.optim`` on seeded random trees: AdamW's init and update
(decay on matrices only, the bias corrections of step 1 and of a later
step), the global norm and clipping (under and over the clip), the
cosine-warmup schedule across warmup and decay, the int8 compression (codes
equal, ties rounded half to even) and the error-feedback round trip —
each within ``atol 1e-6`` of the reference.  Everything runs on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim as topt

ATOL = 1e-6


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((5, 7)) * scale).astype(np.float32),
            "stack": [(rng.standard_normal((2, 3, 4)) * scale
                       ).astype(np.float32),
                      (rng.standard_normal((6,)) * scale).astype(np.float32)],
            "norm": {"scale": (rng.standard_normal((7,)) * scale
                               ).astype(np.float32)}}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return topt.tree_map(torch.from_numpy, tree)


def _close(got, want, atol=ATOL):
    g = [x.numpy() for x in topt.tree_leaves(got)]
    w = [np.asarray(x) for x in jax.tree.leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def test_tree_leaves_follow_the_reference_order():
    tree = _tree(0)
    for a, b in zip(topt.tree_leaves(tree), jax.tree.leaves(tree)):
        assert a is b


def test_adamw_init():
    p = _tree(1)
    got, want = topt.adamw_init(_t(p)), jopt.adamw_init(_j(p))
    _close(got["m"], want["m"])
    _close(got["v"], want["v"])
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 0


@pytest.mark.parametrize("start", [0, 7])
@pytest.mark.parametrize("lr_scale", [1.0, 0.37])
def test_adamw_update(start, lr_scale):
    p, g = _tree(2), _tree(3, 0.1)
    m, v = _tree(4, 0.01), jax.tree.map(np.abs, _tree(5, 0.001))
    cfg = jopt.AdamWConfig(lr=1e-2)
    jst = {"m": _j(m), "v": _j(v), "step": jnp.asarray(start, jnp.int32)}
    tst = {"m": _t(m), "v": _t(v),
           "step": torch.tensor(start, dtype=torch.int32)}
    jp, js = jopt.adamw_update(_j(p), _j(g), jst, cfg, jnp.float32(lr_scale))
    tp, ts = topt.adamw_update(_t(p), _t(g), tst, topt.AdamWConfig(lr=1e-2),
                               torch.tensor(lr_scale))
    _close(tp, jp)
    _close(ts["m"], js["m"])
    _close(ts["v"], js["v"])
    assert int(ts["step"]) == int(js["step"]) == start + 1
    # decay reaches matrices alone: with g = m = v = 0 a vector stays put
    z = topt.tree_map(torch.zeros_like, _t(p))
    zp, _ = topt.adamw_update(_t(p), z, {"m": z, "v": z, "step": tst["step"]},
                              topt.AdamWConfig(lr=1e-2), torch.tensor(1.0))
    assert torch.equal(zp["norm"]["scale"], _t(p)["norm"]["scale"])
    assert not torch.equal(zp["w"], _t(p)["w"])


@pytest.mark.parametrize("max_norm", [1e3, 0.5])
def test_global_norm_and_clip(max_norm):
    g = _tree(6)
    jn = jopt.global_norm(_j(g))
    tn = topt.global_norm(_t(g))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    jc, jg = jopt.clip_by_global_norm(_j(g), max_norm)
    tc, tg = topt.clip_by_global_norm(_t(g), max_norm)
    _close(tc, jc)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 150])
def test_cosine_warmup(step):
    want = jopt.cosine_warmup(jnp.asarray(step, jnp.int32), 10, 100)
    got = topt.cosine_warmup(torch.tensor(step, dtype=torch.int32), 10, 100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(topt.cosine_warmup(step, 10, 100).numpy(),
                               np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed", [7, 8])
def test_compress_int8_codes_equal(seed):
    x = _tree(seed)["w"]
    jq, js = jopt.compress_int8(jnp.asarray(x))
    tq, ts = topt.compress_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=0)
    np.testing.assert_allclose(
        topt.decompress_int8(tq, ts).numpy(),
        np.asarray(jopt.decompress_int8(jq, js)), rtol=0, atol=ATOL)


def test_compress_int8_rounds_half_to_even():
    # max |x| = 127 makes the scale 1: x / scale lands on the halves
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5],
                 dtype=np.float32)
    jq, _ = jopt.compress_int8(jnp.asarray(x))
    tq, _ = topt.compress_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.tolist() == [127, 0, 2, 2, 0, -2, -2, 4]


def test_ef_compress_grads():
    g, e = _tree(9, 0.1), _tree(10, 1e-3)
    jg, je = jopt.ef_compress_grads(_j(g), _j(e))
    tg, te = topt.ef_compress_grads(_t(g), _t(e))
    _close(tg, jg)
    _close(te, je)
