"""The LM mesh in the port against the JAX package's.

(a) ``repro_torch.launch.mesh.ShardingRules``' ``param_spec``,
``cache_spec`` and ``batch_spec`` equal the reference's spec for spec, for
every leaf of every arch at full width (params from ``init_model`` on
``meta`` and the reference's ``jax.eval_shape``; decode states at the
decode_32k and long_500k batches) on (16, 16), (2, 16, 16) and (2, 4): both
rules read only the mesh's axis names and sizes, so each gets a stand-in.
(b) ``make_batch_specs`` equals the reference's for every arch × shape.
(c) Each sharding strategy of the LM's kernel sites (``kernels/sites.py``)
on a (2, 4) mesh of ``LocalTensorMode`` ranks (every rank in this process,
real values): the outputs, gathered, equal one unsharded call — ``c`` and
``o`` bit for bit where K is not split, the launch's split plan is the
global one and a local product has more than one row (one row takes
BLAS's vector path on the CPU), within ``atol = rtol = 1e-4`` otherwise,
the check columns and the block sums' total within it — at M on both
sides of the thin/wide tile boundary.  (d) The reference's sharded train
step (smoke gemma-2b, d 64, heads 4/1, hd 16, ff 128, V 256; a (2, 4)
mesh, batch 8 x 16, 4 steps): clean flags, a moving loss, each step's
loss within ``atol 1e-4 + rtol 1e-6`` of the unsharded port step and of
the reference's unsharded jitted step; the twin's sharded prefill and
decode within the same gate of the unsharded port, and an accumulator
upset on the sharded prefill flags.  (f) ``reshard_restore`` with
``ShardingRules`` shardings: every rank holds the slice of each leaf
that its spec gives.

The ``"fake"`` process group (8 ranks, this process rank 0) lives for the
module only, so other test files in the same worker are unaffected."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.core.abft import ABFTConfig as JABFTConfig
from repro.data.synthetic import make_batch_specs as jmake_batch_specs
from repro.launch.mesh import ShardingRules as JShardingRules
from repro.launch.steps import init_train_state as jinit_train_state
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models.transformer import init_decode_state as jinit_decode_state
from repro.models.transformer import init_model as jinit_model
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch import convert
from repro_torch.checkpoint.ckpt import save_checkpoint
from repro_torch.checkpoint.elastic import reshard_restore
from repro_torch.configs import SHAPES, get_config, list_archs, smoke_config
from repro_torch.core.abft import ABFTConfig
from repro_torch.data import SyntheticLM, make_batch_specs
from repro_torch.kernels.flash_checksum.kernel import (flash_checksum_kernel,
                                                       flash_checksum_plain)
from repro_torch.kernels.matmul_abft.kernel import (matmul_abft_grouped_kernel,
                                                    matmul_abft_grouped_plain,
                                                    matmul_abft_kernel,
                                                    matmul_abft_plain)
from repro_torch.analysis.vmem import matmul_split_k, matmul_splits
from repro_torch.launch.mesh import (ShardingRules, distribute_tree,
                                     make_test_mesh)
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.attention import attention_fault_injection
from repro_torch.models.transformer import init_decode_state, init_model
from repro_torch.optim import AdamWConfig, tree_leaves
from repro_torch.optim.tree import tree_flatten_with_path

ATOL, RTOL = 1e-4, 1e-6          # the LM gate
SITE_TOL = 1e-4
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
WORLD = 8


class StandIn:
    """What both packages' ``ShardingRules`` read of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


def _key(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(_key(p), tuple(x.shape)) for p, x in flat]


def _port_leaves(tree):
    return [("/".join(str(p) for p in path), tuple(x.shape))
            for path, x in tree_flatten_with_path(tree)]


def _entries(spec, n):
    return tuple(spec) + (None,) * (n - len(tuple(spec)))


# ---------------------------------------------------------------------------
# (a) specs, (b) batch specs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_shapes():
    """Per arch, the reference's params and decode states (eval_shape)."""
    out = {}
    for arch in list_archs():
        jcfg = jget_config(arch)
        params = jax.eval_shape(lambda: jinit_model(jcfg,
                                                    jax.random.PRNGKey(0)))
        states = {
            name: jax.eval_shape(lambda s=JSHAPES[name]: jinit_decode_state(
                jcfg, s.global_batch, s.seq_len))
            for name in ("decode_32k", "long_500k")}
        out[arch] = (params, states)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_and_cache_specs_equal_the_reference(ref_shapes, arch, mesh):
    shape, axes = MESHES[mesh]
    rules = ShardingRules(StandIn(shape, axes))
    jrules = JShardingRules(StandIn(shape, axes))
    cfg = get_config(arch)
    jparams, jstates = ref_shapes[arch]
    ours = _port_leaves(init_model(cfg, device="meta"))
    theirs = _ref_leaves(jparams)
    assert ours == theirs
    for key, shp in ours:
        assert rules.param_spec(key, shp) == \
            _entries(jrules.param_spec(key, shp), len(shp)), (key, shp)
    for name, jstate in jstates.items():
        b, n = SHAPES[name].global_batch, SHAPES[name].seq_len
        ours = _port_leaves(init_decode_state(cfg, b, n, device="meta"))
        assert ours == _ref_leaves(jstate)
        for key, shp in ours:
            assert rules.cache_spec(key, shp, b, cfg.n_kv_heads) == _entries(
                jrules.cache_spec(key, shp, b, cfg.n_kv_heads), len(shp)), \
                (name, key, shp)
    assert rules.dp_size == jrules.dp_size
    for dim in (1, 2, 8, 16, 48, 256, 512, 4096, 1000):
        assert rules._combined_if_div(dim) == jrules._combined_if_div(dim)


@pytest.mark.parametrize("arch", list_archs())
def test_batch_specs_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in SHAPES.items():
        ours = make_batch_specs(cfg, shape)
        theirs = jmake_batch_specs(jcfg, JSHAPES[name])
        assert sorted(ours) == sorted(theirs)
        for k, t in ours.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(theirs[k].shape)
            assert str(t.dtype).split(".")[-1] == str(theirs[k].dtype)
        for mesh, (mshape, axes) in MESHES.items():
            rules = ShardingRules(StandIn(mshape, axes))
            jrules = JShardingRules(StandIn(mshape, axes))
            for k, t in ours.items():
                shp = tuple(t.shape)
                assert rules.batch_spec(shp, shp[0]) == _entries(
                    jrules.batch_spec(shp, shp[0]), len(shp)), (mesh, k)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    rules = ShardingRules(StandIn((2, 16, 16), ("pod", "data", "model")))
    assert rules.placements((("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert rules.placements(()) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        rules.placements((("data", "pod"),))


# ---------------------------------------------------------------------------
# the (2, 4) mesh of local ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fake_group():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", rank=0, world_size=WORLD,
                            store=FakeStore())
    yield
    dist.destroy_process_group()


@pytest.fixture
def local_mesh(fake_group):
    """A (2, 4) ("data", "model") mesh whose 8 ranks run in this process;
    the test body runs in their mode (each rank's value of a tensor made
    there is its own), unsharded yardsticks under :func:`_outside`."""
    from torch.distributed._local_tensor import LocalTensorMode

    with LocalTensorMode(frozenset(range(WORLD))):
        yield make_test_mesh((2, 4), ("data", "model"), device="cpu")


def _outside():
    """Plain PyTorch again, inside a test on the local mesh."""
    from torch.distributed._local_tensor import \
        maybe_disable_local_tensor_mode

    return maybe_disable_local_tensor_mode()


def _ranks(x):
    """Every rank's value of a LocalTensor (a plain tensor: one value)."""
    from torch.distributed._local_tensor import LocalTensor

    if isinstance(x, LocalTensor):
        return [x._local_tensors[r] for r in range(WORLD)]
    return [x]


def _whole(x):
    """A DTensor gathered; every rank must hold the same value."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    vals = _ranks(x)
    for v in vals[1:]:
        assert torch.equal(v, vals[0])
    return vals[0]


def _dist(t, mesh, *pls):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, list(pls))


def _site_ok(got, want, exact):
    if exact:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, atol=SITE_TOL, rtol=SITE_TOL)


# ---------------------------------------------------------------------------
# (c) the sites' strategies
# ---------------------------------------------------------------------------

# (a placements, b placements) on ("data", "model"); b_r follows b (its
# partial row sums) or is replicated (a folded w_r)
S0, S1 = "S0", "S1"
PRODUCT_LAYOUTS = {
    "replicated": ((None, None), (None, None)),
    "rows_x_cols": ((S0, None), (None, "N")),
    "rows_on_both": ((S0, S0), (None, None)),
    "k_x_cols": (("K", None), ("K", "N")),
}


def _pl(code, trans_b, on_b):
    from torch.distributed.tensor import Replicate, Shard

    if code is None:
        return Replicate()
    if code == S0:
        return Shard(0)
    if on_b:        # b is [K, N], or [N, K] with trans_b
        return Shard({"K": 1, "N": 0}[code] if trans_b
                     else {"K": 0, "N": 1}[code])
    return Shard(1)                      # a's K axis


@pytest.mark.parametrize("folded", [False, True], ids=["br_of_b", "folded"])
@pytest.mark.parametrize("trans_b", [False, True], ids=["b", "bT"])
@pytest.mark.parametrize("layout", sorted(PRODUCT_LAYOUTS))
@pytest.mark.parametrize("m", [8, 32, 128])
def test_matmul_site_strategies_equal_one_launch(local_mesh, m, layout,
                                                 trans_b, folded):
    """M 8 (thin, locally thin), 32 (wide, locally thin on 2 row shards),
    128 (wide on both)."""
    from torch.distributed.tensor import Replicate

    k, n = 96, 256
    with _outside():
        g = torch.Generator().manual_seed(m)
        a = torch.randn(m, k, generator=g)
        b = torch.randn(n, k, generator=g) if trans_b else torch.randn(
            k, n, generator=g) / math.sqrt(k)
        br = b.sum(dim=0 if trans_b else 1)
        c0, sums0, ex0 = matmul_abft_plain(a, b, br, trans_b=trans_b)
    pa, pb = PRODUCT_LAYOUTS[layout]
    da = _dist(a, local_mesh, *(_pl(x, trans_b, False) for x in pa))
    db = _dist(b, local_mesh, *(_pl(x, trans_b, True) for x in pb))
    dbr = _dist(br, local_mesh, Replicate(), Replicate()) if folded else \
        db.sum(dim=0 if trans_b else 1)
    calls = matmul_abft_plain.calls
    c, sums, ex = matmul_abft_kernel(da, db, dbr, trans_b=trans_b)
    assert matmul_abft_plain.calls > calls          # launched on the shards
    assert c.placements == tuple(
        _expected_c(pa, pb)), (c.placements, layout)
    ml = m // (2 if pa[0] == S0 else 1) // (4 if pa[1] == S0 else 1)
    nl = n // (4 if pb[1] == "N" else 1)
    kl = k // (2 if pa[0] == "K" else 1)
    plan = (matmul_splits(ml, nl, kl), matmul_split_k(ml, nl, kl)) == (
        matmul_splits(m, n, k), matmul_split_k(m, n, k))
    # exact where K is whole and the split plan the global one; a one-row
    # local product takes BLAS's vector path on the CPU (another order)
    _site_ok(_whole(c), c0, exact=plan and "K" not in pa and ml > 1)
    torch.testing.assert_close(_whole(sums).reshape(()), sums0.sum(),
                               atol=SITE_TOL, rtol=SITE_TOL)
    torch.testing.assert_close(_whole(ex), ex0, atol=SITE_TOL, rtol=SITE_TOL)
    c1, sums1, ex1 = matmul_abft_kernel(da, db, None, trans_b=trans_b)
    assert ex1 is None
    _site_ok(_whole(c1), _whole(c), exact=True)


def _expected_c(pa, pb):
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for x, y in zip(pa, pb):           # a partial c is all-reduced at once
        out.append(Shard(0) if x == S0 else Shard(1) if y == "N" else
                   Replicate())
    return out


GROUPED_LAYOUTS = {
    "groups_x_rows": (("G", "R"), ("G", None)),       # experts on model
    "rows_x_groups": (("R", "G"), (None, "G")),
    "k_x_cols": (("K", None), ("K", "N")),
}


@pytest.mark.parametrize("layout", sorted(GROUPED_LAYOUTS))
@pytest.mark.parametrize("m", [8, 32])
def test_grouped_site_strategies_equal_one_launch(local_mesh, m, layout):
    from torch.distributed.tensor import Replicate, Shard

    grp, k, n = 8, 64, 128
    with _outside():
        gen = torch.Generator().manual_seed(7 + m)
        a = torch.randn(grp, m, k, generator=gen)
        b = torch.randn(grp, k, n, generator=gen) / math.sqrt(k)
        c0, sums0, ex0 = matmul_abft_grouped_plain(a, b, b.sum(-1))
    code = {"G": Shard(0), "R": Shard(1), "K": None, "N": Shard(2),
            None: Replicate()}
    pa, pb = GROUPED_LAYOUTS[layout]
    da = _dist(a, local_mesh, *(Shard(2) if x == "K" else code[x]
                                for x in pa))
    db = _dist(b, local_mesh, *(Shard(1) if x == "K" else code[x]
                                for x in pb))
    calls = matmul_abft_grouped_plain.calls
    c, sums, ex = matmul_abft_grouped_kernel(da, db, db.sum(-1))
    assert matmul_abft_grouped_plain.calls > calls
    ml = m // (2 if pa[0] == "R" else 4 if pa[1] == "R" else 1)
    nl = n // (4 if pb[1] == "N" else 1)
    plan = (matmul_splits(ml, nl, k), matmul_split_k(ml, nl, k)) == (
        matmul_splits(m, n, k), matmul_split_k(m, n, k))
    _site_ok(_whole(c), c0, exact=plan and "K" not in pa)
    torch.testing.assert_close(_whole(sums).sum(), sums0.sum(),
                               atol=SITE_TOL, rtol=SITE_TOL)
    torch.testing.assert_close(_whole(ex), ex0, atol=SITE_TOL, rtol=SITE_TOL)


@pytest.mark.parametrize("layout", sorted(GROUPED_LAYOUTS))
def test_grouped_site_with_row_counts_equals_one_launch(local_mesh, layout):
    """With per-group row counts the grouped site's strategies keep the
    counts with the group axis (split with it, whole otherwise) and gather
    a row-sharded ``a``: the outputs, gathered, equal one unsharded counted
    call, and the rows past each count are zeros."""
    from torch.distributed.tensor import Replicate, Shard

    grp, m, k, n = 8, 32, 64, 128
    with _outside():
        gen = torch.Generator().manual_seed(11)
        a = torch.randn(grp, m, k, generator=gen)
        b = torch.randn(grp, k, n, generator=gen) / math.sqrt(k)
        rows = torch.tensor([0, 32, 5, 16, 17, 1, 31, 0], dtype=torch.int32)
        c0, sums0, ex0 = matmul_abft_grouped_plain(a, b, b.sum(-1),
                                                   rows=rows)
    code = {"G": Shard(0), "R": Shard(1), "K": None, "N": Shard(2),
            None: Replicate()}
    pa, pb = GROUPED_LAYOUTS[layout]
    da = _dist(a, local_mesh, *(Shard(2) if x == "K" else code[x]
                                for x in pa))
    db = _dist(b, local_mesh, *(Shard(1) if x == "K" else code[x]
                                for x in pb))
    drows = _dist(rows, local_mesh, *(Shard(0) if x == "G" else Replicate()
                                      for x in pa))
    c, sums, ex = matmul_abft_grouped_kernel(da, db, db.sum(-1), rows=drows)
    c = _whole(c)
    _site_ok(c, c0, exact=False)
    dead = torch.arange(m)[None, :] >= rows[:, None]
    assert not c.masked_select(dead[..., None]).any()
    torch.testing.assert_close(_whole(sums).sum(), sums0.sum(),
                               atol=SITE_TOL, rtol=SITE_TOL)
    torch.testing.assert_close(_whole(ex), ex0, atol=SITE_TOL, rtol=SITE_TOL)


FLASH_CASES = {
    # (H, Kh, causal, window, q placements, k/v placements)
    "gqa_batch_x_heads": (8, 4, True, 0, ("B", "H"), ("B", "H")),
    "mqa_batch_x_heads": (8, 1, True, 0, ("B", "H"), ("B", None)),
    "window_heads": (8, 4, True, 5, (None, "H"), (None, "H")),
    "noncausal_batch": (4, 4, False, 0, ("B", None), ("B", None)),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_site_strategies_equal_one_launch(local_mesh, case):
    from torch.distributed.tensor import Replicate, Shard

    h, kh, causal, window, pq, pk = FLASH_CASES[case]
    bsz, t, s, dh = 4, 19, 19 if causal else 23, 16
    with _outside():
        gen = torch.Generator().manual_seed(11)
        q = torch.randn(bsz, t, h, dh, generator=gen)
        k = torch.randn(bsz, s, kh, dh, generator=gen)
        v = torch.randn(bsz, s, kh, dh, generator=gen)
        vr = torch.randn(bsz, s, h, generator=gen)
        want = flash_checksum_plain(q, k, v, vr, causal=causal,
                                    window=window, with_stats=True)
    code = {"B": Shard(0), "H": Shard(2), None: Replicate()}
    dq = _dist(q, local_mesh, *(code[x] for x in pq))
    dk, dv = (_dist(x, local_mesh, *(code[y] for y in pk)) for x in (k, v))
    dvr = _dist(vr, local_mesh, *(code[x] for x in pq))
    calls = flash_checksum_plain.calls
    got = flash_checksum_kernel(dq, dk, dv, dvr, causal=causal,
                                window=window, with_stats=True)
    assert flash_checksum_plain.calls > calls
    assert got[0].placements == dq.placements
    _site_ok(_whole(got[0]), want[0], exact=True)
    for x, y in zip(got[1:], want[1:]):
        torch.testing.assert_close(_whole(x), y, atol=SITE_TOL,
                                   rtol=SITE_TOL)
    o, extra = flash_checksum_kernel(dq, dk, dv, None, causal=causal,
                                     window=window)
    assert extra is None and torch.equal(_whole(o), want[0])


# ---------------------------------------------------------------------------
# (d) the sharded train step, prefill and decode
# ---------------------------------------------------------------------------

TWIN = dict(d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
            vocab_size=256)
LR = 1e-2
SCHED = dict(total_steps=100, warmup=2)
JABFT = JABFTConfig(mode="fused", dtype=jnp.float32, threshold=5e-2,
                    relative=True)


def _twins():
    return (dataclasses.replace(jsmoke_config(jget_config("gemma-2b")),
                                **TWIN),
            dataclasses.replace(smoke_config(get_config("gemma-2b")), **TWIN))


def _abft():
    return ABFTConfig(mode="fused", threshold=5e-2, relative=True)


def _gate(got, want):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _place_state(state, rules):
    ps = rules.params_shardings(state["params"])
    return {"params": distribute_tree(state["params"], ps),
            "opt": {"m": distribute_tree(state["opt"]["m"], ps),
                    "v": distribute_tree(state["opt"]["v"], ps),
                    "step": distribute_tree(state["opt"]["step"],
                                            rules.replicated())}}


def test_sharded_train_step_matches_both_unsharded_steps(local_mesh):
    jcfg, cfg = _twins()
    step = make_train_step(cfg, _abft(), AdamWConfig(lr=LR), **SCHED)
    with _outside():
        jstate = jinit_train_state(jcfg, jax.random.PRNGKey(0))
        np_state = jax.tree.map(np.asarray, jstate)
        batch = next(SyntheticLM(cfg.vocab_size, 16, 8, seed=0).batches())
        jstep = jax.jit(jmake_train_step(jcfg, JABFT, JAdamWConfig(lr=LR),
                                         **SCHED))
        jb = jax.tree.map(jnp.asarray, batch)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        plain = convert.train_state_from_numpy(np_state, device="cpu")
        jl, pl = [], []
        for _ in range(4):
            jstate, jm = jstep(jstate, jb)
            plain, pm = step(plain, tb)
            jl.append(float(jm["loss"]))
            pl.append(float(pm["loss"]))
            assert not bool(pm["abft_flag"])
        start = convert.train_state_from_numpy(np_state, device="cpu")
    rules = ShardingRules(local_mesh)
    sharded = _place_state(start, rules)
    sbatch = distribute_tree(tb, rules.batch_shardings(tb))
    sl = []
    for _ in range(4):
        sharded, sm = step(sharded, sbatch)
        sl.append(float(_whole(sm["loss"])))
        assert not bool(_whole(sm["abft_flag"]))
    _gate(sl, pl)
    _gate(sl, jl)
    assert sl[-1] < sl[0]                        # the optimizer applied
    for p, s in zip(tree_leaves(plain["params"]),
                    tree_leaves(sharded["params"])):
        assert s.placements                      # still a DTensor
        _gate(_whole(s).numpy(), p.numpy())


def test_sharded_prefill_and_decode_match_unsharded(local_mesh):
    _, cfg = _twins()
    bsz, t, cache = 8, 16, 24
    prefill = make_prefill_step(cfg, _abft(), cache_len=cache)
    decode = make_decode_step(cfg, _abft())
    with _outside():
        params = init_model(cfg, 0, device="cpu")
        gen = torch.Generator().manual_seed(3)
        batch = {"tokens": torch.randint(0, 256, (bsz, t), generator=gen,
                                         dtype=torch.int32)}
        logits, states, m = prefill(params, batch)
        tok = torch.argmax(logits, -1).to(torch.int32)
        logits2, _, m2 = decode(params, states, tok, t)
        assert not bool(m["abft_flag"]) and not bool(m2["abft_flag"])

    rules = ShardingRules(local_mesh)
    sp = distribute_tree(params, rules.params_shardings(params))
    slog, sst, sm = prefill(sp, distribute_tree(
        batch, rules.batch_shardings(batch)))
    _gate(_whole(slog).numpy(), logits.numpy())
    assert not bool(_whole(sm["abft_flag"]))
    sst = distribute_tree(sst, rules.state_shardings(sst, bsz,
                                                     cfg.n_kv_heads))
    slog2, _, sm2 = decode(sp, sst, distribute_tree(
        tok, rules.batch_shardings(tok)), t)
    _gate(_whole(slog2).numpy(), logits2.numpy())
    assert not bool(_whole(sm2["abft_flag"]))
    # an accumulator upset on one rank's shard flags the global check
    with attention_fault_injection(25.0):
        _, _, bad = prefill(sp, distribute_tree(
            batch, rules.batch_shardings(batch)))
    assert bool(_whole(bad["abft_flag"]))


# ---------------------------------------------------------------------------
# (f) reshard_restore onto the mesh
# ---------------------------------------------------------------------------

def _expected_slice(full, spec, coords, sizes):
    """The block of ``full`` a rank at ``coords`` (by axis) holds."""
    idx = []
    for dim, entry in enumerate(spec):
        axes = () if entry is None else \
            (entry,) if isinstance(entry, str) else entry
        block, n = 0, 1
        for ax in axes:                                 # major first
            block, n = block * sizes[ax] + coords[ax], n * sizes[ax]
        step = full.shape[dim] // n
        idx.append(slice(block * step, (block + 1) * step))
    return full[tuple(idx)]


def test_reshard_restore_gives_each_rank_its_slice(local_mesh, tmp_path):
    _, cfg = _twins()
    with _outside():
        params = init_model(cfg, 5, device="cpu")
        save_checkpoint(str(tmp_path), 7, params)
    rules = ShardingRules(local_mesh)
    shardings = rules.params_shardings(params)
    got, step = reshard_restore(str(tmp_path), params, shardings)
    assert step == 7
    sizes = {"data": 2, "model": 4}
    where = {r: {"data": i, "model": j}
             for i, row in enumerate(local_mesh.mesh.tolist())
             for j, r in enumerate(row)}
    for (path, full), sh, dt in zip(tree_flatten_with_path(params),
                                    tree_leaves(shardings),
                                    tree_leaves(got)):
        assert tuple(dt.placements) == sh.placements
        for r, local in enumerate(_ranks(dt.to_local())):
            assert torch.equal(local, _expected_slice(
                full, sh.spec, where[r], sizes)), (path, r)
