"""The LM train step in the port against the JAX package's.

``repro_torch.launch.steps.make_train_step`` / ``init_train_state`` on the
smoke twins of gemma-2b (tied head), deepseek-moe-16b (experts on the
grouped product, the auxiliary loss) and whisper-medium (encoder-decoder),
started from the reference's train state at step 3 with seeded moments
(carried across by ``repro_torch.convert.train_state_from_numpy``) on a
``SyntheticLM`` batch: the loss, every gradient leaf and the gradient norm
against ``jax.value_and_grad`` of the reference's loss, then one step's new
params, ``m``, ``v`` and ``step`` against the reference's jitted
``make_train_step``, each within ``atol 1e-4``; with ``compress_grads``
(the error-feedback buffers too); five steps of the synthetic stream give
the reference's loss curve. Within the port: a flagged step (a forced
threshold, an accumulator upset) returns its input state bit for bit, the
guard retries an upset and adopts the clean step bit for bit, guarded ==
unguarded and two runs agree bit for bit, and the backward runs on the
kernels' autograd Functions (two more B4 products a forward product, one
plain attention recompute a B5 launch) whose gradients equal float64
autograd of the plain products within ``1e-4``. Everything runs on the CPU
(the kernels' plain versions); the ``cuda``-marked case holds the
Functions' backward on the card against autograd of the plain versions."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.core.abft import ABFTConfig as JABFTConfig
from repro.launch.steps import init_train_state as jinit_train_state
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models.transformer import lm_loss as jlm_loss
from repro.models.transformer import model_forward as jmodel_forward
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch import convert
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.abft import ABFTConfig
from repro_torch.data import SyntheticLM
from repro_torch.kernels.flash_checksum import ops as fops
from repro_torch.kernels.flash_checksum.kernel import flash_checksum_plain
from repro_torch.kernels.matmul_abft import ops as mops
from repro_torch.kernels.matmul_abft.kernel import (matmul_abft_grouped_plain,
                                                    matmul_abft_plain)
from repro_torch.launch.steps import (init_train_state, loss_and_grads,
                                      make_train_step)
from repro_torch.models.attention import attention_fault_injection
from repro_torch.models.transformer import lm_loss
from repro_torch.optim import AdamWConfig, tree_leaves
from repro_torch.runtime.abft_guard import ABFTGuard

ATOL = 1e-4
BATCH, SEQ, SRC, DELTA = 2, 16, 24, 25.0
STEP0 = 3                 # the state's step: lr_scale > 0 (step 0 has 0)
SCHED = dict(total_steps=100, warmup=2)
LR = 1e-2
ARCHS = ("gemma-2b", "deepseek-moe-16b", "whisper-medium")


def _batch(cfg, seed=0, n=1):
    """``n`` SyntheticLM batches (+ seeded ``src_embeds`` for whisper)."""
    it = SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=seed).batches()
    out = []
    for i, b in enumerate(itertools.islice(it, n)):
        if cfg.family == "encdec":
            b["src_embeds"] = np.random.default_rng(100 + i).standard_normal(
                (BATCH, SRC, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return jax.tree.map(jnp.asarray, batch)


def _abft(threshold=1e-3):
    return ABFTConfig(mode="fused", threshold=threshold, relative=True)


JABFT = JABFTConfig(mode="fused", dtype=jnp.float32, threshold=1e-3,
                    relative=True)


def _mid_training(jstate, seed=3):
    """The reference's fresh state moved to step ``STEP0`` with seeded
    moments of a run under way (|m| ~ 1e-3, v in [1e-4, 1e-2]).  From zero
    moments Adam's first update is g / |g| elementwise, which turns the
    two packages' rounding noise in a gradient that is 0 in exact
    arithmetic (a key bias: softmax ignores a per-query shift) into
    updates of ±lr."""
    rng = np.random.default_rng(seed)

    def draw(x, lo):
        r = rng.standard_normal(x.shape).astype(np.float32)
        return jnp.asarray(r * 1e-3 if lo is None else
                           np.abs(r) * 1e-2 + lo)
    opt = jstate["opt"]
    jstate["opt"] = {"m": jax.tree.map(lambda x: draw(x, None), opt["m"]),
                     "v": jax.tree.map(lambda x: draw(x, 1e-4), opt["v"]),
                     "step": jnp.asarray(STEP0, jnp.int32)}
    return jstate


@pytest.fixture(scope="module", params=ARCHS)
def twin(request):
    arch = request.param
    jcfg, cfg = jsmoke_config(jget_config(arch)), smoke_config(
        get_config(arch))
    jstate = _mid_training(jinit_train_state(jcfg, jax.random.PRNGKey(0)))
    np_state = jax.tree.map(np.asarray, jstate)
    batch = _batch(cfg)[0]

    def loss_fn(params, b):
        fwd = {k: v for k, v in b.items() if k != "labels"}
        logits, _report, aux = jmodel_forward(params, jcfg, fwd, JABFT)
        return jlm_loss(logits, b["labels"]) + 1e-2 * aux
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        jstate["params"], _jb(batch))
    jstep = jax.jit(jmake_train_step(jcfg, JABFT, JAdamWConfig(lr=LR),
                                     **SCHED))
    jnew, jm = jstep(jstate, _jb(batch))
    return dict(arch=arch, cfg=cfg, jcfg=jcfg, np_state=np_state,
                batch=batch, loss=float(jloss),
                grads=[np.asarray(g) for g in jax.tree.leaves(jgrads)],
                new=[np.asarray(x) for x in jax.tree.leaves(jnew)],
                metrics=jax.tree.map(np.asarray, jm))


def _state(s):
    return convert.train_state_from_numpy(s["np_state"], device="cpu")


def _step(s, **kw):
    return make_train_step(s["cfg"], kw.pop("abft", _abft()),
                           AdamWConfig(lr=LR), **SCHED, **kw)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_loss_and_grads_match_jax(twin):
    s = twin
    loss, report, grads = loss_and_grads(_state(s)["params"], s["cfg"],
                                         _tb(s["batch"]), _abft())
    assert not bool(report.flag)
    np.testing.assert_allclose(float(loss), s["loss"], rtol=0, atol=ATOL)
    assert len(grads) == len(s["grads"])
    for g, want in zip(grads, s["grads"]):
        assert g.shape == want.shape
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=ATOL)


def test_one_step_matches_jax(twin):
    s = twin
    new, m = _step(s)(_state(s), _tb(s["batch"]))
    got = tree_leaves(convert.train_state_to_numpy(new))
    assert len(got) == len(s["new"])
    for g, want in zip(got, s["new"]):
        assert g.shape == want.shape and g.dtype == want.dtype
        np.testing.assert_allclose(g, want, rtol=0, atol=ATOL)
    assert int(new["opt"]["step"]) == STEP0 + 1
    jm = s["metrics"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-6,
                                   atol=ATOL)
    assert bool(m["abft_flag"]) is bool(jm["abft_flag"]) is False
    assert float(m["abft_n_checks"]) == float(jm["abft_n_checks"])
    # the step moved the params (lr > 0 at this step)
    assert not _equal(new["params"], _state(s)["params"])


@pytest.mark.parametrize("how", ["threshold", "upset"])
def test_flagged_step_returns_its_input_bit_for_bit(twin, how):
    s = twin
    state = _state(s)
    keep = convert.train_state_from_numpy(s["np_state"], device="cpu")
    if how == "threshold":
        new, m = _step(s, abft=_abft(1e-12))(state, _tb(s["batch"]))
    else:
        with attention_fault_injection(DELTA):
            new, m = _step(s)(state, _tb(s["batch"]))
    assert bool(m["abft_flag"])
    assert _equal(new, keep) and _equal(state, keep)
    # unguarded, the same flagged step adopts its update
    with attention_fault_injection(DELTA):
        loose, m2 = _step(s, guard_in_graph=False)(state, _tb(s["batch"]))
    assert bool(m2["abft_flag"]) and not _equal(loose["params"],
                                                keep["params"])


def _gemma():
    """The gemma-2b smoke twins (the reference's config, the port's)."""
    return jsmoke_config(jget_config("gemma-2b")), smoke_config(
        get_config("gemma-2b"))


def test_guarded_equals_unguarded_and_two_runs_agree(twin):
    s = twin
    batch = _tb(s["batch"])
    a, _ = _step(s)(_state(s), batch)
    b, _ = _step(s, guard_in_graph=False)(_state(s), batch)
    c, _ = _step(s)(_state(s), batch)
    assert _equal(a, b) and _equal(a, c)


def test_guard_retries_an_upset_and_adopts_the_clean_step(twin):
    s = twin
    step, batch = _step(s), _tb(s["batch"])
    clean, _ = step(_state(s), batch)
    calls = []

    def step_fn(state, b):
        calls.append(1)
        if len(calls) == 1:
            with attention_fault_injection(DELTA):
                return step(state, b)
        return step(state, b)
    guard = ABFTGuard()
    new, m = guard.run_step(step_fn, _state(s), batch)
    assert len(calls) == 2 and guard.flags == 1 and guard.retries == 1
    assert not bool(m["abft_flag"]) and _equal(new, clean)


def test_compress_grads_matches_jax():
    jcfg, cfg = _gemma()
    jstate = _mid_training(jinit_train_state(jcfg, jax.random.PRNGKey(1),
                                             compress_grads=True), seed=4)
    rng = np.random.default_rng(3)
    jstate["ef"] = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32) * 1e-4),
        jstate["ef"])
    np_state = jax.tree.map(np.asarray, jstate)
    batch = _batch(cfg, seed=1)[0]
    jnew, jm = jax.jit(jmake_train_step(jcfg, JABFT, JAdamWConfig(lr=LR),
                                        compress_grads=True, **SCHED))(
        jstate, _jb(batch))
    step = make_train_step(cfg, _abft(), AdamWConfig(lr=LR),
                           compress_grads=True, **SCHED)
    new, m = step(convert.train_state_from_numpy(np_state, device="cpu"),
                  _tb(batch))
    assert set(new) == set(jnew) == {"params", "opt", "ef"}
    got = tree_leaves(convert.train_state_to_numpy(new))
    want = [np.asarray(x) for x in jax.tree.leaves(jnew)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               atol=ATOL)


def test_five_steps_give_the_reference_loss_curve():
    jcfg, cfg = _gemma()
    jstate = jinit_train_state(jcfg, jax.random.PRNGKey(2))
    state = convert.train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                           device="cpu")
    jstep = jax.jit(jmake_train_step(jcfg, JABFT, JAdamWConfig(lr=LR),
                                     **SCHED))
    step = make_train_step(cfg, _abft(), AdamWConfig(lr=LR), **SCHED)
    jl, tl = [], []
    for batch in _batch(cfg, seed=2, n=5):
        jstate, jm = jstep(jstate, _jb(batch))
        state, m = step(state, _tb(batch))
        jl.append(float(jm["loss"]))
        tl.append(float(m["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
    assert tl[-1] < tl[0]                     # it learns the stream


def test_backward_runs_on_the_kernels_functions(monkeypatch):
    _, cfg = _gemma()
    state = init_train_state(cfg, 0, device="cpu")
    batch = _tb(_batch(cfg)[0])
    recomputes = []
    real = fops.attention_plain

    def spy(*a, **kw):
        recomputes.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(fops, "attention_plain", spy)
    n0, f0 = matmul_abft_plain.calls, flash_checksum_plain.calls
    from repro_torch.models.transformer import model_forward
    with torch.no_grad():
        model_forward(state["params"], cfg, batch, _abft())
    fwd, attn = matmul_abft_plain.calls - n0, flash_checksum_plain.calls - f0
    assert fwd > 0 and attn == cfg.n_layers and not recomputes
    n0 = matmul_abft_plain.calls
    loss_and_grads(state["params"], cfg, batch, _abft())
    # the forward's products again, then two a product in the backward
    assert matmul_abft_plain.calls - n0 == 3 * fwd
    assert len(recomputes) == attn


@pytest.mark.parametrize("m,k,n,trans_b", [(20, 33, 17, False),
                                           (5, 70, 9, True)])
def test_matmul_function_backward_is_autograd_of_the_product(m, k, n,
                                                             trans_b):
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(m, k, generator=gen, requires_grad=True)
    b = torch.randn(*((n, k) if trans_b else (k, n)), generator=gen,
                    requires_grad=True)
    dc = torch.randn(m, n, generator=gen)
    c, chk = mops.matmul_abft(a, b, trans_b=trans_b)
    assert not chk.predicted.requires_grad and not chk.actual.requires_grad
    ga, gb = torch.autograd.grad(c, (a, b), dc)
    ad, bd = a.detach().double().requires_grad_(), \
        b.detach().double().requires_grad_()
    cd = ad @ (bd.t() if trans_b else bd)
    wa, wb = torch.autograd.grad(cd, (ad, bd), dc.double())
    torch.testing.assert_close(ga.double(), wa, rtol=ATOL, atol=ATOL)
    torch.testing.assert_close(gb.double(), wb, rtol=ATOL, atol=ATOL)


def test_grouped_function_backward_is_autograd_of_the_products():
    gen = torch.Generator().manual_seed(1)
    a = torch.randn(3, 6, 40, generator=gen, requires_grad=True)
    b = torch.randn(3, 40, 10, generator=gen, requires_grad=True)
    br = b.detach().sum(-1)
    dc = torch.randn(3, 6, 10, generator=gen)
    n0 = matmul_abft_grouped_plain.calls
    c, chk, extra = mops.matmul_abft_grouped(a, b, br)
    ga, gb = torch.autograd.grad(c, (a, b), dc)
    assert matmul_abft_grouped_plain.calls - n0 == 3
    ad, bd = a.detach().double().requires_grad_(), \
        b.detach().double().requires_grad_()
    wa, wb = torch.autograd.grad(torch.bmm(ad, bd), (ad, bd), dc.double())
    torch.testing.assert_close(ga.double(), wa, rtol=ATOL, atol=ATOL)
    torch.testing.assert_close(gb.double(), wb, rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("b,t,s,h,kh,dh,causal,window", [
    (2, 40, 40, 4, 1, 16, True, 0), (1, 70, 70, 4, 2, 16, True, 33),
    (2, 45, 45, 2, 2, 8, False, 0), (2, 20, 37, 4, 4, 16, False, 0)])
def test_flash_function_backward_is_autograd_of_the_plain_version(
        b, t, s, h, kh, dh, causal, window):
    gen = torch.Generator().manual_seed(2)
    q = torch.randn(b, t, h, dh, generator=gen, requires_grad=True)
    k = torch.randn(b, s, kh, dh, generator=gen, requires_grad=True)
    v = torch.randn(b, s, kh, dh, generator=gen, requires_grad=True)
    vr = torch.randn(b, s, h, generator=gen)
    do = torch.randn(b, t, h, dh, generator=gen)
    o, ex = fops.flash_checksum(q, k, v, vr, causal=causal, window=window)
    assert not ex.requires_grad
    got = torch.autograd.grad(o, (q, k, v), do)
    want = torch.autograd.grad(flash_checksum_plain(
        q, k, v, causal=causal, window=window)[0], (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=ATOL, atol=ATOL)


def test_lm_loss_is_the_references():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    for msk in (None, mask):
        want = jlm_loss(jnp.asarray(logits), jnp.asarray(labels),
                        None if msk is None else jnp.asarray(msk))
        got = lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                      None if msk is None else torch.from_numpy(msk))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_init_train_state():
    _, cfg = _gemma()
    st = init_train_state(cfg, 0, device="cpu", compress_grads=True)
    assert set(st) == {"params", "opt", "ef"}
    p = tree_leaves(st["params"])
    for tree in (st["opt"]["m"], st["opt"]["v"], st["ef"]):
        leaves = tree_leaves(tree)
        assert [x.shape for x in leaves] == [x.shape for x in p]
        assert all(x.dtype == torch.float32 and not x.any() for x in leaves)
    assert st["opt"]["step"].dtype == torch.int32
    assert int(st["opt"]["step"]) == 0
    back = convert.train_state_from_numpy(
        convert.train_state_to_numpy(st), device="cpu")
    assert _equal(back, st)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            init_train_state(cfg, 0)


@pytest.mark.cuda
def test_functions_backward_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(130, 70, generator=gen, device="cuda",
                    requires_grad=True)
    w = torch.randn(70, 90, generator=gen, device="cuda", requires_grad=True)
    dc = torch.randn(130, 90, generator=gen, device="cuda")
    got = torch.autograd.grad(mops.matmul_abft(a, w)[0], (a, w), dc)
    ac, wc = a.detach().cpu().requires_grad_(), \
        w.detach().cpu().requires_grad_()
    want = torch.autograd.grad(matmul_abft_plain(ac, wc)[0], (ac, wc),
                               dc.cpu())
    for g, x in zip(got, want):
        torch.testing.assert_close(g.cpu(), x, rtol=ATOL, atol=ATOL)


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_train_launches_are_what_a_step_launches(twin):
    """``chip_smoke.py`` gates the card's train step on three B4 launches
    a product of ``lm_step_launches`` (one forward, two backward) and one
    B5 launch an attention: what a smoke twin's gradient step calls."""
    s, cs = twin, _chip_smoke()
    want = cs.lm_step_launches(s["cfg"])
    n0 = (matmul_abft_plain.calls, matmul_abft_grouped_plain.calls,
          flash_checksum_plain.calls)
    loss_and_grads(_state(s)["params"], s["cfg"], _tb(s["batch"]), _abft())
    got = (matmul_abft_plain.calls - n0[0],
           matmul_abft_grouped_plain.calls - n0[1],
           flash_checksum_plain.calls - n0[2])
    assert got == (3 * want["matmul_abft"], 3 * want["matmul_abft_grouped"],
                   want["flash_checksum"])
