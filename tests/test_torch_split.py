"""Split mode — the paper's two-check baseline — in the port against the
JAX package, on the prefill path that runs through ``flash_checksum``.

The kernel's plain version with ``with_stats`` returns each row's softmax
statistics m and l after its part fold; they equal the reference's
``streaming_attention`` m and l within ``atol 1e-4`` (causal, windowed,
non-causal self- and cross-attention, GQA), o is unchanged by asking for
them, and the JAX ``_split_second_pass`` fed the plain version's m and l
predicts what it predicts from its own.  Then split-mode prefill on the
smoke twins of gemma-2b (causal), h2o-danube-3-4b (its window, the prompt
past it) and whisper-medium (the
encoder's non-causal self-attention, the decoder's cross-attention): every
check's predicted and actual side within ``atol 1e-4`` of the reference's,
plus ``1e-6`` of the op's largest corner (the repo's corner rule: f32 sums
of up to ~300 added in another order) — a chain's actual side Σ o over that
only within 2 x 4 unit roundoffs of its Σ|o|, the port's own within 4 of
the float64 sum —, the per-op ids and flags equal (clean, and under an
accumulator upset, which flags attention chains), the logits within
``atol 1e-4``, and split-mode o equal to fused-mode o bit for bit.
Everything runs on the CPU (the kernels' plain versions)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.core.abft import ABFTConfig as JABFTConfig
from repro.core.abft import per_op_report as jper_op_report
from repro.models.attention import _split_second_pass as jsecond_pass
from repro.models.attention import streaming_attention as jstreaming
from repro.models.transformer import init_model as jinit_model
from repro.models.transformer import model_prefill as jmodel_prefill
from repro_torch import convert
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.abft import ABFTConfig, per_op_report
from repro_torch.kernels.flash_checksum.kernel import flash_checksum_plain
from repro_torch.models import attention as tattn
from repro_torch.models.transformer import model_prefill

ATOL = 1e-4
# a chain's actual side Σ o (thousands of terms, each package's own o and
# order: XLA sums axis by axis) passes over the corner rule only within
# 2 x SUM_ULPS unit roundoffs of Σ|o|
U32, SUM_ULPS = 2.0 ** -24, 4
BATCH, SRC, CACHE, DELTA = 2, 40, 64, 25.0
PROMPTS = {"gemma-2b": 20, "h2o-danube-3-4b": 50, "whisper-medium": 20}


def _rnd(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("b,t,s,h,kh,dh,causal,window", [
    (2, 40, 40, 4, 1, 16, True, 0), (1, 70, 70, 4, 2, 16, True, 33),
    (2, 45, 45, 2, 2, 8, False, 0), (2, 20, 37, 4, 4, 16, False, 0),
    (1, 1, 50, 2, 1, 8, False, 0)])
def test_plain_stats_are_streaming_attentions(b, t, s, h, kh, dh, causal,
                                              window):
    q, k, v = _rnd(1, (b, t, h, dh)), _rnd(2, (b, s, kh, dh)), \
        _rnd(3, (b, s, kh, dh))
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    o, ex, m, l = flash_checksum_plain(qt, kt, vt, causal=causal,
                                       window=window, with_stats=True)
    assert ex is None and m.dtype == l.dtype == torch.float32
    assert m.shape == l.shape == (b, t, h)
    o_bare, _ = flash_checksum_plain(qt, kt, vt, causal=causal,
                                     window=window)
    assert torch.equal(o, o_bare)
    qpos = jnp.broadcast_to(jnp.arange(t)[None], (b, t))
    kpos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    args = dict(q_positions=qpos, k_positions=kpos, causal=causal,
                window=window, chunk=min(32, s))
    jo, _, jm, jl = jstreaming(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), None, **args)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=0, atol=ATOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=ATOL)
    # the second pass predicts from the kernel's statistics what it
    # predicts from the reference's
    kw = dict(args, dtype_acc=jnp.float32)
    want = jsecond_pass(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                        jl, **kw)
    got = jsecond_pass(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(m.numpy()), jnp.asarray(l.numpy()), **kw)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6,
                               atol=ATOL)
    ours = tattn._split_second_pass(
        qt, kt, vt, m, l, q_positions=torch.from_numpy(np.array(qpos)),
        k_positions=torch.from_numpy(np.array(kpos)), causal=causal,
        window=window, chunk=min(32, s), dtype_acc=torch.float32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), rtol=1e-6,
                               atol=ATOL)


@pytest.fixture(scope="module", params=sorted(PROMPTS))
def twin(request):
    arch = request.param
    jcfg, cfg = jsmoke_config(jget_config(arch)), smoke_config(
        get_config(arch))
    np_params = jax.tree.map(np.asarray, jinit_model(
        jcfg, jax.random.PRNGKey(0)))
    batch = {"tokens": np.random.default_rng(5).integers(
        1, cfg.vocab_size, size=(BATCH, PROMPTS[arch])).astype(np.int32)}
    if cfg.family == "encdec":
        batch["src_embeds"] = _rnd(11, (BATCH, SRC, cfg.d_model))
    jabft = JABFTConfig(mode="split", dtype=jnp.float32, threshold=1e-3,
                        relative=True)
    jparams = jax.tree.map(jnp.asarray, np_params)
    jbatch = jax.tree.map(jnp.asarray, batch)
    runs = {}
    for name, inject in (("clean", None), ("upset", jnp.float32(DELTA))):
        runs[name] = jmodel_prefill(jparams, jcfg, jbatch, jabft, CACHE,
                                    return_checks=True, attn_inject=inject)
    return dict(arch=arch, cfg=cfg, jabft=jabft, runs=runs,
                params=convert.lm_params_from_numpy(np_params, cfg,
                                                    device="cpu"),
                batch={k: torch.from_numpy(v) for k, v in batch.items()})


def _ours(s, inject, mode="split", record=None):
    """The port's prefill; ``record`` (a list) receives every attention
    output o the flash path returns, in call order."""
    abft = ABFTConfig(mode=mode, threshold=1e-3, relative=True)
    real = tattn.flash_checksum

    def spy(*a, **kw):
        out = real(*a, **kw)
        record.append(out[0])
        return out
    if record is not None:
        tattn.flash_checksum = spy
    try:
        return abft, model_prefill(s["params"], s["cfg"], s["batch"], abft,
                                   CACHE, return_checks=True,
                                   attn_inject=inject)
    finally:
        tattn.flash_checksum = real


@pytest.mark.parametrize("run", ["clean", "upset"])
def test_split_prefill_matches_the_reference(twin, run):
    s = twin
    outs = []
    abft, (tl, _, _, tchecks) = _ours(s, None if run == "clean" else DELTA,
                                      record=outs)
    jl, _, _, jchecks = s["runs"][run]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)
    # a split chain's actual side is Σ o of one attention call, bit for bit
    # (the same sum of the same tensor), within SUM_ULPS unit roundoffs of
    # Σ|o| of the float64 sum; each package's sum is held to that witness,
    # so the two sides to twice it
    abs_sum = {}
    for o in outs:
        got, a = float(o.to(torch.float32).sum()), float(o.abs().sum())
        assert abs(got - float(o.double().sum())) <= SUM_ULPS * U32 * a
        abs_sum[got] = 2 * a
    assert len(tchecks) == len(jchecks)
    for tc, jc in zip(tchecks, jchecks):
        sides = [(getattr(tc, side).numpy(), np.asarray(getattr(jc, side)))
                 for side in ("predicted", "actual")]
        scale = max(float(np.abs(w).max()) for _, w in sides)
        for (got, want), side in zip(sides, ("predicted", "actual")):
            tol = np.full(got.shape, ATOL + 1e-6 * scale)
            if side == "actual":
                tol = np.maximum(tol, [SUM_ULPS * U32 * abs_sum.get(
                    float(x), 0.0) for x in got.reshape(-1)])
            assert (np.abs(got - want) <= tol.reshape(got.shape)).all(), (
                side, got, want, tol)
    tids, tflags, trel = per_op_report(tchecks, abft)
    jids, jflags, jrel = jper_op_report(jchecks, s["jabft"])
    assert tids == tuple(jids)
    assert tflags.tolist() == np.asarray(jflags).tolist()
    np.testing.assert_allclose(trel.numpy(), np.asarray(jrel), atol=1e-5)
    assert bool(tflags.any()) == (run == "upset")


def test_split_o_is_fused_o_bit_for_bit(twin):
    seen = {"split": [], "fused": []}
    for mode, outs in seen.items():
        _ours(twin, None, mode, record=outs)
    assert len(seen["split"]) == len(seen["fused"]) > 0
    for a, b in zip(seen["split"], seen["fused"]):
        assert torch.equal(a, b)


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_split_ids_and_sites(twin):
    """The split-mode op ids and upset sites ``chip_smoke.py`` derives (and
    gates the card's split prefill on) are what a smoke twin's split
    prefill reports and flags."""
    cs, s = _chip_smoke(), twin
    abft, (_, _, _, checks) = _ours(s, None)
    ids = per_op_report(checks, abft)[0]
    assert list(ids) == cs.lm_op_ids(s["cfg"], "prefill", "split")
    _, (_, _, _, checks) = _ours(s, DELTA)
    ids, flags, _ = per_op_report(checks, abft)
    hit = {ids[i] for i in np.nonzero(flags.numpy())[0]}
    groups = cs.lm_upset_sites(s["cfg"], "prefill", "split")
    assert hit and hit <= {i for v in groups.values() for i in v}
    assert all(hit & set(v) for v in groups.values())


def test_a_row_with_no_valid_key_adds_nothing_to_the_second_pass():
    """A row whose keys are all masked (m = -1e30, l = 0 from the first
    pass) adds 0 to the split prediction, in both packages: the second
    pass masks before it divides by the floored l."""
    b, t, s, h, kh, dh = 1, 4, 6, 2, 1, 8
    q, k, v = _rnd(21, (b, t, h, dh)), _rnd(22, (b, s, kh, dh)), \
        _rnd(23, (b, s, kh, dh))
    qpos = np.array([[0, 1, 7, 8]])           # rows 0, 1 before every key
    kpos = np.array([[2, 3, 4, 5, 6, 7]])
    args = dict(causal=True, window=0, chunk=4)
    jo, _, jm, jl = jstreaming(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), None,
                               q_positions=jnp.asarray(qpos),
                               k_positions=jnp.asarray(kpos), **args)
    assert (np.asarray(jl)[0, :2] == 0).all()
    assert (np.asarray(jm)[0, :2] == -1e30).all()
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tp, tkp = torch.from_numpy(qpos), torch.from_numpy(kpos)
    _, _, m, l = tattn.streaming_attention(tq, tk, tv, None, q_positions=tp,
                                           k_positions=tkp, **args)
    assert torch.equal(m[0, :2], torch.full((2, h), -1e30))
    assert not l[0, :2].any()
    got = tattn._split_second_pass(tq, tk, tv, m, l, q_positions=tp,
                                   k_positions=tkp, dtype_acc=torch.float32,
                                   **args)
    # the same pass over the two rows that have keys
    rest = tattn._split_second_pass(tq[:, 2:], tk, tv, m[:, 2:], l[:, 2:],
                                    q_positions=tp[:, 2:], k_positions=tkp,
                                    dtype_acc=torch.float32, **args)
    want = jsecond_pass(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                        jl, q_positions=jnp.asarray(qpos),
                        k_positions=jnp.asarray(kpos),
                        dtype_acc=jnp.float32, **args)
    assert torch.isfinite(got).all() and torch.equal(got, rest)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=ATOL)
