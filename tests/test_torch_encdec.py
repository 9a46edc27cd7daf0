"""The encoder-decoder (whisper-medium) and the prefix-embedding model
(internvl2-26b) in the port against the JAX package.

B5 non-causal: the plain version of ``flash_checksum`` with
``causal=False`` — an encoder's self-attention (T = S) and a decoder's
cross-attention (T ≠ S, keys at 0..S-1) — against the reference's
materialized oracle ``flash_checksum_ref`` at T = S, T < S, T > S, T = 1
and S not a multiple of the 32-key block, with GQA; against the JAX
``streaming_attention`` with the query positions a decoder gives cross
attention; its part starts against a brute-force recount; the wrapper's
agreement with the library at ``causal = 0``.  ``sinusoid_positions`` and
``encode`` against the JAX functions.  Then the smoke twins (2 + 2 layers
at d 64 for whisper, 2 layers with 5 prefix embeddings for internvl2) on
the same numpy weights (carried across by ``repro_torch.convert``):
prefill logits and every decode state leaf (the cross cache ``xk``, ``xv``,
``xvr`` included), decode logits and ``model_forward``'s logits within
``atol 1e-4``; every check corner within ``atol 1e-4 + rtol 1e-6`` of the
op's largest corner (the two packages' f32 sums of a few thousand terms in
another order); the per-op ids and flags equal, clean, under an
accumulator upset in prefill and in decode, and under a bit flip in an
encoder ``wq``.  Within the port: prefill + decode equals
``model_forward``, the guarded steps under ``ABFTGuard.run_step`` equal the
unguarded ones bit for bit with every product on B4's wrapper and every
prefill attention on B5's, ``fold_lm_w_r`` folds the encoder as the
reference does, ``launch.serve`` runs both twins on the CPU, and ``chip_smoke.py``'s
derived launch shapes, counts, op ids and upset sites equal what a step
does.  Everything runs on the CPU (the kernels' plain versions); the CUDA
kernel is held against the plain version on a GPU (the ``cuda``-marked
case, and ``chip_smoke.py``)."""
import importlib.util
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.core.abft import ABFTConfig as JABFTConfig
from repro.core.abft import per_op_report as jper_op_report
from repro.engine.lm import fold_lm_w_r as jfold_lm_w_r
from repro.kernels.flash_checksum.ref import flash_checksum_ref
from repro.models.attention import streaming_attention as jstreaming
from repro.models.common import sinusoid_positions as jsinusoid
from repro.models.transformer import encode as jencode
from repro.models.transformer import init_model as jinit_model
from repro.models.transformer import model_decode as jmodel_decode
from repro.models.transformer import model_forward as jmodel_forward
from repro.models.transformer import model_prefill as jmodel_prefill
from repro_torch import convert
from repro_torch.analysis import vmem
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.abft import ABFTConfig, per_op_report
from repro_torch.engine.lm import (fold_lm_w_r, make_guarded_decode_step,
                                   make_guarded_prefill_step)
from repro_torch.kernels import runtime
from repro_torch.kernels.flash_checksum import kernel as tfk
from repro_torch.launch import serve
from repro_torch.models import attention
from repro_torch.models.common import sinusoid_positions
from repro_torch.models.transformer import (encode, init_model, model_decode,
                                            model_forward, model_prefill)
from repro_torch.runtime.abft_guard import ABFTGuard, GuardConfig

ARCHS = ["whisper-medium", "internvl2-26b"]
# 40 source frames: past the smoke twin's 32-key attention chunk
BATCH, PROMPT, SRC, PREFIX, NEW = 2, 20, 40, 5, 3
ATOL = 1e-4
DELTA = 25.0
FIELDS = ("family", "n_layers", "enc_layers", "d_model", "n_heads",
          "n_kv_heads", "hd", "d_ff", "vocab_size", "padded_vocab",
          "mlp_act", "norm", "rope_frac", "qkv_bias", "tie_embeddings",
          "frontend", "causal", "window", "block_pattern")
JABFT = JABFTConfig(mode="fused", dtype=jnp.float32, threshold=1e-3,
                    relative=True)
ABFT = ABFTConfig(mode="fused", threshold=1e-3, relative=True)


def _np(seed, shape):
    return np.random.default_rng(seed).normal(0, 1, size=shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# sinusoids, B5 non-causal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 64, 1024])
def test_sinusoid_positions_match_the_jax_function(d):
    """Within ``atol 1e-4`` over a decoder's positions (up to whisper's
    448); over an encoder's (up to 1500 frames) within one f32 spacing of
    the angle ``pos * freq``: the two packages' f32 ``exp`` give a tenth of
    the frequencies one unit in the last place apart, which moves a large
    angle by one spacing (1.2e-4 at 1024-2048) and its sine by as much."""
    pos = np.stack([np.arange(0, 449, dtype=np.int32),
                    np.arange(1051, 1500, dtype=np.int32)])
    want = np.asarray(jsinusoid(jnp.asarray(pos), d, jnp.float32))
    got = sinusoid_positions(torch.from_numpy(pos), d, torch.float32)
    assert got.shape == (2, 449, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=ATOL, rtol=0)
    spacing = np.spacing(pos[1].astype(np.float32))[:, None]
    assert (np.abs(got[1].numpy() - want[1]) <= spacing).all()
    # sin before cos: position 0 is (0 ... 0, 1 ... 1)
    assert got[0, 0, :d // 2].abs().max() == 0
    assert torch.equal(got[0, 0, d // 2:], torch.ones(d // 2))


# (b, t, s, h, kh, dh): T = S ragged; T < S; T > S; S under one key block;
# T = 1 over a ragged S; dh not a multiple of 4 with T != S
NONCAUSAL = [(1, 70, 70, 4, 2, 16), (2, 40, 100, 4, 4, 16),
             (1, 100, 40, 4, 1, 32), (2, 33, 17, 2, 2, 16),
             (2, 1, 75, 4, 2, 16), (1, 33, 50, 2, 2, 70)]
NONCAUSAL_IDS = ["t=s", "t<s", "t>s", "s<block", "t=1", "dh70"]


def _operands(b, t, s, h, kh, dh):
    return (_np(1, (b, t, h, dh)), _np(2, (b, s, kh, dh)),
            _np(3, (b, s, kh, dh)), _np(4, (b, s, h)))


@pytest.mark.parametrize("shape", NONCAUSAL, ids=NONCAUSAL_IDS)
def test_noncausal_plain_matches_the_reference_oracle(shape):
    """``flash_checksum_plain(causal=False)`` against the reference's
    materialized-softmax oracle, per (batch, query head), K and V repeated
    to the query heads as the reference's wrapper does."""
    b, t, s, h, kh, dh = shape
    q, k, v, vr = _operands(*shape)

    def heads(x):               # [B, N, H, d] -> [B*H, N, d]
        return jnp.asarray(np.ascontiguousarray(
            x.transpose(0, 2, 1, 3)).reshape(b * h, x.shape[1], -1))
    g = h // kh
    jo, jex = flash_checksum_ref(
        heads(q), heads(np.repeat(k, g, axis=2)),
        heads(np.repeat(v, g, axis=2)), heads(vr[..., None]), causal=False)
    jo = np.asarray(jo).reshape(b, h, t, dh).transpose(0, 2, 1, 3)
    jex = np.asarray(jex).reshape(b, h, t).transpose(0, 2, 1)
    to, tex = tfk.flash_checksum_plain(*(torch.from_numpy(x)
                                         for x in (q, k, v, vr)),
                                       causal=False)
    np.testing.assert_allclose(to.numpy(), jo, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tex.numpy(), jex, atol=ATOL, rtol=0)
    # the column leaves o alone
    o2, ex2 = tfk.flash_checksum_plain(*(torch.from_numpy(x)
                                         for x in (q, k, v)), causal=False)
    assert ex2 is None and torch.equal(o2, to)


@pytest.mark.parametrize("shape", NONCAUSAL[1:4], ids=NONCAUSAL_IDS[1:4])
def test_cross_attention_plain_matches_the_jax_streaming_attention(shape):
    """Cross-attention as a decoder runs it: queries at its positions
    (here 7..T+6), keys at 0..S-1, no mask but S; the JAX
    ``streaming_attention`` over 32-key chunks."""
    b, t, s, h, kh, dh = shape
    q, k, v, vr = _operands(*shape)
    qpos = np.broadcast_to(np.arange(7, 7 + t, dtype=np.int32), (b, t))
    kpos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jo, jex, _, _ = jstreaming(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vr),
        q_positions=jnp.asarray(qpos), k_positions=jnp.asarray(kpos),
        causal=False, window=0, chunk=32)
    to, tex = tfk.flash_checksum_plain(*(torch.from_numpy(x)
                                         for x in (q, k, v, vr)),
                                       causal=False)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tex.numpy(), np.asarray(jex), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("t,s", [(1, 1), (70, 33), (224, 1500), (1500, 1500)])
def test_noncausal_part_starts_split_every_key_block(t, s):
    """Without the mask every query tile walks all of S's key blocks, from
    block 0, and the parts split them evenly, the earlier parts taking the
    extra ones."""
    n_kb = -(-s // vmem.FLASH_BLOCK_K)
    for qt in range(-(-t // vmem.FLASH_BLOCK_Q)):
        assert vmem.flash_first_block(qt, s, False) == 0
        assert vmem.flash_key_blocks(qt, s, False) == n_kb
        starts = [vmem.flash_part_start(qt, s, False, p)
                  for p in range(vmem.FLASH_PARTS + 1)]
        assert starts[0] == 0 and starts[-1] == n_kb
        sizes = np.diff(starts)
        assert sizes.max() - sizes.min() <= 1
        assert list(sizes) == sorted(sizes, reverse=True)


def test_wrapper_holds_the_library_s_noncausal_part_starts():
    """The B5 wrapper holds the library's part starts at ``causal = 0``
    against ``analysis.vmem``: a library that cut a non-causal launch as a
    causal one (keys up to the diagonal) must not launch."""
    def lib_with(part_start):
        fields = dict(max_dh=lambda: vmem.FLASH_MAX_DH,
                      block_q=lambda: vmem.FLASH_BLOCK_Q,
                      block_k=lambda: vmem.FLASH_BLOCK_K,
                      parts=lambda: vmem.FLASH_PARTS,
                      head_tile=vmem.flash_head_tile, part_start=part_start,
                      smem_bytes=vmem.flash_smem_bytes)
        return types.SimpleNamespace(**{f"flash_checksum_{k}": f
                                        for k, f in fields.items()})

    def same(i, s, c, p, w):
        return vmem.flash_part_start(i, s, bool(c), p, w)

    def causal_always(i, s, c, p, w):
        return vmem.flash_part_start(i, s, True, p, w)
    for t, s in ((224, 1500), (1500, 1500), (1, 75)):
        tfk._agreed_with_library(lib_with(same), "probe", 64, t, s, False)
    with pytest.raises(RuntimeError, match="analysis.vmem models"):
        tfk._agreed_with_library(lib_with(causal_always), "probe", 64, 224,
                                 1500, False)


def _stub_cuda():
    return types.SimpleNamespace(is_cuda=True)


@pytest.mark.parametrize("case,admitted", [
    (dict(causal=True, window=0, cross=False), True),
    (dict(causal=True, window=16, cross=False), True),
    (dict(causal=False, window=0, cross=False), True),
    (dict(causal=False, window=0, cross=True), True),
    (dict(causal=False, window=16, cross=False), False),
    (dict(causal=True, window=0, cross=True), False),
    (dict(causal=False, window=16, cross=True), False),
    (dict(causal=False, window=0, cross=True, keys=False), False),
    (dict(causal=False, window=0, cross=False, queries=False), False),
    (dict(causal=True, window=0, cross=False, queries=False), False)])
def test_the_flash_path_admits_what_the_kernel_takes(case, admitted):
    """On the card prefill attention runs on B5 for causal self-attention
    over 0..T-1 (any window), non-causal self-attention over 0..T-1 and
    non-causal cross-attention over keys at 0..S-1 (no window), and raises
    for anything else; on the CPU the rest takes the streaming path."""
    args = (case["causal"], case["window"], case["cross"],
            case.get("queries", True), case.get("keys", True))
    assert attention._flash_path(torch.zeros(1), *args) == admitted
    if admitted:
        assert attention._flash_path(_stub_cuda(), *args)
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP A10"):
            attention._flash_path(_stub_cuda(), *args)


def test_encoder_and_cross_attention_blocks_take_the_flash_path():
    cfg = smoke_config(get_config("whisper-medium"))
    params = init_model(cfg, 0, device="cpu")
    enc = params["encoder"]["segments"][0]["b0"]["attn"]
    dec = params["segments"][0]["b0"]["xattn"]
    first = {k: {kk: vv[0] for kk, vv in v.items()} for k, v in enc.items()}
    xfirst = {k: {kk: vv[0] for kk, vv in v.items()} for k, v in dec.items()}
    x = torch.randn(BATCH, 37, cfg.d_model)
    mem = torch.randn(BATCH, 50, cfg.d_model)
    runtime.reset_counts()
    out, checks, _ = attention.attention_block(first, x, cfg, ABFT,
                                               causal=False)
    xout, xchecks, (xk, _, kpos, xvr) = attention.attention_block(
        xfirst, x, cfg, ABFT, kv_x=mem, causal=False, use_rope=False)
    assert runtime.plain_counts()["flash_checksum"] == 2
    assert out.shape == xout.shape == x.shape
    assert xk.shape == (BATCH, 50, cfg.n_kv_heads, cfg.hd)
    assert xvr.shape == (BATCH, 50, cfg.n_heads)
    assert torch.equal(kpos[0], torch.arange(50))
    assert not any(bool(c.flag(ABFT)) for c in checks + xchecks)


# ---------------------------------------------------------------------------
# the smoke twins against the JAX package
# ---------------------------------------------------------------------------

def _batch(cfg, tokens):
    batch = {"tokens": tokens}
    if cfg.family == "encdec":
        batch["src_embeds"] = _np(11, (BATCH, SRC, cfg.d_model))
    else:
        batch["prefix_embeds"] = _np(12, (BATCH, PREFIX, cfg.d_model))
    return batch


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    name = request.param
    jcfg = jsmoke_config(jget_config(name))
    cfg = smoke_config(get_config(name))
    jparams = jinit_model(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    params = convert.lm_params_from_numpy(np_params, cfg, device="cpu")
    tokens = np.random.default_rng(0).integers(
        1, cfg.vocab_size, size=(BATCH, PROMPT)).astype(np.int32)
    batch = _batch(cfg, tokens)
    offset = PREFIX if "prefix_embeds" in batch else 0
    return dict(name=name, jcfg=jcfg, cfg=cfg, np_params=np_params,
                params=params, batch=batch, pos0=PROMPT + offset,
                cache=PROMPT + offset + NEW)


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _folded(s):
    return (jfold_lm_w_r(jax.tree.map(jnp.asarray, s["np_params"]),
                         s["jcfg"], JABFT),
            fold_lm_w_r(s["params"], s["cfg"], ABFT))


def _states_close(tstates, jstates):
    assert len(tstates) == len(jstates)
    for ts, js in zip(tstates, jstates):
        assert sorted(ts) == sorted(js)
        for key, val in ts.items():
            if isinstance(val, dict):
                _states_close([val], [js[key]])
                continue
            want = np.asarray(js[key])
            assert tuple(val.shape) == want.shape, key
            assert val.numpy().dtype == want.dtype, key
            np.testing.assert_allclose(val.numpy(), want, atol=ATOL, rtol=0,
                                       err_msg=key)


def _corners_close(tchecks, jchecks):
    """Every check's two sides within ``atol 1e-4 + rtol 1e-6`` of the
    op's scale: the largest |predicted| or |actual| over its elements (the
    layers of a stacked op).  Each side is an f32 sum of a few thousand
    terms, which the two packages add in other orders (XLA reduces a
    multi-axis sum axis by axis), a few unit roundoffs of Σ|terms| apart —
    up to 1.5e-4 at these sizes, where a layer's corner can cancel to
    under 1 while its neighbour's is 40 to 470."""
    assert len(tchecks) == len(jchecks)
    for tc, jc in zip(tchecks, jchecks):
        sides = [(getattr(tc, side).detach().numpy(),
                  np.asarray(getattr(jc, side)))
                 for side in ("predicted", "actual")]
        scale = max(float(np.abs(w).max()) for _, w in sides)
        for (got, want), side in zip(sides, ("predicted", "actual")):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=ATOL + 1e-6 * scale,
                                       err_msg=side)


def _flags_equal(tchecks, jchecks):
    """The per-op ids and flags of both packages, equal; returns the
    flagged ids."""
    tids, tflags, _ = per_op_report(tchecks, ABFT)
    jids, jflags, _ = jper_op_report(jchecks, JABFT)
    assert tids == tuple(jids)
    assert tflags.tolist() == np.asarray(jflags).tolist()
    return [i for i, f in zip(tids, tflags.tolist()) if f]


def _sites(cfg, step):
    """The ids an accumulator upset reaches: every attention chain check —
    the encoder's and, in prefill, a decoder layer's self- and cross-
    attention chains; in decode only the self-attention's (the reference's
    decode cross-attention has no inject site)."""
    if cfg.family != "encdec":
        return [f"op3:L{j}" for j in range(cfg.n_layers)]
    if step == "decode":
        return [f"op3:L{j}" for j in range(cfg.n_layers)]
    enc = [f"op3:L{j}" for j in range(cfg.enc_layers)]
    return enc + [f"op{i}:L{j}" for i in (9, 13) for j in range(cfg.n_layers)]


@pytest.mark.parametrize("name", ARCHS)
def test_full_width_config_fields_equal_the_reference(name):
    cfg, jcfg = get_config(name), jget_config(name)
    for f in FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    smoke, jsmoke = smoke_config(cfg), jsmoke_config(jcfg)
    for f in FIELDS:
        assert getattr(smoke, f) == getattr(jsmoke, f), f


def test_params_carry_the_encoder_and_cross_leaves(setup):
    """``lm_params_from_numpy`` takes the reference's tree — the encoder's
    segments and final norm, each decoder layer's ``lnx`` and ``xattn`` —
    by the shapes ``init_model`` gives, and refuses one without them."""
    s = setup
    back = convert.params_to_numpy(s["params"])
    flat_a, flat_b = jax.tree.leaves(back), jax.tree.leaves(s["np_params"])
    assert len(flat_a) == len(flat_b)
    assert all(np.array_equal(x, y) for x, y in zip(flat_a, flat_b))
    unit = s["params"]["segments"][0]["b0"]
    if s["cfg"].family == "encdec":
        assert set(unit) == {"ln1", "ln2", "lnx", "attn", "xattn", "mlp"}
        assert set(s["params"]["encoder"]) == {"segments", "final_norm"}
        assert set(s["params"]["encoder"]["segments"][0]["b0"]) == {
            "ln1", "ln2", "attn", "mlp"}
        assert "b" in unit["xattn"]["wq"]          # whisper's QKV bias
        cut = dict(s["np_params"])
        del cut["encoder"]
        with pytest.raises(ValueError, match="encoder"):
            convert.lm_params_from_numpy(cut, s["cfg"], device="cpu")
    else:
        assert "encoder" not in s["params"] and "xattn" not in unit
        assert "head" in s["params"]               # internvl2's untied head


@pytest.mark.parametrize("src", [16, 37])
def test_encode_matches_the_jax_function(src):
    jcfg = jsmoke_config(jget_config("whisper-medium"))
    cfg = smoke_config(get_config("whisper-medium"))
    np_params = jax.tree.map(np.asarray,
                             jinit_model(jcfg, jax.random.PRNGKey(3)))
    params = convert.lm_params_from_numpy(np_params, cfg, device="cpu")
    x = _np(5, (BATCH, src, cfg.d_model))
    jout, jchecks = jencode(jfold_lm_w_r(jax.tree.map(jnp.asarray, np_params),
                                         jcfg, JABFT),
                            jcfg, jnp.asarray(x), JABFT)
    tout, tchecks = encode(fold_lm_w_r(params, cfg, ABFT), cfg,
                           torch.from_numpy(x), ABFT)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    jflat = jax.tree.leaves(jchecks,
                            is_leaf=lambda c: hasattr(c, "predicted"))
    _corners_close(tchecks, jflat)
    assert _flags_equal(tchecks, jflat) == []


def test_prefill_and_decode_match_the_jax_model(setup):
    s = setup
    jp, tp = _folded(s)
    jl, js, _, jchecks = jmodel_prefill(jp, s["jcfg"], _j(s["batch"]),
                                        JABFT, s["cache"], return_checks=True)
    tl, ts, _, tchecks = model_prefill(tp, s["cfg"], _t(s["batch"]), ABFT,
                                       s["cache"], return_checks=True)
    steps = [(jl, tl, jchecks, tchecks)]
    _states_close(ts, js)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for i in range(NEW):
        jl, js, _, jchecks = jmodel_decode(jp, s["jcfg"], js,
                                           jnp.asarray(nxt), s["pos0"] + i,
                                           JABFT, return_checks=True)
        tl, ts, _, tchecks = model_decode(tp, s["cfg"], ts,
                                          torch.from_numpy(nxt),
                                          s["pos0"] + i, ABFT,
                                          return_checks=True)
        steps.append((jl, tl, jchecks, tchecks))
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        assert np.array_equal(nxt[:, 0], torch.argmax(tl[:, -1], -1).numpy())
    _states_close(ts, js)                     # the cross cache rode along
    for jl, tl, jchecks, tchecks in steps:
        assert tl.shape == (BATCH, 1, s["cfg"].padded_vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        _corners_close(tchecks, jchecks)
        assert _flags_equal(tchecks, jchecks) == []


def test_forward_matches_the_jax_model(setup):
    s = setup
    jp, tp = _folded(s)
    jl, jrep, _ = jmodel_forward(jp, s["jcfg"], _j(s["batch"]), JABFT)
    tl, trep, aux = model_forward(tp, s["cfg"], _t(s["batch"]), ABFT)
    assert tl.shape == (BATCH, PROMPT, s["cfg"].padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert not bool(trep.flag) and not bool(jrep.flag)
    assert int(trep.n_checks) == int(jrep.n_checks)
    assert float(aux) == 0.0


def test_prefill_then_decode_equals_the_forward(setup):
    """Prefill on T - 1 tokens, decode token T - 1: its logits are the
    forward's last (after the reference's ``test_decode_matches_forward``;
    here at ``atol 1e-4``, f32)."""
    s = setup
    off = ABFTConfig(mode="none")
    batch = _t(s["batch"])
    full, _, _ = model_forward(s["params"], s["cfg"], batch, off)
    pre = dict(batch, tokens=batch["tokens"][:, :-1])
    _, states, _ = model_prefill(s["params"], s["cfg"], pre, off, s["cache"])
    dec, _, _ = model_decode(s["params"], s["cfg"], states,
                             batch["tokens"][:, -1:], s["pos0"] - 1, off)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               atol=ATOL, rtol=0)


def _launches(cfg):
    """(B4 launches a prefill, a decode step; B5 a prefill) of a smoke
    twin: an encoder layer's q, k, v, o and two MLP products, a decoder
    layer's self- and cross-attention (q and o only in decode) and its
    MLP, the head; a prefill attention each self- and cross-attention."""
    mlp = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
    if cfg.family != "encdec":
        return ((4 + mlp) * cfg.n_layers + 1,) * 2 + (cfg.n_layers,)
    return ((4 + mlp) * cfg.enc_layers + (8 + mlp) * cfg.n_layers + 1,
            (6 + mlp) * cfg.n_layers + 1, cfg.enc_layers + 2 * cfg.n_layers)


def test_guarded_steps_are_the_unguarded_bit_for_bit(setup):
    """The guarded step factories under ``ABFTGuard.run_step`` (a restore
    that refolds from the master): logits bit for bit the unguarded
    ``mode="none"`` steps', no flag, every product on B4's wrapper and every
    prefill attention on B5's."""
    s = setup
    off = ABFTConfig(mode="none")
    batch = _t(s["batch"])
    logits, states, _ = model_prefill(s["params"], s["cfg"], batch, off,
                                      s["cache"])
    ref = [logits]
    for i in range(NEW):
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        logits, states, _ = model_decode(s["params"], s["cfg"], states, nxt,
                                         s["pos0"] + i, off)
        ref.append(logits)
    work = {"params": fold_lm_w_r(s["params"], s["cfg"], ABFT)}

    def restore():
        work["params"] = fold_lm_w_r(s["params"], s["cfg"], ABFT)
        return work["params"]
    guard = ABFTGuard(GuardConfig(), restore_fn=restore)
    prefill = make_guarded_prefill_step(s["cfg"], ABFT, s["cache"])
    decode = make_guarded_decode_step(s["cfg"], ABFT)
    runtime.reset_counts()
    (logits, states), m = guard.run_step(prefill, work["params"], batch)
    assert torch.equal(logits, ref[0]) and not m["abft_op_flags"].any()
    for i in range(NEW):
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        (logits, states), m = guard.run_step(decode, work["params"], states,
                                             nxt, s["pos0"] + i)
        assert torch.equal(logits, ref[i + 1]) and not bool(m["abft_flag"])
    assert guard.flags == 0
    prefill_b4, decode_b4, prefill_b5 = _launches(s["cfg"])
    assert runtime.plain_counts()["matmul_abft"] == \
        prefill_b4 + NEW * decode_b4
    assert runtime.plain_counts()["flash_checksum"] == prefill_b5


def test_fold_folds_the_encoder(setup):
    """Every dense weight of the encoder gains the reference's folded
    ``w_r``, the decoder's cross-attention too; the master is not
    mutated."""
    s = setup
    jp, tp = _folded(s)
    if s["cfg"].family != "encdec":
        assert "encoder" not in tp
        return
    for tree, jtree in ((tp["encoder"]["segments"][0],
                         jp["encoder"]["segments"][0]),
                        ({"xattn": tp["segments"][0]["b0"]["xattn"]},
                         {"xattn": jp["segments"][0]["b0"]["xattn"]})):
        tleaves = [(path, leaf) for path, leaf in _dense_leaves(tree)]
        assert len(tleaves) >= 4
        for path, leaf in tleaves:
            jleaf = jtree
            for k in path:
                jleaf = jleaf[k]
            assert "w_r" in leaf, path
            np.testing.assert_allclose(leaf["w_r"].numpy(),
                                       np.asarray(jleaf["w_r"]), atol=1e-5,
                                       rtol=1e-6, err_msg=str(path))
    assert "w_r" not in s["params"]["encoder"]["segments"][0]["b0"]["attn"][
        "wq"]
    assert tp["encoder"]["final_norm"] is s["params"]["encoder"]["final_norm"]


def _dense_leaves(tree, path=()):
    if isinstance(tree, dict):
        if "w" in tree:
            yield path, tree
            return
        for k, v in tree.items():
            yield from _dense_leaves(v, path + (k,))


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_upset_flags_equal_the_reference(setup, step):
    """An accumulator upset (every attention call's O[0] += 25) in prefill
    flags the encoder's, the self- and the cross-attention chains in both
    packages; in decode only the self-attention's (the cross-attention
    over the static encoder cache has no inject site, in either)."""
    s = setup
    jp, tp = _folded(s)
    jl, js, _ = jmodel_prefill(jp, s["jcfg"], _j(s["batch"]), JABFT,
                               s["cache"])
    tl, ts, _ = model_prefill(tp, s["cfg"], _t(s["batch"]), ABFT, s["cache"])
    if step == "prefill":
        _, _, _, jchecks = jmodel_prefill(
            jp, s["jcfg"], _j(s["batch"]), JABFT, s["cache"],
            return_checks=True, attn_inject=jnp.float32(DELTA))
        _, _, _, tchecks = model_prefill(
            tp, s["cfg"], _t(s["batch"]), ABFT, s["cache"],
            return_checks=True, attn_inject=DELTA)
    else:
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        _, _, _, jchecks = jmodel_decode(
            jp, s["jcfg"], js, jnp.asarray(nxt), s["pos0"], JABFT,
            return_checks=True, attn_inject=jnp.float32(DELTA))
        _, _, _, tchecks = model_decode(
            tp, s["cfg"], ts, torch.from_numpy(nxt), s["pos0"], ABFT,
            return_checks=True, attn_inject=DELTA)
    assert _flags_equal(tchecks, jchecks) == _sites(s["cfg"], step)


def _corner(checks, site):
    """(predicted, actual) of the check element ``site`` names."""
    ids = list(per_op_report(checks, ABFT)[0])
    i = ids.index(site)
    return tuple(torch.cat([getattr(c, side).reshape(-1) for c in checks])[i]
                 for side in ("predicted", "actual"))


def test_encoder_wq_flip_flags_equal_the_reference():
    """A bit flipped after load in encoder layer 1's ``wq`` flags that
    product's check (``op0:L1``) in both packages, and not layer 0's.  The
    fold is what catches it: the check's predicted side is the clean run's
    bit for bit (the master's folded ``w_r`` times the unchanged input),
    while without the encoder's fold it comes from the corrupted weight."""
    name = "whisper-medium"
    jcfg, cfg = jsmoke_config(jget_config(name)), smoke_config(
        get_config(name))
    np_params = jax.tree.map(np.asarray,
                             jinit_model(jcfg, jax.random.PRNGKey(0)))
    params = convert.lm_params_from_numpy(np_params, cfg, device="cpu")
    jp = jfold_lm_w_r(jax.tree.map(jnp.asarray, np_params), jcfg, JABFT)
    tp = fold_lm_w_r(params, cfg, ABFT)
    w = np.array(np_params["encoder"]["segments"][0]["b0"]["attn"]["wq"]["w"])
    w.view(np.int32)[1, 0, 0, 0] ^= 1 << 30

    def flipped(tree, leaf):
        enc = dict(tree["encoder"])
        seg = dict(enc["segments"][0])
        b0 = dict(seg["b0"])
        attn = dict(b0["attn"])
        attn["wq"] = dict(attn["wq"], w=leaf)
        b0["attn"], seg["b0"] = attn, b0
        enc["segments"] = [seg]
        return dict(tree, encoder=enc)
    tokens = np.random.default_rng(0).integers(
        1, cfg.vocab_size, size=(BATCH, PROMPT)).astype(np.int32)
    batch = _batch(cfg, tokens)
    _, _, _, clean = model_prefill(tp, cfg, _t(batch), ABFT, 32,
                                   return_checks=True)
    _, _, _, jchecks = jmodel_prefill(flipped(jp, jnp.asarray(w)), jcfg,
                                      _j(batch), JABFT, 32,
                                      return_checks=True)
    _, _, _, tchecks = model_prefill(flipped(tp, torch.from_numpy(w)), cfg,
                                     _t(batch), ABFT, 32, return_checks=True)
    flagged = _flags_equal(tchecks, jchecks)
    assert "op0:L1" in flagged and "op0:L0" not in flagged
    assert torch.equal(_corner(tchecks, "op0:L1")[0],
                       _corner(clean, "op0:L1")[0])
    # without the encoder's fold the predicted side reads the corrupted
    # weight
    unfolded = flipped(dict(tp, encoder=params["encoder"]),
                       torch.from_numpy(w))
    _, _, _, uchecks = model_prefill(unfolded, cfg, _t(batch), ABFT, 32,
                                     return_checks=True)
    assert not torch.equal(_corner(uchecks, "op0:L1")[0],
                           _corner(clean, "op0:L1")[0])


# ---------------------------------------------------------------------------
# the serving entry point, chip_smoke.py's counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_serve_runs_the_smoke_twin_on_the_cpu(name, capsys):
    got = serve.main(["--arch", name, "--smoke", "--batch", "2", "--prompt",
                      "12", "--new", "4", "--device", "cpu"])
    cfg = smoke_config(get_config(name))
    assert got["model"] == cfg.name and got["device"] == "cpu"
    assert got["logits_shape"] == (2, 1, cfg.padded_vocab) and got["finite"]
    assert not got["prefill_flag"] and got["decode_flags"] == 0
    out = capsys.readouterr().out
    assert "flag=False" in out and "flags=0" in out


@pytest.mark.parametrize("name", ARCHS)
def test_serve_without_a_gpu_raises(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cuda' requested"):
        serve.main(["--arch", name, "--smoke", "--new", "2"])


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ARCHS)
def test_chip_smoke_counts_are_what_a_step_launches(name, monkeypatch):
    """The launch shapes, launch counts, op ids and upset sites
    ``chip_smoke.py`` derives (and gates the card's run on) equal what a
    smoke twin's prefill and decode step launch and report."""
    from repro_torch.kernels.matmul_abft import ops
    cs = _chip_smoke()
    cfg = smoke_config(get_config(name))
    seen = {}
    single = ops.matmul_abft_kernel

    def rec(a, b, br=None, *, trans_b=False):
        key = (a.shape[0], a.shape[1], b.shape[0] if trans_b else b.shape[1],
               trans_b)
        seen.setdefault(key, {"prefill": 0, "decode": 0})[seen_step[0]] += 1
        return single(a, b, br, trans_b=trans_b)
    monkeypatch.setattr(ops, "matmul_abft_kernel", rec)
    seen_step = ["prefill"]
    params = fold_lm_w_r(init_model(cfg, 0, device="cpu"), cfg, ABFT)
    tokens = np.random.default_rng(35).integers(
        1, cfg.vocab_size, size=(BATCH, PROMPT)).astype(np.int32)
    batch = _t(_batch(cfg, tokens))
    extra = dict(src=SRC) if cfg.family == "encdec" else dict(prefix=PREFIX)
    pos0 = PROMPT + extra.get("prefix", 0)
    flash0 = runtime.plain_counts()["flash_checksum"]
    _, states, _, checks = model_prefill(params, cfg, batch, ABFT, pos0 + 2,
                                         return_checks=True)
    flash = runtime.plain_counts()["flash_checksum"] - flash0
    seen_step[0] = "decode"
    _, _, _, dchecks = model_decode(params, cfg, states, batch["tokens"][:, :1],
                                    pos0, ABFT, return_checks=True)
    assert seen == cs.lm_matmul_shapes(cfg, BATCH, PROMPT, **extra)
    for step in ("prefill", "decode"):
        want = cs.lm_step_launches(cfg, step)
        assert want["matmul_abft"] == sum(c[step] for c in seen.values())
        assert want["flash_checksum"] == (flash if step == "prefill" else 0)
    assert list(per_op_report(checks, ABFT)[0]) == cs.lm_op_ids(cfg)
    assert list(per_op_report(dchecks, ABFT)[0]) == cs.lm_op_ids(cfg,
                                                                "decode")
    for step in ("prefill", "decode"):
        assert [i for ids in cs.lm_upset_sites(cfg, step).values()
                for i in ids] == _sites(cfg, step)
    # the flip's site: the first check of unit 1's first block, the
    # encoder's (segment 0) and the decoder's
    assert cs.first_check_id(cfg, 0, 1) == "op0:L1"
    assert cs.first_check_id(cfg, len(cs.check_segments(cfg)) - 1, 1) == (
        "op6:L1" if cfg.family == "encdec" else "op0:L1")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_noncausal_kernel_matches_the_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    runtime.reset_counts()
    cases = NONCAUSAL + [(2, 224, 1500, 16, 16, 64)]
    for shape in cases:
        q, k, v, vr = (torch.from_numpy(x).to(dtype).to(dev)
                       for x in _operands(*shape))
        got = tfk.flash_checksum_kernel(q, k, v, vr, causal=False)
        want = tfk.flash_checksum_plain(q, k, v, vr, causal=False)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w.float(), atol=2 * tol,
                                       rtol=2 * tol)
        again = tfk.flash_checksum_kernel(q, k, v, vr, causal=False)
        assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert runtime.launch_counts()["flash_checksum"] == 2 * len(cases)
