"""qwen1.5-4b, chatglm3-6b, h2o-danube-3-4b, deepseek-moe-16b,
qwen3-moe-30b-a3b, rwkv6-7b and recurrentgemma-9b in the port against the
JAX package.

The seven configs are copies of the reference's; their full-width fields
must equal it.  Their smoke twins (``smoke_config``: 2 layers — 3, one
(rglru, rglru, attn) unit, for recurrentgemma —, d 64, the same block
flavour — QKV bias, MHA / GQA / MQA, partial RoPE, SwiGLU / GeGLU, an
untied head, danube's sliding window cut to 32, the MoE twins' 8 experts
top-2 at the published capacity factor 1.25, deepseek's with a shared
expert, RWKV6's one head of 64, the RG-LRU's gate blocks of 4 and local
window of 16) run the JAX ``LMEngine`` and the port's on the same numpy
weights (carried across by ``repro_torch.convert``): prefill and decode
logits within ``atol 1e-4``, every checksum corner within ``atol 1e-4 +
rtol 1e-6`` (the same f32 sums in another order), every decode state
(KV caches, recurrent states) within ``atol 1e-4``, the per-op ids and
flags, and the greedy tokens.  Danube's and recurrentgemma's prompt (40) is
longer than their smoke windows, so prefill masks by the window (the flash
path's plain version) and so does every decode step.  recurrentgemma also
runs at 5 and 8 layers: a trailing (rglru, rglru) segment of one unit after
one or two whole units, its checks flat, the whole units' stacked when
there are two.  Within the port: guarded == unguarded bit for bit.
Everything runs on the CPU (the kernels' plain versions)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.core.abft import ABFTConfig as JABFTConfig
from repro.core.abft import per_op_report as jper_op_report
from repro.engine.lm import LMEngine as JLMEngine
from repro.engine.lm import fold_lm_w_r as jfold_lm_w_r
from repro.models.transformer import init_model as jinit_model
from repro.models.transformer import model_decode as jmodel_decode
from repro.models.transformer import model_prefill as jmodel_prefill
from repro_torch import convert
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.abft import ABFTConfig, per_op_report
from repro_torch.engine.lm import LMEngine, fold_lm_w_r
from repro_torch.kernels import runtime
from repro_torch.models.transformer import model_decode, model_prefill

ARCHS = ["qwen1.5-4b", "chatglm3-6b", "h2o-danube-3-4b", "deepseek-moe-16b",
         "qwen3-moe-30b-a3b", "rwkv6-7b", "recurrentgemma-9b"]
# danube's smoke window is 32, recurrentgemma's local window 16: the prompt
# runs past both, decode further
PROMPT, CACHE, BATCH, NEW = 40, 48, 2, 3
ATOL = 1e-4
FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "hd", "d_ff",
          "padded_vocab", "rope_frac", "rope_theta", "qkv_bias", "mlp_act",
          "tie_embeddings", "window", "block_pattern", "local_window",
          "embed_scale", "conv1d_width", "rglru_d", "attention_free")


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    return _setup(request.param)


def _setup(name, n_layers=None):
    jcfg = jsmoke_config(jget_config(name))
    cfg = smoke_config(get_config(name))
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    jparams = jinit_model(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    params = convert.lm_params_from_numpy(np_params, cfg, device="cpu")
    jabft = JABFTConfig(mode="fused", dtype=jnp.float32, threshold=1e-3,
                        relative=True)
    abft = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size,
                          size=(BATCH, PROMPT)).astype(np.int32)
    return dict(name=name, jcfg=jcfg, cfg=cfg, np_params=np_params,
                params=params, jabft=jabft, abft=abft, tokens=tokens)


def _per_layer(cfg, btype):
    """(checks, matmul_abft launches, grouped launches) of one layer of a
    fused-mode step: attention's four or RWKV6's time mix's five (r, k, v,
    g, o) or the RG-LRU's five (proj_x, proj_gate, the two gates on the
    grouped kernel, proj_out); then RWKV6's channel mix's two, a dense
    MLP's three, or an MoE layer's router, up, gate and fused combine
    checks (the three expert products on the grouped kernel) and its shared
    expert's three."""
    if btype == "rwkv":
        return 7, 7, 0
    mixer = (5, 3, 2) if btype == "rglru" else (4, 4, 0)
    if cfg.moe is None:
        mlp = (3, 3, 0)
    else:
        shared = 3 if cfg.moe.n_shared else 0
        mlp = (4 + shared, 1 + shared, 3)
    return tuple(a + b for a, b in zip(mixer, mlp))


def _per_step(cfg):
    """(checks, matmul_abft launches, grouped launches) of all layers of a
    step, the head left out, and the attention layers (flash_checksum's
    launches a prefill)."""
    rows = [_per_layer(cfg, cfg.block_type(i)) for i in range(cfg.n_layers)]
    attn = sum(cfg.block_type(i) == "attn" for i in range(cfg.n_layers))
    return tuple(sum(col) for col in zip(*rows)) + (attn,)


def _close_corner(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=ATOL,
                               err_msg=what)


def _corners(checks):
    return [(c.predicted.detach() if isinstance(c.predicted, torch.Tensor)
             else c.predicted,
             c.actual.detach() if isinstance(c.actual, torch.Tensor)
             else c.actual) for c in checks]


@pytest.mark.parametrize("name", ARCHS)
def test_full_width_config_fields_equal_the_reference(name):
    cfg, jcfg = get_config(name), jget_config(name)
    for f in FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.name == name
    assert (cfg.moe is None) == (jcfg.moe is None)
    if cfg.moe is not None:
        assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)


def test_smoke_twin_blocks_are_the_architecture_s(setup):
    """The smoke twin keeps what the full model exercises: QKV bias on
    qwen and chatglm, RoPE over half the head on chatglm, danube's window
    shorter than the prompt, an untied head on all but recurrentgemma;
    RWKV6's time and channel mix; recurrentgemma's whole (rglru, rglru,
    attn) unit, its local window shorter than the prompt."""
    cfg, full = setup["cfg"], get_config(setup["name"])
    assert cfg.qkv_bias == full.qkv_bias and cfg.rope_frac == full.rope_frac
    assert cfg.tie_embeddings == full.tie_embeddings \
        == ("head" not in setup["params"])
    assert cfg.window == (32 if full.window else 0) and cfg.window < PROMPT
    assert cfg.block_pattern == full.block_pattern
    unit = setup["params"]["segments"][0]
    if full.block_pattern != ("attn",):
        assert cfg.n_layers == max(2, len(full.block_pattern))
        assert cfg.local_window < PROMPT
        for i, bt in enumerate(full.block_pattern):
            want = {"rwkv": {"tm", "cm"}, "rglru": {"rglru", "mlp"},
                    "attn": {"attn", "mlp"}}[bt]
            assert set(unit[f"b{i}"]) == want | {"ln1", "ln2"}
        return
    assert not cfg.tie_embeddings
    b0 = unit["b0"]
    assert ("b" in b0["attn"]["wq"]) == full.qkv_bias
    assert ("moe" in b0) == (full.moe is not None) != ("mlp" in b0)
    if full.moe is not None:
        assert cfg.moe.capacity_factor == full.moe.capacity_factor == 1.25
        assert ("shared" in b0["moe"]) == bool(full.moe.n_shared)


def test_prefill_and_decode_match_the_jax_model(setup):
    _match_the_jax_model(setup)


def _states_close(tstates, jstates):
    """Every decode state leaf (KV cache, recurrent state) within atol."""
    assert len(tstates) == len(jstates)
    for ts, js in zip(tstates, jstates):
        assert sorted(ts) == sorted(js)
        for key, val in ts.items():
            if isinstance(val, dict):
                _states_close([val], [js[key]])
                continue
            want = np.asarray(js[key])
            assert val.numpy().dtype == want.dtype, key
            np.testing.assert_allclose(val.numpy(), want, atol=ATOL, rtol=0,
                                       err_msg=key)


def _match_the_jax_model(s):
    jp = jfold_lm_w_r(jax.tree.map(jnp.asarray, s["np_params"]), s["jcfg"],
                      s["jabft"])
    tp = fold_lm_w_r(s["params"], s["cfg"], s["abft"])
    jl, js, _, jchecks = jmodel_prefill(
        jp, s["jcfg"], {"tokens": jnp.asarray(s["tokens"])}, s["jabft"],
        CACHE, return_checks=True)
    tl, ts, _, tchecks = model_prefill(
        tp, s["cfg"], {"tokens": torch.from_numpy(s["tokens"])}, s["abft"],
        CACHE, return_checks=True)
    steps = [(jl, tl, jchecks, tchecks)]
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for i in range(NEW):
        jl, js, _, jchecks = jmodel_decode(jp, s["jcfg"], js,
                                           jnp.asarray(nxt), PROMPT + i,
                                           s["jabft"], return_checks=True)
        tl, ts, _, tchecks = model_decode(tp, s["cfg"], ts,
                                          torch.from_numpy(nxt), PROMPT + i,
                                          s["abft"], return_checks=True)
        steps.append((jl, tl, jchecks, tchecks))
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        assert np.array_equal(nxt[:, 0], torch.argmax(
            tl[:, -1], -1).numpy())                 # the same greedy token
    _states_close(ts, js)
    for jl, tl, jchecks, tchecks in steps:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        jids, jflags, _ = jper_op_report(jchecks, s["jabft"])
        tids, tflags, _ = per_op_report(tchecks, s["abft"])
        assert tids == tuple(jids)
        assert len(tids) == _per_step(s["cfg"])[0] + 1
        assert tflags.tolist() == np.asarray(jflags).tolist()
        assert not tflags.any()
        for (tp_, ta), (jp_, ja) in zip(_corners(tchecks),
                                        _corners(jchecks)):
            _close_corner(tp_, jp_, "predicted")
            _close_corner(ta, ja, "actual")


def test_engine_matches_the_jax_engine(setup):
    s = setup
    jeng = JLMEngine(s["jcfg"], s["jabft"], jax.tree.map(jnp.asarray,
                                                         s["np_params"]),
                     cache_len=CACHE)
    eng = LMEngine(s["cfg"], s["abft"], s["params"], cache_len=CACHE)
    jl, js, jm = jeng.prefill(jnp.asarray(s["tokens"]))
    tl, ts, tm = eng.prefill(torch.from_numpy(s["tokens"]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert tm["abft_op_ids"] == jm["abft_op_ids"]
    assert tm["abft_op_flags"].tolist() == \
        np.asarray(jm["abft_op_flags"]).tolist()
    toks = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    jl2, _, jm2 = jeng.decode(js, jnp.asarray(toks), PROMPT)
    tl2, _, tm2 = eng.decode(ts, torch.from_numpy(toks), PROMPT)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL,
                               rtol=0)
    assert tm2["abft_op_ids"] == jm2["abft_op_ids"]
    assert not bool(tm2["abft_flag"]) and not bool(jm2["abft_flag"])
    jt, _ = jeng.generate(jnp.asarray(s["tokens"]), NEW)
    tt, _ = eng.generate(torch.from_numpy(s["tokens"]), NEW)
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert eng.guard.flags == 0


def test_guarded_logits_bit_identical_to_unguarded(setup):
    _guarded_is_unguarded(setup)


def _guarded_is_unguarded(s):
    off = ABFTConfig(mode="none")
    tok = torch.from_numpy(s["tokens"])
    logits, states, _ = model_prefill(s["params"], s["cfg"],
                                      {"tokens": tok}, off, CACHE)
    ref = [logits]
    for i in range(NEW):
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        logits, states, _ = model_decode(s["params"], s["cfg"], states, nxt,
                                         PROMPT + i, off)
        ref.append(logits)
    eng = LMEngine(s["cfg"], s["abft"], s["params"], cache_len=CACHE)
    runtime.reset_counts()
    logits, states, m = eng.prefill(tok)
    assert torch.equal(logits, ref[0]) and not m["abft_op_flags"].any()
    for i in range(NEW):
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        logits, states, m = eng.decode(states, nxt, PROMPT + i)
        assert torch.equal(logits, ref[i + 1]) and not bool(m["abft_flag"])
    assert eng.guard.flags == 0
    # every product (the head's too) went through matmul_abft's wrapper —
    # an MoE layer's expert products and the RG-LRU gates through its
    # grouped one —, every prefill attention through flash_checksum's —
    # danube's and recurrentgemma's windowed ones included — their plain
    # versions on the CPU
    _, single, grouped, attn = _per_step(s["cfg"])
    assert runtime.plain_counts()["matmul_abft"] == (NEW + 1) * (single + 1)
    assert runtime.plain_counts()["matmul_abft_grouped"] == \
        (NEW + 1) * grouped
    assert runtime.plain_counts()["flash_checksum"] == attn


@pytest.mark.parametrize("n_layers", [5, 8])
def test_hybrid_twin_with_a_trailing_segment_matches_the_jax_model(n_layers):
    """recurrentgemma's twin at 5 layers (one whole unit and the trailing
    (rglru, rglru) segment, both of one unit: flat checks) and 8 (two whole
    units, their checks stacked ``op{i}:L{j}``, then the trailing segment's
    flat): the op ids equal the JAX ``per_op_report``'s, and the rest of
    the prefill-and-decode comparison and guarded == unguarded hold."""
    s = _setup("recurrentgemma-9b", n_layers)
    _match_the_jax_model(s)
    _guarded_is_unguarded(s)
