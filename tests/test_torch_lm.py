"""Guarded LM serving in the port against the JAX package's.

The JAX ``LMEngine`` and the port's run ``smoke_config(get_config(
"gemma-2b"))`` on the same numpy weights (carried across by
``repro_torch.convert``): prefill and decode logits, every checksum corner,
the per-op ids, flags and relative divergences, and the greedy tokens agree
(logits within ``atol 1e-4``; checksum corners — sums of up to ~270 here —
within ``atol 1e-4 + rtol 1e-6``, i.e. at most a few f32 spacings: the same
f32 sums in another order; fused-mode corners measure ≤ 6.1e-5, the split
baseline's prefill corners 2.0e-4).
Within the port: guarded == unguarded bit for bit, an accumulator upset is
retried away bit for bit, weight bit flips are restored from the master
bit for bit.  Everything runs on the CPU (the kernels' plain versions)."""
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
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.core.abft import ABFTConfig, per_op_report
from repro_torch.engine.lm import LMEngine, fold_lm_w_r
from repro_torch.kernels import runtime
from repro_torch.launch import serve_lm
from repro_torch.models.transformer import model_decode, model_prefill

PROMPT, CACHE, BATCH = 8, 16, 2
ATOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = jsmoke_config(jget_config("gemma-2b"))
    cfg = smoke_config(get_config("gemma-2b"))
    jparams = jinit_model(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    params = convert.lm_params_from_numpy(np_params, cfg, device="cpu")
    jabft = JABFTConfig(mode="fused", dtype=jnp.float32, threshold=1e-3,
                        relative=True)
    abft = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size,
                          size=(BATCH, PROMPT)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, np_params=np_params,
                params=params, jabft=jabft, abft=abft, tokens=tokens)


def _fresh_engine(s) -> LMEngine:
    return LMEngine(s["cfg"], s["abft"], s["params"], cache_len=CACHE)


def _close_corner(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL,
                               err_msg=what)


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------

def test_the_registry_lists_what_the_port_runs():
    assert list_archs() == ["chatglm3-6b", "deepseek-moe-16b", "gemma-2b",
                            "h2o-danube-3-4b", "internvl2-26b", "qwen1.5-4b",
                            "qwen3-moe-30b-a3b", "recurrentgemma-9b",
                            "rwkv6-7b", "whisper-medium"]
    cfg = get_config("gemma-2b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab_size) == (18, 2048, 8, 1, 256, 16384, 256000)
    for f in ("n_layers", "d_model", "d_ff", "mlp_act", "embed_scale",
              "padded_vocab", "hd", "kv_groups"):
        assert getattr(cfg, f) == getattr(jget_config("gemma-2b"), f)
    with pytest.raises(KeyError, match="not an architecture the port runs"):
        get_config("llama-70b")


def test_params_round_trip_and_shape_check(setup):
    back = convert.params_to_numpy(setup["params"])
    flat_a = jax.tree.leaves(back)
    flat_b = jax.tree.leaves(setup["np_params"])
    assert len(flat_a) == len(flat_b)
    for x, y in zip(flat_a, flat_b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    wrong = dict(setup["np_params"], final_norm={"scale": np.zeros(
        (7,), np.float32)})
    with pytest.raises(ValueError, match="final_norm"):
        convert.lm_params_from_numpy(wrong, setup["cfg"], device="cpu")


def test_fold_folds_stacked_segments_per_layer(setup):
    folded = fold_lm_w_r(setup["params"], setup["cfg"], setup["abft"])
    jfolded = jfold_lm_w_r(setup["jparams"], setup["jcfg"], setup["jabft"])
    found = 0
    for name in ("wq", "wk", "wv", "wo"):
        node = folded["segments"][0]["b0"]["attn"][name]
        jnode = jfolded["segments"][0]["b0"]["attn"][name]
        assert tuple(node["w_r"].shape) == tuple(node["w"].shape[:2])
        np.testing.assert_allclose(node["w_r"].numpy(),
                                   np.asarray(jnode["w_r"]), atol=1e-5)
        found += 1
    for name in ("wi", "wg", "wo"):
        node = folded["segments"][0]["b0"]["mlp"][name]
        assert tuple(node["w_r"].shape) == tuple(node["w"].shape[:2])
        found += 1
    assert found == 7
    # master untouched: the fold returns a new tree sharing the weights
    assert "w_r" not in setup["params"]["segments"][0]["b0"]["attn"]["wq"]
    assert folded["segments"][0]["b0"]["attn"]["wq"]["w"] is \
        setup["params"]["segments"][0]["b0"]["attn"]["wq"]["w"]


# ---------------------------------------------------------------------------
# cross-framework parity
# ---------------------------------------------------------------------------

def _check_arrays(checks):
    return ([np.asarray(c.predicted.detach() if isinstance(c.predicted,
                                                           torch.Tensor)
                        else c.predicted) for c in checks],
            [np.asarray(c.actual.detach() if isinstance(c.actual,
                                                        torch.Tensor)
                        else c.actual) for c in checks])


@pytest.mark.parametrize("mode", ["fused", "split"])
def test_prefill_and_decode_match_the_jax_model(setup, mode):
    s = setup
    jabft = JABFTConfig(mode=mode, dtype=jnp.float32)
    abft = ABFTConfig(mode=mode)
    jp = jfold_lm_w_r(jax.tree.map(jnp.asarray, s["np_params"]), s["jcfg"],
                      jabft)
    tp = fold_lm_w_r(s["params"], s["cfg"], abft)
    jl, js, jrep, jchecks = jmodel_prefill(
        jp, s["jcfg"], {"tokens": jnp.asarray(s["tokens"])}, jabft, CACHE,
        return_checks=True)
    tl, ts, trep, tchecks = model_prefill(
        tp, s["cfg"], {"tokens": torch.from_numpy(s["tokens"])}, abft, CACHE,
        return_checks=True)
    steps = [(jl, tl, jchecks, tchecks)]
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for i in range(2):
        jl, js, _, jchecks = jmodel_decode(jp, s["jcfg"], js,
                                           jnp.asarray(nxt), PROMPT + i,
                                           jabft, return_checks=True)
        tl, ts, _, tchecks = model_decode(tp, s["cfg"], ts,
                                          torch.from_numpy(nxt), PROMPT + i,
                                          abft, return_checks=True)
        steps.append((jl, tl, jchecks, tchecks))
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        assert np.array_equal(nxt[:, 0], torch.argmax(
            tl[:, -1], -1).numpy())                 # the same greedy token
    for jl, tl, jchecks, tchecks in steps:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        jids, jflags, jrel = jper_op_report(jchecks, jabft)
        tids, tflags, trel = per_op_report(tchecks, abft)
        assert tids == tuple(jids) and len(tids) == (
            2 * 7 + 1 if mode == "fused" else 2 * 8 + 1)
        assert tflags.tolist() == np.asarray(jflags).tolist()
        assert not tflags.any()
        np.testing.assert_allclose(trel.numpy(), np.asarray(jrel),
                                   atol=1e-5)
        for (tp_, ta), (jp_, ja) in zip(zip(*_check_arrays(tchecks)),
                                        zip(*_check_arrays(jchecks))):
            _close_corner(tp_, jp_, "predicted")
            _close_corner(ta, ja, "actual")


def test_engine_prefill_and_decode_match_the_jax_engine(setup):
    s = setup
    jeng = JLMEngine(s["jcfg"], s["jabft"], jax.tree.map(jnp.asarray,
                                                         s["np_params"]),
                     cache_len=CACHE)
    eng = _fresh_engine(s)
    jl, js, jm = jeng.prefill(jnp.asarray(s["tokens"]))
    tl, ts, tm = eng.prefill(torch.from_numpy(s["tokens"]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert tm["abft_op_ids"] == jm["abft_op_ids"]
    assert tm["abft_op_ids"][:2] == ("op0:L0", "op0:L1")
    assert tm["abft_op_ids"][-1] == "op7"
    assert tm["abft_op_flags"].tolist() == \
        np.asarray(jm["abft_op_flags"]).tolist()
    np.testing.assert_allclose(tm["abft_op_rel"].numpy(),
                               np.asarray(jm["abft_op_rel"]), atol=1e-5)
    toks = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    jl2, _, jm2 = jeng.decode(js, jnp.asarray(toks), PROMPT)
    tl2, _, tm2 = eng.decode(ts, torch.from_numpy(toks), PROMPT)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL,
                               rtol=0)
    assert tm2["abft_op_ids"] == jm2["abft_op_ids"]
    assert not bool(tm2["abft_flag"]) and not bool(jm2["abft_flag"])
    # greedy generation: the same tokens
    jt, _ = jeng.generate(jnp.asarray(s["tokens"]), 4)
    tt, _ = eng.generate(torch.from_numpy(s["tokens"]), 4)
    assert np.array_equal(tt.numpy(), np.asarray(jt))


# ---------------------------------------------------------------------------
# within the port: bit-identity and repairs
# ---------------------------------------------------------------------------

def _reference(s, n_new=2):
    off = ABFTConfig(mode="none")
    tok = torch.from_numpy(s["tokens"])
    logits, states, _ = model_prefill(s["params"], s["cfg"],
                                      {"tokens": tok}, off, CACHE)
    out = [logits]
    for i in range(n_new):
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        logits, states, _ = model_decode(s["params"], s["cfg"], states, nxt,
                                         PROMPT + i, off)
        out.append(logits)
    return out


def test_clean_guarded_logits_bit_identical_to_unguarded(setup):
    ref = _reference(setup)
    eng = _fresh_engine(setup)
    runtime.reset_counts()
    logits, states, m = eng.prefill(torch.from_numpy(setup["tokens"]))
    assert torch.equal(logits, ref[0]) and eng.guard.flags == 0
    assert len(m["abft_op_ids"]) == len(m["abft_op_flags"]) == 15
    assert not m["abft_op_flags"].any()
    for i in range(2):
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        logits, states, m = eng.decode(states, nxt, PROMPT + i)
        assert torch.equal(logits, ref[i + 1])
        assert not bool(m["abft_flag"])
    assert eng.guard.flags == 0
    # every product and the prefill attention went through the kernels'
    # wrappers (their plain versions, on the CPU)
    assert runtime.plain_counts()["matmul_abft"] == 3 * (2 * 7 + 1)
    assert runtime.plain_counts()["flash_checksum"] == 2


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_transient_inject_detected_and_repaired(setup, step):
    ref = _reference(setup, 1)
    eng = _fresh_engine(setup)
    tok = torch.from_numpy(setup["tokens"])
    logits, states, _ = eng.prefill(tok, inject=30.0 if step == "prefill"
                                    else 0.0)
    if step == "decode":
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        logits, _, _ = eng.decode(states, nxt, PROMPT, inject=30.0)
    assert eng.guard.flags == 1 and eng.guard.retries == 1
    assert torch.equal(logits, ref[0 if step == "prefill" else 1])


def _flip_leaf(eng, path, index, bit=30):
    """Replace one weight leaf of the WORKING tree by a clone with one bit
    flipped; the master shares the original tensor and stays pristine."""
    params = dict(eng.params)
    seg = dict(params["segments"][0])
    node = seg
    for key in path[:-1]:
        node[key] = dict(node[key])
        node = node[key]
    leaf = dict(node[path[-1]])
    w = leaf["w"].clone()
    w.view(torch.int32)[index] ^= (1 << bit)
    leaf["w"] = w
    node[path[-1]] = leaf
    params["segments"] = [seg]
    eng.params = params
    return w


@pytest.mark.parametrize("site", ["qkv_w", "mlp_w"])
def test_weight_fault_detected_and_restored(setup, site):
    ref = _reference(setup, 0)
    eng = _fresh_engine(setup)
    path = ["b0", "attn", "wq"] if site == "qkv_w" else ["b0", "mlp", "wi"]
    index = (1, 0, 0, 0) if site == "qkv_w" else (1, 0, 0)
    w = _flip_leaf(eng, path, index)
    master = setup["params"]["segments"][0]["b0"][path[1]][path[2]]["w"]
    assert not torch.equal(w, master)
    logits, _, m = eng.prefill(torch.from_numpy(setup["tokens"]))
    assert eng.guard.flags == 1 and eng.guard.restores == 1
    assert torch.equal(logits, ref[0])          # refolded from the master
    logits2, _, _ = eng.prefill(torch.from_numpy(setup["tokens"]))
    assert eng.guard.flags == 1 and torch.equal(logits2, ref[0])


def test_serve_lm_cli_gates_pass_on_the_cpu():
    payload = serve_lm.main(["--prompt", "8", "--new", "4", "--device",
                             "cpu", "--assert-clean", "--inject-at", "3"])
    assert payload["clean"] == {"bitwise_identical": True, "flags": 0}
    assert payload["fault"]["detected"] and \
        payload["fault"]["repaired_bitwise"]
    assert payload["authoritative"] is False


@pytest.mark.parametrize("entry", ["init", "serve_lm", "decode_state"])
def test_a_cuda_request_without_a_gpu_raises(setup, entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device resolves")
    from repro_torch.models.transformer import init_decode_state
    calls = {
        "init": lambda: LMEngine.init(setup["cfg"], setup["abft"], 0),
        "serve_lm": lambda: serve_lm.main(["--new", "1"]),
        "decode_state": lambda: init_decode_state(setup["cfg"], 1, 4),
    }
    with pytest.raises(RuntimeError, match="device='cuda' requested"):
        calls[entry]()


def test_unported_blocks_and_cases_raise(setup):
    import dataclasses
    import types
    from repro_torch.models.attention import _flash_path, attention_block
    # on the card, prefill attention the kernel does not take raises: a
    # non-causal window, causal cross-attention, positions not 0..T-1
    card = types.SimpleNamespace(is_cuda=True)
    for args in ((False, 4, False, True, True), (True, 0, True, True, True),
                 (True, 0, False, False, False)):
        with pytest.raises(NotImplementedError, match="ROADMAP A10"):
            _flash_path(card, *args)
    # windowed causal self-attention takes the flash_checksum path (its
    # plain version on the CPU, the CUDA kernel on the card)
    cfg = dataclasses.replace(setup["cfg"], window=4)
    p = setup["params"]["segments"][0]["b0"]["attn"]
    p = {k: {"w": v["w"][0]} for k, v in p.items()}
    x = torch.randn(1, 6, cfg.d_model)
    out, checks, _ = attention_block(p, x, cfg, setup["abft"], window=4)
    assert out.shape == x.shape and not any(bool(c.flag(setup["abft"]))
                                            for c in checks)


@pytest.mark.parametrize("tied", [True, False])
def test_unembed_matches_the_jax_function(setup, tied):
    from repro.models.common import unembed as junembed
    from repro_torch.models.common import unembed
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (BATCH, 3, setup["cfg"].d_model)).astype(np.float32)
    if tied:
        p = {"table": setup["np_params"]["embed"]["table"]}
    else:
        p = {"w": rng.normal(0, 0.1, (setup["cfg"].d_model, 40)).astype(
            np.float32)}
    jl, jc = junembed(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                      setup["jcfg"], setup["jabft"])
    tl, tc = unembed({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x), setup["cfg"], setup["abft"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert len(tc) == len(jc) == 1
    _close_corner(tc[0].predicted, jc[0].predicted, "predicted")
    _close_corner(tc[0].actual, jc[0].actual, "actual")
