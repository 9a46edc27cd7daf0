"""The port's LM examples against the JAX package's, on the CPU.

``examples/torch_{train_lm,serve_lm}.py`` run as processes of their own
(``python -X importtime``, ``PYTHONPATH=src``, ``--device cpu``, smoke
twins at small flags): each must exit 0 and import no module of ``jax`` or
of the JAX package ``repro``.  Their printed numbers are held against the
reference's jitted steps in this process, from the port's own seed-0 state
(``init_train_state(cfg, 0)`` / ``init_model(cfg, 0)`` on the CPU, carried
across with ``repro_torch.convert``):

* train_lm — each printed loss and gradient norm within the train-step
  tolerance of ``tests/test_torch_train.py`` (``atol 1e-4``) plus half a
  unit of the last printed digit, against the reference's
  ``make_train_step`` over the same stream; the parameter count and the
  ABFT flag count equal; the decoder-only (gemma-2b), encoder-decoder
  (whisper-medium: seeded ``src_embeds``) and prefix-embedding
  (internvl2-26b: zero ``prefix_embeds``) branches; a second gemma-2b run
  on the same ``--ckpt`` prints ``restored from step N`` and continues as
  the reference's state does from that checkpoint, with the data stream
  started again (ROADMAP C12);
* serve_lm — the prefill flag and the decode flag count equal, and the
  greedy tokens of sequence 0 equal the reference's prefill/decode from
  the same params up to the first step where the reference's top-2 logit
  margin (over every sequence of the batch: MoE capacity couples them)
  falls under 1e-3, where a rounding difference may rightly pick the other
  token; the output shows what ``chip_smoke.py``'s ``examples`` phase asks
  of serve_lm on the card.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.core.abft import ABFTConfig as JABFTConfig
from repro.launch.steps import make_decode_step as jmake_decode_step
from repro.launch.steps import make_prefill_step as jmake_prefill_step
from repro.launch.steps import make_train_step as jmake_train_step
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch import convert
from repro_torch.configs import get_config, smoke_config
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch.steps import init_train_state
from repro_torch.models.transformer import init_model
from examples_run import chip_smoke_gates, run_example

ATOL = 1e-4                    # tests/test_torch_train.py's train-step gate
LOSS_ATOL = ATOL + 0.5e-4      # printed with 4 decimals
GNORM_ATOL = ATOL + 0.5e-2     # printed with 2 decimals
MARGIN = 1e-3                  # top-2 logit margin a greedy token needs
BATCH, SEQ = 2, 16
JABFT = JABFTConfig(mode="fused", threshold=5e-2, relative=True)


def _train_batches(cfg, steps):
    """The example's batches: the stream from its start, + the branch's
    embeddings."""
    it = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SEQ,
                     batch_size=BATCH, seed=0).batches()
    for i in range(steps):
        b = {k: jnp.asarray(v) for k, v in next(it).items()}
        if cfg.family == "encdec":
            b["src_embeds"] = jnp.asarray(np.random.default_rng(i).normal(
                size=(BATCH, SEQ, cfg.d_model)), jnp.float32)
        elif cfg.frontend:
            b["prefix_embeds"] = jnp.zeros((BATCH, 4, cfg.d_model),
                                           jnp.float32)
        yield b


def _printed_steps(out):
    return [(int(i), float(loss), float(gnorm)) for i, loss, gnorm in
            re.findall(r"^step +(\d+) loss=(\S+) gnorm=(\S+) ", out, re.M)]


@pytest.mark.parametrize("arch,steps,runs", [
    ("gemma-2b", 2, 2),           # decoder-only; a second run resumes
    ("whisper-medium", 1, 1),     # the encdec branch
    ("internvl2-26b", 1, 1),      # the frontend branch
])
def test_train_lm_matches_the_reference(tmp_path, arch, steps, runs):
    ckpt = tmp_path / "ckpt"
    flags = ["--arch", arch, "--steps", str(steps), "--batch", str(BATCH),
             "--seq", str(SEQ), "--ckpt", str(ckpt), "--device", "cpu"]
    outs = [run_example("train_lm", *flags, cwd=tmp_path)
            for _ in range(runs)]

    cfg = smoke_config(get_config(arch))
    jcfg = jsmoke_config(jget_config(arch))
    state = jax.tree.map(jnp.asarray, convert.train_state_to_numpy(
        init_train_state(cfg, 0, device="cpu")))
    n_params = sum(x.size for x in jax.tree.leaves(state["params"]))
    jstep = jax.jit(jmake_train_step(jcfg, JABFT, JAdamWConfig(lr=1e-3),
                                     total_steps=steps, warmup=20))
    for r, out in enumerate(outs):
        assert f"arch={cfg.name} params={n_params/1e6:.2f}M abft=fused" \
            in out
        if r:
            assert f"restored from step {steps}" in out
        else:
            assert "restored from" not in out
        want, n_flags = [], 0
        for b in _train_batches(cfg, steps):
            state, m = jstep(state, b)
            n_flags += bool(m["abft_flag"])
            want.append((float(m["loss"]), float(m["grad_norm"])))
        printed = _printed_steps(out)
        assert [p[0] for p in printed] == list(range(steps))
        for (i, loss, gnorm) in printed:
            np.testing.assert_allclose(loss, want[i][0], rtol=0,
                                       atol=LOSS_ATOL, err_msg=f"run {r}")
            np.testing.assert_allclose(gnorm, want[i][1], rtol=0,
                                       atol=GNORM_ATOL, err_msg=f"run {r}")
        assert n_flags == 0
        assert out.rstrip().endswith(f"ABFT flags: {n_flags}")


def _margin(logits):
    """The smallest top-2 gap of the last position's logits over the
    batch."""
    top2 = np.sort(np.asarray(logits[:, -1], np.float64), axis=-1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())


@pytest.mark.parametrize("arch", ["gemma-2b", "whisper-medium",
                                  "deepseek-moe-16b"])
def test_serve_lm_matches_the_reference(tmp_path, arch):
    batch, prompt, new = 2, 8, 4
    out = run_example("serve_lm", "--arch", arch, "--batch", str(batch),
                      "--prompt", str(prompt), "--new", str(new),
                      "--device", "cpu", cwd=tmp_path)

    cfg = smoke_config(get_config(arch))
    jcfg = jsmoke_config(jget_config(arch))
    params = jax.tree.map(jnp.asarray, convert.params_to_numpy(
        init_model(cfg, 0, device="cpu")))
    rng = np.random.default_rng(0)
    b = {"tokens": jnp.asarray(
        rng.integers(0, cfg.vocab_size, size=(batch, prompt)), jnp.int32)}
    if cfg.family == "encdec":
        b["src_embeds"] = jnp.asarray(
            rng.normal(size=(batch, prompt, cfg.d_model)), jnp.float32)
    prefill = jax.jit(jmake_prefill_step(jcfg, JABFT, prompt + new))
    decode = jax.jit(jmake_decode_step(jcfg, JABFT))

    logits, states, m = prefill(params, b)
    prefill_flag = bool(m["abft_flag"])
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    margins, toks, n_flags = [_margin(logits)], [tok], 0
    for i in range(new - 1):
        logits, states, m = decode(params, states, tok,
                                   jnp.asarray(prompt + i, jnp.int32))
        n_flags += int(bool(m["abft_flag"]))
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        margins.append(_margin(logits))
        toks.append(tok)
    want = np.concatenate([np.asarray(t) for t in toks], axis=1)[0]

    (flag,) = re.findall(r"abft_flag=(\w+)$", out, re.M)
    assert (flag == "True") == prefill_flag
    assert not prefill_flag
    (got_flags,) = re.findall(r"ABFT flags: (\d+)$", out, re.M)
    assert int(got_flags) == n_flags == 0
    (seq0,) = re.findall(r"sample continuation \(seq 0\): \[(.*)\]$", out,
                         re.M)
    got = [int(t) for t in seq0.split(",")]
    # tokens are compared while every earlier greedy choice was clear
    n_sure = next((i for i, mg in enumerate(margins) if mg < MARGIN),
                  len(margins))
    assert n_sure >= 1, margins
    assert got[:n_sure] == want[:n_sure].tolist(), (margins, got, want)
    assert chip_smoke_gates("serve_lm", out) == 3
