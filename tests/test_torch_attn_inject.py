"""The attention-accumulator fault site (``models/attention.py``
``_maybe_inject``), on the CPU:

  (a) a zero delta (0, 0.0, -0.0) or none binds no site: O is returned
      itself, with no mask, host scalar or pass over it;
  (b) a non-zero delta changes element 0 of O alone, bit for bit as the
      site always added it (mask, host scalar, select), in float32 and
      bfloat16; a tensor delta keeps that path, zero or not;
  (c) a clean ``LMEngine`` prefill and two decode steps of a smoke
      deepseek-moe-16b and chatglm3-6b give the same logits as the same
      steps with the site adding 0.0 in every attention layer.
"""
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.abft import ABFTConfig
from repro_torch.engine.lm import LMEngine
from repro_torch.models import attention
from repro_torch.models.attention import (_maybe_inject,
                                          attention_fault_injection)

BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _site_adding(o):
    """The site as it ran for every bound delta, zero included."""
    val = attention._ATTN_INJECT["value"]
    if val is None:
        return o
    first = torch.zeros(o.shape, dtype=torch.bool, device=o.device)
    first.view(-1)[0] = True
    return torch.where(first, o + torch.as_tensor(val, dtype=o.dtype,
                                                  device=o.device), o)


def _o(dtype):
    gen = torch.Generator().manual_seed(7)
    return torch.randn((2, 5, 4, 8), generator=gen).to(dtype)


@pytest.mark.parametrize("delta", [None, 0, 0.0, -0.0])
def test_a_zero_delta_binds_no_site(delta):
    o = _o(torch.float32)
    with attention_fault_injection(delta):
        assert _maybe_inject(o) is o


@pytest.mark.parametrize("dtype", list(BITS), ids=["float32", "bfloat16"])
@pytest.mark.parametrize("delta", [25.0, -3.5, torch.tensor(25.0),
                                   torch.tensor(0.0)],
                         ids=["25.0", "-3.5", "tensor25.0", "tensor0.0"])
def test_a_nonzero_or_tensor_delta_keeps_the_sites_bits(dtype, delta):
    o = _o(dtype)
    with attention_fault_injection(delta):
        got = _maybe_inject(o)
        want = _site_adding(o)
    assert got is not o and got.dtype == dtype
    bits = BITS[dtype]
    assert torch.equal(got.view(bits), want.view(bits))
    assert torch.equal(got.view(bits).view(-1)[1:],
                       o.view(bits).view(-1)[1:])
    first = o.view(-1)[0] + torch.as_tensor(delta, dtype=dtype)
    assert torch.equal(got.view(-1)[:1].view(bits), first.view(1).view(bits))


def _steps(eng, tokens):
    logits, states, _ = eng.prefill(tokens)
    out = [logits]
    for i in range(2):
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        logits, states, _ = eng.decode(states, nxt, tokens.shape[1] + i)
        out.append(logits)
    return out


@pytest.mark.parametrize("mode", ["none", "fused"])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "chatglm3-6b"])
def test_clean_steps_equal_the_site_adding_zero(monkeypatch, arch, mode):
    cfg = smoke_config(get_config(arch))
    abft = ABFTConfig(mode=mode, threshold=1e-3, relative=True)
    tokens = torch.randint(1, 200, (2, 12), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(11))
    got = _steps(LMEngine.init(cfg, abft, 0, device="cpu", cache_len=16),
                 tokens)

    zeros = []

    def site(o):
        zeros.append(attention._ATTN_INJECT["value"] == 0.0)
        return _site_adding(o)

    monkeypatch.setattr(attention, "_maybe_inject", site)
    want = _steps(LMEngine.init(cfg, abft, 0, device="cpu", cache_len=16),
                  tokens)
    # the site ran with 0.0 in every attention layer of all three steps
    assert len(zeros) == 3 * cfg.n_layers and all(zeros)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
