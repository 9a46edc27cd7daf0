"""The float64 witness of ``chip_smoke.py``'s card-vs-CPU cut (ROADMAP
C10): the plain versions of B4 and B5 take float64 operands and sum them in
float64 in their own association; a model config with ``dtype="float64"``
runs its whole prefill and decode path in float64 — no operation narrows a
float64 input to float32 — on the smoke twins of whisper-medium (the
encoder-decoder the witness is for), recurrentgemma-9b (RG-LRU, local
attention) and gemma-2b; and ``chip_smoke.py``'s ``cut_run`` /
``f64_distance`` put a float32 run within f32 rounding of its witness.  The
float32 path is the one every other parity test holds against the JAX
package."""
import dataclasses
import importlib.util
import pathlib

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.abft import ABFTConfig
from repro_torch.kernels.flash_checksum.kernel import flash_checksum_plain
from repro_torch.kernels.matmul_abft.kernel import (matmul_abft_grouped_plain,
                                                    matmul_abft_plain)
from repro_torch.models.transformer import init_model

ARCHS = ("whisper-medium", "recurrentgemma-9b", "gemma-2b")
PROMPT, DECODE, SRC = 12, 3, 20


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _f64(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64)


@pytest.mark.parametrize("m,k,n,trans_b", [(3, 70, 9, False),
                                           (40, 33, 17, True)])
def test_matmul_plain_sums_float64_in_float64(m, k, n, trans_b):
    a, b = _f64(m, k), _f64(*((n, k) if trans_b else (k, n)), seed=1)
    br = (b.sum(0) if trans_b else b.sum(1))
    c, sums, extra = matmul_abft_plain(a, b, br, trans_b=trans_b)
    want = a @ (b.t() if trans_b else b)
    assert c.dtype == sums.dtype == extra.dtype == torch.float64
    assert float((c - want).abs().max()) < 1e-12
    assert float((extra[:, 0] - a @ br).abs().max()) < 1e-12
    assert abs(float(sums.sum() - want.sum())) < 1e-10
    cg, _, _ = matmul_abft_grouped_plain(a[None].expand(2, m, k), (
        b[None].expand(2, *b.shape)), trans_b=trans_b)
    assert torch.equal(cg[0], c) and torch.equal(cg[1], c)


def _attention64(q, k, v, causal, window):
    """softmax(q·kᵀ/√dh + mask)·v with A materialized, in float64."""
    b, t, h, dh = q.shape
    s, kh = k.shape[1], k.shape[2]
    ke = k.repeat_interleave(h // kh, dim=2)
    ve = v.repeat_interleave(h // kh, dim=2)
    sc = torch.einsum("bthd,bshd->bhts", q, ke) * dh ** -0.5
    if causal:
        qpos = torch.arange(t)[:, None]
        kpos = torch.arange(s)[None, :]
        valid = (kpos <= qpos) & ((kpos > qpos - window) if window else True)
        sc = sc.masked_fill(~valid, float("-inf"))
    return torch.einsum("bhts,bshd->bthd", torch.softmax(sc, dim=-1), ve)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0)])
def test_flash_plain_runs_float64_in_float64(causal, window):
    s = 37 if causal else 41
    q, k, v = _f64(2, 37, 4, 16), _f64(2, s, 2, 16, seed=1), \
        _f64(2, s, 2, 16, seed=2)
    vr = _f64(2, s, 4, seed=3)
    o, ex = flash_checksum_plain(q, k, v, vr, causal=causal, window=window)
    assert o.dtype == ex.dtype == torch.float64
    assert float((o - _attention64(q, k, v, causal, window)).abs().max()) \
        < 1e-12


def test_kernels_still_refuse_float64_off_the_cpu():
    from repro_torch.kernels.matmul_abft import kernel
    a = torch.zeros((2, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="share one of"):
        kernel._check_shapes(a, a.t(), None, False)


class _Narrowing(TorchDispatchMode):
    """Records every operation that takes a float64 tensor and returns a
    float32 or bfloat16 one."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [x for x in tree_flatten((args, kwargs))[0]
               if isinstance(x, torch.Tensor)]
        outs = [x for x in tree_flatten(out)[0]
                if isinstance(x, torch.Tensor)]
        if any(x.dtype == torch.float64 for x in ins) and any(
                x.dtype in (torch.float32, torch.bfloat16) for x in outs):
            self.hits.append(str(func))
        return out


def _cut(arch):
    cfg = smoke_config(get_config(arch))
    params = init_model(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (2, PROMPT), generator=g,
                           dtype=torch.int32)
    extra = {}
    if cfg.family == "encdec":
        extra["src_embeds"] = torch.randn(2, SRC, cfg.d_model, generator=g)
    return cfg, params, extra, tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_float64_config_runs_the_path_in_float64(arch):
    cs = _chip_smoke()
    cfg, params, extra, tokens = _cut(arch)
    f64_cfg = dataclasses.replace(cfg, dtype="float64")
    with _Narrowing() as mode:
        run = cs.cut_run(torch, f64_cfg, ABFTConfig(mode="none"), params,
                         extra, tokens, PROMPT, PROMPT + DECODE, DECODE,
                         dev="cpu")
    assert mode.hits == []
    assert all(x.dtype == torch.float64 for x in run["logits"])
    assert len(run["logits"]) == DECODE + 1 and not any(run["flags"])


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_cut_sits_within_f32_rounding_of_its_witness(arch):
    """The witness as ``lm_gates`` makes it: the f32 run (checks on) and
    the float64 run fed the f32 run's tokens.  Their distance is f32
    rounding: small against the gate, not zero."""
    cs = _chip_smoke()
    cfg, params, extra, tokens = _cut(arch)
    args = (params, extra, tokens, PROMPT, PROMPT + DECODE, DECODE)
    f32 = cs.cut_run(torch, cfg, ABFTConfig(mode="fused", threshold=1e-3,
                                            relative=True), *args, dev="cpu")
    f64 = cs.cut_run(torch, dataclasses.replace(cfg, dtype="float64"),
                     ABFTConfig(mode="none"), *args, dev="cpu",
                     feed=f32["fed"])
    assert not any(f32["flags"])
    assert all(torch.equal(a, b) for a, b in zip(f32["fed"], f64["fed"]))
    dist = cs.f64_distance(f32["logits"], f64["logits"], cfg.vocab_size)
    assert len(dist["per_step_max_abs_err"]) == DECODE + 1
    assert 0 < max(dist["per_step_max_abs_err"]) < 1e-4
    assert max(dist["per_step_gate_ratio"]) < 0.5
