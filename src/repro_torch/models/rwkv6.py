"""RWKV6 ("Finch") time-mix and channel-mix blocks.

Counterpart of the JAX package's ``repro/models/rwkv6.py``.  The
data-dependent per-channel decay makes the recurrence a product of
data-dependent diagonal maps, which the fused GCN-ABFT chain does not factor
through: the projections (r, k, v, g, o and the channel-mix's two) carry
split checks through :func:`~repro_torch.models.common.dense` — the
``matmul_abft`` kernel on the card, seven checks a layer in the reference's
order — and the recurrence itself is unchecked.

State per head: S [hd, hd];   wkv_t = S_{t-1} + diag(u) kᵀ_t v_t
                              out_t = r_t · wkv_t
                              S_t   = diag(w_t) S_{t-1} + kᵀ_t v_t
with w_t = exp(-exp(w0 + lora_w(x̄_t))) (data-dependent decay).

The low-rank token-shift and decay products (``lora_a``/``lora_b``,
``w_lora_a``/``w_lora_b``) are unchecked, as in the reference, and run as
plain ``torch.einsum``/``torch.matmul`` (float32 on the card needs TF32
off, as every checked path). The WKV scan is a Python loop over time steps
with the reference's per-step arithmetic; what does not depend on the step
(``kᵀv`` and ``u·kᵀv``) is computed ``WKV_CHUNK`` steps at a time,
elementwise, so each element is rounded as the reference rounds it.

The channel mix has no receptance gate: the reference computes the
published second mix (``xv``) and drops it; the port follows the
reference's output and leaves that mix out.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.abft import ABFTConfig, Check
from repro_torch.models.common import dense, gen_device, init_dense, \
    trunc_normal

Tensor = torch.Tensor
Params = Dict[str, Any]

HEAD_SIZE = 64
LORA_R = 32
# time steps whose kᵀv and u·kᵀv the WKV scan makes at once: each is
# [B, steps, H, hd, hd], hd = 64 times the activation's bytes a step
WKV_CHUNK = 64


def _heads(cfg: ModelConfig) -> int:
    return cfg.d_model // HEAD_SIZE


def init_rwkv_time_mix(gen: torch.Generator, cfg: ModelConfig,
                       lead: Tuple[int, ...] = ()) -> Params:
    d = cfg.d_model
    dev = gen_device(gen)

    def const(shape, value):
        return torch.full((*lead, *shape), value, dtype=torch.float32,
                          device=dev)
    return {
        "mu": const((5, d), 0.5),                        # r,k,v,g,w lerps
        "lora_a": trunc_normal(gen, (*lead, d, 5, LORA_R), d ** -0.5),
        "lora_b": trunc_normal(gen, (*lead, 5, LORA_R, d), LORA_R ** -0.5),
        "wr": init_dense(gen, d, d, lead=lead),
        "wk": init_dense(gen, d, d, lead=lead),
        "wv": init_dense(gen, d, d, lead=lead),
        "wg": init_dense(gen, d, d, lead=lead),
        "wo": init_dense(gen, d, d, lead=lead),
        "w0": const((d,), -5.0),                         # decay base
        "w_lora_a": trunc_normal(gen, (*lead, d, LORA_R), d ** -0.5),
        "w_lora_b": trunc_normal(gen, (*lead, LORA_R, d), LORA_R ** -0.5),
        "u": trunc_normal(gen, (*lead, d), 0.5),         # current-token bonus
        "ln_scale": const((d,), 1.0),                    # per-head groupnorm
    }


def init_rwkv_channel_mix(gen: torch.Generator, cfg: ModelConfig,
                          lead: Tuple[int, ...] = ()) -> Params:
    return {
        "mu": torch.full((*lead, 2, cfg.d_model), 0.5, dtype=torch.float32,
                         device=gen_device(gen)),
        "wk": init_dense(gen, cfg.d_model, cfg.d_ff, lead=lead),
        "wv": init_dense(gen, cfg.d_ff, cfg.d_model, lead=lead),
    }


def _shift(x: Tensor, x_prev: Tensor) -> Tensor:
    """The previous token of every position: ``x_prev`` [B, d] then
    ``x[:, :-1]``."""
    return torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _ddlerp(p: Params, x: Tensor, x_prev: Tensor) -> Tuple[Tensor, ...]:
    """RWKV6 data-dependent token shift: 5 mixed streams (r, k, v, g, w).
    ``x_prev`` [B, T, d] is the shifted sequence."""
    dxprev = x_prev - x
    base = x + dxprev * p["mu"][:, None, None, :].to(x.dtype)  # [5,B,T,d]
    lora = torch.einsum("btd,dfr->fbtr", x + 0.5 * dxprev,
                        p["lora_a"].to(x.dtype))
    adj = torch.einsum("fbtr,frd->fbtd", torch.tanh(lora),
                       p["lora_b"].to(x.dtype))           # [5,B,T,d]
    mixed = base + dxprev[None] * adj
    return tuple(mixed[i] for i in range(5))


def _wkv_scan(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
              state0: Tensor) -> Tuple[Tensor, Tensor]:
    """Sequential WKV recurrence.  r, k, v: [B, T, H, hd]; w: [B, T, H, hd]
    decay in (0, 1); u: [H, hd]; state0: [B, H, hd, hd].  Returns (out
    [B, T, H, hd], state).  ``kᵀ_t v_t`` and ``u·kᵀ_t v_t`` are one rounding
    an element whichever step computes them, so they are made for
    ``WKV_CHUNK`` steps at once; each step then adds, contracts and decays
    in the reference's order."""
    s = state0
    outs = []
    for t0 in range(0, r.shape[1], WKV_CHUNK):
        kv = k[:, t0:t0 + WKV_CHUNK, :, :, None] \
            * v[:, t0:t0 + WKV_CHUNK, :, None, :]        # [B,C,H,hd,hd]
        ukv = u[None, None, :, :, None] * kv
        for i in range(kv.shape[1]):
            wkv = s + ukv[:, i]
            outs.append(torch.matmul(r[:, t0 + i, :, None, :],
                                     wkv)[..., 0, :])
            s = w[:, t0 + i, :, :, None] * s + kv[:, i]
    return torch.stack(outs, dim=1), s


def rwkv_time_mix(p: Params, x: Tensor, cfg: ModelConfig, abft: ABFTConfig,
                  x_prev: Tensor, state0: Tensor
                  ) -> Tuple[Tensor, Tensor, Tensor, List[Check]]:
    """x: [B, T, d]; x_prev: [B, d] (last token of the previous segment);
    state0: [B, H, hd, hd].  Returns (out, last x, state, checks)."""
    b, t, d = x.shape
    h = _heads(cfg)
    xr, xk, xv, xg, xw = _ddlerp(p, x, _shift(x, x_prev))

    r, c1 = dense(p["wr"], xr, abft)
    k, c2 = dense(p["wk"], xk, abft)
    v, c3 = dense(p["wv"], xv, abft)
    g, c4 = dense(p["wg"], xg, abft)
    dw = torch.tanh(xw @ p["w_lora_a"].to(x.dtype)) @ \
        p["w_lora_b"].to(x.dtype)
    w = torch.exp(-torch.exp(p["w0"].to(torch.float32)
                             + dw.to(torch.float32)))    # (0,1) decay

    hd = HEAD_SIZE
    f32 = torch.float32
    rh = r.reshape(b, t, h, hd).to(f32)
    kh = k.reshape(b, t, h, hd).to(f32)
    vh = v.reshape(b, t, h, hd).to(f32)
    wh = w.reshape(b, t, h, hd)
    u = p["u"].reshape(h, hd).to(f32)
    out, state = _wkv_scan(rh, kh, vh, wh, u, state0)

    # per-head group norm
    mu = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, unbiased=False)
    out = (out - mu) * torch.rsqrt(var + 1e-5)
    out = out.reshape(b, t, d).to(x.dtype) * p["ln_scale"].to(x.dtype)
    out = out * F.silu(g)
    y, c5 = dense(p["wo"], out, abft)
    return y, x[:, -1].clone(), state, c1 + c2 + c3 + c4 + c5


def rwkv_channel_mix(p: Params, x: Tensor, cfg: ModelConfig,
                     abft: ABFTConfig, x_prev: Tensor
                     ) -> Tuple[Tensor, Tensor, List[Check]]:
    """x: [B, T, d]; x_prev: [B, d].  Returns (out, last x, checks)."""
    del cfg
    dxprev = _shift(x, x_prev) - x
    xk = x + dxprev * p["mu"][0].to(x.dtype)
    k, c1 = dense(p["wk"], xk, abft)
    k = torch.square(F.relu(k))
    out, c2 = dense(p["wv"], k, abft)
    return out, x[:, -1].clone(), c1 + c2


def rwkv_state_init(cfg: ModelConfig, batch: int,
                    device=None) -> Dict[str, Tensor]:
    h = _heads(cfg)
    f32 = torch.float32
    return {
        "wkv": torch.zeros((batch, h, HEAD_SIZE, HEAD_SIZE), dtype=f32,
                           device=device),
        "x_tm": torch.zeros((batch, cfg.d_model), dtype=f32, device=device),
        "x_cm": torch.zeros((batch, cfg.d_model), dtype=f32, device=device),
    }
