"""Shared model components: norms, activations, RoPE, dense layers, embeds.

Counterpart of the JAX package's ``repro/models/common.py``.  Plain
functions on tensors; ``init_*`` draws from a ``torch.Generator``.  Every
matmul-bearing block takes an :class:`~repro_torch.core.abft.ABFTConfig`
and returns the checks it performed.  Every dense product — checked or not
— runs through :class:`MatmulAbftOp`, i.e. the ``matmul_abft`` CUDA kernel
for tensors on the card and its plain version on the CPU, so a guarded and
an unguarded step compute their products with the same code.

Numerics copied as the reference has them: ``rms_norm`` always scales by
``1 + scale`` (``cfg.rms_offset`` is not read), GELU is the tanh
approximation (``jax.nn.gelu``'s default), RoPE rotates interleaved pairs
(``x[..., ::2]``, ``x[..., 1::2]``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.abft import ABFTConfig, Check
from repro_torch.kernels import acc_dtype
from repro_torch.kernels.matmul_abft.ops import MatmulAbftOp, matmul_abft

Tensor = torch.Tensor
Params = Dict[str, Any]


def cdtype(cfg: ModelConfig) -> torch.dtype:
    """The compute dtype: bfloat16 or float32 as served; ``"float64"`` is
    a witness run of the plain versions on the CPU (every accumulation
    then in float64, :func:`~repro_torch.kernels.acc_dtype`)."""
    return {"bfloat16": torch.bfloat16,
            "float64": torch.float64}.get(cfg.dtype, torch.float32)


# ---------------------------------------------------------------------------
# initializers — params are stored in float32; compute casts per-config.
# ``lead`` prepends stack axes (the layer axis of a segment), as the
# reference's vmapped init does.
# ---------------------------------------------------------------------------

def gen_device(gen: Optional[torch.Generator]) -> torch.device:
    """Where ``gen`` draws; ``None`` builds shapes only, on ``meta``."""
    return torch.device("meta") if gen is None else gen.device


def trunc_normal(gen: Optional[torch.Generator], shape: Sequence[int],
                 std: float) -> Tensor:
    """``std`` x a normal truncated to [-2, 2], on ``gen``'s device."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen_device(gen))
    if gen is None:
        return t
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std)


def init_dense(gen: torch.Generator, d_in: int,
               d_out: Union[Tuple[int, ...], int], bias: bool = False,
               lead: Tuple[int, ...] = ()) -> Params:
    if isinstance(d_out, int):
        d_out = (d_out,)
    p = {"w": trunc_normal(gen, (*lead, d_in, *d_out), 1.0 / math.sqrt(d_in))}
    if bias:
        p["b"] = torch.zeros((*lead, *d_out), dtype=torch.float32,
                             device=gen_device(gen))
    return p


def init_norm(d: int, lead: Tuple[int, ...] = (), device=None) -> Params:
    return {"scale": torch.zeros((*lead, d), dtype=torch.float32,
                                 device=device)}   # offset-style (1 + w)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x: Tensor, p: Params, eps: float, offset_base: float = 1.0
             ) -> Tensor:
    dt = x.dtype
    x = x.to(acc_dtype(dt))
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * (offset_base + p["scale"])
    return y.to(dt)


def layer_norm(x: Tensor, p: Params, eps: float) -> Tensor:
    dt = x.dtype
    x = x.to(acc_dtype(dt))
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps) * (1.0 + p["scale"])
    if "bias" in p:
        y = y + p["bias"]
    return y.to(dt)


def norm_apply(x: Tensor, p: Params, cfg) -> Tensor:
    if getattr(cfg, "norm", "rms") == "ln":
        return layer_norm(x, p, cfg.norm_eps)
    return rms_norm(x, p, cfg.norm_eps)


def sinusoid_positions(positions: Tensor, d: int, dtype) -> Tensor:
    """[B, T] -> [B, T, d] standard transformer sinusoids: the sines of the
    first ``d // 2`` frequencies, then their cosines, the frequencies
    ``10000^(-i / (half - 1))`` as the reference spaces them."""
    half = d // 2
    f32 = acc_dtype(dtype)
    i = torch.arange(half, dtype=f32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * i / max(half - 1, 1))
    ang = positions[..., None].to(f32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def gelu(x: Tensor) -> Tensor:
    """The tanh approximation, as ``jax.nn.gelu`` computes by default."""
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"gelu": gelu, "silu": F.silu, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# RoPE (full / partial "2d" à la ChatGLM / none)
# ---------------------------------------------------------------------------

def rope_freqs(hd_rot: int, theta: float, device=None,
               dtype: torch.dtype = torch.float32) -> Tensor:
    exps = torch.arange(0, hd_rot, 2, dtype=dtype, device=device) / hd_rot
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float,
               frac: float = 1.0) -> Tensor:
    """x: [B, T, H, hd]; positions: [B, T].  frac < 1 rotates only the first
    frac*hd dims (ChatGLM-style partial/2d RoPE).  Pairs are interleaved:
    (x[..., 0], x[..., 1]), (x[..., 2], x[..., 3]), ..."""
    hd = x.shape[-1]
    hd_rot = int(hd * frac)
    hd_rot -= hd_rot % 2
    if hd_rot == 0:
        return x
    xr, xp = x[..., :hd_rot], x[..., hd_rot:]
    f32 = acc_dtype(x.dtype)
    freqs = rope_freqs(hd_rot, theta, x.device, f32)         # [hd_rot/2]
    ang = positions[..., None].to(f32) * freqs               # [B,T,hd_rot/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    xr = torch.stack([out1, out2], dim=-1).reshape(xr.shape)
    return torch.cat([xr, xp.to(xr.dtype)], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, vocab: int, d: int) -> Params:
    return {"table": trunc_normal(gen, (vocab, d), 1.0)}


def embed(p: Params, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    """The table's rows of ``tokens``, in the compute dtype (scaled by
    sqrt(d) where the config asks).  The lookup is ``F.embedding``, a
    gather equal to ``table[tokens]``, whose backward on the card sorts the
    tokens and sums each token's rows in a fixed order (indexing's backward
    may add repeated tokens' rows with atomics): two train steps of one
    batch give the table's gradient bit for bit."""
    x = F.embedding(tokens.long(), p["table"]).to(cdtype(cfg))
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def unembed(p: Params, x: Tensor, cfg: ModelConfig,
            abft: ABFTConfig) -> Tuple[Tensor, List[Check]]:
    """Logits against the embedding table (tied) or a head weight; one
    split check.  The table is multiplied as it lies (``trans_b``)."""
    b, t, d = x.shape
    x2 = x.reshape(-1, d).contiguous()
    tied = "table" in p
    w = (p["table"] if tied else p["w"]).to(cdtype(cfg))
    br = None
    if abft.enabled:
        br = w.to(abft.dtype).sum(dim=0 if tied else 1)
    logits, chk = matmul_abft(x2, w, br, trans_b=tied,
                              with_check=abft.enabled)
    return (logits.reshape(b, t, -1).to(acc_dtype(logits.dtype)),
            [chk] if chk is not None else [])


# ---------------------------------------------------------------------------
# checked dense application (split-ABFT unit for isolated matmuls)
# ---------------------------------------------------------------------------

_DENSE = MatmulAbftOp()


def dense(p: Params, x: Tensor, abft: ABFTConfig,
          out_axes: int = 1) -> Tuple[Tensor, List[Check]]:
    """y = x @ w (+ b).  x: [..., d_in]; w: [d_in, *out].  The product and
    its ABFT check run through :class:`MatmulAbftOp` on the 2-D flattened
    operands — one scalar check per call: the ``matmul_abft`` kernel on
    the card, its plain version on the CPU.

    A folded right checksum ``p["w_r"]`` ([d_in], from ``fold_w_r_tree`` at
    weight load — the paper's offline eq.-5 convention) is the kernel's
    ``b_r``: the predicted side then comes from the *master* weights, so a
    post-load weight corruption trips the check (a recomputed row-sum of the
    corrupted W would cancel it).  A fold whose shape doesn't match this
    call's flattened layout is ignored, not misapplied."""
    del out_axes
    w = p["w"].to(x.dtype)
    d_in = w.shape[0]
    out_shape = w.shape[1:]
    x2 = x.reshape(-1, d_in).contiguous()
    w2 = w.reshape(d_in, -1)
    w_r = p.get("w_r") if abft.enabled else None
    if w_r is not None and tuple(w_r.shape) != (d_in,):
        w_r = None
    y2, chk = _DENSE(abft, x2, w2, w_r=w_r)
    y = y2.reshape(*x.shape[:-1], *out_shape)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y, ([chk] if chk is not None else [])
