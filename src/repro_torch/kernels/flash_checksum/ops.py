"""Public wrapper for the flash_checksum kernel: W_o folding into the carried
column and Check construction — plus the :class:`FlashAttentionOp`
CheckedOp that runs the whole A·V·W_o chain (flash attention + output
projection) as ONE checked op.

Counterpart of the JAX package's ``repro/kernels/flash_checksum/ops.py``.
The kernel indexes the key/value head of each query head and handles ragged
T and S itself, so nothing is repeated or padded here; there are no block
or ``interpret`` arguments.

Gradients.  :func:`flash_checksum` runs the kernel through
:class:`FlashChecksumFunction` when autograd records: the forward is the
launch (the plain version on the CPU); ``o_extra`` and the softmax
statistics are not differentiable and ``vr`` takes no gradient (the chain
check feeds the flag, never the loss); the backward recomputes
``softmax(q·kᵀ·dh^-0.5 + mask)·v`` in plain PyTorch
(:func:`attention_plain`) and differentiates it for dq, dk and dv.  The
reference has no attention backward kernel either: it differentiates its
plain streaming attention.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.abft import ABFTConfig, Check, CheckedOp
from repro_torch.kernels.matmul_abft.ops import matmul_abft

from .kernel import NEG, flash_checksum_kernel

Tensor = torch.Tensor


def attention_plain(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0) -> Tensor:
    """``softmax(q·kᵀ·dh^-0.5 + mask)·v`` in f32 with A materialized, the
    kernel's masks (query and key indices; ``window`` > 0 keeps key j for
    query i iff i - window < j <= i; ``causal=False`` keeps every key).
    q [B, T, H, dh], k and v [B, S, Kh, dh]; returns o [B, T, H, dh] f32.
    The backward of :class:`FlashChecksumFunction` differentiates it."""
    b, t, h, dh = q.shape
    s, kh = k.shape[1], k.shape[2]
    f32 = torch.float32
    ke = k.to(f32).repeat_interleave(h // kh, dim=2)
    ve = v.to(f32).repeat_interleave(h // kh, dim=2)
    sc = torch.einsum("bthd,bshd->bhts", q.to(f32), ke) * dh ** -0.5
    if causal:
        qpos = torch.arange(t, device=q.device)[:, None]
        kpos = torch.arange(s, device=q.device)[None, :]
        valid = kpos <= qpos
        if window > 0:
            valid = valid & (kpos > qpos - window)
        sc = torch.where(valid, sc, torch.full_like(sc, NEG))
    return torch.einsum("bhts,bshd->bthd", torch.softmax(sc, dim=-1), ve)


class FlashChecksumFunction(torch.autograd.Function):
    """``(o, o_extra[, m, l]) = FlashChecksumFunction.apply(q, k, v, vr,
    causal, window, with_stats)``: :func:`~.kernel.flash_checksum_kernel`
    with a plain recompute for its backward (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, vr, causal, window, with_stats):
        outs = flash_checksum_kernel(q, k, v, vr, causal=causal,
                                     window=window, with_stats=with_stats)
        ctx.save_for_backward(q, k, v)
        ctx.mask = dict(causal=causal, window=window)
        ctx.mark_non_differentiable(*(x for x in outs[1:] if x is not None))
        return outs

    @staticmethod
    def backward(ctx, do, *_rest):
        q, k, v = ctx.saved_tensors
        want = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [x.detach().requires_grad_(w) for x, w in zip((q, k, v),
                                                                 want)]
            o = attention_plain(*ins, **ctx.mask)
            got = iter(torch.autograd.grad(
                o, [x for x in ins if x.requires_grad], do.to(o.dtype)))
        grads = [next(got).to(x.dtype) if w else None
                 for x, w in zip((q, k, v), want)]
        return (*grads, None, None, None, None)


def flash_checksum(q: Tensor, k: Tensor, v: Tensor,
                   vr: Optional[Tensor] = None, *, causal: bool = True,
                   window: int = 0, with_stats: bool = False
                   ) -> Tuple[Tensor, ...]:
    """:func:`~.kernel.flash_checksum_kernel`, differentiable in q, k and
    v through :class:`FlashChecksumFunction` when autograd records (one
    launch either way; the same outputs bit for bit)."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashChecksumFunction.apply(q, k, v, vr, causal, window,
                                           with_stats)
    return flash_checksum_kernel(q, k, v, vr, causal=causal, window=window,
                                 with_stats=with_stats)


def carried_column(v: Tensor, w_or: Tensor, n_heads: int) -> Tensor:
    """vr [B, S, H] = V·w_or per query head, in V's dtype: query head h
    reads key/value head h // (H / Kh)."""
    b, s, kh, dh = v.shape
    w = w_or.to(torch.float32).reshape(kh, n_heads // kh, dh)
    vr = torch.einsum("bskd,kgd->bskg", v.to(torch.float32), w)
    return vr.reshape(b, s, n_heads).to(v.dtype).contiguous()


def flash_attention_checksum(q: Tensor, k: Tensor, v: Tensor, w_or: Tensor,
                             *, causal: bool = True) -> Tuple[Tensor, Tensor]:
    """q: [B,T,H,dh]; k,v: [B,S,Kh,dh]; w_or: [H,dh] = per-head W_o·e.

    Returns (o [B,T,H,dh], o_extra [B,T,H]): Σ o_extra equals the fused
    chain checksum eᵀ(A·V·W_o)e — compare against Σ(attn_out·W_o) with
    :func:`chain_check`.
    """
    vr = carried_column(v, w_or, q.shape[2]).to(q.dtype)
    return flash_checksum_kernel(q, k, v, vr, causal=causal)


def chain_check(o_extra: Tensor, out_after_wo: Tensor, *,
                granularity: str = "layer") -> Check:
    """Close the eq. 4–6 chain: Σ o_extra (the kernel's carried column,
    independent of the output path) vs Σ(attn_out·W_o).  Compare via
    ``Check.flag(cfg)``, whose ``~(d <= tau*scale)`` form flags NaN
    divergences instead of silently passing them."""
    return Check(predicted=o_extra.to(torch.float32).sum(),
                 actual=out_after_wo.to(torch.float32).sum(),
                 granularity=granularity)


def fold_w_or(wo: Tensor, n_heads: int, hd: int) -> Tensor:
    """Offline fold of the output projection's right checksum into the
    per-head carried-column form: ``w_or[h, dh]`` = the head-``h`` slice of
    W_o·e.  ``wo`` is ``[H*dh, d]`` (the ``init_dense`` layout)."""
    return wo.to(torch.float32).sum(dim=1).reshape(n_heads, hd)


class FlashAttentionOp(CheckedOp):
    """CheckedOp over the flash-checksum kernel: the three-matrix chain
    ``out = A · V · W_o`` (A never materialized) with the paper's single
    eq. 4–6 comparison carried as one extra accumulator column.

    ``out, check = op(cfg, q, k, v, wo, w_or=folded)`` where ``wo`` is the
    ``[H*dh, d]`` output projection and ``w_or`` its per-head folded right
    checksum (:func:`fold_w_or`; recomputed when absent).  The predicted
    side rides the kernel's carried column — computed from Q/K/V/w_or only,
    never from the output — so a fault anywhere in the attention
    accumulator or the W_o product trips the comparison.  The output
    projection runs on the matmul_abft kernel without its own check (the
    chain check covers it).
    """

    op_id = "flash_attention"

    def __init__(self, *, causal: bool = True):
        self.causal = causal

    def __call__(self, cfg: ABFTConfig, q: Tensor, k: Tensor, v: Tensor,
                 wo: Tensor, *, w_or: Optional[Tensor] = None):
        b, t, h, dh = q.shape
        if not cfg.enabled:
            o, _ = flash_checksum_kernel(q, k, v, None, causal=self.causal)
            out, _ = matmul_abft(o.reshape(b * t, h * dh), wo.to(o.dtype),
                                 with_check=False)
            return out.reshape(b, t, -1), None
        if w_or is None:
            w_or = fold_w_or(wo, h, dh)
        o, o_extra = flash_attention_checksum(q, k, v, w_or,
                                              causal=self.causal)
        out, _ = matmul_abft(o.reshape(b * t, h * dh), wo.to(o.dtype),
                             with_check=False)
        out = out.reshape(b, t, -1)
        return out, chain_check(o_extra, out)
