"""Attention: GQA/MQA, RoPE, KV caches — with the paper's fused ABFT chain
check adapted to streaming (flash) attention.

Counterpart of the JAX package's ``repro/models/attention.py``.  The ABFT
adaptation: the attention output path is the three-matrix chain
O = A · V · W_o with A = softmax(QKᵀ) in the role of the GCN's adjacency S,
so eᵀ(A V W_o)e = (eᵀA) · V · (W_o e).  A streaming softmax never
materializes A, so the right end of the chain is folded instead:
vr = V·w_or with w_or = W_o·e, carried as ONE extra accumulator column,
o_extra = A·vr, and Σ_q o_extra = eᵀ(A V W_o)e.

Where the work runs:

* prefill attention runs through the ``flash_checksum`` kernel — the
  CUDA kernel for tensors on the card, its plain version on the CPU;
  differentiable through its autograd Function — with the ``vr`` column
  this block computes (fused mode) or emitting the softmax statistics m
  and l (split mode), in three cases: causal self-attention over
  positions 0..T-1 with or without a sliding window, non-causal
  self-attention over 0..T-1 (an encoder), and non-causal cross-attention
  from T queries to S keys at positions 0..S-1 (a decoder over its
  encoder's output; the mask reads no query position);
* the split baseline's second scoring pass (:func:`_split_second_pass`)
  is plain PyTorch on every device, as the reference computes it outside
  any Pallas kernel, from the kernel's m and l;
* any other prefill attention (a non-causal window, causal
  cross-attention, positions that are not 0..T-1) is plain PyTorch
  (:func:`streaming_attention`) on the CPU and raises
  ``NotImplementedError`` on the card: the kernel does not take it, and
  the port does not fall back;
* decode attention (one query over the ring-buffer cache, position-masked,
  or over the static encoder cache) is plain PyTorch on every device, as
  the JAX package computes it outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.abft import ABFTConfig, Check
from repro_torch.kernels import acc_dtype
from repro_torch.kernels.flash_checksum.ops import flash_checksum
from repro_torch.models.common import apply_rope, dense, init_dense

Tensor = torch.Tensor
Params = Dict[str, Any]

NEG = -1e30
_FAR = 2 ** 30          # position of an unwritten cache slot / padded key


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   cross: bool = False, lead: Tuple[int, ...] = ()
                   ) -> Params:
    del cross
    hd = cfg.hd
    return {
        "wq": init_dense(gen, cfg.d_model, (cfg.n_heads, hd), cfg.qkv_bias,
                         lead),
        "wk": init_dense(gen, cfg.d_model, (cfg.n_kv_heads, hd),
                         cfg.qkv_bias, lead),
        "wv": init_dense(gen, cfg.d_model, (cfg.n_kv_heads, hd),
                         cfg.qkv_bias, lead),
        "wo": init_dense(gen, cfg.n_heads * hd, cfg.d_model, lead=lead),
    }


def _fold_wo_checkcol(p: Params, cfg: ModelConfig, dtype) -> Tensor:
    """w_or[h, hd] = per-head slice of W_o · e (offline in deployment).

    Consumes the tree-generic ``fold_w_r_tree`` fold when present
    (``p["wo"]["w_r"]``, [H*hd]) — the carried column then predicts from
    the load-time master weights, so a post-load W_o corruption trips the
    chain check instead of cancelling."""
    w_r = p["wo"].get("w_r")
    if w_r is not None and tuple(w_r.shape) == (cfg.n_heads * cfg.hd,):
        return w_r.to(torch.float32).reshape(cfg.n_heads, cfg.hd).to(dtype)
    wo = p["wo"]["w"].to(torch.float32)               # [H*hd, d]
    return wo.sum(dim=1).reshape(cfg.n_heads, cfg.hd).to(dtype)


# ---------------------------------------------------------------------------
# fault-injection hook: the attention-accumulator site, mirroring the GCN
# kernels' inject= tuple.
# ---------------------------------------------------------------------------

_ATTN_INJECT: Dict[str, Optional[float]] = {"value": None}


class attention_fault_injection:
    """Bind a delta to the attention-accumulator inject site.

    The model entry points (``model_prefill`` / ``model_decode`` with
    ``attn_inject=...``) set this around their body so that every
    attention call inside adds the same delta to element 0 of its
    accumulator O = A·V (every layer: per-layer addressing goes through
    the weight sites instead).  An accumulator upset is exactly what the
    eq. 4–6 chain check must catch, because the carried column o_extra is
    accumulated independently."""

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        self._prev = _ATTN_INJECT["value"]
        _ATTN_INJECT["value"] = self.value
        return self

    def __exit__(self, *exc):
        _ATTN_INJECT["value"] = self._prev
        return False


def _maybe_inject(o: Tensor) -> Tensor:
    val = _ATTN_INJECT["value"]
    if val is None:
        return o
    o = o.clone()
    flat = o.view(-1)
    flat[0] = flat[0] + torch.as_tensor(val, dtype=flat.dtype,
                                        device=flat.device)
    return o


def _project_qkv(p: Params, x: Tensor, kv_x: Tensor, cfg: ModelConfig,
                 abft: ABFTConfig) -> Tuple[Tensor, Tensor, Tensor,
                                            List[Check]]:
    q, c1 = dense(p["wq"], x, abft)
    k, c2 = dense(p["wk"], kv_x, abft)
    v, c3 = dense(p["wv"], kv_x, abft)
    return q, k, v, c1 + c2 + c3


def _group(q: Tensor, n_kv: int) -> Tensor:
    """[B,T,H,hd] -> [B,T,Kh,G,hd]"""
    b, t, h, hd = q.shape
    return q.reshape(b, t, n_kv, h // n_kv, hd)


def _mask(kp: Tensor, qp: Tensor, causal: bool, window: int) -> Tensor:
    """Validity of keys at positions ``kp`` [B,1,1,1,c] for queries at
    ``qp`` [B,T,1,1,1]."""
    valid = (kp <= qp) if causal else (kp < _FAR)
    if window > 0:
        valid = valid & (kp > qp - window)
    return valid


def streaming_attention(
    q: Tensor, k: Tensor, v: Tensor, vr: Optional[Tensor], *,
    q_positions: Tensor, k_positions: Tensor, causal: bool, window: int,
    chunk: int,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    """Online-softmax attention over KV chunks (never materializes A), in
    plain PyTorch.

    q: [B,T,H,hd]; k,v: [B,S,Kh,hd]; vr: [B,S,H] fused-ABFT check column.
    q_positions: [B,T] absolute positions; k_positions: [B,S] (entries > any
    q position are treated as invalid/future and masked).
    Returns (o [B,T,H,hd], o_extra [B,T,H] | None, m [B,T,H], l [B,T,H]).
    """
    b, t, h, hd = q.shape
    s = k.shape[1]
    kh = k.shape[2]
    g = h // kh
    f32 = acc_dtype(q.dtype)
    qg = _group(q, kh)                                    # [B,T,Kh,G,hd]
    vrg = vr.reshape(b, s, kh, g) if vr is not None else None
    scale = hd ** -0.5
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_positions = torch.nn.functional.pad(k_positions, (0, pad),
                                              value=_FAR)
        if vrg is not None:
            vrg = torch.nn.functional.pad(vrg, (0, 0, 0, 0, 0, pad))
    qp_b = q_positions[:, :, None, None, None]            # [B,T,1,1,1]

    if n_chunks == 1:
        # single-shot path (decode T=1, short contexts)
        sc = torch.einsum("btkgh,bskh->btkgs", qg.to(f32), k.to(f32)) * scale
        valid = _mask(k_positions[:, None, None, None, :], qp_b, causal,
                      window)
        sc = torch.where(valid, sc, torch.full_like(sc, NEG))
        m = sc.amax(dim=-1)
        p = torch.where(valid, torch.exp(sc - m[..., None]),
                        torch.zeros_like(sc))
        l = p.sum(dim=-1)
        lsafe = torch.clamp(l, min=1e-30)
        o = torch.einsum("btkgs,bskh->btkgh", p.to(v.dtype).to(f32),
                         v.to(f32)) / lsafe[..., None]
        o_extra = None
        if vrg is not None:
            ex = torch.einsum("btkgs,bskg->btkg", p.to(vrg.dtype).to(f32),
                              vrg.to(f32)) / lsafe
            o_extra = ex.reshape(b, t, h)
        return (o.reshape(b, t, h, hd), o_extra,
                m.reshape(b, t, h), l.reshape(b, t, h))

    m = torch.full((b, t, kh, g), NEG, dtype=f32, device=q.device)
    l = torch.zeros((b, t, kh, g), dtype=f32, device=q.device)
    acc = torch.zeros((b, t, kh, g, hd), dtype=f32, device=q.device)
    ex = torch.zeros((b, t, kh, g), dtype=f32, device=q.device)
    for c0 in range(0, n_chunks * chunk, chunk):
        kch, vch = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        kp = k_positions[:, c0:c0 + chunk]
        sc = torch.einsum("btkgh,bskh->btkgs", qg.to(f32),
                          kch.to(f32)) * scale
        valid = _mask(kp[:, None, None, None, :], qp_b, causal, window)
        sc = torch.where(valid, sc, torch.full_like(sc, NEG))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        p = torch.where(valid, p, torch.zeros_like(p))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "btkgs,bskh->btkgh", p.to(vch.dtype).to(f32), vch.to(f32))
        if vrg is not None:
            vrch = vrg[:, c0:c0 + chunk]
            ex = ex * corr + torch.einsum(
                "btkgs,bskg->btkg", p.to(vrch.dtype).to(f32), vrch.to(f32))
        m = m_new
    lsafe = torch.clamp(l, min=1e-30)
    o = (acc / lsafe[..., None]).reshape(b, t, h, hd)
    o_extra = (ex / lsafe).reshape(b, t, h) if vr is not None else None
    return o, o_extra, m.reshape(b, t, h), l.reshape(b, t, h)


def _split_second_pass(q, k, v, m, l, *, q_positions, k_positions, causal,
                       window, chunk, dtype_acc) -> Tensor:
    """Second scoring pass for baseline split ABFT: accumulates the
    predicted checksum (eᵀA)(V e) and nothing else.  Cost ≈ one extra score
    matmul.  Returns predicted [B]."""
    del dtype_acc
    b, t, h, hd = q.shape
    s = k.shape[1]
    kh = k.shape[2]
    g = h // kh
    f32 = torch.float32
    qg = _group(q, kh).to(f32)
    scale = hd ** -0.5
    mg = m.reshape(b, t, kh, g)
    lg = torch.clamp(l.reshape(b, t, kh, g), min=1e-30)
    ve = v.to(f32).sum(dim=-1)                            # [B,S,Kh] = V e
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        ve = torch.nn.functional.pad(ve, (0, 0, 0, pad))
        k_positions = torch.nn.functional.pad(k_positions, (0, pad),
                                              value=_FAR)
    qp_b = q_positions[:, :, None, None, None]
    pred = torch.zeros((b,), dtype=f32, device=q.device)
    for c0 in range(0, n_chunks * chunk, chunk):
        kch, vech = k[:, c0:c0 + chunk].to(f32), ve[:, c0:c0 + chunk]
        kp = k_positions[:, c0:c0 + chunk]
        sc = torch.einsum("btkgh,bskh->btkgs", qg, kch) * scale
        valid = _mask(kp[:, None, None, None, :], qp_b, causal, window)
        p = torch.where(valid, torch.exp(sc - mg[..., None]),
                        torch.zeros_like(sc)) / lg[..., None]
        # predicted += Σ_q A[q, s_chunk] · (V e)[s_chunk]
        pred = pred + torch.einsum("btkgs,bsk->b", p, vech)
    return pred


def _flash_path(q: Tensor, causal: bool, window: int, cross: bool,
                queries_are_indices: bool, keys_are_indices: bool) -> bool:
    """True when prefill attention goes through the flash_checksum kernel:
    causal self-attention (any window) or non-causal self-attention (no
    window) over positions 0..T-1, or non-causal cross-attention (no
    window) over keys at 0..S-1.  Raises on the card for any other case."""
    if cross:
        ok = not causal and window == 0 and keys_are_indices
    else:
        ok = (causal or window == 0) and queries_are_indices \
            and keys_are_indices
    if not ok and q.is_cuda:
        raise NotImplementedError(
            f"attention on the card runs only through the flash_checksum "
            f"kernel, which takes causal self-attention over positions "
            f"0..T-1 (with or without a sliding window), non-causal "
            f"self-attention over 0..T-1 and non-causal cross-attention over "
            f"keys at 0..S-1, both without a window (got causal={causal}, "
            f"window={window}, cross={cross}, query positions 0..T-1: "
            f"{queries_are_indices}, key positions 0..S-1: "
            f"{keys_are_indices}); other cases are still to port (ROADMAP "
            f"A10.10)")
    return ok


def _are_indices(given: Optional[Tensor], n: int) -> bool:
    """``given`` positions [B, n] are 0..n-1 in every row (``None``: they
    are); compared on the device (one host sync)."""
    if given is None:
        return True
    want = torch.arange(n, device=given.device)[None].expand(given.shape[0],
                                                             n)
    return bool(torch.equal(given.to(want.dtype), want))


def attention_block(
    p: Params, x: Tensor, cfg: ModelConfig, abft: ABFTConfig, *,
    kv_x: Optional[Tensor] = None,
    positions: Optional[Tensor] = None,
    kv_positions: Optional[Tensor] = None,
    causal: Optional[bool] = None,
    window: int = 0,
    use_rope: bool = True,
) -> Tuple[Tensor, List[Check], Tuple[Tensor, Tensor, Tensor,
                                      Optional[Tensor]]]:
    """Self- (or cross-) attention for prefill.  x: [B,T,d].
    Also returns (k, v, kv_positions, vr) — roped keys + the fused-check
    column, for cache building."""
    b, t, _ = x.shape
    cross = kv_x is not None
    kv_x = x if kv_x is None else kv_x
    s = kv_x.shape[1]
    dev = x.device
    causal = cfg.causal if causal is None else causal
    # positions=None is the prompt from its start, kv_positions=None the
    # queries' positions (self-attention) or 0..S-1 (cross-attention)
    q_idx = _are_indices(positions, t)
    if kv_positions is not None:
        k_idx = _are_indices(kv_positions, s)
    else:
        k_idx = True if cross else q_idx
    flash = _flash_path(x, causal, window, cross, q_idx, k_idx)
    if positions is None:
        positions = torch.arange(t, device=dev)[None].expand(b, t)
    if kv_positions is None:
        kv_positions = positions if not cross else \
            torch.arange(s, device=dev)[None].expand(b, s)

    q, k, v, checks = _project_qkv(p, x, kv_x, cfg, abft)
    if use_rope and cfg.rope_frac > 0:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_frac)
        k = apply_rope(k, kv_positions, cfg.rope_theta, cfg.rope_frac)

    vr = None
    if abft.mode == "fused":
        w_or = _fold_wo_checkcol(p, cfg, q.dtype)         # [H, hd]
        g = cfg.kv_groups
        w_org = w_or.reshape(cfg.n_kv_heads, g, cfg.hd)
        vr = torch.einsum("bskh,kgh->bskg", v.to(q.dtype),
                          w_org).reshape(b, s, cfg.n_heads)

    split = abft.mode == "split"
    if flash:
        # split mode: the kernel's row statistics feed the second pass
        o, o_extra, *ml = flash_checksum(
            q.contiguous(), k.contiguous(), v.contiguous(),
            None if vr is None else vr.contiguous(), causal=causal,
            window=window, with_stats=split)
        m, l = ml if split else (None, None)
    else:
        o, o_extra, m, l = streaming_attention(
            q, k, v, vr, q_positions=positions, k_positions=kv_positions,
            causal=causal, window=window, chunk=min(cfg.attn_chunk, s))
    o = _maybe_inject(o)

    out, oc = dense(p["wo"], o.reshape(b, t, -1).to(x.dtype),
                    abft if abft.mode == "split" else
                    ABFTConfig(mode="none"))
    checks += oc

    if abft.mode == "fused":
        pred = o_extra.to(torch.float32).sum()
        actual = out.to(abft.dtype).sum()
        checks.append(Check(predicted=pred, actual=actual))
    elif split:
        pred = _split_second_pass(
            q, k, v, m, l, q_positions=positions, k_positions=kv_positions,
            causal=causal, window=window, chunk=min(cfg.attn_chunk, s),
            dtype_acc=abft.dtype).sum()
        checks.append(Check(predicted=pred,
                            actual=o.to(abft.dtype).sum()))
    return out, checks, (k, v, kv_positions, vr)


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, length: int, dtype,
               device=None) -> Params:
    """Ring-buffer KV cache for one attention layer.  ``vr`` is the
    fused-ABFT check column V·w_or cached incrementally, so the per-step
    check is O(1) in the cache length."""
    hd = cfg.hd
    return {
        "k": torch.zeros((batch, length, cfg.n_kv_heads, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, length, cfg.n_kv_heads, hd), dtype=dtype,
                         device=device),
        "vr": torch.zeros((batch, length, cfg.n_heads), dtype=dtype,
                          device=device),
        "pos": torch.full((batch, length), _FAR, dtype=torch.int32,
                          device=device),              # unwritten -> masked
    }


def _masked_update(buf: Tensor, new: Tensor, slot: int) -> Tensor:
    """Ring-buffer write of ``new`` [B, 1, ...] at ``slot`` into a copy of
    ``buf`` [B, length, ...]."""
    out = buf.clone()
    out[:, slot] = new[:, 0].to(buf.dtype)
    return out


def attention_decode(
    p: Params, x: Tensor, cache: Params, pos: int, cfg: ModelConfig,
    abft: ABFTConfig, *, window: int = 0, use_rope: bool = True,
) -> Tuple[Tensor, Params, List[Check]]:
    """One-token decode.  x: [B,1,d]; pos: the current position.  The cache
    is a ring buffer of fixed length; its ``pos`` entries give absolute
    positions for masking."""
    b = x.shape[0]
    pos = int(pos)
    length = cache["k"].shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)

    q, c1 = dense(p["wq"], x, abft)
    k_new, c2 = dense(p["wk"], x, abft)
    v_new, c3 = dense(p["wv"], x, abft)
    checks = c1 + c2 + c3
    if use_rope and cfg.rope_frac > 0:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_frac)
        k_new = apply_rope(k_new, positions, cfg.rope_theta, cfg.rope_frac)

    slot = pos % length
    k = _masked_update(cache["k"], k_new, slot)
    v = _masked_update(cache["v"], v_new, slot)
    kpos = _masked_update(cache["pos"], positions, slot)
    new_cache = {"k": k, "v": v, "pos": kpos, "vr": cache["vr"]}

    vr = None
    if abft.mode == "fused":
        # incremental check-column update: fold w_or through the NEW
        # token's V only; history is already cached
        w_or = _fold_wo_checkcol(p, cfg, q.dtype)
        g = cfg.kv_groups
        w_org = w_or.reshape(cfg.n_kv_heads, g, cfg.hd)
        vr_new = torch.einsum("bskh,kgh->bskg", v_new.to(q.dtype),
                              w_org).reshape(b, 1, cfg.n_heads)
        vr = _masked_update(cache["vr"], vr_new, slot)
        new_cache["vr"] = vr
        vr = vr.to(q.dtype)

    # single-shot attention for T=1 (chunk = full length)
    o, o_extra, m, l = streaming_attention(
        q, k, v, vr, q_positions=positions, k_positions=kpos,
        causal=True, window=window, chunk=length)
    o = _maybe_inject(o)

    out, oc = dense(p["wo"], o.reshape(b, 1, -1).to(x.dtype),
                    abft if abft.mode == "split" else ABFTConfig(mode="none"))
    checks += oc
    if abft.mode == "fused":
        checks.append(Check(predicted=o_extra.to(torch.float32).sum(),
                            actual=out.to(abft.dtype).sum()))
    elif abft.mode == "split":
        pred = _split_second_pass(
            q, k, v, m, l, q_positions=positions, k_positions=kpos,
            causal=True, window=window, chunk=min(cfg.attn_chunk, length),
            dtype_acc=abft.dtype).sum()
        checks.append(Check(predicted=pred, actual=o.to(abft.dtype).sum()))
    return out, new_cache, checks
