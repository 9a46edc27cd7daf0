"""Plain PyTorch float32 pieces of a decoder-only transformer, shared by the
references of each family (``dense_gqa.py``, ``moe.py``).

Written from the published descriptions, not from the program under test:
this package imports nothing of the port and nothing of JAX.  It reads the
weight tensors the benchmark drew, in the param-tree layout the benchmark
hands to the program (``bench/layouts/decoder.py``), and works everything
else out again.

Conventions (those of the configurations' ``assumed`` notes): RMSNorm
weights are held as ``1 + scale``; rotary embeddings turn interleaved pairs
``(x[2i], x[2i+1])`` of the first ``rope_frac`` of each head by angles
``pos / theta ** (2i / r)`` computed in float32; grouped-query attention
gives query head ``h`` the key/value head ``h // (H / Kh)``; a dense leaf
``{"w": [d_in, *out], "b": [*out]}`` is ``x @ w + b``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# bytes a block of attention scores may take
SCORE_BLOCK_BYTES = 1 << 28
# tokens a block of MLP rows may hold
ROW_BLOCK = 4096


def require_f32_matmul() -> None:
    """Raise unless float32 products run in float32 (TF32 off)."""
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise RuntimeError("the reference needs TF32 off: set "
                           "torch.backends.cuda.matmul.allow_tf32 and "
                           "torch.backends.cudnn.allow_tf32 to False")


def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    """RMSNorm computed in float32, returned in x's type."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps) * \
        (1.0 + scale)
    return y.to(x.dtype)


def linear(x: Tensor, leaf: Dict[str, Tensor]) -> Tensor:
    """x @ w (+ b) in x's type (the weights cast to it)."""
    w = leaf["w"].to(x.dtype)
    y = x @ w.reshape(w.shape[0], -1)
    if "b" in leaf:
        y = y + leaf["b"].reshape(-1).to(x.dtype)
    return y


def rope(x: Tensor, pos: Tensor, theta: float, frac: float) -> Tensor:
    """x [..., S, H, hd] turned at positions ``pos`` [S]."""
    hd = x.shape[-1]
    r = int(hd * frac)
    r -= r % 2
    if r == 0:
        return x
    exps = torch.arange(0, r, 2, dtype=torch.float32, device=x.device) / r
    freqs = 1.0 / (theta ** exps)
    ang = pos.to(torch.float32)[:, None] * freqs               # [S, r/2]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0:r:2].float(), x[..., 1:r:2].float()
    turned = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).reshape(*x.shape[:-1], r)
    return torch.cat([turned.to(x.dtype), x[..., r:]], dim=-1)


def causal_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Softmax attention of q [n, S, H, hd] over k, v [n, S, Kh, hd], query
    i seeing keys 0..i; computed in blocks of queries.  Returns
    [n, S, H * hd]."""
    n, s, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = q.reshape(n, s, kh, g, hd).permute(0, 2, 3, 1, 4)   # [n,Kh,G,S,hd]
    kt = k.permute(0, 2, 3, 1).unsqueeze(2)                  # [n,Kh,1,hd,S]
    vv = v.permute(0, 2, 1, 3).unsqueeze(2)                  # [n,Kh,1,S,hd]
    out = torch.empty_like(qg)
    qb = max(16, SCORE_BLOCK_BYTES // max(1, 4 * n * h * s))
    scale = hd ** -0.5
    for q0 in range(0, s, qb):
        q1 = min(s, q0 + qb)
        sc = (qg[..., q0:q1, :] @ kt[..., :q1]) * scale      # [n,Kh,G,b,q1]
        qi = torch.arange(q0, q1, device=q.device)[:, None]
        kj = torch.arange(q1, device=q.device)[None, :]
        sc = sc.float().masked_fill(kj > qi, float("-inf"))
        out[..., q0:q1, :] = torch.softmax(sc, dim=-1).to(q.dtype) @ \
            vv[..., :q1, :]
    return out.permute(0, 3, 1, 2, 4).reshape(n, s, h * hd)


def one_query_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Attention of one query q [H, hd] over all of k, v [P, Kh, hd]."""
    h, hd = q.shape
    kh = k.shape[1]
    qg = q.reshape(kh, h // kh, hd)
    sc = torch.einsum("kgd,pkd->kgp", qg, k).float() * hd ** -0.5
    o = torch.einsum("kgp,pkd->kgd", torch.softmax(sc, dim=-1).to(q.dtype), v)
    return o.reshape(h * hd)


def swiglu(x: Tensor, wi: Tensor, wg: Tensor, wo: Tensor) -> Tensor:
    """(silu(x wg) * (x wi)) wo, wi and wg [d, f], wo [f, d], in x's
    type."""
    dt = x.dtype
    return (F.silu(x @ wg.to(dt)) * (x @ wi.to(dt))) @ wo.to(dt)


def dense_mlp(lp: dict, h: Tensor) -> Tensor:
    """The gated MLP of a layer over rows h [N, d], in blocks of rows."""
    wi, wg, wo = (lp[k]["w"] for k in ("wi", "wg", "wo"))
    out = torch.empty_like(h)
    for r0 in range(0, h.shape[0], ROW_BLOCK):
        out[r0:r0 + ROW_BLOCK] = swiglu(h[r0:r0 + ROW_BLOCK], wi, wg, wo)
    return out


def layer_params(params: dict, layer: int) -> dict:
    """Layer ``layer``'s leaves (every segment holds one block type,
    ``b0``, stacked on a leading layer axis)."""
    seen = 0
    for seg in params["segments"]:
        count = next(iter(_leaves(seg))).shape[0]
        if layer < seen + count:
            return _index(seg["b0"], layer - seen)
        seen += count
    raise IndexError(layer)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


class Capture:
    """What :func:`forward` keeps for a family that revisits positions:
    each layer's keys and values (after RoPE) and, at the compared
    positions, each layer's input."""

    def __init__(self):
        self.k: List[Tensor] = []
        self.v: List[Tensor] = []
        self.x_in: List[Tensor] = []


def attention_block(lp: dict, x: Tensor, run: dict, pos: Tensor):
    """A layer's attention sublayer over x [n, S, d]: (output, k, v)."""
    n, s, _ = x.shape
    h_, kh, hd = run["n_heads"], run["n_kv_heads"], run["head_dim"]
    h = rms_norm(x, lp["ln1"]["scale"], run["norm_eps"])
    a = lp["attn"]
    q = linear(h, a["wq"]).reshape(n, s, h_, hd)
    k = linear(h, a["wk"]).reshape(n, s, kh, hd)
    v = linear(h, a["wv"]).reshape(n, s, kh, hd)
    q = rope(q, pos, run["rope_theta"], run["rope_frac"])
    k = rope(k, pos, run["rope_theta"], run["rope_frac"])
    o = causal_attention(q, k, v)
    return o @ a["wo"]["w"].to(o.dtype), k, v


def forward(params: dict, run: dict, tokens: Tensor, positions: List[int],
            mlp_fn: Callable[[dict, Tensor, int], Tensor],
            capture: Optional[Capture] = None,
            dtype: torch.dtype = torch.float32) -> Tensor:
    """Logits [n, len(positions), V] (float32) at ``positions`` of tokens
    [n, S] (positions 0..S-1).  ``mlp_fn(layer_params, h [n*S, d], layer)``
    is the family's MLP sublayer on the normed rows.  ``dtype`` is the type
    of every product and of the residual stream (bfloat16: the lower
    precision's control); norms, RoPE angles and softmax stay float32."""
    if dtype == torch.float32:
        require_f32_matmul()
    n, s = tokens.shape
    pos = torch.arange(s, device=tokens.device)
    at = torch.tensor(positions, device=tokens.device)
    x = params["embed"]["table"][tokens.long()].to(dtype)
    for layer in range(run["n_layers"]):
        lp = layer_params(params, layer)
        if capture is not None:
            capture.x_in.append(x[:, at].clone())
        y, k, v = attention_block(lp, x, run, pos)
        if capture is not None:
            capture.k.append(k)
            capture.v.append(v)
        x = x + y
        h = rms_norm(x, lp["ln2"]["scale"], run["norm_eps"])
        x = x + mlp_fn(lp, h.reshape(n * s, -1), layer).reshape(x.shape)
    return head(params, run, x[:, at])


def head(params: dict, run: dict, x: Tensor) -> Tensor:
    """Logits of final-layer residuals x [..., d]."""
    h = rms_norm(x, params["final_norm"]["scale"], run["norm_eps"])
    if run["tie_embeddings"]:
        logits = h @ params["embed"]["table"].T.to(h.dtype)
    else:
        logits = h @ params["head"]["w"].to(h.dtype)
    logits = logits.float()
    # rows of a vocabulary padded for sharding are never a token
    return logits.masked_fill(
        torch.arange(logits.shape[-1], device=logits.device)
        >= run["vocab_size"], -1e30)
