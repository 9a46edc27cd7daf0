"""Plain float32 reference of a decoder whose MLPs are mixtures of experts
(deepseek-moe-16b: 64 routed experts of width 1408, top-6 with the gates
divided by their sum, 2 shared experts as one gated MLP of width 2816).

Routing as DeepSeekMoE and GShard describe it, over the tokens of one call
in (token, slot) order: a float32 softmax over the router's logits, the
top ``k`` experts, their probabilities divided by their sum; an expert
holds at most ``max(int(N * k * cf / E), k)`` assignments, later ones are
dropped.  A token's output is the gate-weighted sum of its kept experts'
SwiGLU MLPs plus the shared experts' MLP.

Near ties.  Where a compared position's k-th and (k+1)-th router logits lie
closer than ``tie``, float32 rounding may put either expert in the top k,
in the program as here: directly, or through an earlier position's own
near tie, which reaches the compared position through attention and moves
its router logits by up to a few thousandths (``tie`` is a cell's setting).
For each such position the reference then also follows the position alone
through the remaining layers with the two swapped (up to ``MAX_TIES`` such
layers, the closest ones, in every combination), over the keys and values
the main pass kept, and returns every outcome as a candidate: the
comparison takes the candidate nearest the program's logits.  What an
earlier position's near tie does to a compared position besides, the
limits absorb."""
from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from bench.reference import common

Tensor = torch.Tensor

MAX_TIES = 4
# router logit gap counted as a near tie anywhere in a sequence (reported
# only: a few dozen float32 roundings of a logit)
NEAR = 1e-4


def capacity(tokens: int, mc: dict) -> int:
    return max(int(tokens * mc["top_k"] * mc["capacity_factor"]
                   / mc["n_experts"]), mc["top_k"])


def _experts(lp: dict, h: Tensor, ex: Tensor, gates: Tensor, keep: Tensor
             ) -> Tensor:
    """Σ over kept (token, slot) of gate · expert(h[token]); h [N, d],
    ex / gates / keep [N, k]."""
    moe = lp["moe"]
    n, k = ex.shape
    flat_e = ex.reshape(-1)
    tok = torch.arange(n, device=h.device).repeat_interleave(k)
    sel = keep.reshape(-1)
    flat_e, tok, g = flat_e[sel], tok[sel], gates.reshape(-1)[sel]
    order = torch.argsort(flat_e, stable=True)
    flat_e, tok, g = flat_e[order], tok[order], g[order]
    counts = torch.bincount(flat_e, minlength=moe["w_up"].shape[0]).tolist()
    y = torch.zeros_like(h)
    start = 0
    for e, c in enumerate(counts):
        if c:
            t = tok[start:start + c]
            out = common.swiglu(h[t], moe["w_up"][e], moe["w_gate"][e],
                                moe["w_down"][e])
            y.index_add_(0, t, out * g[start:start + c, None].to(out.dtype))
        start += c
    return y


def _shared(lp: dict, h: Tensor) -> Tensor:
    if "shared" not in lp["moe"]:
        return torch.zeros_like(h)
    return common.dense_mlp(lp["moe"]["shared"], h)


def _route(lp: dict, h: Tensor, k: int):
    """(router logits [N, E], top-k experts [N, k], gates [N, k])."""
    logits = (h @ lp["moe"]["router"]["w"].to(h.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    pv, ex = torch.topk(probs, k, dim=-1)
    return logits, ex, pv / pv.sum(-1, keepdim=True).clamp_min(1e-9)


def logits(params: dict, run: dict, tokens: Tensor, positions: List[int],
           tie: float, dtype: torch.dtype = torch.float32
           ) -> Tuple[List[List[Tensor]], Dict[str, int]]:
    """For each of the n sequences of tokens [n, S], one [m, V] tensor of
    candidates per compared position (m = 1 unless a near tie); and the
    counts of near ties met, candidates made, assignments and drops, and of
    each sequence's (token, layer) routings within ``NEAR`` of a tie."""
    stats = {"ties": 0, "candidates": 0, "assignments": 0, "dropped": 0}
    near = []                     # per layer: [n] near ties of each sequence
    mc = run["moe"]
    k, n_exp = mc["top_k"], mc["n_experts"]
    n, s = tokens.shape
    cap = capacity(n * s, mc)
    at = torch.tensor(positions, device=tokens.device)
    gaps, before = [], []         # per layer: [n, P] gaps, [n, P, E] counts

    def mlp(lp, h, layer):
        lg, ex, gates = _route(lp, h, k)
        flat = ex.reshape(-1)
        onehot = F.one_hot(flat, n_exp).to(torch.int32)
        seen = torch.cumsum(onehot, dim=0)
        pos_in_e = ((seen - onehot) * onehot).sum(-1)
        keep = (pos_in_e < cap).reshape(ex.shape)
        stats["dropped"] += int((~keep).sum())
        stats["assignments"] += keep.numel()
        top = torch.topk(lg.reshape(n, s, n_exp), k + 1, dim=-1).values
        gap = top[..., k - 1] - top[..., k]                     # [n, S]
        near.append((gap < NEAR).sum(-1))
        gaps.append(gap[:, at])
        rows = (torch.arange(n, device=h.device)[:, None] * s + at) * k
        before.append((seen - onehot)[rows.reshape(-1)].reshape(n, len(
            positions), n_exp))
        return _experts(lp, h, ex, gates, keep) + _shared(lp, h)

    cap_ = common.Capture()
    main = common.forward(params, run, tokens, positions, mlp, cap_, dtype)
    gaps_t = torch.stack(gaps, dim=-1)                       # [n, P, L]
    out = []
    for i in range(n):
        row = []
        for j, p in enumerate(positions):
            cands = [main[i, j]]
            g = gaps_t[i, j]
            tied = [int(x) for x in torch.nonzero(g < tie).flatten()]
            tied = sorted(tied, key=lambda layer: float(g[layer]))[:MAX_TIES]
            stats["ties"] += len(tied)
            for flips in itertools.product((False, True), repeat=len(tied)):
                if any(flips):
                    swap = {layer for layer, f in zip(tied, flips) if f}
                    cands.append(_follow(params, run, cap_, before, i, j, p,
                                         min(swap), swap, cap))
            stats["candidates"] += len(cands)
            row.append(torch.stack(cands))
        out.append(row)
    stats["near"] = [int(x) for x in torch.stack(near).sum(0)]
    return out, stats


def _follow(params, run, cap_, before, i, j, p, start, swap, cap) -> Tensor:
    """Logits of position p of sequence i followed alone from layer
    ``start``, with the k-th and (k+1)-th experts swapped at the layers of
    ``swap``."""
    mc = run["moe"]
    k = mc["top_k"]
    h_, hd = run["n_heads"], run["head_dim"]
    pos = torch.tensor([p], device=cap_.x_in[0].device)
    x = cap_.x_in[start][i, j]
    for layer in range(start, run["n_layers"]):
        lp = common.layer_params(params, layer)
        h = common.rms_norm(x, lp["ln1"]["scale"], run["norm_eps"])
        a = lp["attn"]
        q = common.linear(h, a["wq"]).reshape(1, h_, hd)
        kk = common.linear(h, a["wk"]).reshape(1, -1, hd)
        vv = common.linear(h, a["wv"]).reshape(1, -1, hd)
        q = common.rope(q, pos, run["rope_theta"], run["rope_frac"])[0]
        kk = common.rope(kk, pos, run["rope_theta"], run["rope_frac"])
        keys = torch.cat([cap_.k[layer][i, :p], kk])
        vals = torch.cat([cap_.v[layer][i, :p], vv])
        x = x + common.one_query_attention(q, keys, vals) @ \
            a["wo"]["w"].to(x.dtype)
        h = common.rms_norm(x, lp["ln2"]["scale"], run["norm_eps"])[None]
        lg = (h @ lp["moe"]["router"]["w"].to(h.dtype)).float()
        probs = torch.softmax(lg, dim=-1)
        order = torch.argsort(probs[0], descending=True)[:k + 1]
        ex = order[:k].clone()
        if layer in swap:
            ex[k - 1] = order[k]
        pv = probs[0, ex]
        gates = (pv / pv.sum().clamp_min(1e-9))[None]
        keep = (before[layer][i, j, ex] < cap)[None]
        x = x + (_experts(lp, h, ex[None], gates, keep) + _shared(lp, h))[0]
    return common.head(params, run, x)

