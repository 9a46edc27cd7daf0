"""Materialized-A oracle for the flash_checksum kernel: attention plus the
exact fused chain checksum quantities."""
from __future__ import annotations

import torch


def flash_checksum_ref(q, k, v, vr, *, causal: bool = True):
    """q: [BH,T,dh]; k,v: [BH,S,dh]; vr: [BH,S,1].
    Returns (o [BH,T,dh], o_extra [BH,T,1])."""
    bh, t, dh = q.shape
    s = k.shape[1]
    scale = dh ** -0.5
    logits = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        qpos = torch.arange(t, device=q.device)[:, None]
        kpos = torch.arange(s, device=q.device)[None, :]
        logits = torch.where(kpos <= qpos, logits,
                             torch.full_like(logits, -1e30))
    a = torch.softmax(logits, dim=-1)
    o = torch.einsum("bqk,bkd->bqd", a, v.to(torch.float32))
    o_extra = torch.einsum("bqk,bkd->bqd", a, vr.to(torch.float32))
    return o.to(q.dtype), o_extra.to(torch.float32)
