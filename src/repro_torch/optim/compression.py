"""int8 gradient compression with error feedback (the JAX package's
``repro/optim/compression.py``): a per-tensor scale ``max|x| / 127``,
codes rounded half to even (``jnp.round``'s rule, and ``torch.round``'s)
and clipped to ±127; the quantization residual is fed back into the next
step's gradient."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from .tree import tree_leaves, tree_unflatten

Tensor = torch.Tensor


def compress_int8(x: Tensor) -> Tuple[Tensor, Tensor]:
    """(int8 codes, float32 scale)."""
    amax = torch.max(torch.abs(x.to(torch.float32)))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127
                    ).to(torch.int8)
    return q, scale


def decompress_int8(q: Tensor, scale: Tensor) -> Tensor:
    return q.to(torch.float32) * scale


def ef_compress_leaf(g: Tensor, e: Tensor) -> Tuple[Tensor, Tensor]:
    """One leaf's (compressed-then-restored gradient, new error buffer)."""
    gf = g.to(torch.float32) + e
    q, s = compress_int8(gf)
    deq = decompress_int8(q, s)
    return deq.to(g.dtype), gf - deq


def ef_compress_grads(grads: Any, ef_state: Any) -> Tuple[Any, Any]:
    """Error-feedback int8 round trip over a tree: (restored grads, new
    error buffers); ``ef_state`` is a float32 tree like ``grads``."""
    out = [ef_compress_leaf(g, e) for g, e in
           zip(tree_leaves(grads), tree_leaves(ef_state))]
    return (tree_unflatten(grads, iter(o[0] for o in out)),
            tree_unflatten(grads, iter(o[1] for o in out)))
