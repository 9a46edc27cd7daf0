"""Global-norm gradient clipping (the JAX package's
``repro/optim/clip.py``)."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from .tree import tree_leaves, tree_map

Tensor = torch.Tensor


def global_norm(tree: Any) -> Tensor:
    """sqrt of the sum over leaves, in leaf order, of Σ x² in float32."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_scale(gn: Tensor, max_norm: float) -> Tensor:
    """``min(1, max_norm / max(gn, 1e-9))``."""
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(tree: Any, max_norm: float) -> Tuple[Any, Tensor]:
    """(the tree scaled by :func:`clip_scale`, its global norm)."""
    gn = global_norm(tree)
    scale = clip_scale(gn, max_norm)
    return tree_map(lambda x: (x.to(torch.float32) * scale).to(x.dtype),
                    tree), gn
