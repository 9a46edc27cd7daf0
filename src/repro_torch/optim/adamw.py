"""AdamW with decoupled weight decay.

Counterpart of the JAX package's ``repro/optim/adamw.py``: the state is a
tree mirroring params (``m``, ``v`` in float32) and a 0-d int32 ``step``;
weight decay applies to leaves with ``ndim >= 2`` (matrices, not norms or
biases).  :func:`adamw_update` updates a whole tree; the train step uses
:func:`adamw_scalars` and :func:`adamw_leaf` to update one leaf at a time.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from .tree import tree_leaves, tree_map, tree_unflatten

Tensor = torch.Tensor
Params = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params: Params) -> Dict[str, Any]:
    """Zero ``m`` and ``v`` (float32, each leaf's shape and device) and
    ``step`` 0 (int32, on the first leaf's device)."""
    zeros = lambda x: torch.zeros(x.shape, dtype=torch.float32,  # noqa: E731
                                  device=x.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_scalars(step: Tensor, cfg: AdamWConfig, lr_scale
                  ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(step + 1, lr, 1 - b1^(step+1), 1 - b2^(step+1)) as device tensors,
    computed once a step."""
    step = step + 1
    sf = step.to(torch.float32)
    b1t = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=sf.device), sf)
    b2t = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=sf.device), sf)
    return step, cfg.lr * lr_scale, b1t, b2t


def adamw_leaf(p: Tensor, g: Tensor, m: Tensor, v: Tensor,
               cfg: AdamWConfig, lr: Tensor, b1t: Tensor, b2t: Tensor
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """One leaf's (new p, new m, new v), the reference's ``upd``."""
    g = g.to(torch.float32)
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
    mhat = m / b1t
    vhat = v / b2t
    delta = mhat / (torch.sqrt(vhat) + cfg.eps)
    if p.ndim >= 2:                       # decay matrices, not norms/bias
        delta = delta + cfg.weight_decay * p.to(torch.float32)
    return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v


def adamw_update(params: Params, grads: Params, state: Dict[str, Any],
                 cfg: AdamWConfig, lr_scale
                 ) -> Tuple[Params, Dict[str, Any]]:
    """(new params, new state ``{"m", "v", "step"}``)."""
    step, lr, b1t, b2t = adamw_scalars(state["step"], cfg, lr_scale)
    out = [adamw_leaf(p, g, m, v, cfg, lr, b1t, b2t) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
        tree_leaves(state["v"]))]
    new = [tree_unflatten(params, iter(o[i] for o in out)) for i in range(3)]
    return new[0], {"m": new[1], "v": new[2], "step": step}
