"""MLP blocks (gated and plain) with split ABFT checks per matmul.

Counterpart of the JAX package's ``repro/models/mlp.py``.  The nonlinearity
between up- and down-projection breaks the linear chain, so each matmul is
checked individually (the fused form applies only to uninterrupted matrix
chains).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.abft import ABFTConfig, Check
from repro_torch.models.common import dense, gelu, init_dense

Tensor = torch.Tensor
Params = Dict[str, Any]


def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: int = 0,
             lead: Tuple[int, ...] = ()) -> Params:
    d_ff = d_ff or cfg.d_ff
    if cfg.mlp_act in ("swiglu", "geglu"):
        return {
            "wi": init_dense(gen, cfg.d_model, d_ff, lead=lead),
            "wg": init_dense(gen, cfg.d_model, d_ff, lead=lead),
            "wo": init_dense(gen, d_ff, cfg.d_model, lead=lead),
        }
    return {
        "wi": init_dense(gen, cfg.d_model, d_ff, lead=lead),
        "wo": init_dense(gen, d_ff, cfg.d_model, lead=lead),
    }


def mlp_block(p: Params, x: Tensor, cfg: ModelConfig, abft: ABFTConfig
              ) -> Tuple[Tensor, List[Check]]:
    checks: List[Check] = []
    if cfg.mlp_act in ("swiglu", "geglu"):
        up, c1 = dense(p["wi"], x, abft)
        gate, c2 = dense(p["wg"], x, abft)
        act = F.silu if cfg.mlp_act == "swiglu" else gelu
        h = act(gate) * up
        checks += c1 + c2
    else:
        h, c1 = dense(p["wi"], x, abft)
        h = gelu(h)
        checks += c1
    out, c3 = dense(p["wo"], h, abft)
    return out, checks + c3
