"""Plain float32 reference of a dense decoder with grouped-query attention
(chatglm3-6b: rotary embeddings over half of each head, QKV bias, SwiGLU).

``logits(params, run, tokens, positions)`` returns, for each of the n
sequences, a list with one entry per compared position, each a [1, V]
tensor of candidates (a dense model has exactly one), and empty counts."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from bench.reference import common

Tensor = torch.Tensor


def logits(params: dict, run: dict, tokens: Tensor, positions: List[int],
           tie: float = 0.0, dtype: torch.dtype = torch.float32
           ) -> Tuple[List[List[Tensor]], Dict[str, int]]:
    del tie                      # no routing, no near ties
    out = common.forward(params, run, tokens, positions,
                         lambda lp, h, layer: common.dense_mlp(lp["mlp"], h),
                         dtype=dtype)
    return [[out[i, j][None] for j in range(len(positions))]
            for i in range(tokens.shape[0])], {}
