"""The paper's target model: a Kipf & Welling GCN — weight init and the
dense adjacency helpers.

Counterpart of the JAX package's ``repro/core/gcn.py``.  The forward pass
and the checks live in ``repro_torch.engine``; the training loss and the
sparse-tensor helpers are not part of the serving path and arrive with the
training stack.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Params = Dict[str, Any]


def init_gcn(generator: Optional[torch.Generator], dims: Sequence[int], *,
             device: DeviceLike = "cuda") -> Params:
    """Glorot-initialized weights for a len(dims)-1 layer GCN.

    ``generator`` is a CPU ``torch.Generator`` (or ``None`` for the global
    one): the draws are made on the host so one seed gives one set of
    weights whatever the device, then moved to ``device``."""
    dev = resolve_device(device)
    layers = []
    for fin, fout in zip(dims[:-1], dims[1:]):
        scale = math.sqrt(6.0 / (fin + fout))
        u = torch.rand((fin, fout), generator=generator, dtype=torch.float32)
        layers.append({"w": ((2.0 * u - 1.0) * scale).to(dev)})
    return {"layers": layers}


def normalized_adjacency_dense(edges: np.ndarray, n: int) -> np.ndarray:
    """D^-1/2 (A + I) D^-1/2 as a dense float32 matrix (small graphs)."""
    a = np.zeros((n, n), np.float32)
    a[edges[:, 0], edges[:, 1]] = 1.0
    a[edges[:, 1], edges[:, 0]] = 1.0
    np.fill_diagonal(a, 1.0)
    d = a.sum(1)
    dinv = 1.0 / np.sqrt(np.maximum(d, 1.0))
    return (a * dinv[None, :]) * dinv[:, None]


def dataset_to_dense(ds) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(S, H0, labels) dense views of a core.datasets.GraphDataset."""
    return ds.s.todense(), ds.features.todense(), ds.labels
