"""The paper's target model: a Kipf & Welling GCN with ABFT checking —
weight init, the forward shims over the engine, the training loss, and the
dense and sparse adjacency helpers.

Counterpart of the JAX package's ``repro/core/gcn.py``.  The forward loop
and the checks live in ``repro_torch.engine``; the functions here are the
paper's own entry points over it.  S is a dense matrix or a ``torch``
sparse tensor (COO or CSR — the JAX package's BCOO); a block-ELL layout
goes through ``repro_torch.engine.gcn_apply`` with ``backend="block_ell"``.

Every function that computes takes ``device=`` (default ``"cuda"``, which
raises without a GPU).  :func:`gcn_loss` is differentiable by autograd on
the dense and sparse backends (plain PyTorch products); the block-ELL
kernels have no backward, as the TPU kernels they replace have none.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

from .abft import ABFTConfig, ABFTReport, Check, sparse_col_checksum, summarize

Tensor = torch.Tensor
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


def gcn_forward(params: Params, s: Any, h0: Any, cfg: ABFTConfig, *,
                device: DeviceLike = "cuda") -> Tuple[Tensor, List[Check]]:
    """Forward pass; checks are taken pre-activation (as in the paper).

    Delegates to the adjacency-generic loop (dense S dispatches through
    the same layer math; s_c is then computed once and shared by layers).
    """
    return gcn_forward_sparse(params, s, h0, cfg, device=device)


def gcn_apply(params: Params, s: Any, h0: Any, cfg: ABFTConfig, *,
              device: DeviceLike = "cuda") -> Tuple[Tensor, ABFTReport]:
    logits, checks = gcn_forward(params, s, h0, cfg, device=device)
    return logits, summarize(checks, cfg, device=logits.device)


def gcn_loss(params: Params, s: Any, h0: Any, labels: Any,
             mask: Optional[Any], cfg: ABFTConfig, *,
             device: DeviceLike = "cuda") -> Tuple[Tensor, ABFTReport]:
    """Masked mean negative log-likelihood of ``log_softmax(logits)``, and
    the forward's report."""
    logits, report = gcn_apply(params, s, h0, cfg, device=device)
    logp = torch.log_softmax(logits, dim=-1)
    labels = torch.as_tensor(labels).to(logits.device).long()
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    if mask is None:
        return nll.mean(), report
    mask = torch.as_tensor(mask).to(logits.device).bool()
    nll = torch.where(mask, nll, torch.zeros_like(nll))
    return nll.sum() / mask.sum().clamp(min=1), report


# ---------------------------------------------------------------------------
# Sparse-adjacency path.  S stays a sparse tensor; the per-graph s_c = e^T S
# is computed once offline (:func:`precompute_s_c`) and reused across every
# layer and step — the paper's "offline for static graphs" convention.
# ---------------------------------------------------------------------------

def precompute_s_c(s: Any, cfg: ABFTConfig) -> Tensor:
    """Offline e^T S in the checksum accumulation dtype, on S's device."""
    return sparse_col_checksum(s, cfg.dtype)


def gcn_forward_sparse(params: Params, s: Any, h0: Any, cfg: ABFTConfig,
                       s_c: Optional[Tensor] = None, *,
                       device: DeviceLike = "cuda"
                       ) -> Tuple[Tensor, List[Check]]:
    """Forward loop, generic over the adjacency (sparse or dense).

    Thin shim over the unified engine (``repro_torch.engine``), which owns
    the canonical loop (ReLU chain-breaking, pre-activation checks) and the
    backend dispatch.
    """
    from repro_torch.engine import Graph
    from repro_torch.engine import gcn_forward as engine_forward
    return engine_forward(params, Graph(s=s, h0=h0, s_c=s_c), cfg,
                          device=device)


def gcn_apply_sparse(params: Params, s: Any, h0: Any, cfg: ABFTConfig,
                     s_c: Optional[Tensor] = None, *,
                     device: DeviceLike = "cuda"
                     ) -> Tuple[Tensor, ABFTReport]:
    """Sparse twin of :func:`gcn_apply`: same logits, same report semantics.

    ``s`` is a ``torch`` sparse normalized adjacency (dense also accepted —
    the layer math dispatches), moved to ``device`` with the features.
    """
    logits, checks = gcn_forward_sparse(params, s, h0, cfg, s_c,
                                        device=device)
    return logits, summarize(checks, cfg, device=logits.device)


def normalized_adjacency_sparse(edges: np.ndarray, n: int, *,
                                device: DeviceLike = "cuda") -> Tensor:
    """D^-1/2 (A + I) D^-1/2 as a ``torch`` sparse COO matrix (any graph
    size)."""
    from .datasets import Coo
    src = np.concatenate([edges[:, 0], edges[:, 1], np.arange(n)])
    dst = np.concatenate([edges[:, 1], edges[:, 0], np.arange(n)])
    # dedupe (symmetrization may duplicate bidirectional input edges)
    key = src * n + dst
    _, keep = np.unique(key, return_index=True)
    src, dst = src[keep], dst[keep]
    deg = np.bincount(src, minlength=n).astype(np.float64)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    vals = (dinv[src] * dinv[dst]).astype(np.float32)
    return Coo(vals, src, dst, (n, n)).to_sparse(device=device)


def dataset_to_sparse(ds, *, device: DeviceLike = "cuda"
                      ) -> Tuple[Tensor, Tensor, np.ndarray]:
    """(S as a sparse tensor, dense H0, labels) views of a
    core.datasets.GraphDataset, S and H0 on ``device``.

    H0 stays dense on the device: after the first combination every
    activation is dense anyway, and the paper's sparse-H0 op accounting
    lives in the analytic model (core/opcount.py).
    """
    dev = resolve_device(device)
    return (ds.s.to_sparse(device=dev),
            torch.from_numpy(ds.features.todense()).to(dev), ds.labels)


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
