"""Checksum primitives shared by every ABFT variant.

Notation follows the paper (Peltekis & Dimitrakopoulos, 2024):
  col_checksum(A) = e^T A   (sum over rows   -> one value per column)
  row_checksum(A) = A e     (sum over cols   -> one value per row)
  total(A)        = e^T A e (grand sum)

The fundamental ABFT identity for a matmul C = A @ B:
  e^T C e = (e^T A) (B e)            -- eq. (2) corner
and for the paper's three-matrix GCN product H_out = S H W:
  e^T H_out e = (e^T S) H (W e) = s_c H w_r          -- eq. (4)

All helpers take an explicit accumulation ``dtype`` (a ``torch.dtype``).
The production default is float32, with optional Kahan (compensated)
summation to recover most of the precision float64 would give.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

Tensor = torch.Tensor


def _acc(x: Tensor, dtype: Optional[torch.dtype]) -> Tensor:
    return x if dtype is None else x.to(dtype)


def col_checksum(a: Tensor, dtype: Optional[torch.dtype] = None) -> Tensor:
    """e^T A: sum over the second-to-last axis (rows)."""
    return _acc(a, dtype).sum(dim=-2)


def row_checksum(a: Tensor, dtype: Optional[torch.dtype] = None) -> Tensor:
    """A e: sum over the last axis (columns)."""
    return _acc(a, dtype).sum(dim=-1)


def total_checksum(a: Tensor, dtype: Optional[torch.dtype] = None) -> Tensor:
    """e^T A e: grand sum over the trailing two axes."""
    return _acc(a, dtype).sum(dim=(-2, -1))


def kahan_sum(x: Tensor, axis: int) -> Tensor:
    """Compensated (Kahan/Neumaier) summation along ``axis``.

    Used when checksums must accumulate in f32; recovers ~f64-grade
    absolute error for the magnitudes seen in normalized activations.  A
    Python loop over the summed axis: every step is elementwise over the
    remaining axes.
    """
    x = torch.movedim(x, axis, 0)
    s = torch.zeros_like(x[0])
    c = torch.zeros_like(x[0])
    for xi in x:
        t = s + xi
        # Neumaier variant: pick the larger-magnitude operand for the
        # compensation term so it also handles |xi| > |s|.
        s_big = s.abs() >= xi.abs()
        big = torch.where(s_big, s, xi)
        small = torch.where(s_big, xi, s)
        c = c + ((big - t) + small)
        s = t
    return s + c


def kahan_total(a: Tensor) -> Tensor:
    """Compensated grand sum over trailing two axes (f32-safe)."""
    return kahan_sum(kahan_sum(a, -1), -1)


def fused_chain_checksum(mats: Sequence[Tensor],
                         dtype: torch.dtype = torch.float32) -> Tensor:
    """Predicted checksum of the product ``mats[0] @ ... @ mats[-1]``.

    Generic form of the paper's eq. (4): (e^T M0) M1 ... (M_{k-1} e).
    Cost is O(sum of matrix sizes) instead of O(product) — the whole point.
    The contraction is evaluated left-to-right as vector-matrix products.
    """
    assert len(mats) >= 2
    v = col_checksum(mats[0], dtype)           # [k0]
    for m in mats[1:-1]:
        v = v @ _acc(m, dtype)                 # stays a vector
    return v @ row_checksum(mats[-1], dtype)   # scalar


def predicted_matmul_checksum(a: Tensor, b: Tensor,
                              dtype: torch.dtype = torch.float32) -> Tensor:
    """(e^T A)(B e) — predicted grand checksum of A @ B (batched-ok)."""
    ca = col_checksum(a, dtype)
    rb = row_checksum(b, dtype)
    return torch.einsum("...k,...k->...", ca, rb)
