"""Public wrapper for the matmul_abft kernel: the final block-sum reduction
and Check construction — plus the :class:`MatmulAbftOp` CheckedOp
conforming to the engine protocol.

Counterpart of the JAX package's ``repro/kernels/matmul_abft/ops.py``.
There are no block-size or ``interpret`` arguments: the kernel handles
ragged shapes itself and picks its own tile, tensors on the CPU take the
kernel's plain PyTorch version, CUDA tensors launch the kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.abft import ABFTConfig, Check, CheckedOp, resolve_w_r

from .kernel import matmul_abft_grouped_kernel, matmul_abft_kernel

Tensor = torch.Tensor


def matmul_abft(a: Tensor, b: Tensor, br: Optional[Tensor] = None, *,
                trans_b: bool = False, with_check: bool = True
                ) -> Tuple[Tensor, Optional[Check]]:
    """C = A @ B with the fused ABFT check computed in the same pass.

    ``br`` is the offline right-checksum column B·e (``[k]`` or ``[k, 1]``);
    recomputed here when not supplied (weights: fold it at load time).
    Returns (C, Check) where Check.predicted = (eᵀA)·(B e) and
    Check.actual = Σ C — both produced by the kernel epilogue.  The Check is
    at ``"layer"`` granularity (one scalar corner for the whole product);
    compare it NaN-safely via ``Check.flag(cfg)``.

    ``trans_b=True`` takes B as ``[N, K]`` (C = A @ Bᵀ without a transposed
    copy).  ``with_check=False`` runs the product alone and returns
    ``(C, None)``; C is the same either way."""
    if not with_check:
        c, _sums, _ = matmul_abft_kernel(a, b, None, trans_b=trans_b)
        return c, None
    if br is None:
        br = b.to(torch.float32).sum(dim=0 if trans_b else 1)
    br = br.reshape(-1).to(torch.float32).contiguous()
    c, block_sums, extra = matmul_abft_kernel(a, b, br, trans_b=trans_b)
    actual = block_sums.sum()                       # O(#blocks) reduce
    predicted = extra[:, 0].sum()                   # Σ (A b_r) = eᵀA B e
    return c, Check(predicted=predicted, actual=actual, granularity="layer")


def matmul_abft_grouped(a: Tensor, b: Tensor, br: Optional[Tensor] = None
                        ) -> Tuple[Tensor, Optional[Check], Optional[Tensor]]:
    """C_g = A_g @ B_g for every group g of ``a`` [G, M, K] and ``b``
    [G, K, N], one launch.  With ``br`` [G, K], each group's B·e, it adds
    one fused ABFT check over all groups: predicted = Σ_g (eᵀA_g)(B_g e) =
    Σ extra, actual = Σ_g Σ C_g = Σ of the block sums (the reference's
    batched-einsum check of an MoE layer's expert products), and returns
    (C, Check, extra [G, M]).  Without ``br`` the product runs alone and
    returns ``(C, None, None)`` — C is the same either way."""
    if br is None:
        return matmul_abft_grouped_kernel(a, b, None)[0], None, None
    br = br.reshape(b.shape[0], -1).to(torch.float32).contiguous()
    c, block_sums, extra = matmul_abft_grouped_kernel(a, b, br)
    extra = extra[..., 0]
    chk = Check(predicted=extra.sum(), actual=block_sums.sum(),
                granularity="layer")
    return c, chk, extra


class MatmulAbftOp(CheckedOp):
    """CheckedOp over the fused-epilogue matmul kernel.

    ``out, check = op(cfg, a, b, w_r=folded)`` — the kernel computes the
    product and both checksum corners in one pass; a folded ``w_r``
    (validated against ``cfg.dtype``) skips the per-call row-sum of B.
    Drop-in for :class:`~repro_torch.core.abft.MatmulOp` where the operands
    are 2-D.  With checking off the product runs without the extra column
    and the check is ``None``.
    """

    op_id = "matmul_abft"

    def __call__(self, cfg: ABFTConfig, a: Tensor, b: Tensor, *,
                 w_r: Optional[Tensor] = None):
        w_r = resolve_w_r(b, w_r, cfg) if cfg.enabled else None
        return matmul_abft(a, b, w_r, with_check=cfg.enabled)
