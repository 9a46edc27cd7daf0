"""Public wrapper for the matmul_abft kernel: the final block-sum reduction
and Check construction — plus the :class:`MatmulAbftOp` CheckedOp
conforming to the engine protocol, and the autograd Functions that make
the kernel's products differentiable.

Counterpart of the JAX package's ``repro/kernels/matmul_abft/ops.py``.
There are no block-size or ``interpret`` arguments: the kernel handles
ragged shapes itself and picks its own tile, tensors on the CPU take the
kernel's plain PyTorch version, CUDA tensors launch the kernel.

Gradients.  When autograd records (grad mode on and an operand that
requires grad), :func:`matmul_abft` and :func:`matmul_abft_grouped` run
through :class:`MatmulAbftFunction` / :class:`GroupedMatmulAbftFunction`:
the forward is the same launch; the block sums and the extra column are
not differentiable and ``b_r`` takes no gradient (the checks feed the
flag, never the loss); the backward is two more launches of the same
kernel without ``b_r`` — unchecked products, as the reference's XLA
autodiff of its plain products — so every product of a train step, forward
and backward, runs on B4 in f32 (never TF32):

    C = A·B      dA = dC·Bᵀ (``trans_b`` on B as it lies),
                 dB = Aᵀ·dC (a contiguous transposed copy of A);
    C = A·Wᵀ     dA = dC·W,  dW = dCᵀ·A (a contiguous transposed dC)
    (the tied head, ``trans_b``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.abft import ABFTConfig, Check, CheckedOp, resolve_w_r

from .kernel import (matmul_abft_grouped_kernel, matmul_abft_kernel,
                     zero_dead_rows)

Tensor = torch.Tensor


def _records(*xs: Tensor) -> bool:
    """Autograd would record an op on ``xs``."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _non_differentiable(ctx, *outs) -> None:
    ctx.mark_non_differentiable(*(x for x in outs if x is not None))


class MatmulAbftFunction(torch.autograd.Function):
    """``(c, block_sums, extra) = MatmulAbftFunction.apply(a, b, br,
    trans_b)``: :func:`~.kernel.matmul_abft_kernel` with a backward of B4
    launches (module docstring)."""

    @staticmethod
    def forward(ctx, a, b, br, trans_b):
        c, sums, extra = matmul_abft_kernel(a, b, br, trans_b=trans_b)
        ctx.save_for_backward(a, b)
        ctx.trans_b = trans_b
        _non_differentiable(ctx, sums, extra)
        return c, sums, extra

    @staticmethod
    def backward(ctx, dc, _dsums, _dextra):
        a, b = ctx.saved_tensors
        dc = dc.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = matmul_abft_kernel(dc, b, None, trans_b=not ctx.trans_b)[0]
        if ctx.needs_input_grad[1]:
            db = matmul_abft_kernel(dc.t().contiguous(), a)[0] \
                if ctx.trans_b else \
                matmul_abft_kernel(a.t().contiguous(), dc)[0]
        return da, db, None, None


class GroupedMatmulAbftFunction(torch.autograd.Function):
    """``(c, block_sums, extra) = GroupedMatmulAbftFunction.apply(a, b,
    br, rows)``: :func:`~.kernel.matmul_abft_grouped_kernel` (a [G, M, K],
    b [G, K, N], row counts or None) with a backward of one grouped launch
    a gradient, each group as :class:`MatmulAbftFunction` does it.  The
    backward launches take no counts.  With ``rows`` the forward is
    ``bmm(zero_dead_rows(a, rows), b)``, and so is the gradient: dA's rows
    at or past a count are +0 (the launch's rows there are zeroed) and dB
    is taken from ``zero_dead_rows(a, rows)``; without ``rows`` both
    multiply ``a`` as given."""

    @staticmethod
    def forward(ctx, a, b, br, rows):
        c, sums, extra = matmul_abft_grouped_kernel(a, b, br, rows=rows)
        ctx.save_for_backward(a, b)
        ctx.rows = rows
        _non_differentiable(ctx, sums, extra)
        return c, sums, extra

    @staticmethod
    def backward(ctx, dc, _dsums, _dextra):
        a, b = ctx.saved_tensors
        rows = ctx.rows
        dc = dc.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = matmul_abft_grouped_kernel(dc, b, None, trans_b=True)[0]
            if rows is not None:
                da = zero_dead_rows(da, rows)
        if ctx.needs_input_grad[1]:
            live = a if rows is None else zero_dead_rows(a, rows)
            db = matmul_abft_grouped_kernel(
                live.transpose(1, 2).contiguous(), dc)[0]
        return da, db, None, None


def _product(a: Tensor, b: Tensor, br: Optional[Tensor], trans_b: bool):
    if _records(a, b):
        return MatmulAbftFunction.apply(a, b, br, trans_b)
    return matmul_abft_kernel(a, b, br, trans_b=trans_b)


def _grouped_product(a: Tensor, b: Tensor, br: Optional[Tensor],
                     rows: Optional[Tensor] = None):
    if _records(a, b):
        return GroupedMatmulAbftFunction.apply(a, b, br, rows)
    return matmul_abft_grouped_kernel(a, b, br, rows=rows)


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
        c, _sums, _ = _product(a, b, None, trans_b)
        return c, None
    if br is None:
        br = b.to(torch.float32).sum(dim=0 if trans_b else 1)
    br = br.reshape(-1).to(torch.float32).contiguous()
    c, block_sums, extra = _product(a, b, br, trans_b)
    actual = block_sums.sum()                       # O(#blocks) reduce
    predicted = extra[:, 0].sum()                   # Σ (A b_r) = eᵀA B e
    return c, Check(predicted=predicted, actual=actual, granularity="layer")


def matmul_abft_grouped(a: Tensor, b: Tensor, br: Optional[Tensor] = None,
                        rows: Optional[Tensor] = None
                        ) -> Tuple[Tensor, Optional[Check], Optional[Tensor]]:
    """C_g = A_g @ B_g for every group g of ``a`` [G, M, K] and ``b``
    [G, K, N], one launch.  With ``br`` [G, K], each group's B·e, it adds
    one fused ABFT check over all groups: predicted = Σ_g (eᵀA_g)(B_g e) =
    Σ extra, actual = Σ_g Σ C_g = Σ of the block sums (the reference's
    batched-einsum check of an MoE layer's expert products), and returns
    (C, Check, extra [G, M]).  Without ``br`` the product runs alone and
    returns ``(C, None, None)`` — C is the same either way.  ``rows``
    (int32 [G] or None): each group's live rows, those past it taken as
    zero rows (``matmul_abft_grouped_kernel``)."""
    if br is None:
        return _grouped_product(a, b, None, rows)[0], None, None
    br = br.reshape(b.shape[0], -1).to(torch.float32).contiguous()
    c, block_sums, extra = _grouped_product(a, b, br, rows)
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
