"""Dense oracle for the spmm_abft kernel (densifies S — small shapes)."""
from __future__ import annotations

import torch


def spmm_abft_ref(s_dense: torch.Tensor, x: torch.Tensor, xr: torch.Tensor):
    """Returns (out, actual_checksum_scalar, extra [M,1]) in f32.

    s_dense is the dense reconstruction of the block-ELL operand
    (``BlockEll.todense()``); xr is the carried right-checksum column.
    """
    out = s_dense.to(torch.float32) @ x.to(torch.float32)
    extra = s_dense.to(torch.float32) @ xr.to(torch.float32)
    return out.to(x.dtype), out.sum(), extra
