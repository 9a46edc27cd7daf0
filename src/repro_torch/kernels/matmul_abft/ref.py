"""Dense oracle for the matmul_abft kernel."""
from __future__ import annotations

import torch


def matmul_abft_ref(a: torch.Tensor, b: torch.Tensor, br: torch.Tensor):
    """Returns (c, actual_checksum_scalar, extra [M,1]) in f32 accumulation:
    ``c`` in the operand dtype, ``actual`` and ``extra`` in f32."""
    c = a.to(torch.float32) @ b.to(torch.float32)
    actual = c.sum()
    extra = a.to(torch.float32) @ br.to(torch.float32)
    return c.to(a.dtype), actual, extra.to(torch.float32)
