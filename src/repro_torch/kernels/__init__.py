"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain versions."""
import sys

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype of a computation on ``dtype`` operands:
    float32 for the dtypes the kernels take (float32, bfloat16), float64
    for float64 — a float64 witness run of the plain versions on the CPU,
    which the kernels do not take."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def any_dtensor(*xs) -> bool:
    """Is one of ``xs`` a DTensor?  (None exists before
    ``torch.distributed.tensor`` is imported, so this imports nothing.)"""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and any(isinstance(x, mod.DTensor) for x in xs)


def reduce_partial(x):
    """A DTensor's pending partial sums reduced to replicas (an all-reduce
    over each mesh dim that holds one); anything else as it is."""
    if not any_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])
