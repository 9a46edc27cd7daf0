"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain versions."""
import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype of a computation on ``dtype`` operands:
    float32 for the dtypes the kernels take (float32, bfloat16), float64
    for float64 — a float64 witness run of the plain versions on the CPU,
    which the kernels do not take."""
    return torch.float64 if dtype == torch.float64 else torch.float32
