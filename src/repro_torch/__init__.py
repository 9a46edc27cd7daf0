"""GCN-ABFT on PyTorch + CUDA (NVIDIA Hopper).

The second implementation of the system beside the JAX package ``repro``:
the same sub-package and file names, so each module's counterpart is easy
to find, with plain functions on tensors, explicit ``device=`` arguments
and explicit ``torch.Generator``s inside.  The kernels — the GCN
aggregations and the checked-op matmul and attention of the guarded LM —
are hand-written CUDA C++ (``kernels/csrc``), built at first use.

Nothing here imports ``jax`` or ``repro``.  Entry points run on the GPU
unless the caller passes ``device="cpu"``; they never fall back by
themselves.
"""
from .device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
