"""Device resolution shared by every entry point of the port.

The port runs on the GPU.  An entry point called without ``device=`` asks
for ``"cuda"``; when no card is present that request raises instead of
quietly carrying on on the CPU, so a timing or a "the kernel ran" claim can
never come from the wrong device.  Tests pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' explicitly to run the plain "
            f"PyTorch versions on the CPU")
    return dev
