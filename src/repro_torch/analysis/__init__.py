"""Static analysis of the port.

* :mod:`repro_torch.analysis.vmem` — the shared resource models (shared
  memory, tiles, splits) that the kernel launchers assert against;
* :mod:`repro_torch.analysis.syncs` — AST lint for implicit host syncs,
  recompiles in loops, and mutable-default hazards in the engine, launch
  and fault layers (``scan_tree`` is the gate: zero findings);
* :mod:`repro_torch.analysis.coverage` — the ABFT coverage proof: a step
  traced with ``torch.fx`` under check tagging, every matmul-shaped ATen
  node and kernel site walked back from the check sinks;
* :mod:`repro_torch.analysis.lint` — the ``abftlint`` CLI over the three
  passes (coverage, the shared-memory pricing of ``vmem``, syncs).

The kernel wrappers import ``vmem``, so this ``__init__`` stays
import-light: submodules load lazily.
"""
from __future__ import annotations

import importlib

_SUBMODULES = ("vmem", "syncs", "coverage", "lint")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
