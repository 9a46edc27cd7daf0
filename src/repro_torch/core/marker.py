"""Check-sink tagging: a trace-time marker that makes ABFT coverage
statically verifiable.

Counterpart of the JAX package's ``repro/core/marker.py``.  ``abftlint``'s
coverage pass (:mod:`repro_torch.analysis.coverage`) proves that every
matmul in a traced step flows into an eq. 4-6 checksum comparison.  "Flows
into a comparison" must be a property of the traced *graph*, not of the
Python source, so the comparison needs a recognizable footprint in a
``torch.fx`` graph.  This module provides it:

* ``torch.ops.repro_torch.abft_check_sink`` — an identity custom op whose
  node marks "these values are being consumed by a checksum comparison".
  It carries the check's declared ``granularity`` as a string argument,
  so the analysis can report per-site granularity.
* :func:`tag_check` — routes a Check's (predicted, actual) pair through
  the op.  Called by ``Check.diff`` (the reduction core every report path
  funnels through) **only while tagging is enabled**.
* :func:`check_tagging` — the enabling context manager.  The lint traces
  under it; outside it no ``repro_torch::`` op is ever called, so serving,
  launches and numerics are bit for bit unchanged by this module.

A custom op may not return an alias of its input, so the op returns
clones; that copy is why it runs only under tagging.  Its autograd formula
is the identity, so a gradient taken through a tagged step equals the
untagged one bit for bit.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List, Tuple

import torch

Tensor = torch.Tensor

CHECK_SINK = "abft_check_sink"

_state = threading.local()


def tagging_enabled() -> bool:
    return getattr(_state, "tagging", False)


@contextlib.contextmanager
def check_tagging(enabled: bool = True) -> Iterator[None]:
    """Enable check-sink tagging (and the kernel site ops of
    :mod:`repro_torch.kernels.sites`) for work done inside the block.

    Nesting is fine; tagging is thread-local, so a lint trace on one thread
    never perturbs serving on another.  ``enabled=False`` suspends it (a
    site op's implementation runs its wrapper's untagged body)."""
    prev = tagging_enabled()
    _state.tagging = enabled
    try:
        yield
    finally:
        _state.tagging = prev


@torch.library.custom_op(f"repro_torch::{CHECK_SINK}", mutates_args=())
def _check_sink(predicted: Tensor, actual: Tensor, granularity: str
                ) -> List[Tensor]:
    del granularity
    return [predicted.clone(), actual.clone()]


@_check_sink.register_fake
def _check_sink_fake(predicted, actual, granularity):
    del granularity
    return [torch.empty_like(predicted), torch.empty_like(actual)]


def _check_sink_backward(ctx, grads):
    # the identity: each input's gradient is its output's, untouched
    return grads[0], grads[1], None


_check_sink.register_autograd(_check_sink_backward)


def tag_check(predicted: Tensor, actual: Tensor, granularity: str
              ) -> Tuple[Tensor, Tensor]:
    """Identity on (predicted, actual); routes the pair through the
    ``abft_check_sink`` op when tagging is enabled (see module
    docstring)."""
    if not tagging_enabled():
        return predicted, actual
    p, a = torch.ops.repro_torch.abft_check_sink(predicted, actual,
                                                  granularity)
    return p, a
