"""Program spans and counters on the profiler's clock.

The profiler is the span store: a span is a
``torch.profiler.record_function("repro." + name)`` range, which lands in
the same trace as the card's kernels and copies, on the same clock, and
the trace's export writes it out.  Spans and counters follow the
profiler's state: they are on exactly while ``torch.profiler.profile``
records, and off otherwise, with no switch of their own.

Off, :func:`span` is one read of the profiler's module flag and returns a
shared no-op context manager: it enters no ``record_function``, allocates
nothing and touches no tensor; :func:`count` returns after the same read.

Counters are sums kept by name: a host int is added on the host, a 0-d
tensor into an int64 accumulator on its device, never read on the hot
path (no host sync).  :func:`read` synchronises once and returns host
ints; :func:`reset` clears them.  A value a caller must compute on the
card is computed only where :func:`recording` holds::

    if spans.recording():
        spans.count("moe.kept", keep.sum())
"""
from __future__ import annotations

from typing import Dict, Union

import torch
from torch.autograd import profiler as _profiler

PREFIX = "repro."

_host: Dict[str, int] = {}
_device: Dict[str, torch.Tensor] = {}


class _Off:
    """The shared no-op span."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def recording() -> bool:
    """Whether the profiler records (the module flag that
    ``torch.profiler.profile`` sets on start and clears on stop: a
    module attribute read, cheaper than the C query)."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A context manager: ``record_function("repro." + name)`` while the
    profiler records, else the shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def count(name: str, value: Union[int, torch.Tensor]) -> None:
    """Add ``value`` (a host int or a 0-d integer tensor) to counter
    ``name`` while the profiler records; a tensor is added on its device."""
    if not _profiler._is_profiler_enabled:
        return
    if isinstance(value, torch.Tensor):
        acc = _device.get(name)
        if acc is None:
            acc = _device[name] = torch.zeros((), dtype=torch.int64,
                                              device=value.device)
        acc.add_(value)
    else:
        _host[name] = _host.get(name, 0) + int(value)


def read() -> Dict[str, int]:
    """Every counter as a host int; one synchronisation, where any counter
    lies on a device."""
    out = dict(_host)
    if _device:
        names = list(_device)
        dev = _device[names[0]].device
        # the counters' one read
        vals = torch.stack([_device[n].to(dev) for n in names]).tolist()
        for n, v in zip(names, vals):
            out[n] = out.get(n, 0) + v
    return out


def reset() -> None:
    """Clear every counter."""
    _host.clear()
    _device.clear()
