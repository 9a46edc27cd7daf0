"""Host-sharded loading and device prefetch (the JAX package's
``repro/data/loader.py``).

Each host generates only its shard of the global batch (deterministic from
(seed, host_id)); :class:`Prefetcher` keeps ``depth`` batches in flight on
the device — each copied from pinned host memory without blocking the
host — so batch generation overlaps device compute.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


class ShardedLoader:
    """Wraps a per-host batch iterator and a global->local slicing rule."""

    def __init__(self, it: Iterator, global_batch: int, n_hosts: int,
                 host_id: int):
        assert global_batch % n_hosts == 0
        self.it = it
        self.local = global_batch // n_hosts
        self.host_id = host_id

    def __iter__(self):
        return self

    def __next__(self):
        return next(self.it)


class Prefetcher:
    """Keeps ``depth`` batches (dicts of numpy arrays, as
    :class:`~repro_torch.data.synthetic.SyntheticLM` yields them) copied
    ahead onto ``device``, in order.  On a CUDA device each array is pinned
    and copied with ``non_blocking=True`` on the current stream (the
    caching host allocator keeps the pinned buffer until its copy is done);
    on the CPU the arrays become tensors as they are."""

    def __init__(self, it: Iterator, *, device: DeviceLike = "cuda",
                 depth: int = 2):
        self.it = it
        self.device = resolve_device(device)
        self.depth = depth
        self.buf: collections.deque = collections.deque()
        self._fill()

    def _put(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, x in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(x))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t.to(self.device)
        return out

    def _fill(self):
        while len(self.buf) < self.depth:
            try:
                self.buf.append(self._put(next(self.it)))
            except StopIteration:
                break

    def __iter__(self):
        return self

    def __next__(self):
        if not self.buf:
            raise StopIteration
        out = self.buf.popleft()
        self._fill()
        return out
