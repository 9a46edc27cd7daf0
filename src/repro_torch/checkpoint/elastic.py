"""Restore a checkpoint with a placement per leaf.

Counterpart of the JAX package's ``repro/checkpoint/elastic.py``.  The
manifest stores logical (global) shapes, so a checkpoint restores whole
whatever wrote it; the reference then ``jax.device_put``s each leaf with a
``NamedSharding`` of a new mesh.  The port has no LM mesh yet (ROADMAP
A12.3), so a placement here is a device — a ``torch.device`` or a device
string — or ``None``, which keeps the leaf where
:func:`~repro_torch.checkpoint.ckpt.load_checkpoint` put it (the device of
the matching ``tree_like`` leaf).  The mesh-aware form, a sharding spec a
leaf, waits for A12.3.
"""
from __future__ import annotations

from typing import Any, Iterator, Tuple

import torch

from .ckpt import _flatten, _unflatten, load_checkpoint


def _placements(like, places) -> Iterator[Any]:
    """The placement of each leaf of ``like`` in flatten order: ``places``
    has ``like``'s structure down to its leaves (``jax``'s
    ``flatten_up_to``)."""
    if like is None:
        return
    if isinstance(like, dict):
        for k in sorted(like):
            yield from _placements(like[k], places[k])
    elif isinstance(like, (list, tuple)):
        for v, p in zip(like, places, strict=True):
            yield from _placements(v, p)
    else:
        yield places


def reshard_restore(dirpath: str, tree_like, placements) -> Tuple[Any, int]:
    """Restore the latest checkpoint and move each leaf to the device that
    ``placements`` (a tree matching ``tree_like``) gives it; ``None``
    leaves it where ``load_checkpoint`` put it.  ``(tree, step)``, or
    ``(None, -1)`` when there is no checkpoint."""
    restored, step = load_checkpoint(dirpath, tree_like)
    if restored is None:
        return None, -1
    placed = [leaf if place is None else leaf.to(torch.device(place))
              for (_, leaf), place in zip(
                  _flatten(restored), _placements(tree_like, placements),
                  strict=True)]
    return _unflatten(tree_like, iter(placed)), step
