"""Restore a checkpoint with a placement per leaf.

Counterpart of the JAX package's ``repro/checkpoint/elastic.py``.  The
manifest stores logical (global) shapes, so a checkpoint restores whole
whatever wrote it; the reference then ``jax.device_put``s each leaf with a
``NamedSharding`` of a new mesh.  Here a placement is one of

  * a ``(mesh, placements)`` pair — a
    :class:`~repro_torch.launch.mesh.NamedSharding` from
    :class:`~repro_torch.launch.mesh.ShardingRules` unpacks as one — and
    the leaf becomes a DTensor distributed on that mesh, each rank holding
    the slice its spec gives;
  * a device (a ``torch.device`` or a device string): the leaf moves there;
  * ``None``: the leaf stays where
    :func:`~repro_torch.checkpoint.ckpt.load_checkpoint` put it (the device
    of the matching ``tree_like`` leaf).
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
    """Restore the latest checkpoint and place each leaf as ``placements``
    (a tree matching ``tree_like``) says: on a mesh, on a device, or, for
    ``None``, where ``load_checkpoint`` put it (module docstring).
    ``(tree, step)``, or ``(None, -1)`` when there is no checkpoint."""
    restored, step = load_checkpoint(dirpath, tree_like)
    if restored is None:
        return None, -1
    placed = [_place(leaf, place) for (_, leaf), place in zip(
        _flatten(restored), _placements(tree_like, placements), strict=True)]
    return _unflatten(tree_like, iter(placed)), step


def _place(leaf: torch.Tensor, place) -> torch.Tensor:
    if place is None:
        return leaf
    if isinstance(place, (str, torch.device)):
        return leaf.to(torch.device(place))
    from torch.distributed.tensor import distribute_tensor

    mesh, pls = place
    return distribute_tensor(leaf.to(mesh.device_type), mesh, pls)
