"""Carry weights between the JAX package and the port.

The JAX package's GCN params are a tree ``{"layers": [{"w": ..., "w_r"?:
...}, ...]}`` of ``jax.Array`` leaves; exported with
``jax.tree.map(np.asarray, params)`` they become numpy arrays, which is the
form this module reads and writes.  Neither side imports the other.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _map(tree: Any, leaf_fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, leaf_fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, leaf_fn) for v in tree)
    return leaf_fn(tree)


def params_from_numpy(tree: Any, *, device: DeviceLike = "cuda") -> Any:
    """Numpy-leaved params tree -> the port's params on ``device`` (same
    structure, same dtypes, values copied)."""
    dev = resolve_device(device)

    def leaf(x):
        if isinstance(x, np.ndarray) or np.isscalar(x):
            return torch.from_numpy(np.array(x)).to(dev)
        return x
    return _map(tree, leaf)


def params_to_numpy(tree: Any) -> Any:
    """The port's params -> numpy leaves (host copies), ready for
    ``jax.tree.map(jnp.asarray, ...)`` on the JAX side."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return x
    return _map(tree, leaf)


def params_to_device(tree: Any, *, device: DeviceLike = "cuda") -> Any:
    """Move every tensor leaf of a params tree to ``device``."""
    dev = resolve_device(device)
    return _map(tree, lambda x: x.to(dev) if isinstance(x, torch.Tensor)
                else x)
