"""Carry weights between the JAX package and the port.

The JAX package's GCN params are a tree ``{"layers": [{"w": ..., "w_r"?:
...}, ...]}``, its GAT params the same with ``a_l`` and ``a_r`` beside each
``w``, and its LM params a tree ``{"embed": {"table"}, "segments":
[layer-stacked unit dicts], "final_norm": {"scale"}}`` (an untied
``"head"``; an encoder-decoder's ``"encoder": {"segments",
"final_norm"}`` and each decoder layer's ``"lnx"`` and ``"xattn"``) of
``jax.Array`` leaves; exported with ``jax.tree.map(np.asarray, params)`` they become
numpy arrays, which is the form this module reads and writes.  Neither side
imports the other.
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


def _shapes(tree: Any, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(tree.shape)}


def lm_params_from_numpy(tree: Any, cfg, *,
                         device: DeviceLike = "cuda") -> Any:
    """The JAX package's LM params (numpy leaves) -> the port's, after
    checking that every leaf has the shape the port's ``init_model(cfg)``
    gives it (a tree from another configuration raises instead of failing
    inside a kernel).  :func:`params_to_numpy` carries them back."""
    from repro_torch.models.transformer import init_model

    want = _shapes(init_model(cfg, 0, device="meta"))
    have = _shapes(tree)
    if want != have:
        diff = sorted(k for k in set(want) | set(have)
                      if want.get(k) != have.get(k))
        raise ValueError(f"LM params do not match {cfg.name}: "
                         + ", ".join(f"{k} {have.get(k)} (want "
                                     f"{want.get(k)})" for k in diff[:6]))
    return params_from_numpy(tree, device=device)



def gat_params_from_numpy(tree: Any, dims, *,
                          device: DeviceLike = "cuda") -> Any:
    """The JAX package's GAT params (numpy leaves) -> the port's, after
    checking that every leaf has the shape the port's ``init_gat(dims)``
    gives it (a tree of other widths raises instead of failing inside a
    kernel)."""
    from repro_torch.engine.gat import init_gat

    want = _shapes(init_gat(None, tuple(dims), device="meta"))
    have = _shapes(tree)
    if want != have:
        diff = sorted(k for k in set(want) | set(have)
                      if want.get(k) != have.get(k))
        raise ValueError(f"GAT params do not match dims {tuple(dims)}: "
                         + ", ".join(f"{k} {have.get(k)} (want "
                                     f"{want.get(k)})" for k in diff[:6]))
    return params_from_numpy(tree, device=device)


def train_state_from_numpy(tree: Any, *, device: DeviceLike = "cuda") -> Any:
    """The JAX package's train state exported with ``jax.tree.map(
    np.asarray, state)`` — ``{"params", "opt": {"m", "v", "step"}}`` (+
    ``"ef"``) — as the port's :func:`~repro_torch.launch.steps.
    init_train_state` makes it: every leaf copied to ``device`` with its
    dtype (``step`` a 0-d int32 tensor)."""
    return params_from_numpy(tree, device=device)


def train_state_to_numpy(state: Any) -> Any:
    """The port's train state -> numpy leaves (``step`` a 0-d int32 array),
    ready for ``jax.tree.map(jnp.asarray, ...)``."""
    return params_to_numpy(state)
