"""Sharded checkpointing: per-host shard files + manifest, atomic rename,
optional async writer thread.

Counterpart of the JAX package's ``repro/checkpoint/ckpt.py``, with its
on-disk layout, so a checkpoint written by either package restores into
the other leaf for leaf:

    <dir>/step_<N>/                 (``step_%08d``)
        manifest.json   — ``step``, ``n_hosts``, ``extra`` and
                          ``leaves[key] = {shape, dtype}``
        host<h>.npz     — this host's shard of every leaf
    <dir>/LATEST        — atomic pointer file (the last step dir's name)

A leaf's key is its path in the tree — dict keys in sorted order, list and
tuple indices as numbers — joined by ``/`` (``__`` inside the npz), as
``jax.tree_util.tree_flatten_with_path`` names them; ``None`` is no leaf.
A step is written into ``step_<N>.tmp<h>`` and renamed into place.

A bfloat16 leaf is written as the reference writes it: its 2-byte
elements as numpy void ``|V2`` (numpy has no bfloat16), ``"bfloat16"`` in
the manifest; it is read back by viewing those bytes as bfloat16.

Restore keeps each leaf's saved dtype, asserts its shape against
``tree_like``'s, and places it on the device of the matching ``tree_like``
leaf (a tensor's device; the CPU for anything else).  Placement onto
other devices is :func:`repro_torch.checkpoint.elastic.reshard_restore`.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.tree import tree_flatten_with_path

SEP = "/"
BF16_BYTES = np.dtype("V2")     # how numpy stores a bfloat16 element


def _flatten(tree) -> List[Tuple[str, Any]]:
    return [(SEP.join(str(p) for p in path), leaf)
            for path, leaf in tree_flatten_with_path(tree)]


def _unflatten(like, leaves):
    """A tree of ``like``'s structure (``None`` kept) whose leaves are
    taken from the iterator ``leaves`` in :func:`_flatten`'s order."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def to_host(leaf) -> np.ndarray:
    """A leaf as the host array the file holds: a copy of a tensor's
    values (a bfloat16 tensor's 2-byte elements as ``|V2``), or
    ``np.asarray`` of anything else (a host array as it is)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(BF16_BYTES)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == BF16_BYTES else str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, like) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(dev)


def save_checkpoint(dirpath: str, step: int, tree, *, host_id: int = 0,
                    n_hosts: int = 1, extra: Optional[Dict] = None) -> str:
    """Write this host's shard + (host 0) the manifest; atomic rename."""
    stepdir = os.path.join(dirpath, f"step_{step:08d}")
    tmpdir = stepdir + f".tmp{host_id}"
    os.makedirs(tmpdir, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    manifest = {"step": step, "n_hosts": n_hosts,
                "extra": extra or {}, "leaves": {}}
    for key, leaf in _flatten(tree):
        arr = to_host(leaf)
        manifest["leaves"][key] = {"shape": list(arr.shape),
                                   "dtype": _dtype_name(arr)}
        arrays[key.replace(SEP, "__")] = arr
    np.savez(os.path.join(tmpdir, f"host{host_id}.npz"), **arrays)
    if host_id == 0:
        with open(os.path.join(tmpdir, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    # atomic publish
    os.makedirs(dirpath, exist_ok=True)
    if os.path.isdir(stepdir):
        shutil.rmtree(stepdir)
    os.rename(tmpdir, stepdir)
    with open(os.path.join(dirpath, "LATEST.tmp"), "w") as f:
        f.write(os.path.basename(stepdir))
    os.replace(os.path.join(dirpath, "LATEST.tmp"),
               os.path.join(dirpath, "LATEST"))
    return stepdir


def latest_step_dir(dirpath: str) -> Optional[str]:
    ptr = os.path.join(dirpath, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    p = os.path.join(dirpath, name)
    return p if os.path.isdir(p) else None


def load_checkpoint(dirpath: str, tree_like, *, host_id: int = 0):
    """Restore the latest checkpoint into the structure of ``tree_like``:
    ``(tree, step)``, or ``(None, -1)`` when there is none."""
    stepdir = latest_step_dir(dirpath)
    if stepdir is None:
        return None, -1
    with open(os.path.join(stepdir, "manifest.json")) as f:
        manifest = json.load(f)
    restored = []
    with np.load(os.path.join(stepdir, f"host{host_id}.npz")) as data:
        for key, leaf in _flatten(tree_like):
            arr = data[key.replace(SEP, "__")]
            want = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
                else tuple(np.shape(leaf))
            assert tuple(arr.shape) == want, (key, arr.shape, want)
            restored.append(_from_host(
                arr, manifest["leaves"][key]["dtype"], leaf))
    return _unflatten(tree_like, iter(restored)), manifest["step"]


class CheckpointManager:
    """Async, bounded-keep checkpoint writer with a step-retention policy.

    ``timings`` holds, for every save, the seconds of its blocking
    snapshot (every leaf copied to host memory) and of its write (the
    writer thread's, or the inline write's)."""

    def __init__(self, dirpath: str, keep: int = 3, async_write: bool = True):
        self.dirpath = dirpath
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self.last_saved = -1
        self.timings: List[Dict[str, float]] = []

    def save(self, step: int, tree, extra: Optional[Dict] = None):
        # snapshot to host memory synchronously, write async
        t0 = time.perf_counter()
        host_tree = _unflatten(tree, iter([to_host(x)
                                           for _, x in _flatten(tree)]))
        timing = {"step": step, "snapshot_s": time.perf_counter() - t0}
        self.timings.append(timing)
        if self._thread is not None:
            self._thread.join()

        def work():
            t1 = time.perf_counter()
            save_checkpoint(self.dirpath, step, host_tree, extra=extra)
            self._gc()
            self.last_saved = step
            timing["write_s"] = time.perf_counter() - t1

        if self.async_write:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, tree_like):
        return load_checkpoint(self.dirpath, tree_like)

    def _gc(self):
        # as the reference filters: a half-written ``step_N.tmp<h>`` dir
        # does not end in "tmp", so it is counted as a step (ROADMAP C)
        if not os.path.isdir(self.dirpath):
            return
        steps = sorted(d for d in os.listdir(self.dirpath)
                       if d.startswith("step_") and not d.endswith("tmp"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dirpath, d), ignore_errors=True)
