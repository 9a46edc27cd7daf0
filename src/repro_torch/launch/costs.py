"""Per-device cost of one step: the port's own cost model, read off the
operations each rank runs on its local shards.

Counterpart of the JAX package's ``repro/launch/costs.py``, whose
``xla_cost_analysis`` reads XLA's cost analysis of a compiled partitioned
module.  The port compiles nothing: :func:`step_cost_analysis` runs the step
once (on fake tensors for the dry run, on real ones to hold the model
against the card) under a dispatch mode that sees every operation DTensor
runs on the local shards, and counts

  * ``flops``: ``torch.utils.flop_counter``'s formula of each local
    operation — ATen's own (mm, bmm, ...), and the kernel sites' registered
    in ``kernels/sites.py`` (B4 2MNK + 2MK, B5 the valid (query, key) pairs
    × (4·dh + 2)); elementwise work counts 0, as in ``FlopCounterMode``;
  * ``bytes accessed``: each local operation's input and output bytes, once
    each (an operand passed twice counts once); views, which move nothing,
    and collectives, which are counted apart, add none;
  * ``collectives``: each ``_c10d_functional`` collective's result bytes by
    kind, all-reduce counted twice (a ring is a reduce-scatter and an
    all-gather), as the reference counts its HLO;
  * ``memory``: live local storage — every new storage an operation makes
    is live until the last tensor that views it is freed; ``peak_bytes``
    is the inputs' bytes plus the most that was live at once.

These are not XLA's numbers and are not comparable with them; the keys are
the reference's so that callers index them the same way
(``cost["flops"]``, ``cost["bytes accessed"]``).
"""
from __future__ import annotations

import contextlib
import time
import weakref
from typing import Any, Callable, Dict, Iterator, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

Tensor = torch.Tensor

# ``_c10d_functional`` collectives and the reference's HLO names for them
COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def _local(x: Any) -> Any:
    """A DTensor's local shard; anything else as it is."""
    from repro_torch.kernels import any_dtensor

    return x.to_local() if any_dtensor(x) else x


def _tensors(tree: Any) -> List[Tensor]:
    return [x for x in tree_leaves(tree) if isinstance(x, Tensor)]


def _key(t: Tensor) -> int:
    return t.untyped_storage()._cdata


def _nbytes(t: Tensor) -> int:
    return t.numel() * t.element_size()


def local_bytes(tree: Any) -> int:
    """Bytes of the local shards of every tensor of ``tree`` (a DTensor's
    own shard; a plain tensor whole), each storage once."""
    seen, total = set(), 0
    for t in map(_local, _tensors(tree)):
        if t.numel() and _key(t) not in seen:
            seen.add(_key(t))
            total += _nbytes(t)
    return total


class LocalCostMode(TorchDispatchMode):
    """Counts the local operations of a (DTensor) step; see the module
    docstring.  An operation on DTensors is left to DTensor
    (``NotImplemented``), which then runs it on the local shards — those
    come back here.  The global-shape operations DTensor runs to propagate
    shapes are not counted (:func:`_uncounted_propagation`)."""

    def __init__(self, arguments: Any = ()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.by_kind: Dict[str, float] = {}
        self.n_collectives = 0
        self.suspended = 0
        self.args = {_key(t) for t in map(_local, _tensors(arguments))}
        self.live: Dict[int, List[int]] = {}     # storage -> [bytes, refs]
        self.live_bytes = 0
        self.peak_live = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from repro_torch.kernels import any_dtensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if any_dtensor(*ins):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.suspended:
            return out
        outs = _tensors(out)
        coll = COLLECTIVES.get(func._opname) \
            if func.namespace == "_c10d_functional" else None
        if coll is not None:
            b = sum(map(_nbytes, outs))
            self.by_kind[coll] = self.by_kind.get(coll, 0.0) + \
                b * (2.0 if coll == "all-reduce" else 1.0)
            self.n_collectives += 1
        elif outs and not _is_view(func):
            uniq = {id(t): t for t in ins + outs}.values()
            self.bytes += sum(map(_nbytes, uniq))
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
        for t in outs:
            self._hold(t)
        return out

    def _hold(self, t: Tensor) -> None:
        """``t``'s storage is live at least as long as ``t``."""
        key = _key(t)
        if key in self.args:
            return
        if key not in self.live:
            self.live[key] = [t.untyped_storage().nbytes(), 0]
            self.live_bytes += self.live[key][0]
            self.peak_live = max(self.peak_live, self.live_bytes)
        self.live[key][1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self.live[key]
        entry[1] -= 1
        if not entry[1]:
            self.live_bytes -= entry[0]
            del self.live[key]


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


@contextlib.contextmanager
def _uncounted_propagation(mode: LocalCostMode) -> Iterator[None]:
    """DTensor runs each new operator schema once on global-shape fake
    tensors to learn its output's shape: suspend the count there."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    plain = ShardingPropagator._propagate_tensor_meta_non_cached

    def propagate(self, op_schema):
        mode.suspended += 1
        try:
            return plain(self, op_schema)
        finally:
            mode.suspended -= 1
    ShardingPropagator._propagate_tensor_meta_non_cached = propagate
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = plain


def step_cost_analysis(fn: Callable, *args: Any) -> Dict[str, Any]:
    """Run ``fn(*args)`` once and count its per-device cost (module
    docstring): ``{"flops", "bytes accessed", "collectives", "memory",
    "trace_s"}``.  ``collectives`` is ``{"by_kind", "by_depth",
    "n_ops", "per_device_bytes_unweighted"}``: the step runs eagerly, so
    every trip of a loop is already counted and ``by_depth`` holds one
    entry, ``{"0": total}`` (the reference parses its HLO, which prints a
    loop body once, and keys each op by its loop depth to weight it
    later).  ``memory``: ``argument_bytes`` (the local shards of ``args``),
    ``output_bytes`` (the local shards of the outputs that are not
    arguments), ``peak_bytes`` (arguments + the most live at once) and
    ``temp_bytes`` (peak less arguments and outputs).  The outputs are
    dropped."""
    mode = LocalCostMode(args)
    t0 = time.perf_counter()
    with _uncounted_propagation(mode), mode:
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    arg_b = local_bytes(args)
    outs = [t for t in map(_local, _tensors(out)) if _key(t) not in mode.args]
    out_b = local_bytes(outs)
    peak = arg_b + mode.peak_live
    del out, outs
    coll = sum(mode.by_kind.values())
    return {
        "flops": float(mode.flops),
        "bytes accessed": float(mode.bytes),
        "collectives": {"per_device_bytes_unweighted": coll,
                        "by_kind": dict(mode.by_kind),
                        "by_depth": {"0": coll},
                        "n_ops": mode.n_collectives},
        "memory": {"argument_bytes": arg_b, "output_bytes": out_b,
                   "temp_bytes": max(0, peak - arg_b - out_b),
                   "peak_bytes": peak},
        "trace_s": trace_s,
    }

