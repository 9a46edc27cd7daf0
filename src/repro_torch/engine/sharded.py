"""Sharded block-ELL aggregation: row-stripes split over a device mesh.

The checksum is linear, so sharding the aggregation shards the check: each
shard owns a contiguous slab of block-ELL row-stripes and computes

    out_local   = S_local @ X          (X replicated: column blocks of any
                                        stripe may reference any X row)
    pred_local  = Σ S_local x_r        (the carried eq.-5 column)
    actual_local= Σ out_local

and the per-shard partials, added in shard order, are the global eq.-6
comparison — the single-device scalar up to the order of the sum, because
Σ over shards commutes with Σ over rows.  Per-stripe corners concatenate
instead: each stripe lives on exactly one shard.

Counterpart of the JAX package's ``repro/engine/sharded.py``.  There
``shard_map`` runs one program over a mesh; here one process walks the
shards in order and makes ONE kernel launch per shard on its slab — the
slab's ``cols``/``vals`` are views of the staged tables at an offset base
pointer, on the shard's device (``launch/mesh.py``).  The kernels' work per
stripe depends on that stripe alone (one owner per output, fixed-order
sums, no atomics), so a sharded run's output rows and stripe corners equal
the unsharded run's bit for bit.  There is no ``torch.distributed``
process group, as the reference has no collective beyond its psum.

Requires ``n_block_rows % n_shards == 0``; the block-ELL backend pads with
all-zero stripes (``pad_block_rows``) before staging, which contribute
nothing to either side of the check.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.abft import Check
from repro_torch.launch.mesh import GraphMesh, GraphShardingRules

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Partition:
    """Where the graph's row-stripes live: one mesh axis."""

    mesh: GraphMesh
    axis: str = "graph"

    def __post_init__(self):
        if self.axis not in self.mesh.axis_names:
            raise ValueError(f"axis {self.axis!r} not in mesh axes "
                             f"{self.mesh.axis_names}")

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.axis]


def _sharded_check(rules: GraphShardingRules, sums: Sequence[Tensor],
                   extras: Sequence[Tensor], granularity: str) -> Check:
    """The global Check from each shard's (stripe_sums, extra) partials:
    concatenated and reduced per stripe exactly as the unsharded wrapper
    reduces them (``granularity="stripe"``), or each shard's totals added
    in shard order (the psum)."""
    from repro_torch.kernels.spmm_abft.ops import stripe_check_corners
    if granularity == "stripe":
        return stripe_check_corners(rules.gather_rows(sums),
                                    rules.gather_rows(extras))
    return Check(predicted=rules.psum([e.sum() for e in extras]),
                 actual=rules.psum([s.sum() for s in sums]))


def _shards(partition: Partition, cols: Tensor, vals: Tensor,
            *activations: Tensor) -> Tuple[GraphShardingRules, List[tuple]]:
    rules = GraphShardingRules(partition.mesh, partition.axis)
    per_shard = zip(rules.split_stripes(cols), rules.split_stripes(vals),
                    *[rules.replicate(a) for a in activations])
    return rules, list(per_shard)


def sharded_spmm_abft(bell, cols: Tensor, vals: Tensor, x: Tensor,
                      xr: Optional[Tensor], partition: Partition, *,
                      block_g: int = 128, granularity: str = "layer"
                      ) -> Tuple[Tensor, Optional[Check]]:
    """out = S @ X over stripe-sharded (cols, vals) with the summed check.

    ``cols``/``vals`` are the staged device tensors of ``bell`` (already
    padded so stripes divide the axis); ``x`` is [n, g] replicated; ``xr``
    the carried [n, 1] checksum column or None (check disabled).
    ``granularity="stripe"`` keeps the per-stripe corners: exactly the
    single-device [n_block_rows] vector, each stripe from its one shard.
    Returns (out [n, g] gathered then trimmed, Check | None).
    """
    from repro_torch.kernels.spmm_abft.kernel import spmm_abft_kernel
    from repro_torch.kernels.spmm_abft.ops import (prepare_operands,
                                                   trim_output)

    g = x.shape[1]
    xp, xrp = prepare_operands(bell, x, xr, block_g)
    rules, shards = _shards(partition, cols, vals, xp, xrp)
    outs, sums, extras = zip(*[spmm_abft_kernel(c, v, xs, xrs)
                               for c, v, xs, xrs in shards])
    out = trim_output(bell, rules.gather_rows(outs), g)
    if xr is None:
        return out, None
    return out, _sharded_check(rules, sums, extras, granularity)


def sharded_gcn_fused(bell, cols: Tensor, vals: Tensor, h: Tensor,
                      w: Tensor, wr: Optional[Tensor], partition: Partition,
                      *, block_g: int = 128, granularity: str = "layer"
                      ) -> Tuple[Tensor, Optional[Check]]:
    """One whole GCN layer out = S (H W) over stripe-sharded (cols, vals)
    through the fused-layer kernel, with the summed check.

    H, W and w_r are replicated (any stripe's column blocks may reference
    any H row), so each shard's launch forms the whole combination H W
    again before sweeping its own stripes, as the reference's shards do.
    ``wr`` is the folded right checksum W·e (vector or column) or None
    (check disabled — the kernel skips the eq.-5 products).
    Returns (out [n, g] gathered then trimmed, Check | None).
    """
    from repro_torch.kernels.gcn_fused.kernel import gcn_fused_kernel
    from repro_torch.kernels.gcn_fused.ops import prepare_fused_operands
    from repro_torch.kernels.spmm_abft.ops import trim_output

    g = w.shape[1]
    want_check = wr is not None
    hp, wp, wrp = prepare_fused_operands(bell, h, w, wr, block_g)
    rules, shards = _shards(partition, cols, vals, hp, wp, wrp)
    outs, sums, extras = zip(*[
        gcn_fused_kernel(c, v, hs, ws, wrs, with_check=want_check)
        for c, v, hs, ws, wrs in shards])
    out = trim_output(bell, rules.gather_rows(outs), g)
    if not want_check:
        return out, None
    return out, _sharded_check(rules, sums, extras, granularity)
