"""The graph engine's device mesh and its sharding rules.

Counterpart of the graph half of the JAX package's ``repro/launch/mesh.py``
(``make_graph_mesh``, ``GraphShardingRules``).  There a 1-D ``Mesh`` and
``PartitionSpec``s tell ``shard_map`` where each operand lives; here one
process drives several devices, so the mesh is a named tuple of
``torch.device``s and each rule is the operation that places or collects a
tensor:

  * the block-ELL tile table and its column-index table split by row-stripe
    on the axis (one contiguous slab a shard);
  * activations (X, x_r; or H, W, w_r) are replicated: any stripe's column
    blocks may reference any row;
  * output rows live where their stripes live, and are concatenated onto
    the first device;
  * scalar check partials reduce to one replicated value (the psum), added
    in shard order on the first device;
  * per-stripe check partials concatenate, each stripe from its one owner.

The LM's production ``ShardingRules`` are not ported (ROADMAP A12.3).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GraphMesh:
    """A 1-D list of devices named by one axis."""

    devices: Tuple[torch.device, ...]
    axis: str = "graph"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a graph mesh needs at least one device")

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis,)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: len(self.devices)}


def make_graph_mesh(n_devices: Optional[int] = None, axis: str = "graph", *,
                    device: DeviceLike = "cuda") -> GraphMesh:
    """1-D mesh of ``n_devices`` shards for stripe sharding.

    On ``"cuda"`` shard i lives on card ``i % torch.cuda.device_count()``:
    each shard on a card of its own when there are enough, every shard on
    ``cuda:0`` on a one-card machine.  ``n_devices`` defaults to the card
    count.  On ``"cpu"`` every shard lives on the CPU (default 1 shard).
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        devices = tuple(torch.device("cuda", i % count) for i in range(n))
    else:
        n = 1 if n_devices is None else n_devices
        devices = (dev,) * n
    if n < 1:
        raise ValueError(f"a graph mesh needs n_devices >= 1, got {n}")
    return GraphMesh(devices, axis)


class GraphShardingRules:
    """Where each operand of the stripe-sharded block-ELL backend lives."""

    def __init__(self, mesh: GraphMesh, axis: str = "graph"):
        assert axis in mesh.axis_names, (axis, mesh.axis_names)
        self.mesh = mesh
        self.axis = axis

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.axis]

    def _bounds(self, n_rows: int) -> List[Tuple[int, int]]:
        n = self.n_shards
        if n_rows % n:
            raise ValueError(f"{n_rows} stripes do not split over {n} "
                             f"shards; pad with pad_block_rows first")
        per = n_rows // n
        return [(i * per, (i + 1) * per) for i in range(n)]

    def split_stripes(self, t: Tensor) -> List[Tensor]:
        """block_cols [nbm, width] or values [nbm, width, bm, bk]: shard i
        owns stripes [i·nbm/n, (i+1)·nbm/n), a contiguous slab of ``t``
        (a view at an offset base pointer on its own device)."""
        return [t[a:b].to(d) for (a, b), d
                in zip(self._bounds(t.shape[0]), self.mesh.devices)]

    def replicate(self, t: Tensor) -> List[Tensor]:
        """An activation on every shard's device (one copy a device)."""
        copies: Dict[torch.device, Tensor] = {}
        return [copies.setdefault(d, t.to(d)) for d in self.mesh.devices]

    def gather_rows(self, parts: Sequence[Tensor]) -> Tensor:
        """Row-sharded outputs (or per-stripe partials) concatenated in
        shard order on the first device."""
        first = self.mesh.devices[0]
        return torch.cat([p.to(first) for p in parts], dim=0)

    def psum(self, parts: Sequence[Tensor]) -> Tensor:
        """Scalar partials added in shard order on the first device."""
        first = self.mesh.devices[0]
        total = parts[0].to(first)
        for p in parts[1:]:
            total = total + p.to(first)
        return total
