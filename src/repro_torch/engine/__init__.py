"""Unified checked-op engine: backend-dispatched layers and batching.

Public surface:
  api       — Graph, gcn_layer, gcn_forward, gcn_apply (the entry point)
  backends  — AggregationBackend (a CheckedOp) + dense/bcoo/block_ell
              registry
  sharded   — Partition: block-ELL row-stripes split over devices, one
              kernel launch a shard, partial checks summed in shard order
  gat       — guarded GAT serving: the three-matrix chain A (H W) with one
              eq. 4–6 corner a layer, both products on the matmul_abft
              kernel
  batching  — bucketed padding and block-diagonal packing of variable-size
              graphs for batched serving
  localize  — the stripe- and slot-surgical repair tiers
  streaming — continuous-traffic serving: canonical rungs, online packing,
              double-buffered guarded dispatch, latency SLOs, backpressure;
              and the serving steps and per-shape runner with its retry
              ladder that the closed-batch server shares
"""
from .api import (  # noqa: F401
    Graph,
    fold_w_r,
    gcn_apply,
    gcn_forward,
    gcn_layer,
)
from .backends import (  # noqa: F401
    AggregationBackend,
    backend_names,
    get_backend,
    infer_backend,
    make_backend,
    register_backend,
)
from .batching import (  # noqa: F401
    GraphBatch,
    PackedGraphs,
    graph_pack_stats,
    make_batches,
    make_packed_batches,
    pack_graphs,
    pad_graph,
    pick_bucket,
    schedule_packs,
    synth_graph_stream,
)
from .gat import (  # noqa: F401
    GATEngine,
    GATLayerOp,
    fold_gat_w_r,
    gat_forward,
    gat_layer,
    init_gat,
    make_gat_serve_step,
)
from .localize import (  # noqa: F401
    gather_stripe_system,
    surgical_slot_retry,
    surgical_stripe_retry,
)
from .sharded import (  # noqa: F401
    Partition,
    sharded_gcn_fused,
    sharded_spmm_abft,
)
from .streaming import (  # noqa: F401
    PackedRunner,
    RequestResult,
    Rung,
    RungTable,
    StreamingEngine,
    plan_rungs,
)
