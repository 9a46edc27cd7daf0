"""Unified checked-op engine: backend-dispatched layers and batching.

Public surface:
  api       — Graph, gcn_layer, gcn_forward, gcn_apply (the entry point)
  backends  — AggregationBackend (a CheckedOp) + dense/block_ell registry
  batching  — bucketed padding and block-diagonal packing of variable-size
              graphs for batched serving
  streaming — the serving steps and the per-shape runner with its retry
              ladder (the closed-batch server's machinery)
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
from .streaming import PackedRunner  # noqa: F401
