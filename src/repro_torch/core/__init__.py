"""Checksum algebra, ABFT checks, the GCN model and the synthetic datasets.

Public surface:
  checksum  — checksum primitives (col/row/total, Kahan, fused-chain)
  abft      — ABFTConfig + split/fused checks, GCN layer policies, reports
  gcn       — the GCN model (Kipf & Welling) with ABFT threading
  datasets  — synthetic stand-ins for Cora/Citeseer/PubMed/Nell
  opcount   — analytic op-count model (paper Table II)
  fault     — bit-flip fault-injection engine (paper Table I)
"""
from . import fault, opcount  # noqa: F401
from .fault import (  # noqa: F401
    CampaignSummary,
    NumpyGCN,
    flip_bit_f32,
    flip_bit_f64,
    run_campaign,
    run_campaigns,
    train_weights_numpy,
)
from .opcount import (  # noqa: F401
    OpCounts,
    all_gcn_op_counts,
    fault_sites,
    gcn_op_counts,
)
