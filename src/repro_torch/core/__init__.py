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
from .abft import (  # noqa: F401
    ABFTConfig,
    ABFTReport,
    ChainOp,
    Check,
    CheckedOp,
    MatmulOp,
    check_chain,
    check_matmul,
    checked_matmul,
    fold_w_r_tree,
    gcn_layer,
    gcn_layer_fused,
    gcn_layer_fused_sparse,
    gcn_layer_sparse,
    gcn_layer_split,
    gcn_layer_split_sparse,
    merge_reports,
    per_op_report,
    resolve_w_r,
    sparse_col_checksum,
    sparse_matmul,
    summarize,
)
from .checksum import (  # noqa: F401
    col_checksum,
    fused_chain_checksum,
    kahan_total,
    predicted_matmul_checksum,
    row_checksum,
    total_checksum,
)
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
