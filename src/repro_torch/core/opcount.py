"""Analytic operation-count model for ABFT variants (paper Table II).

The port's own copy of the JAX package's ``repro/core/opcount.py``: pure
Python over the port's ``core/datasets.py`` statistics, the same counts.

Conventions (reverse-engineered from the paper's "True Out" column, which we
match to <1 % — see datasets.py header):

  * multiplications and additions are counted equally (a MAC = 2 ops);
  * a sparse @ dense matmul with nnz nonzeros in the sparse operand and G
    output columns costs 2·nnz·G;
  * a dense [M,K] @ [K,G] matmul costs 2·M·K·G;
  * the combination step of layer 1 uses the *sparse* feature matrix
    (combination-first dataflow, as in the paper's accelerators);
  * augmented-systolic convention: multiplying enhanced matrices computes the
    *full* extra checksum row and column (eqs. 2/3/5/6), not just the corner;
  * offline checksums are free at inference time: w_r = W e always, and
    s_c = e^T S for static graphs;
  * the online actual checksum (grand sum of an output with M·G entries)
    costs M·G additions;
  * the final comparison is 1 op (ignored, sub-ppm).

Split ABFT per layer (S:[N,N] nnz_s, H:[N,F] nnz_h (or dense), W:[F,G]):
  check 1 (X = H W):      h_c = e^T H            nnz_h   adds   (online!)
                          extra col  H w_r       2·nnz_h
                          extra row  h_c [W|w_r] 2·F·(G+1)
                          actual     sum(X)      N·G
  check 2 (H_out = S X):  extra col  S x_r       2·nnz_s
                          extra row  s_c [X|x_r] 2·N·(G+1)
                          actual     sum(H_out)  N·G

GCN-ABFT per layer:
  first multiply:         extra col  H w_r       2·nnz_h      (eq. 5 — only this)
  second multiply:        extra col  S x_r       2·nnz_s
                          extra row  s_c [X|x_r] 2·N·(G+1)
                          actual     sum(H_out)  N·G          (eq. 6)

Savings = split − fused = nnz_h + 2·F·(G+1) + N·G per layer: exactly the
paper's narrative — no h_c state, no first-step actual checksum.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .datasets import STATS, GraphStats


@dataclasses.dataclass(frozen=True)
class LayerShape:
    n: int          # nodes (rows of S and H)
    f: int          # input features
    g: int          # output features
    nnz_s: int      # nonzeros of S (adjacency + self loops)
    nnz_h: int      # nonzeros of H (== n*f when dense)

    @property
    def h_dense(self) -> bool:
        return self.nnz_h == self.n * self.f


def gcn_layer_shapes(stats: GraphStats) -> List[LayerShape]:
    """Two-layer GCN as evaluated in the paper (layer 2 input is dense)."""
    f, h, c = stats.layer_dims
    return [
        LayerShape(stats.nodes, f, h, stats.adj_nnz, stats.feat_nnz),
        LayerShape(stats.nodes, h, c, stats.adj_nnz, stats.nodes * h),
    ]


def true_ops(ls: LayerShape) -> int:
    comb = 2 * ls.nnz_h * ls.g          # X = H W   (sparse or dense H)
    agg = 2 * ls.nnz_s * ls.g           # H_out = S X
    return comb + agg


def split_check_ops(ls: LayerShape, h_static: bool = False) -> int:
    """``h_static``: layer-1 input features are known statically, so h_c is
    computed offline — the paper states this explicitly ("except only for the
    first GCN layer")."""
    ops = 0
    if not h_static:
        ops += ls.nnz_h                  # h_c = e^T H  (online)
    ops += 2 * ls.nnz_h                  # H w_r extra column
    ops += 2 * ls.f * (ls.g + 1)         # h_c @ [W | w_r] extra row
    ops += ls.n * ls.g                   # actual sum(X)
    ops += 2 * ls.nnz_s                  # S x_r extra column
    ops += 2 * ls.n * (ls.g + 1)         # s_c @ [X | x_r] extra row
    ops += ls.n * ls.g                   # actual sum(H_out)
    return ops


def fused_check_ops(ls: LayerShape) -> int:
    ops = 0
    ops += 2 * ls.nnz_h                  # H w_r extra column (eq. 5)
    ops += 2 * ls.nnz_s                  # S x_r extra column
    ops += 2 * ls.n * (ls.g + 1)         # s_c @ [X | x_r] extra row
    ops += ls.n * ls.g                   # actual sum(H_out)
    return ops


@dataclasses.dataclass(frozen=True)
class OpCounts:
    name: str
    true_out: int
    split_check: int
    fused_check: int

    @property
    def split_total(self) -> int:
        return self.true_out + self.split_check

    @property
    def fused_total(self) -> int:
        return self.true_out + self.fused_check

    @property
    def check_savings(self) -> float:
        return 1.0 - self.fused_check / self.split_check

    @property
    def total_savings(self) -> float:
        return 1.0 - self.fused_total / self.split_total


def gcn_op_counts(name: str, stats: Optional[GraphStats] = None) -> OpCounts:
    st = stats or STATS[name]
    layers = gcn_layer_shapes(st)
    return OpCounts(
        name=st.name,
        true_out=sum(true_ops(l) for l in layers),
        split_check=sum(split_check_ops(l, h_static=(i == 0))
                        for i, l in enumerate(layers)),
        fused_check=sum(fused_check_ops(l) for l in layers),
    )


def all_gcn_op_counts() -> Dict[str, OpCounts]:
    return {n: gcn_op_counts(n) for n in STATS}


# ---------------------------------------------------------------------------
# Per-site op counts — drives fault-injection site sampling (site chosen
# proportionally to its op count, per the paper's setup section).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SiteOps:
    layer: int
    phase: str      # 'comb' | 'agg'
    target: str     # 'mm' | 'check'
    ops: int


def fault_sites(stats: GraphStats, mode: str) -> List[SiteOps]:
    sites: List[SiteOps] = []
    for i, ls in enumerate(gcn_layer_shapes(stats)):
        sites.append(SiteOps(i, "comb", "mm", 2 * ls.nnz_h * ls.g))
        sites.append(SiteOps(i, "agg", "mm", 2 * ls.nnz_s * ls.g))
        if mode == "split":
            h_c = 0 if i == 0 else ls.nnz_h   # layer-1 h_c is offline
            comb_chk = h_c + 2 * ls.nnz_h + 2 * ls.f * (ls.g + 1) + ls.n * ls.g
            agg_chk = 2 * ls.nnz_s + 2 * ls.n * (ls.g + 1) + ls.n * ls.g
        elif mode == "fused":
            comb_chk = 2 * ls.nnz_h
            agg_chk = 2 * ls.nnz_s + 2 * ls.n * (ls.g + 1) + ls.n * ls.g
        else:
            comb_chk = agg_chk = 0
        if comb_chk:
            sites.append(SiteOps(i, "comb", "check", comb_chk))
        if agg_chk:
            sites.append(SiteOps(i, "agg", "check", agg_chk))
    return sites


# ---------------------------------------------------------------------------
# Beyond-paper: ABFT op counts for transformer linear-chain sites.
# Used by the JAX package's benchmarks/abft_overhead.py to show the paper's savings transpose
# to attention (A·V·W_o) and MoE (C·G·W2) chains.  Dims per layer; batch*seq
# = t tokens, h heads, dh head dim, d model dim.
# ---------------------------------------------------------------------------

def attention_chain_counts(t: int, h: int, dh: int, d: int) -> Dict[str, int]:
    """Ops for checking O = A·(X W_v)·W_o per layer (single sequence)."""
    true = 2 * t * t * h * dh * 2 + 2 * t * d * (3 * h * dh) + 2 * t * h * dh * d
    # split: check qk^T? (not a chain member), AV, (AV)Wo, XWv separately.
    split = 0
    split += t * h * dh + 2 * t * h * dh + 2 * h * t * (dh + 1) + t * h * dh  # AV check
    split += t * h * dh + 2 * t * h * dh + 2 * h * dh * (d + 1) + t * d      # (AV)Wo
    split += t * d + 2 * t * d + 2 * d * (h * dh + 1) + t * h * dh           # XWv
    # fused chain (e^T A)·V·(W_o e): col-sums of A accumulate online in the
    # flash pass (t*t*h adds), then s_c·V (2 t h dh), fold through W_o offline.
    fused = t * t * h + 2 * t * h * dh + 2 * h * dh + t * d
    # plus split check on XWv (chain broken upstream by softmax? no — V=XW_v is
    # inside the chain; the fused check covers it end-to-end).
    return {"true": true, "split": split, "fused": fused}


def moe_chain_counts(t: int, k: int, e_cap: int, dff: int, d: int) -> Dict[str, int]:
    """Ops for checking Y = C·G·W2 (combine, per layer)."""
    nnz_c = t * k
    true = 2 * e_cap * dff * d + 2 * nnz_c * d
    split = (e_cap * dff + 2 * e_cap * dff + 2 * dff * (d + 1) + e_cap * d
             + 2 * nnz_c + 2 * t * (d + 1) + t * d)
    fused = 2 * e_cap * dff + 2 * nnz_c + 2 * t * (d + 1) + t * d
    return {"true": true, "split": split, "fused": fused}
