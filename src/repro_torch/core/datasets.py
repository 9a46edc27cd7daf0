"""Synthetic stand-ins for the paper's four GCN applications.

The port's own numpy copy of the JAX package's ``repro/core/datasets.py``
(its BCOO view is ``Coo.to_sparse``, a ``torch`` sparse tensor): the same
seed gives the same graphs.

The container is offline, so Cora/Citeseer/PubMed/Nell are generated to the
*published* statistics (nodes, undirected edges, feature nnz, feature dim,
hidden width, classes).  The statistics below reproduce the paper's Table II
"True Out" operation counts to <1 % (see ``core/opcount.py`` and
``benchmarks/table2_op_counts.py``), which pins down both the dataset shapes
and the paper's counting conventions:

    Cora     2.79 M  (paper:   2.8 M)
    Citeseer 4.56 M  (paper:   4.6 M)
    PubMed  37.52 M  (paper:  37.6 M)
    Nell    1743  M  (paper: 1745.9 M)

Generation is deterministic (seeded) and cheap: edges are sampled uniformly
(Erdos–Renyi by pair sampling, symmetrized, self-loops added), features are
sparse nonnegative "bag-of-words"-style rows, row-normalized as in Kipf &
Welling.  Fault-detection mechanics (bit flip -> checksum divergence) depend
on magnitudes, not topology; EXPERIMENTS.md notes this as the one deviation
forced by the offline container.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class GraphStats:
    name: str
    nodes: int
    und_edges: int          # undirected edges, without self loops
    feat_dim: int
    feat_nnz: int           # total nonzeros in the feature matrix
    hidden: int
    classes: int

    @property
    def adj_nnz(self) -> int:
        # directed nnz of A + I  (symmetric edges counted twice + self loops)
        return 2 * self.und_edges + self.nodes

    @property
    def layer_dims(self) -> Tuple[int, int, int]:
        return (self.feat_dim, self.hidden, self.classes)


# Published statistics (Planetoid splits; Nell from graphlearning / planetoid
# nell.0.001 preprocessing — hidden 64 per the GCN paper's Nell setup).
STATS: Dict[str, GraphStats] = {
    "cora":     GraphStats("cora",     2708,   5278,  1433,   49216, 16,   7),
    "citeseer": GraphStats("citeseer", 3327,   4552,  3703,  105165, 16,   6),
    "pubmed":   GraphStats("pubmed",  19717,  44324,   500,  985850, 16,   3),
    "nell":     GraphStats("nell",    65755, 133072,  5414,   92057, 64, 186),
}


class Coo:
    """Minimal COO sparse matrix for the numpy-side fault-injection engine."""

    __slots__ = ("data", "row", "col", "shape", "_csr")

    def __init__(self, data: np.ndarray, row: np.ndarray, col: np.ndarray,
                 shape: Tuple[int, int]):
        self.data = np.asarray(data, np.float32)
        self.row = np.asarray(row, np.int64)
        self.col = np.asarray(col, np.int64)
        self.shape = shape
        self._csr = None

    def csr(self):
        """(indptr, cols, data) sorted by row — the per-row accumulation
        order used by the fault engine's prefix-sum delta model."""
        if self._csr is None:
            order = np.argsort(self.row, kind="stable")
            rows = self.row[order]
            indptr = np.zeros(self.shape[0] + 1, np.int64)
            np.add.at(indptr, rows + 1, 1)
            np.cumsum(indptr, out=indptr)
            self._csr = (indptr, self.col[order], self.data[order])
        return self._csr

    def row_slice(self, i: int):
        """(cols, vals) of row i in accumulation order."""
        indptr, cols, data = self.csr()
        lo, hi = indptr[i], indptr[i + 1]
        return cols[lo:hi], data[lo:hi]

    @property
    def nnz(self) -> int:
        return int(self.data.size)

    def matmul_dense(self, x: np.ndarray) -> np.ndarray:
        """self @ x for dense x — vectorized scatter-add."""
        out = np.zeros((self.shape[0], x.shape[1]), np.float32)
        np.add.at(out, self.row, self.data[:, None] * x[self.col])
        return out

    def col_sums(self) -> np.ndarray:
        out = np.zeros(self.shape[1], np.float64)
        np.add.at(out, self.col, self.data.astype(np.float64))
        return out

    def col_slice_dense(self, j: int) -> np.ndarray:
        """Return column j as a dense vector (used by delta propagation)."""
        out = np.zeros(self.shape[0], np.float32)
        m = self.col == j
        np.add.at(out, self.row[m], self.data[m])
        return out

    def rows_of_col(self, j: int) -> np.ndarray:
        return self.row[self.col == j]

    def todense(self) -> np.ndarray:
        out = np.zeros(self.shape, np.float32)
        np.add.at(out, (self.row, self.col), self.data)
        return out

    def to_sparse(self, device="cuda", layout=None):
        """``torch`` sparse view on ``device`` — the counterpart of the JAX
        package's BCOO view.  COO (the default) keeps duplicate entries
        uncoalesced; the product accumulates them, matching todense +
        np.add.at.  ``layout=torch.sparse_csr`` sums them while converting."""
        import torch

        from repro_torch.device import resolve_device
        idx = torch.from_numpy(np.stack([self.row, self.col]))
        s = torch.sparse_coo_tensor(idx, torch.from_numpy(self.data),
                                    self.shape, check_invariants=True)
        if layout is not None and layout != torch.sparse_coo:
            s = s.to_sparse(layout=layout)
        return s.to(resolve_device(device))

    def to_block_ell(self, block_m: int = 128, block_k: int = 128):
        """Padded block-ELL layout for the spmm_abft kernel."""
        from repro_torch.kernels.spmm_abft.layout import coo_to_block_ell
        return coo_to_block_ell(self.row, self.col, self.data, self.shape,
                                block_m, block_k)


@dataclasses.dataclass
class GraphDataset:
    stats: GraphStats
    s: Coo                     # normalized adjacency  D^-1/2 (A+I) D^-1/2
    features: Coo              # sparse H^0
    labels: np.ndarray         # [nodes] int — synthetic classes
    # CSC-style views of S used by the delta-propagation fault engine
    _s_by_col: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def name(self) -> str:
        return self.stats.name

    def s_col(self, j: int):
        """(rows, vals) of column j of S, cached."""
        hit = self._s_by_col.get(j)
        if hit is None:
            m = self.s.col == j
            hit = (self.s.row[m], self.s.data[m])
            self._s_by_col[j] = hit
        return hit


def _sample_edges(n: int, m: int, rng: np.random.Generator) -> np.ndarray:
    """m distinct undirected edges (i<j), uniform."""
    want = m
    got = np.empty((0, 2), np.int64)
    while got.shape[0] < want:
        k = int((want - got.shape[0]) * 1.3) + 16
        e = rng.integers(0, n, size=(k, 2), dtype=np.int64)
        e = e[e[:, 0] != e[:, 1]]
        e = np.sort(e, axis=1)
        got = np.unique(np.concatenate([got, e], axis=0), axis=0)
    return got[:want]


def _stable_hash(name: str) -> int:
    import zlib
    return zlib.crc32(name.encode()) & 0xFFFF


def make_dataset(name: str, seed: int = 0, normalize: bool = True) -> GraphDataset:
    """``normalize=True``: Kipf row-normalized features (activations ~1e-2).
    ``normalize=False``: raw bag-of-words-scale features (~1) — the
    magnitude-calibrated variant whose trained second-layer partial sums reach
    ~1e3, matching the scales implied by the paper's Table I thresholds."""
    st = STATS[name]
    rng = np.random.default_rng(np.random.SeedSequence([_stable_hash(name), seed]))

    # --- adjacency: ER edges, symmetrized, self loops, sym-normalized
    e = _sample_edges(st.nodes, st.und_edges, rng)
    src = np.concatenate([e[:, 0], e[:, 1], np.arange(st.nodes)])
    dst = np.concatenate([e[:, 1], e[:, 0], np.arange(st.nodes)])
    deg = np.bincount(src, minlength=st.nodes).astype(np.float64)
    dinv = 1.0 / np.sqrt(deg)
    vals = (dinv[src] * dinv[dst]).astype(np.float32)
    s = Coo(vals, src, dst, (st.nodes, st.nodes))

    # --- features: sparse nonnegative rows, ≥1 nnz per row, row-normalized
    per_row = np.full(st.nodes, st.feat_nnz // st.nodes, np.int64)
    extra = st.feat_nnz - per_row.sum()
    if extra > 0:
        per_row[rng.choice(st.nodes, size=extra, replace=False)] += 1
    per_row = np.maximum(per_row, 1)
    rows = np.repeat(np.arange(st.nodes), per_row)
    cols = rng.integers(0, st.feat_dim, size=rows.size, dtype=np.int64)
    fvals = rng.uniform(0.5, 1.5, size=rows.size).astype(np.float32)
    if normalize:
        # row-normalize (Kipf preprocessing)
        rsum = np.zeros(st.nodes, np.float64)
        np.add.at(rsum, rows, fvals.astype(np.float64))
        fvals = (fvals / rsum[rows]).astype(np.float32)
    features = Coo(fvals, rows, cols, (st.nodes, st.feat_dim))

    # --- labels from a random *teacher* GCN so the task is learnable and
    # trained weights reach realistic magnitudes (the paper evaluates trained
    # GCNs; detection thresholds see trained-activation scales).
    t1 = rng.normal(0, 1.0, size=(st.feat_dim, st.hidden)).astype(np.float32)
    t2 = rng.normal(0, 1.0, size=(st.hidden, st.classes)).astype(np.float32)
    x1 = s.matmul_dense(features.matmul_dense(t1))
    z = s.matmul_dense(np.maximum(x1, 0.0) @ t2)
    labels = np.argmax(z + 0.1 * rng.normal(size=z.shape), axis=1).astype(np.int64)
    return GraphDataset(stats=st, s=s, features=features, labels=labels)


def reduced_stats(name: str, scale: int = 8) -> GraphStats:
    """A smaller same-shape dataset for CPU-budget fault campaigns/tests."""
    st = STATS[name]
    f = max(1, scale)
    return GraphStats(
        name=f"{name}-r{f}",
        nodes=max(64, st.nodes // f),
        und_edges=max(128, st.und_edges // f),
        feat_dim=max(16, st.feat_dim // f),
        feat_nnz=max(256, st.feat_nnz // f),
        hidden=st.hidden,
        classes=st.classes,
    )


def make_reduced(name: str, scale: int = 8, seed: int = 0) -> GraphDataset:
    st = reduced_stats(name, scale)
    STATS_BACKUP = STATS.get(st.name)
    STATS[st.name] = st
    try:
        return make_dataset(st.name, seed)
    finally:
        if STATS_BACKUP is None:
            del STATS[st.name]
        else:
            STATS[st.name] = STATS_BACKUP
