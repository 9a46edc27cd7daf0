"""Fault-injection engine reproducing the paper's Table I campaign.

The port's own numpy copy of the JAX package's ``repro/core/fault.py``:
the same seed gives the same campaign, outcome for outcome.

Faithful to the paper's setup (§IV-A):
  * single random bit flips in the *results of arithmetic operations* —
    multiplies and adds inside matrix multiplication (float32) and checksum
    accumulation (float64);
  * injection site chosen proportionally to its operation count (faults are
    more likely in longer-running steps), time point uniform within the site;
  * memory assumed protected (inputs fault-free);
  * categories at the end of a layer: detected / false positive / silent;
  * absolute detection thresholds swept over 1e-4 .. 1e-7;
  * criticality: a fault is critical if it flips the argmax class of ≥1 node;
    we also record how many nodes flip (paper's "Avg. Nodes Affected").

Implementation note — the *prefix-delta model*: flipping a bit of the running
partial sum at accumulation step t changes the final element by exactly
``delta = flip(p_t) - p_t`` (the remaining additions are unaffected by where
the perturbation entered, modulo O(eps) re-rounding).  This makes a campaign
cost one prefix dot product instead of an O(ops) scalar-level emulation, so
thousands of campaigns run in CPU-budget.  Downstream criticality is computed
by exact sparse *delta propagation* through the remaining layers (ReLU
re-evaluated on affected entries only).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .datasets import Coo, GraphDataset
from .opcount import SiteOps, fault_sites, gcn_layer_shapes

THRESHOLDS = (1e-4, 1e-5, 1e-6, 1e-7)


# ---------------------------------------------------------------------------
# bit flips
# ---------------------------------------------------------------------------

def flip_bit_f32(x: np.float32, bit: int) -> np.float32:
    i = np.float32(x).view(np.uint32) ^ np.uint32(1 << bit)
    return i.view(np.float32)


def flip_bit_f64(x: np.float64, bit: int) -> np.float64:
    i = np.float64(x).view(np.uint64) ^ np.uint64(1 << bit)
    return i.view(np.float64)


# ---------------------------------------------------------------------------
# fault-free forward with cached intermediates + checksum state
# ---------------------------------------------------------------------------

def glorot_weights(dims: Sequence[int], seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    ws = []
    for fin, fout in zip(dims[:-1], dims[1:]):
        s = np.sqrt(6.0 / (fin + fout))
        ws.append(rng.uniform(-s, s, size=(fin, fout)).astype(np.float32))
    return ws


@dataclasses.dataclass
class LayerState:
    h_in: object                 # Coo (layer 0) or dense np.ndarray
    w: np.ndarray                # [F, G] f32
    x: np.ndarray                # X = H W           (pre-aggregation)
    h_out: np.ndarray            # H_out = S X       (pre-activation)
    # f64 checksum state
    w_r: np.ndarray              # W e
    h_c: np.ndarray              # e^T H (split check state)
    x_r: np.ndarray              # H w_r  (shared by split chk2 and fused)
    sum_x: float                 # actual checksum of X (split chk1)
    sum_hout: float              # actual checksum of H_out
    pred1: float                 # h_c . w_r
    pred2: float                 # s_c . x_r  (== fused prediction)


class NumpyGCN:
    """Fault-free reference forward over a GraphDataset (combination-first)."""

    def __init__(self, ds: GraphDataset, weights: Optional[List[np.ndarray]] = None,
                 seed: int = 0):
        self.ds = ds
        dims = ds.stats.layer_dims
        self.weights = weights or glorot_weights(dims, seed)
        self.s_c = ds.s.col_sums()                       # e^T S (f64, offline)
        self.layers: List[LayerState] = []
        h: object = ds.features
        for k, w in enumerate(self.weights):
            if isinstance(h, Coo):
                x = h.matmul_dense(w)
                h_c = h.col_sums()                        # f64
                w_r = w.astype(np.float64).sum(axis=1)
                x_r = np.zeros(h.shape[0], np.float64)    # x_r = H w_r (f64)
                np.add.at(x_r, h.row, h.data.astype(np.float64) * w_r[h.col])
            else:
                x = h @ w
                h_c = h.astype(np.float64).sum(axis=0)
                w_r = w.astype(np.float64).sum(axis=1)
                x_r = h.astype(np.float64) @ w_r
            h_out = ds.s.matmul_dense(x)
            st = LayerState(
                h_in=h, w=w, x=x, h_out=h_out,
                w_r=w_r, h_c=h_c, x_r=x_r,
                sum_x=float(x.astype(np.float64).sum()),
                sum_hout=float(h_out.astype(np.float64).sum()),
                pred1=float(h_c @ w_r),
                pred2=float(self.s_c @ x_r),
            )
            self.layers.append(st)
            h = np.maximum(h_out, 0.0) if k < len(self.weights) - 1 else h_out
        self.logits = h
        self.pred_cls = np.argmax(self.logits, axis=1)

    # -- accumulation-order prefixes -------------------------------------

    def comb_prefix(self, k: int, i: int, j: int, t: int) -> Tuple[np.float32, np.float32]:
        """(partial sum after t MACs, t-th product) of X_k[i, j]."""
        st = self.layers[k]
        if isinstance(st.h_in, Coo):
            cols, vals = st.h_in.row_slice(i)
        else:
            cols, vals = np.arange(st.h_in.shape[1]), st.h_in[i]
        terms = (vals.astype(np.float32) * st.w[cols, j]).astype(np.float32)
        part = np.float32(terms[: t + 1].sum(dtype=np.float32))
        return part, np.float32(terms[t])

    def agg_prefix(self, k: int, i: int, j: int, t: int) -> Tuple[np.float32, np.float32]:
        st = self.layers[k]
        cols, vals = self.ds.s.row_slice(i)
        terms = (vals.astype(np.float32) * st.x[cols, j]).astype(np.float32)
        part = np.float32(terms[: t + 1].sum(dtype=np.float32))
        return part, np.float32(terms[t])

    def comb_terms(self, k: int, i: int) -> int:
        st = self.layers[k]
        if isinstance(st.h_in, Coo):
            indptr, _, _ = st.h_in.csr()
            return max(int(indptr[i + 1] - indptr[i]), 1)
        return st.h_in.shape[1]

    def agg_terms(self, i: int) -> int:
        indptr, _, _ = self.ds.s.csr()
        return max(int(indptr[i + 1] - indptr[i]), 1)


# ---------------------------------------------------------------------------
# delta propagation for criticality
# ---------------------------------------------------------------------------

def _propagate(model: NumpyGCN, k: int, rows: np.ndarray, cols_j: int,
               dvals: np.ndarray) -> Tuple[bool, int]:
    """Exact effect of H_out_k[rows, j] += dvals on the final argmax.

    Returns (critical?, #nodes whose class flips).  Sparse all the way:
    only affected rows are recomputed.
    """
    ds = model.ds
    n_layers = len(model.layers)
    # current sparse delta on H_out_k: (rows, single column j, dvals).
    # rows must be sorted & unique (searchsorted below relies on it).
    order = np.argsort(rows)
    cur_rows, cur_j, cur_vals = rows[order], cols_j, dvals[order].astype(np.float32)
    for kk in range(k, n_layers):
        st = model.layers[kk]
        last = kk == n_layers - 1
        if kk > k:
            # delta arrived on X_kk (dense rows x all cols): aggregate S @ dX
            dx_rows, dx = cur_rows, cur_dense          # [m, G]
            mask = np.isin(ds.s.col, dx_rows)
            r_idx = ds.s.row[mask]
            c_idx = ds.s.col[mask]
            v = ds.s.data[mask]
            pos = np.searchsorted(dx_rows, c_idx)
            contrib = v[:, None] * dx[pos]
            out_rows = np.unique(r_idx)
            acc = np.zeros((out_rows.size, dx.shape[1]), np.float32)
            np.add.at(acc, np.searchsorted(out_rows, r_idx), contrib)
            hout_rows, hout_delta = out_rows, acc      # full-width delta
        else:
            hout_rows = cur_rows
            hout_delta = None                          # single-column delta
        if last:
            if hout_delta is None:
                new = model.logits[hout_rows].copy()
                new[:, cur_j] += cur_vals
            else:
                new = model.logits[hout_rows] + hout_delta
            flips = int((np.argmax(new, axis=1)
                         != model.pred_cls[hout_rows]).sum())
            return flips > 0, flips
        # ReLU re-evaluation on affected entries, then push through W_{kk+1}
        nxt = model.layers[kk + 1]
        if hout_delta is None:
            old = st.h_out[hout_rows, cur_j]
            dh = np.maximum(old + cur_vals, 0.0) - np.maximum(old, 0.0)
            keep = dh != 0.0
            rows2 = hout_rows[keep]
            if rows2.size == 0:
                return False, 0
            cur_dense = dh[keep, None].astype(np.float32) * nxt.w[cur_j][None, :]
            cur_rows = rows2
        else:
            old = st.h_out[hout_rows]
            dh = np.maximum(old + hout_delta, 0.0) - np.maximum(old, 0.0)
            keep = np.any(dh != 0.0, axis=1)
            rows2 = hout_rows[keep]
            if rows2.size == 0:
                return False, 0
            cur_dense = dh[keep].astype(np.float32) @ nxt.w
            cur_rows = rows2
    return False, 0


# ---------------------------------------------------------------------------
# campaigns
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CampaignOutcome:
    mode: str
    target: str                  # 'mm' | 'check'
    output_corrupted: bool
    critical: bool
    nodes_flipped: int
    diffs: Dict[float, bool]     # threshold -> flagged?


def _flag(diff: float, tau: float) -> bool:
    # NaN/Inf in a checksum must flag (real divergence), hence the negation.
    return not (abs(diff) <= tau)


def _sample_element(rng, n_rows: int, n_cols: int) -> Tuple[int, int]:
    return int(rng.integers(n_rows)), int(rng.integers(n_cols))


def run_campaign(model: NumpyGCN, mode: str, rng: np.random.Generator,
                 thresholds: Sequence[float] = THRESHOLDS,
                 mm_bias: float = 1.0) -> CampaignOutcome:
    """Inject one fault under ABFT policy ``mode`` ('split' | 'fused').

    ``mm_bias`` scales the probability of hitting the matmul datapath
    relative to op-count-proportional sampling.  1.0 = pure op counts (our
    default).  The paper's accelerator has a wide MAC array vs a one-column
    checker, so its effective bias is larger; benchmarks report both.
    """
    ds = model.ds
    sites = fault_sites(ds.stats, mode)
    weights = np.array([s.ops * (mm_bias if s.target == "mm" else 1.0)
                        for s in sites], np.float64)
    site = sites[rng.choice(len(sites), p=weights / weights.sum())]
    st = model.layers[site.layer]
    n, g = st.h_out.shape

    # residuals of the fault-free run (float rounding noise floor)
    r1 = st.sum_x - st.pred1
    r2 = st.sum_hout - st.pred2

    if site.target == "mm":
        if site.phase == "comb":
            i, j = _sample_element(rng, st.x.shape[0], st.x.shape[1])
            nt = model.comb_terms(site.layer, i)
            t = int(rng.integers(nt))
            part, prod = model.comb_prefix(site.layer, i, j, t)
            victim = part if rng.integers(2) else prod     # add vs multiply
            delta = float(flip_bit_f32(victim, int(rng.integers(32)))) - float(victim)
            # detection: chk1 sees delta in sum(X); chk2/fused see the
            # aggregated delta sum(S[:, i]) * delta in sum(H_out).
            d1 = r1 + delta
            agg_gain = float(model.s_c[i])
            d2 = r2 + delta * agg_gain
            if mode == "split":
                flags = {tau: _flag(d1, tau) or _flag(d2, tau) for tau in thresholds}
            else:
                flags = {tau: _flag(d2, tau) for tau in thresholds}
            # criticality: delta lands on X[i,j] -> H_out[:, j] += S[:, i]*delta
            rows, vals = ds.s_col(i)
            crit, flips = _propagate(model, site.layer, rows,
                                     j, vals.astype(np.float64) * delta)
            corrupted = delta != 0.0
        else:  # 'agg': fault in H_out[i, j]
            i, j = _sample_element(rng, n, g)
            nt = model.agg_terms(i)
            t = int(rng.integers(nt))
            part, prod = model.agg_prefix(site.layer, i, j, t)
            victim = part if rng.integers(2) else prod
            delta = float(flip_bit_f32(victim, int(rng.integers(32)))) - float(victim)
            d2 = r2 + delta
            if mode == "split":
                flags = {tau: _flag(r1, tau) or _flag(d2, tau) for tau in thresholds}
            else:
                flags = {tau: _flag(d2, tau) for tau in thresholds}
            crit, flips = _propagate(model, site.layer, np.array([i]), j,
                                     np.array([delta]))
            corrupted = delta != 0.0
        return CampaignOutcome(mode, "mm", corrupted, crit, flips, flags)

    # --- checksum-accumulation fault (float64 state) ----------------------
    # choose which accumulator ∝ its op share within this site
    accs: List[Tuple[str, float]] = []
    ls = gcn_layer_shapes(ds.stats)[site.layer]
    if site.phase == "comb":
        if mode == "split":
            if site.layer > 0:
                accs.append(("h_c", ls.nnz_h))
            accs.append(("x_r", 2 * ls.nnz_h))
            accs.append(("pred1", 2 * ls.f * (ls.g + 1)))
            accs.append(("sum_x", ls.n * ls.g))
        else:
            accs.append(("x_r", 2 * ls.nnz_h))
    else:
        accs.append(("sx_r", 2 * ls.nnz_s))
        accs.append(("pred2", 2 * ls.n * (ls.g + 1)))
        accs.append(("sum_hout", ls.n * ls.g))
    w = np.array([a[1] for a in accs], np.float64)
    which = accs[rng.choice(len(accs), p=w / w.sum())][0]
    bit = int(rng.integers(64))

    def f64_delta(value: float) -> float:
        return float(flip_bit_f64(np.float64(value), bit)) - float(value)

    d1, d2 = r1, r2
    if which == "h_c":
        # corrupts predicted1 via one h_c component: pred1 = Σ h_c[c] w_r[c]
        c = int(rng.integers(st.h_c.size))
        # flip a prefix of the h_c[c] accumulation — approximate the partial
        # by a uniform fraction of the final value (distribution-equivalent
        # for the magnitudes that matter).
        frac = rng.uniform()
        dd = f64_delta(st.h_c[c] * frac) * float(st.w_r[c])
        d1 = r1 - dd
    elif which == "x_r":
        c = int(rng.integers(st.x_r.size))
        dd = f64_delta(st.x_r[c] * rng.uniform())
        d2 = r2 - dd * float(model.s_c[c])
    elif which == "pred1":
        d1 = r1 - f64_delta(st.pred1 * rng.uniform())
    elif which == "sx_r":
        # extra column S x_r — feeds the (unused-for-flagging) upper right
        # block; corrupts nothing the scalar check reads.  Still an injected
        # checksum op per the paper; flags only via rounding floor.
        pass
    elif which == "pred2":
        d2 = r2 - f64_delta(st.pred2 * rng.uniform())
    elif which == "sum_x":
        d1 = r1 + f64_delta(st.sum_x * rng.uniform())
    elif which == "sum_hout":
        d2 = r2 + f64_delta(st.sum_hout * rng.uniform())

    if mode == "split":
        flags = {tau: _flag(d1, tau) or _flag(d2, tau) for tau in thresholds}
    else:
        flags = {tau: _flag(d2, tau) for tau in thresholds}
    return CampaignOutcome(mode, "check", False, False, 0, flags)


@dataclasses.dataclass
class CampaignSummary:
    mode: str
    n: int
    detected: Dict[float, float]
    false_pos: Dict[float, float]
    silent: Dict[float, float]
    masked: Dict[float, float]
    critical_rate: float          # over output-corrupting faults
    avg_nodes_affected: float     # % of nodes flipped, over critical faults


def run_campaigns(model: NumpyGCN, mode: str, n: int, seed: int = 0,
                  thresholds: Sequence[float] = THRESHOLDS,
                  mm_bias: float = 1.0) -> CampaignSummary:
    """Paper taxonomy (§IV-A): every campaign falls into exactly one of
    detected / false-positive / silent per threshold:
      * matmul fault, flagged      -> detected
      * matmul fault, unflagged    -> silent
      * checksum fault, flagged    -> false positive
      * checksum fault, unflagged  -> silent (no separate 'benign' bucket;
        ``masked`` tracks this sub-population for analysis)
    """
    rng = np.random.default_rng(seed)
    det = {t: 0 for t in thresholds}
    fp = {t: 0 for t in thresholds}
    sil = {t: 0 for t in thresholds}
    msk = {t: 0 for t in thresholds}
    crit = 0
    corrupted = 0
    node_pcts: List[float] = []
    n_nodes = model.ds.stats.nodes
    for _ in range(n):
        o = run_campaign(model, mode, rng, thresholds, mm_bias=mm_bias)
        if o.target == "mm" and o.output_corrupted:
            corrupted += 1
            if o.critical:
                crit += 1
                node_pcts.append(100.0 * o.nodes_flipped / n_nodes)
        for t in thresholds:
            flagged = o.diffs[t]
            if o.target == "mm" and o.output_corrupted:
                if flagged:
                    det[t] += 1
                else:
                    sil[t] += 1
            else:
                if flagged:
                    fp[t] += 1
                else:
                    sil[t] += 1
                    msk[t] += 1
    pct = lambda d: {t: 100.0 * v / n for t, v in d.items()}
    return CampaignSummary(
        mode=mode, n=n,
        detected=pct(det), false_pos=pct(fp), silent=pct(sil), masked=pct(msk),
        critical_rate=100.0 * crit / max(corrupted, 1),
        avg_nodes_affected=float(np.mean(node_pcts)) if node_pcts else 0.0,
    )


# ---------------------------------------------------------------------------
# numpy full-batch training — the paper evaluates *trained* GCNs, and trained
# weights set the activation magnitudes that detection thresholds see.
# ---------------------------------------------------------------------------

def train_weights_numpy(ds: GraphDataset, epochs: int = 100, lr: float = 0.5,
                        seed: int = 0) -> List[np.ndarray]:
    """Full-batch GD on softmax cross-entropy over the synthetic labels.
    2-layer combination-first GCN; S is symmetric so S^T = S."""
    dims = ds.stats.layer_dims
    ws = glorot_weights(dims, seed)
    h0, s = ds.features, ds.s
    y = ds.labels
    n = ds.stats.nodes
    onehot = np.zeros((n, dims[-1]), np.float32)
    onehot[np.arange(n), y] = 1.0

    def sp_T_dense(coo: Coo, m: np.ndarray) -> np.ndarray:
        """coo^T @ m  (scatter over transposed indices)."""
        out = np.zeros((coo.shape[1], m.shape[1]), np.float32)
        np.add.at(out, coo.col, coo.data[:, None] * m[coo.row])
        return out

    for _ in range(epochs):
        x1 = h0.matmul_dense(ws[0])
        a1 = s.matmul_dense(x1)
        h1 = np.maximum(a1, 0.0)
        x2 = h1 @ ws[1]
        z = s.matmul_dense(x2)
        zs = z - z.max(1, keepdims=True)
        p = np.exp(zs)
        p /= p.sum(1, keepdims=True)
        dz = (p - onehot) / n
        dx2 = s.matmul_dense(dz)            # S^T = S
        dw2 = h1.T @ dx2
        dh1 = dx2 @ ws[1].T
        da1 = dh1 * (a1 > 0)
        dx1 = s.matmul_dense(da1)
        dw1 = sp_T_dense(h0, dx1)
        ws[0] -= lr * dw1
        ws[1] -= lr * dw2
    return ws
