"""Numpy references for the fused GCN-layer and whole-network kernels.

Computes the quantities the kernel emits, in f64, from the dense
reconstruction of the block-ELL operand — the ground truth the single-pass
sweep must reproduce within f32 accumulation tolerance.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.kernels.spmm_abft.layout import BlockEll


def gcn_fused_ref(bell: BlockEll, h: np.ndarray, w: np.ndarray,
                  w_r: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, float, float]:
    """(out [n, g], predicted, actual) in f64 for one layer S (H W).

    ``predicted`` is the eq.-4 corner s_c H w_r computed the offline way
    (column sums of S applied to H w_r); ``actual`` the total checksum of
    the output.  ``w_r`` defaults to the canonical fold W·e.
    """
    n = bell.shape[0]
    s = bell.todense().astype(np.float64)[:n, :n]
    h = np.asarray(h, np.float64)[:n]
    w = np.asarray(w, np.float64)
    w_r = w.sum(axis=1) if w_r is None else np.asarray(w_r, np.float64).ravel()
    out = s @ (h @ w)
    predicted = float(s.sum(axis=0) @ (h @ w_r))
    actual = float(out.sum())
    return out, predicted, actual


def gcn_network_ref(bell: BlockEll, h0: np.ndarray,
                    ws: Sequence[np.ndarray],
                    w_rs: Optional[Sequence[np.ndarray]] = None
                    ) -> Tuple[np.ndarray, List[Tuple[float, float]]]:
    """(logits [n, g_last], [(predicted, actual)] per layer) in f64 for the
    L-layer network ``H_{l+1} = relu(S (H_l W_l))`` (no ReLU after the
    last layer).

    Each layer's corner is taken pre-activation, as the kernels take it:
    ``predicted`` the eq.-4 corner s_c H_l w_r,l, ``actual`` the total
    checksum of S (H_l W_l).  ``w_rs`` default to the canonical folds W·e.
    """
    n = bell.shape[0]
    s = bell.todense().astype(np.float64)[:n, :n]
    h = np.asarray(h0, np.float64)[:n]
    corners = []
    for ell, w in enumerate(ws):
        w = np.asarray(w, np.float64)
        w_r = w.sum(axis=1) if w_rs is None \
            else np.asarray(w_rs[ell], np.float64).ravel()
        out = s @ (h @ w)
        corners.append((float(s.sum(axis=0) @ (h @ w_r)), float(out.sum())))
        h = np.maximum(out, 0.0) if ell < len(ws) - 1 else out
    return h, corners
