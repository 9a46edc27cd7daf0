"""Public wrappers for the spmm_abft kernel: host layout → device tensors,
padding to block / register-tile multiples, final stripe-sum reduction, and Check
construction.

Counterpart of the JAX package's ``repro/kernels/spmm_abft/ops.py``.  The
reference pads the output-feature axis to ``block_g`` = 128 TPU lanes; the
CUDA kernel needs a multiple of 8 floats (its 2 x 8 register tiles), so ``block_g`` is
kept in every signature for parity of the call and the padding goes to
``analysis.vmem.G_QUANTUM``.  There is no ``interpret`` argument: tensors on
the CPU take the kernel's plain PyTorch version, CUDA tensors launch the
kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.analysis.vmem import _lanes
from repro_torch.core.abft import ABFTConfig, Check, segment_sum
from repro_torch.device import DeviceLike, resolve_device

from .kernel import spmm_abft_kernel
from .layout import BlockEll

Tensor = torch.Tensor


def device_block_ell(bell: BlockEll, device: DeviceLike = "cuda"
                     ) -> Tuple[Tensor, Tensor]:
    """(block_cols, values) as device tensors — stage once per static graph."""
    dev = resolve_device(device)
    return (torch.from_numpy(bell.block_cols).to(dev),
            torch.from_numpy(bell.values).to(dev))


def fit_rows(x: Tensor, rows: int) -> Tensor:
    """Pad or trim x's leading axis to ``rows``.  Trimming is sound: it
    only happens when trailing column-blocks of S hold no nonzero tiles,
    so those x rows are never referenced by any stored tile.  Shared with
    the fused-layer kernel's operand prep (``kernels/gcn_fused/ops.py``)."""
    if x.shape[0] > rows:
        return x[:rows]
    if x.shape[0] < rows:
        return F.pad(x, [0, 0] * (x.ndim - 1) + [0, rows - x.shape[0]])
    return x


def pad_features(x: Tensor, gp: int) -> Tensor:
    """Zero-pad the trailing (feature) axis to ``gp`` columns."""
    g = x.shape[-1]
    return F.pad(x, [0, gp - g]) if gp != g else x


def prepare_operands(bell: BlockEll, x: Tensor, xr: Optional[Tensor],
                     block_g: int) -> Tuple[Tensor, Tensor]:
    """The kernel's operand contract: rows padded to cover every referenced
    column stripe (>= one block_k), the feature axis to the register-tile quantum,
    and ``xr`` defaulting to the standalone column X·e in f32."""
    if xr is None:
        xr = x.to(torch.float32).sum(dim=1, keepdim=True)
    k_pad = max(bell.padded_cols, bell.block_k)
    xp = pad_features(fit_rows(x, k_pad), _lanes(x.shape[1], block_g))
    return xp.contiguous(), fit_rows(xr.to(torch.float32), k_pad).contiguous()


def trim_output(bell: BlockEll, out: Tensor, g: int) -> Tensor:
    """Drop stripe/feature padding back to the logical [n, g] output."""
    return out[:bell.shape[0], :g]


def stripe_check_corners(stripe_sums: Tensor, extra: Tensor) -> Check:
    """Per-stripe kernel partials -> one eq.-6 corner PER ROW-STRIPE.

    The finest check granularity the two-pass kernel supports: the sweep
    already accumulates (actual, predicted) per row-stripe — this just
    declines to collapse them, so a flipped bit names the stripe it landed
    in and recovery can re-execute exactly those rows.  Exact by linearity;
    padding stripes (all-zero tiles) compare 0 = 0 and can never flag.
    Shared by the two-pass (``spmm_abft*``) and single-pass (``gcn_fused*``)
    wrappers."""
    nbm = stripe_sums.shape[0]
    pred = extra[:, 0].reshape(nbm, -1).sum(dim=1)
    return Check(predicted=pred, actual=stripe_sums[:, 0],
                 granularity="stripe")


def spmm_abft(bell: BlockEll, x: Tensor, xr: Optional[Tensor] = None,
              *, block_g: int = 128, granularity: str = "layer",
              inject: Optional[Tuple[int, int, float]] = None,
              _staged: Optional[Tuple[Tensor, Tensor]] = None
              ) -> Tuple[Tensor, Check]:
    """out = S @ X with the fused ABFT check computed in the same pass.

    ``xr`` is the carried right-checksum column: X·e by default (standalone
    check of this multiply), or H·w_r threaded from the combination matmul
    for the full GCN-ABFT chain (eq. 4) — then Check.predicted equals
    s_c H w_r without s_c ever being applied online.
    ``granularity="stripe"`` keeps the kernel's per-row-stripe partials as
    individual corners ([n_block_rows] fields) instead of collapsing to one
    scalar; ``"layer"`` (default) is the paper's single corner.
    ``_staged`` lets a long-lived caller (the engine's block_ell backend)
    reuse already-staged (block_cols, values) device tensors; without it the
    layout is staged on ``x``'s device.
    Returns (out [n, g], Check(predicted=Σ S·xr, actual=Σ out)).
    """
    n, _k_logical = bell.shape
    g = x.shape[1]
    cols, vals = _staged if _staged is not None \
        else device_block_ell(bell, x.device)
    xp, xrp = prepare_operands(bell, x, xr, block_g)
    out, stripe_sums, extra = spmm_abft_kernel(cols, vals, xp, xrp,
                                               inject=inject)
    if granularity == "stripe":
        return trim_output(bell, out, g), stripe_check_corners(stripe_sums,
                                                               extra)
    return trim_output(bell, out, g), Check(predicted=extra[:n, 0].sum(),
                                            actual=stripe_sums.sum())


def validate_packed_operands(vals: Tensor, rows: int, name: str) -> None:
    """Shared contract of the block-diagonal packed kernels: square blocks
    (stripe offset == column-block offset) and a row operand covering every
    padded stripe."""
    nbm, _width, bm, bk = vals.shape
    if bm != bk:
        raise ValueError("block-diagonal packing needs square blocks; "
                         f"got block_m={bm}, block_k={bk}")
    if rows != nbm * bm:
        raise ValueError(f"{name} covers {rows} rows; packed system has "
                         f"{nbm * bm} (= {nbm} stripes x {bm})")


def packed_check_corners(stripe_sums: Tensor, extra: Tensor,
                         segments: Tensor, num_segments: int) -> Check:
    """Per-stripe kernel partials -> one eq.-6 check corner per packed
    graph.  Exact by linearity: each graph owns whole contiguous stripes,
    so segment-summing decomposes the batch checksum with no cross-talk;
    padding stripes carry the overflow id (== num_segments) and are
    dropped.  The segment sums go through ``core.abft.segment_sum`` (a
    masked fixed-order reduction over the sorted stripe → graph map) rather
    than ``index_add_``, whose CUDA atomics would add in a different order
    every run.  Shared by the two-pass (``spmm_abft_packed``) and
    single-pass (``gcn_fused_packed``) paths."""
    nbm = stripe_sums.shape[0]
    pred_stripe = extra[:, 0].reshape(nbm, -1).sum(dim=1)
    pred = segment_sum(pred_stripe, segments, num_segments)
    actual = segment_sum(stripe_sums[:, 0], segments, num_segments)
    return Check(predicted=pred, actual=actual, granularity="graph")


def spmm_abft_packed(cols: Tensor, vals: Tensor, x: Tensor,
                     xr: Optional[Tensor], segments: Tensor,
                     *, num_segments: int, block_g: int = 128,
                     granularity: str = "graph",
                     inject: Optional[Tuple[int, int, float]] = None
                     ) -> Tuple[Tensor, Optional[Check]]:
    """Block-diagonal packed SpMM with *per-graph* fused check corners.

    ``cols``/``vals`` are the staged block-ELL tensors of a block-diagonal
    packed system (``engine.batching.pack_graphs``) with square blocks,
    ``x`` the stacked [rows, g] combination output covering every padded
    row, ``xr`` the stacked carried eq.-5 column (or ``None`` to disable
    checking), and ``segments`` the [n_block_rows] stripe → graph id map
    (padding stripes carry id ``num_segments`` and are dropped).

    Because the checksum is linear and each graph owns whole contiguous
    stripes, segment-summing the kernel's per-stripe partials decomposes the
    batch check *exactly* into one eq.-6 corner per graph:

        actual[g] = Σ_{stripes of g} Σ out_stripe
        pred[g]   = Σ_{rows of g} (S x_r)_row

    so a flipped bit in one packed graph perturbs only that graph's corner.
    ``granularity="stripe"`` refines further: the per-stripe partials stay
    un-segmented ([n_block_rows] corners), so the fault names the exact
    stripe and a surgical retry can re-execute only those rows.
    Returns (out [rows, g], Check(predicted [G], actual [G]) | None).
    """
    validate_packed_operands(vals, x.shape[0], "x")
    rows = x.shape[0]
    g = x.shape[1]
    xp = pad_features(x, _lanes(g, block_g)).contiguous()
    want_check = xr is not None
    xrp = (torch.zeros((rows, 1), dtype=torch.float32, device=x.device)
           if xr is None else xr.to(torch.float32).contiguous())
    out, stripe_sums, extra = spmm_abft_kernel(cols, vals, xp, xrp,
                                               inject=inject)
    out = out[:, :g]
    if not want_check:
        return out, None
    if granularity == "stripe":
        return out, stripe_check_corners(stripe_sums, extra)
    return out, packed_check_corners(stripe_sums, extra, segments,
                                     num_segments)


def spmm_abft_auto(bell: BlockEll, x: Tensor, xr: Optional[Tensor] = None,
                   *, block_g: int = 128) -> Tuple[Tensor, Check]:
    """Same as :func:`spmm_abft`: the reference resolves interpret mode
    here, the port dispatches on ``x``'s device in the kernel wrapper."""
    return spmm_abft(bell, x, xr, block_g=block_g)


def gcn_layer_fused_sparse_kernel(bell: BlockEll, h: Tensor, w: Tensor, *,
                                  w_r: Optional[Tensor] = None,
                                  block_g: int = 128,
                                  device: DeviceLike = "cuda"
                                  ) -> Tuple[Tensor, Check]:
    """One GCN layer H_out = S (H W) with the single fused GCN-ABFT check
    (eqs. 4–6), aggregation through the block-ELL kernel (B1) on
    ``device``.

    Thin shim over the unified engine (``repro_torch.engine``): the eq. 4–6
    algebra lives in ``engine/api.py``; this backend only contributes the
    kernel aggregation, whose fused epilogue carries x_r = H w_r so
    Check.predicted = Σ S H w_r = s_c H w_r with no online s_c pass.
    ``w_r`` (= W·e) is offline in a deployment — fold it at weight-load time.
    """
    from repro_torch.engine import gcn_layer, make_backend

    cfg = ABFTConfig(mode="fused", dtype=torch.float32)
    bk = make_backend(bell, cfg, backend="block_ell", block_g=block_g,
                      device=device)
    h = torch.as_tensor(h).to(bk.device)
    w = torch.as_tensor(w).to(bk.device)
    w_r_vec = None if w_r is None else torch.as_tensor(w_r).to(
        bk.device).reshape(-1)
    h_out, checks = gcn_layer(bk, h, w, cfg, w_r=w_r_vec)
    return h_out, checks[0]
