"""Public wrappers for the fused GCN-layer kernel: operand padding, the
final checksum reduction, Check construction, and the packed
(block-diagonal) per-graph variant.

Counterpart of the JAX package's ``repro/kernels/gcn_fused/ops.py``.  The
shared-memory budget predicates are the SAME objects the engine's fallback
decision and the serving statistics use (``analysis/vmem.py``), re-exported
here as the reference does.  The input-feature axis F is not padded at all
(the CUDA kernel walks it in chunks and masks the ragged end); the output
axis G pads to a multiple of 8 floats; ``block_g`` is accepted for parity of
the call.  The whole-network wrappers and the device-memory traffic models
arrive with the whole-network kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.analysis.vmem import (  # noqa: F401  (re-exported: the
    FUSED_SMEM_BUDGET,                   # runtime fallback predicates and
    _lanes,                              # the kernel launch share ONE model
                                         # — see repro_torch/analysis/vmem.py)
    fused_layer_fits,
    fused_network_fits,
    fused_vmem_bytes,
    network_vmem_bytes,
)
from repro_torch.core.abft import Check
from repro_torch.kernels.spmm_abft.layout import BlockEll
from repro_torch.kernels.spmm_abft.ops import (
    device_block_ell,
    fit_rows,
    packed_check_corners,
    pad_features,
    stripe_check_corners,
    validate_packed_operands,
)

from .kernel import gcn_fused_kernel

Tensor = torch.Tensor


def _pad_weights(w: Tensor, wr: Optional[Tensor], block_g: int
                 ) -> Tuple[Tensor, Tensor]:
    """W [f, g] -> f32 [f, gp] and wr (vector/column/None) -> f32 [f, 1];
    ``wr=None`` (check disabled) becomes a zero column the kernel never
    reads.  The ONE place the weight-operand contract lives — the
    single-graph and packed entry points both pad through here."""
    f = w.shape[0]
    wr = (torch.zeros((f, 1), dtype=torch.float32, device=w.device)
          if wr is None else wr.to(torch.float32).reshape(f, 1))
    wp = pad_features(w.to(torch.float32), _lanes(w.shape[1], block_g))
    return wp.contiguous(), wr.contiguous()


def prepare_fused_operands(bell: BlockEll, h: Tensor, w: Tensor,
                           wr: Optional[Tensor], block_g: int
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """The fused kernel's operand contract: H rows padded (or trimmed — see
    :func:`~repro_torch.kernels.spmm_abft.ops.fit_rows`) to cover every
    referenced column stripe, the output-feature axis of W padded to the
    register-tile quantum, and ``wr`` defaulting to zeros (check disabled) in f32.

    Zero padding is exact end to end: padded W/wr columns add zero output
    columns that the caller trims, and padded H rows are never referenced by
    any stored tile.
    """
    k_pad = max(bell.padded_cols, bell.block_k)
    hp = fit_rows(h, k_pad).to(torch.float32).contiguous()
    wp, wrp = _pad_weights(w, wr, block_g)
    return hp, wp, wrp


def slot_check_corners(slot_acts: Tensor, slot_preds: Tensor) -> Check:
    """Telescoped per-slot running sums -> one eq.-6 corner PER (stripe,
    ell-slot) step — the finest granularity the sweep itself has.

    The kernel records Σ acc and Σ ex after every slot; the slot corner is
    the adjacent difference along the slot axis.  Telescoping is what makes
    detection exact: an accumulator upset between two recordings shifts
    every later running sum by the same delta, so exactly one difference
    diverges — per-slot sums rebuilt from tile products would miss faults
    that corrupt the accumulator itself.  On a clean run each difference is
    bounded by twice the stripe-level f32 noise (both running sums are
    valid partial-sweep eq.-6 comparisons by linearity)."""
    zeros = torch.zeros((slot_acts.shape[0], 1), dtype=slot_acts.dtype,
                        device=slot_acts.device)
    return Check(predicted=torch.diff(slot_preds, dim=1, prepend=zeros),
                 actual=torch.diff(slot_acts, dim=1, prepend=zeros),
                 granularity="slot")


def _fused_result(res, want_check: bool, with_slots: bool, granularity: str,
                  collapse) -> Optional[Check]:
    """The Check of one fused sweep at the asked granularity; ``collapse``
    reduces (stripe_sums, extra) for the coarse granularities."""
    if not want_check:
        return None
    if with_slots:
        return slot_check_corners(res[3], res[4])
    if granularity == "stripe":
        return stripe_check_corners(res[1], res[2])
    return collapse(res[1], res[2])


def gcn_fused_layer(bell: BlockEll, h: Tensor, w: Tensor,
                    w_r: Optional[Tensor] = None, *, block_g: int = 128,
                    granularity: str = "layer",
                    inject: Optional[Tuple[int, int, float]] = None,
                    _staged: Optional[Tuple[Tensor, Tensor]] = None
                    ) -> Tuple[Tensor, Optional[Check]]:
    """out = S (H W) with the single eq. 4–6 check, in ONE kernel sweep.

    ``w_r`` is the folded right checksum W·e ([g_in] vector or [g_in, 1]
    column; offline at weight-load time — ``engine.fold_w_r``).  ``None``
    disables checking (mode="none"): the kernel still runs single-pass and
    skips the eq.-5 products.  Like the two-pass spmm_abft kernel path,
    checks accumulate in f32 regardless of ``ABFTConfig.dtype``.
    ``granularity="stripe"`` keeps the sweep's per-row-stripe partials as
    individual corners instead of one scalar (fault localization);
    ``"slot"`` differences the telescoped running sums.
    ``_staged`` lets a long-lived caller reuse already-staged
    (block_cols, values) device tensors.
    Returns (out [n, g], Check(predicted=Σ S H w_r, actual=Σ out) | None).
    """
    n, _ = bell.shape
    g = w.shape[1]
    cols, vals = _staged if _staged is not None \
        else device_block_ell(bell, h.device)
    want_check = w_r is not None
    with_slots = want_check and granularity == "slot"
    hp, wp, wrp = prepare_fused_operands(bell, h, w, w_r, block_g)
    res = gcn_fused_kernel(cols, vals, hp, wp, wrp, inject=inject,
                           with_check=want_check, with_slots=with_slots)
    chk = _fused_result(
        res, want_check, with_slots, granularity,
        lambda sums, extra: Check(predicted=extra[:n, 0].sum(),
                                  actual=sums.sum()))
    return res[0][:n, :g], chk


def gcn_fused_packed(cols: Tensor, vals: Tensor, h: Tensor, w: Tensor,
                     w_r: Optional[Tensor], segments: Tensor, *,
                     num_segments: int, block_g: int = 128,
                     granularity: str = "graph",
                     inject: Optional[Tuple[int, int, float]] = None
                     ) -> Tuple[Tensor, Optional[Check]]:
    """Fused layer over a block-diagonal packed batch with *per-graph*
    eq.-6 corners — the single-pass analogue of ``spmm_abft_packed``.

    The kernel's per-stripe checksum partials segment-sum into one corner
    per packed graph exactly as in the two-pass path (the checksum is
    linear and each graph owns whole contiguous stripes), so a fault inside
    the fused sweep flags only the graph whose stripes it landed in.
    ``granularity="stripe"`` keeps the partials un-segmented (one corner
    per row-stripe) so the fault names the exact stripe.
    """
    validate_packed_operands(vals, h.shape[0], "h")
    g = w.shape[1]
    want_check = w_r is not None
    with_slots = want_check and granularity == "slot"
    hp = h.to(torch.float32).contiguous()
    wp, wrp = _pad_weights(w, w_r, block_g)
    res = gcn_fused_kernel(cols, vals, hp, wp, wrp, inject=inject,
                           with_check=want_check, with_slots=with_slots)
    chk = _fused_result(
        res, want_check, with_slots, granularity,
        lambda sums, extra: packed_check_corners(sums, extra, segments,
                                                 num_segments))
    return res[0][:, :g], chk
