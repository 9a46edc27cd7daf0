"""Public wrappers for the fused GCN-layer and whole-network kernels:
operand padding, the final checksum reduction, Check construction, the
packed (block-diagonal) per-graph variants, and the device-memory traffic
models of the three GCN kernel paths.

Counterpart of the JAX package's ``repro/kernels/gcn_fused/ops.py``.  The
shared-memory budget predicates are the SAME objects the engine's fallback
decisions and the serving statistics use (``analysis/vmem.py``),
re-exported here as the reference does.  The input-feature axis F is not
padded at all (the CUDA kernels walk it in chunks and mask the ragged end);
each layer's output axis G pads to a multiple of 8 floats — per layer, also
in the whole-network kernel, which takes no shared padded width; ``block_g``
is accepted for parity of the call.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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
from repro_torch.core.abft import Check, segment_sum
from repro_torch.kernels.spmm_abft.layout import BlockEll
from repro_torch.kernels.spmm_abft.ops import (
    device_block_ell,
    fit_rows,
    packed_check_corners,
    pad_features,
    stripe_check_corners,
    validate_packed_operands,
)

from .kernel import gcn_fused_kernel, gcn_network_kernel

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


def gcn_fused_auto(bell: BlockEll, h: Tensor, w: Tensor,
                   w_r: Optional[Tensor] = None, *, block_g: int = 128
                   ) -> Tuple[Tensor, Optional[Check]]:
    """Same as :func:`gcn_fused_layer`: the reference resolves interpret
    mode here, the port dispatches on ``h``'s device in the kernel
    wrapper."""
    return gcn_fused_layer(bell, h, w, w_r, block_g=block_g)


# ---------------------------------------------------------------------------
# Whole-network fusion: L layers in ONE launch.
# ---------------------------------------------------------------------------

def _network_weights(ws: Sequence[Tensor], wrs: Sequence[Optional[Tensor]],
                     block_g: int) -> Tuple[List[Tensor], List[Tensor]]:
    """Every layer's W / w_r through :func:`_pad_weights`: each layer keeps
    its own widths (F unpadded, G to the register-tile quantum).  The
    reference pads every layer to one shared width P so its activations fit
    two fixed VMEM buffers; the port's kernel keeps one device-memory
    buffer per layer and needs no shared width."""
    padded = [_pad_weights(w, wr, block_g) for w, wr in zip(ws, wrs)]
    return [w for w, _ in padded], [wr for _, wr in padded]


def _network_checks(tele_acts: Tensor, tele_preds: Tensor, granularity: str,
                    segments: Optional[Tensor], num_segments: Optional[int]
                    ) -> List[Check]:
    """Per-layer Checks from the network kernel's telescoped running sums
    [L, nbm, width].  The final telescope value of a stripe IS its stripe
    corner (the same Σ acc / Σ ex the single-layer sweep emits), so every
    granularity reduces from the telescopes exactly as it would from a
    sequential per-layer run."""
    checks: List[Check] = []
    for ell in range(tele_acts.shape[0]):
        ta, tp = tele_acts[ell], tele_preds[ell]
        if granularity == "slot":
            checks.append(slot_check_corners(ta, tp))
        elif granularity == "stripe":
            checks.append(Check(predicted=tp[:, -1], actual=ta[:, -1],
                                granularity="stripe"))
        elif granularity == "graph":
            checks.append(Check(
                predicted=segment_sum(tp[:, -1], segments, num_segments),
                actual=segment_sum(ta[:, -1], segments, num_segments),
                granularity="graph"))
        else:
            checks.append(Check(predicted=tp[:, -1].sum(),
                                actual=ta[:, -1].sum()))
    return checks


def _network_sweep(cols: Tensor, vals: Tensor, hp: Tensor,
                   ws: Sequence[Tensor], wrs: Sequence[Optional[Tensor]], *,
                   block_g: int, granularity: str, inject, stash_acts: bool,
                   segments: Optional[Tensor] = None,
                   num_segments: Optional[int] = None):
    """One network launch on padded operands: (out [rows, g_last], checks,
    stashed post-ReLU activations | None)."""
    want_check = wrs[0] is not None
    wps, wrps = _network_weights(ws, wrs, block_g)
    out, tele_acts, tele_preds, acts = gcn_network_kernel(
        cols, vals, hp, wps, wrps, inject=inject, with_check=want_check,
        stash_acts=stash_acts)
    checks = (_network_checks(tele_acts, tele_preds, granularity, segments,
                              num_segments) if want_check
              else [None] * len(ws))
    return out[:, :ws[-1].shape[1]], checks, acts


def gcn_network_packed(cols: Tensor, vals: Tensor, h0: Tensor,
                       ws: Sequence[Tensor], wrs: Sequence[Optional[Tensor]],
                       segments: Optional[Tensor], *,
                       num_segments: Optional[int] = None,
                       block_g: int = 128, granularity: str = "graph",
                       inject: Optional[Tuple[int, int, int, float]] = None,
                       stash_acts: bool = False
                       ) -> Tuple[Tensor, List[Optional[Check]],
                                  Optional[Tuple[Tensor, ...]]]:
    """An L-layer GCN over a block-diagonal packed batch in ONE kernel
    launch: relu and the next layer's combination follow each layer's
    aggregation inside the launch, and the eq.-5 column is carried across
    every layer boundary — one check per layer, taken pre-activation,
    exactly as the sequential path.

    ``wrs`` entries are the folded per-layer W·e (all present, or all
    ``None`` to disable checking).  ``inject=(layer, stripe, slot, delta)``
    is the accumulator fault hook.  ``stash_acts=True`` also returns the
    per-layer inputs ``h_layers`` (h0, relu(out_0), …) for the
    surgical-repair tiers.  Returns (out [rows, g_last], [Check | None] per
    layer, h_layers | None).
    """
    validate_packed_operands(vals, h0.shape[0], "h0")
    out, checks, acts = _network_sweep(
        cols, vals, h0.to(torch.float32).contiguous(), ws, wrs,
        block_g=block_g, granularity=granularity, inject=inject,
        stash_acts=stash_acts, segments=segments, num_segments=num_segments)
    h_layers = (h0,) + acts if stash_acts else None
    return out, checks, h_layers


def gcn_network_layer(bell: BlockEll, h: Tensor, ws: Sequence[Tensor],
                      wrs: Sequence[Optional[Tensor]], *, block_g: int = 128,
                      granularity: str = "layer",
                      inject: Optional[Tuple[int, int, int, float]] = None,
                      stash_acts: bool = False,
                      _staged: Optional[Tuple[Tensor, Tensor]] = None
                      ) -> Tuple[Tensor, List[Optional[Check]],
                                 Optional[Tuple[Tensor, ...]]]:
    """Single-graph whole-network fusion (see :func:`gcn_network_packed`).

    Requires square blocks; H is padded to the full nbm*block_m stripe rows
    (the activations must cover every output stripe AND every referenced
    column block — a square adjacency always satisfies this).  ``_staged``
    reuses already-staged (block_cols, values) device tensors.
    Returns (out [n, g_last], [Check | None] per layer, h_layers | None);
    stashed h_layers keep the padded stripe rows (the repair path indexes
    them by stripe)."""
    if bell.block_m != bell.block_k:
        raise ValueError("whole-network fusion needs square blocks; got "
                         f"block_m={bell.block_m}, block_k={bell.block_k}")
    if granularity == "graph":
        raise ValueError("granularity='graph' needs a packed batch "
                         "(gcn_network_packed with segments)")
    n, _ = bell.shape
    rows = bell.n_block_rows * bell.block_m
    if bell.padded_cols > rows:
        raise ValueError(f"the adjacency references {bell.padded_cols} "
                         f"columns beyond its {rows} padded rows")
    cols, vals = _staged if _staged is not None \
        else device_block_ell(bell, h.device)
    out, checks, acts = _network_sweep(
        cols, vals, fit_rows(h.to(torch.float32), rows).contiguous(), ws,
        wrs, block_g=block_g, granularity=granularity, inject=inject,
        stash_acts=stash_acts)
    h_layers = (fit_rows(h, rows),) + acts if stash_acts else None
    return out[:n], checks, h_layers


# ---------------------------------------------------------------------------
# Device-memory traffic of the three GCN kernel paths, as their tile
# schedules ask for it: every stored tile (ELL padding tiles included —
# both paths schedule them like real tiles) reads its S tile and its
# operand tile, weights are read once, every output is written once.  The
# models do not know the L2 cache: W's chunks re-read by every combine
# item, the workspace read per stored tile, or an activation the previous
# layer just wrote, count once or per tile as the docstrings say.  They price a BlockEll layout, which analysis/vmem.py
# does not know, so they live here.
# ---------------------------------------------------------------------------

def schedule_bytes_twopass(bell: BlockEll, f: int, g: int, *,
                           itemsize: int = 4) -> int:
    """One two-pass layer: the combination ``torch.matmul`` (read H [n, f]
    and W, write X padded to [k_pad, gp]), the independent eq.-5 column
    H·w_r, then the spmm_abft launch (per stored tile the S tile, one X
    tile and one x_r tile; the index table; out / stripe sums / extra)."""
    gp = _lanes(g)
    nbm, width = bell.n_block_rows, bell.width
    bm, bk = bell.block_m, bell.block_k
    tiles = nbm * width
    k_pad = max(bell.padded_cols, bell.block_k)
    n = bell.shape[0]
    combine = n * f + f * g + k_pad * gp
    eq5 = n * f + f + k_pad
    aggregate = (tiles * (bm * bk + bk * gp + bk) + tiles
                 + nbm * bm * gp + nbm + nbm * bm)
    return itemsize * (combine + eq5 + aggregate)


def schedule_bytes_fused(bell: BlockEll, f: int, g: int, *,
                         itemsize: int = 4) -> int:
    """One gcn_fused launch, its two phases: the combination reads H
    [k_pad, f] once (every row the kernel covers, as the wrapper pads it),
    W [f, gp] and w_r once, and writes the workspace X [k_pad, gp] and x_r
    [k_pad] once; the sweep reads per stored tile the S tile, one X tile
    [bk, gp] and one x_r tile [bk] from the workspace; the index table;
    out / stripe sums / extra."""
    gp = _lanes(g)
    nbm, width = bell.n_block_rows, bell.width
    bm, bk = bell.block_m, bell.block_k
    tiles = nbm * width
    k_pad = max(bell.padded_cols, bell.block_k)
    combine = k_pad * f + f * gp + f + k_pad * gp + k_pad
    sweep = tiles * (bm * bk + bk * gp + bk) + tiles
    return itemsize * (combine + sweep + nbm * bm * gp + nbm + nbm * bm)


def schedule_bytes_network(bell: BlockEll, dims: Sequence[int], *,
                           itemsize: int = 4) -> int:
    """One gcn_network launch over layer widths ``dims``: per layer the
    combination reads its input once ([rows, F_l]: h0 at layer 0, the
    previous layer's activations after — written once [rows, F_{l+1}] and
    read back through L2), W_l [F_l, gp_l] and w_r once, and writes the
    workspace X [rows, gp_l] and x_r [rows] once; the sweep reads per
    stored tile the S tile, one X tile [bk, gp_l] and one x_r tile [bk],
    the index table again, writes the slot telescopes, and at the last
    layer the logits [rows, gp] once.  The activation buffers double as the
    repair stash, so stashing adds nothing."""
    nbm, width = bell.n_block_rows, bell.width
    bm, bk = bell.block_m, bell.block_k
    tiles = nbm * width
    rows = nbm * bm
    traffic = 0
    for ell, (f, g) in enumerate(zip(dims[:-1], dims[1:])):
        gp = _lanes(g)
        traffic += rows * f + f * gp + f + rows * gp + rows     # combine
        traffic += (tiles * (bm * bk + bk * gp + bk) + tiles
                    + 2 * tiles)                                # sweep
        traffic += rows * gp if ell == len(dims) - 2 else rows * g
    return itemsize * traffic


# The JAX package's names for the same three models (its ``hbm_bytes_*``);
# ``block_g`` and ``stash_acts`` are accepted for parity of the call — the
# port pads G to the register-tile quantum whatever ``block_g`` says, and
# its stashed activations are the network kernel's own buffers.

def hbm_bytes_twopass(bell: BlockEll, f: int, g: int, *, block_g: int = 128,
                      itemsize: int = 4) -> int:
    return schedule_bytes_twopass(bell, f, g, itemsize=itemsize)


def hbm_bytes_fused(bell: BlockEll, f: int, g: int, *, block_g: int = 128,
                    itemsize: int = 4) -> int:
    return schedule_bytes_fused(bell, f, g, itemsize=itemsize)


def hbm_bytes_network(bell: BlockEll, dims: Sequence[int], *,
                      block_g: int = 128, stash_acts: bool = False,
                      itemsize: int = 4) -> int:
    return schedule_bytes_network(bell, dims, itemsize=itemsize)
