"""Stripe-surgical fault recovery: re-execute ONLY the rows a fault hit.

Counterpart of the JAX package's ``repro/engine/localize.py``.  The
host-side index logic (which stripes are flagged, which are reachable
downstream, which rows changed) is the reference's, in numpy over the host
copy of the packed layout; the recomputation runs through the port's
kernels on the device the batch lives on, and the repaired logits and
activations stay there.

The eq. 4–6 corner is linear, so the packed kernels can keep their
per-row-stripe checksum partials as individual corners
(``granularity="stripe"``) — a detected fault then *names the stripe* it
corrupted instead of condemning a whole graph.  This module turns that
name into the cheapest exact repair the layout admits:

  1. **gather** the flagged stripes' tile rows + column-index table into a
     sub-system (:func:`gather_stripe_system`) — the cols table keeps its
     original column-block indices, so the FULL packed H stays the operand
     and no re-packing happens;
  2. **recompute** those stripes through the kernel that ran them.  A
     fused layer — single-layer or inside the whole-network kernel, which
     runs each stripe through the same sweep — replays through the
     single-pass fused kernel (``kernels/gcn_fused``); a two-pass layer
     whose combination output X was stashed (``abft_x_layers``,
     ``gcn_forward(..., return_x=True)``) replays its aggregation through
     the two-pass spmm kernel against that exact X.  Each stripe
     accumulates independently in the same slot order over the same tiles,
     so either way the recomputed rows are *bit-for-bit* the values a clean
     full sweep would have produced.  (A two-pass original with no stashed
     X falls back to the fused recompute — exact up to f32 reassociation,
     re-verified by its own corners, just not bitwise — and a layer the
     fused kernel does not take escalates instead of running a kernel the
     engine rejected.);
  3. **splice** the rows back (through ReLU for non-final layers) and
     propagate: a repaired stripe's rows are column blocks of the next
     layer, so only the stripes whose cols table references them (nonzero
     tiles — block-diagonal keeps this inside the owning graph) need
     re-execution downstream, not the whole graph;
  4. **re-verify**: the sub-sweep carries its own per-stripe corners; any
     corner still flagged aborts the repair and the guard escalates to the
     per-graph retry tier.

Recovery cost is counted in re-executed rows (``abft_rows_recomputed``):
a last-layer fault costs one stripe; an early-layer fault costs one stripe
plus the reachable downstream stripes — strictly less than the per-graph
retry's rows(graph) x layers whenever a graph spans more than one stripe.

:func:`surgical_slot_retry` is the tier below: at ``granularity="slot"``
the fused kernels' telescoped corners name the exact (stripe, ell-slot)
the fault landed in, and the repair refines downstream propagation to the
*rows that actually changed*.  After recomputing a flagged stripe it diffs
the new post-ReLU rows against the stashed activations; a downstream
stripe re-executes only if one of its stored tiles has a nonzero column
AT a changed row (0·x = 0 exactly, so skipping a zero column is sound —
and a fault ReLU already masked to zero propagates nowhere).
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.abft import ABFTConfig
from repro_torch.core.checksum import row_checksum
from repro_torch.kernels.spmm_abft.layout import BlockEll
from repro_torch.runtime.abft_guard import _host

log = logging.getLogger(__name__)

Tensor = torch.Tensor


def gather_stripe_system(bell: BlockEll, stripe_idx) -> BlockEll:
    """Sub-system holding only ``stripe_idx``'s tile rows.

    The column-block indices are NOT remapped: the sub-system's stripes
    still gather from the full packed H/X rows, which is what makes the
    recompute a pure row-subset of the original sweep (same tiles, same
    slot order, same operand values — bitwise-identical stripe outputs).
    """
    idx = np.asarray(stripe_idx, np.int64)
    return BlockEll(values=bell.values[idx],
                    block_cols=bell.block_cols[idx],
                    shape=(int(idx.size) * bell.block_m, bell.shape[1]))


def _layer_stripe_flags(sflags: np.ndarray, n_layers: int) -> np.ndarray:
    """[n_checks, nbm] per-check stripe flags -> [n_layers, nbm].

    Fused mode emits one check per layer; split mode two (combination +
    corner).  Rows group contiguously per layer, so OR-reducing each
    layer's group attributes every flag to the layer that must re-execute.
    """
    if sflags.ndim != 2 or sflags.shape[0] % n_layers or not sflags.shape[0]:
        raise ValueError(
            f"abft_stripe_flags has shape {sflags.shape}; expected "
            f"[k*{n_layers} checks, n_stripes] (k checks per layer)")
    per = sflags.shape[0] // n_layers
    return sflags.reshape(n_layers, per, sflags.shape[1]).any(axis=1)


def _layer_slot_flags(slflags: np.ndarray, n_layers: int) -> np.ndarray:
    """[n_checks, nbm, width] per-check slot flags -> [n_layers, nbm,
    width], same contiguous-per-layer grouping as the stripe reduction."""
    if slflags.ndim != 3 or slflags.shape[0] % n_layers \
            or not slflags.shape[0]:
        raise ValueError(
            f"abft_slot_flags has shape {slflags.shape}; expected "
            f"[k*{n_layers} checks, n_stripes, width]")
    per = slflags.shape[0] // n_layers
    return slflags.reshape((n_layers, per) + slflags.shape[1:]).any(axis=1)


def _stashed_x_layers(metrics, n_layers: int
                      ) -> Optional[List[Optional[Tensor]]]:
    """Writable copies of the step's per-layer combination outputs
    (``abft_x_layers``), or None when the step didn't stash them.  Entries
    are None for layers a fused hook ran (no X ever existed)."""
    xs = metrics.get("abft_x_layers")
    if xs is None:
        return None
    xs = [None if x is None else x.clone() for x in xs]
    if len(xs) != n_layers:
        raise ValueError(f"abft_x_layers carries {len(xs)} arrays; "
                         f"the model has {n_layers} layers")
    return xs


def _stashed_h_layers(metrics, n_layers: int) -> List[Tensor]:
    """Writable copies of every layer's input activations
    (``abft_h_layers``)."""
    hs = [h.clone() for h in metrics["abft_h_layers"]]
    if len(hs) != n_layers:
        raise ValueError(f"abft_h_layers carries {len(hs)} arrays; "
                         f"the model has {n_layers} layers")
    return hs


def _recompute_stripes(bell: BlockEll, todo, w, w_r, h_ell, x_ell,
                       cfg: ABFTConfig, *, block_g: int):
    """Re-execute ``todo``'s stripes of one layer through the kernel that
    ran them originally: the two-pass spmm against the stashed X when
    ``x_ell`` is given (bit-for-bit replay of a two-pass layer), else the
    single-pass fused kernel (bit-for-bit for a fused original, whole-
    network included).  Runs on ``h_ell``'s device.  Returns (sub_out,
    per-stripe Check), or None when the fused kernel does not take the
    layer and no X is stashed — the caller escalates rather than forcing a
    kernel the engine itself refused to run."""
    sub = gather_stripe_system(bell, todo)
    if x_ell is not None:
        from repro_torch.kernels.spmm_abft.ops import spmm_abft
        xr = (h_ell.to(cfg.dtype) @ w_r)[:, None]
        return spmm_abft(sub, x_ell, xr, block_g=block_g,
                         granularity="stripe")
    from repro_torch.kernels.gcn_fused.ops import (fused_layer_fits,
                                                   gcn_fused_layer)
    if not fused_layer_fits(*w.shape, bell.block_m, bell.block_k,
                            block_g=block_g):
        return None
    return gcn_fused_layer(sub, h_ell, w, w_r, block_g=block_g,
                           granularity="stripe")


def _layer_w_r(layer, cfg: ABFTConfig):
    w_r = layer.get("w_r")
    return row_checksum(layer["w"], cfg.dtype) if w_r is None else w_r


class _Repair:
    """Shared state of one surgical repair: the writable operand stashes,
    the repaired logits and the accounting, plus the escalation result."""

    def __init__(self, pb, params, cfg, out, metrics, tier: str,
                 block_g: int):
        self.layers = params["layers"]
        self.block_g = block_g
        self.n_layers = len(self.layers)
        self.cfg = cfg
        self.tier = tier
        self.h_layers = _stashed_h_layers(metrics, self.n_layers)
        self.x_layers = _stashed_x_layers(metrics, self.n_layers)
        self.bell = pb.bell
        self.bm = pb.bell.block_m
        self.stripe_graph = np.asarray(pb.stripe_graph)
        self.n_slots = pb.n_slots
        self.orig_flags = _host(metrics["abft_graph_flags"]).astype(bool)
        self.out = out
        self.repaired = out.clone()
        self.graph_rel = np.zeros(self.n_slots, np.float32)
        self.rows_recomputed = 0
        self.stripes_recomputed = 0

    def escalate(self, reason: str):
        log.error("ABFT %s repair escalating: %s", self.tier, reason)
        return self.out, {
            "abft_graph_flags": self.orig_flags.copy(),
            "abft_rows_recomputed": self.rows_recomputed,
            "abft_stripes_recomputed": self.stripes_recomputed,
        }

    def padding_flagged(self, stripes) -> bool:
        # a padding stripe's corner is 0 = 0 by construction; it flagging
        # means the batch invariants are broken — do not guess, hand the
        # step to the coarser tiers
        return any(self.stripe_graph[s] >= self.n_slots for s in stripes)

    def live(self, mask: np.ndarray) -> set:
        return {s for s in np.nonzero(mask)[0].tolist()
                if self.stripe_graph[s] < self.n_slots}

    def recompute(self, ell: int, todo):
        """(sub_out, per-stripe rel) of ``todo`` at layer ``ell``, or an
        escalation reason (str)."""
        layer = self.layers[ell]
        w = layer["w"]
        x_ell = self.x_layers[ell] if self.x_layers is not None else None
        res = _recompute_stripes(self.bell, todo, w,
                                 _layer_w_r(layer, self.cfg),
                                 self.h_layers[ell], x_ell, self.cfg,
                                 block_g=self.block_g)
        if res is None:
            # the engine itself would refuse to run this layer fused and no
            # X was stashed — recovery must not be the one place that
            # kernel is forced to run
            return (f"layer {ell} [f, g]={tuple(w.shape)} is outside the "
                    f"fused kernel and no X is stashed")
        sub_out, chk = res
        self.rows_recomputed += len(todo) * self.bm
        self.stripes_recomputed += len(todo)
        if bool(chk.flag(self.cfg)):
            return f"recomputed stripes still flagged at layer {ell}"
        _, rel = chk.elementwise(self.cfg)
        rel = _host(rel)
        for k, s in enumerate(todo):
            g = self.stripe_graph[s]
            self.graph_rel[g] = max(self.graph_rel[g], float(rel[k]))  # abftlint: sync-ok (host array)
        return sub_out

    def splice(self, ell: int, s: int, rows: Tensor,
               refresh_unchanged: bool) -> Optional[np.ndarray]:
        """Write stripe ``s``'s recomputed rows of layer ``ell`` back:
        through ReLU into the next layer's input (refreshing its stashed X
        rows — also when no row changed, with ``refresh_unchanged``), or
        into the logits.  Returns the changed-row mask [bm] of a non-final
        layer's activations (host bool), else None."""
        r0 = s * self.bm
        if ell == self.n_layers - 1:
            self.repaired[r0:r0 + self.bm] = rows
            return None
        act = torch.relu(rows)
        nxt = self.h_layers[ell + 1]
        changed = _host((act != nxt[r0:r0 + self.bm]).any(dim=1))
        nxt[r0:r0 + self.bm] = act
        if (refresh_unchanged or changed.any()) \
                and self.x_layers is not None \
                and self.x_layers[ell + 1] is not None:
            # the spliced activations invalidate the NEXT layer's stashed
            # combination rows — refresh them so its replay consumes the
            # repaired operands
            self.x_layers[ell + 1][r0:r0 + self.bm] = \
                act @ self.layers[ell + 1]["w"]
        return changed

    def adopted(self):
        log.warning("ABFT: %s-surgical repair verified clean "
                    "(%d stripes / %d rows re-executed)", self.tier,
                    self.stripes_recomputed, self.rows_recomputed)
        return self.repaired, {
            "abft_graph_flags": np.zeros(self.n_slots, bool),
            "abft_graph_max_rel": self.graph_rel,
            "abft_rows_recomputed": self.rows_recomputed,
            "abft_stripes_recomputed": self.stripes_recomputed,
        }


def surgical_stripe_retry(pb, params, cfg: ABFTConfig, out: Tensor,
                          metrics, *, block_g: int = 128
                          ) -> Tuple[Tensor, Dict[str, Any]]:
    """Repair a flagged packed step by re-executing only the hit stripes.

    ``pb`` is the :class:`~repro_torch.engine.batching.PackedGraphs` batch
    the step ran; ``metrics`` must carry ``abft_stripe_flags`` (the
    per-(check, stripe) verdicts) and ``abft_h_layers`` (every layer's
    input activations, ``gcn_forward(..., return_intermediates=True)`` — or
    the whole-network kernel's stash); ``abft_x_layers`` (the stashed
    two-pass combination outputs, ``return_x=True``), when present, lets
    two-pass layers replay through the spmm kernel bit-for-bit.  Returns
    ``(repaired_out, sub_metrics)`` in the guard's stripe-tier contract:
    ``sub_metrics['abft_graph_flags']`` is the FULL [n_slots] vector
    (all-False on verified success; the original flags when the repair
    could not be verified, so the guard escalates), plus the
    ``abft_rows_recomputed`` / ``abft_stripes_recomputed`` accounting.
    ``repaired_out`` stays on ``out``'s device (a copy).
    """
    rep = _Repair(pb, params, cfg, out, metrics, "stripe", block_g)
    sflags = _layer_stripe_flags(
        _host(metrics["abft_stripe_flags"]).astype(bool), rep.n_layers)
    dirty_cols: set = set()          # column blocks whose H rows changed
    for ell in range(rep.n_layers):
        flagged = set(np.nonzero(sflags[ell])[0].tolist())  # abftlint: sync-ok (host array, post-flag repair path)
        if rep.padding_flagged(flagged):
            return rep.escalate("padding stripe flagged")
        todo = sorted(flagged | rep.live(
            _reachable_stripes(rep.bell, dirty_cols)))
        if not todo:
            continue
        sub_out = rep.recompute(ell, todo)
        if isinstance(sub_out, str):
            return rep.escalate(sub_out)
        for k, s in enumerate(todo):
            rep.splice(ell, s, sub_out[k * rep.bm:(k + 1) * rep.bm], True)
        dirty_cols = set(todo)       # square blocks: stripe s == col block s
    return rep.adopted()


def _reachable_stripes(bell: BlockEll, col_blocks: set) -> np.ndarray:
    """[n_block_rows] mask of stripes that read any of ``col_blocks``' rows
    through a stored (nonzero) tile.  ELL padding tiles alias column-block
    0 with all-zero values — they must not mark graph 0's stripes dirty."""
    if not col_blocks:
        return np.zeros(bell.n_block_rows, bool)
    hit = np.isin(bell.block_cols,
                  np.fromiter(col_blocks, np.int64, len(col_blocks)))
    stored = np.abs(bell.values).max(axis=(2, 3)) > 0
    return (hit & stored).any(axis=1)


def _rows_reachable_stripes(bell: BlockEll,
                            dirty: Dict[int, np.ndarray]) -> np.ndarray:
    """[n_block_rows] mask of stripes that read a CHANGED row of a dirty
    column block through a nonzero tile column — the slot tier's row-level
    refinement of :func:`_reachable_stripes`.  A tile column that is all
    zero contributes exactly 0 regardless of the operand row (0·x = 0 in
    f32), so skipping it cannot change the recomputed output bitwise."""
    mask = np.zeros(bell.n_block_rows, bool)
    if not dirty:
        return mask
    # nonzero per tile COLUMN: tile columns index the operand's local rows
    colnz = np.abs(bell.values).max(axis=2) > 0      # [nbm, width, bk]
    for cb, rowmask in dirty.items():
        if not rowmask.any():
            continue
        hit = bell.block_cols == cb                  # [nbm, width]
        mask |= (hit[:, :, None] & colnz
                 & rowmask[None, None, :]).any(axis=(1, 2))
    return mask


def surgical_slot_retry(pb, params, cfg: ABFTConfig, out: Tensor, metrics,
                        *, block_g: int = 128
                        ) -> Tuple[Tensor, Dict[str, Any]]:
    """The ladder's finest tier: repair from per-(stripe, slot) verdicts
    with row-level downstream propagation.

    Same contract as :func:`surgical_stripe_retry` (FULL-batch
    ``abft_graph_flags``, rows/stripes accounting; the guard escalates to
    the stripe tier when the repair cannot be verified), but consumes
    ``metrics['abft_slot_flags']`` ([n_checks, n_stripes, width] telescope
    corners) and refines propagation: after recomputing a flagged stripe
    it diffs the new post-ReLU rows against the stashed activations and
    marks ONLY the changed rows dirty — a downstream stripe re-executes
    only if a stored tile reads a changed row through a nonzero column.
    """
    rep = _Repair(pb, params, cfg, out, metrics, "slot", block_g)
    slflags = _layer_slot_flags(
        _host(metrics["abft_slot_flags"]).astype(bool), rep.n_layers)
    dirty: Dict[int, np.ndarray] = {}    # col block -> [bm] changed rows
    for ell in range(rep.n_layers):
        flagged = set(np.nonzero(slflags[ell].any(axis=1))[0].tolist())  # abftlint: sync-ok (host array, post-flag repair path)
        if rep.padding_flagged(flagged):
            return rep.escalate("padding stripe flagged")
        todo = sorted(flagged | rep.live(
            _rows_reachable_stripes(rep.bell, dirty)))
        dirty = {}
        if not todo:
            continue
        sub_out = rep.recompute(ell, todo)
        if isinstance(sub_out, str):
            return rep.escalate(sub_out)
        for k, s in enumerate(todo):
            changed = rep.splice(ell, s, sub_out[k * rep.bm:(k + 1) * rep.bm],
                                 False)
            if changed is not None and changed.any():
                # square blocks: stripe s == column block s; only the rows
                # that actually changed can perturb downstream
                dirty[s] = changed
    return rep.adopted()
