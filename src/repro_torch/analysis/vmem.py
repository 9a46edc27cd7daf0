"""Static shared-memory budget model — the single source of truth.

Counterpart of the JAX package's ``repro/analysis/vmem.py``, re-stated for
an NVIDIA Hopper card.  There the budget was a TPU core's VMEM and the
fused kernel held a whole ``[block_k, F]`` feature tile plus ``W``
resident.  Here the budget is the dynamic shared memory ONE thread block
may request, and the bytes are what the port's kernels really allocate
(``kernels/csrc/*.cu`` — the launchers request exactly these numbers, and
the wrappers assert that the C side and this module agree).

The function names keep the reference's spelling (``fused_vmem_bytes``,
``fused_layer_fits``, ...) so callers and command lines carry over; on this
card "vmem" reads "shared memory of one block".

The predicates are **one object** shared by ``BlockEllBackend.layer`` /
``BlockEllBackend.network`` (the runtime fallback decisions),
``PackedRunner.fusion_counts`` / ``_warn_fallbacks`` (the serving
statistics) and the kernel wrappers (the launches), so they cannot drift.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

# Dynamic shared memory one block can use on sm_90: 227 KB of the SM's
# 256 KB (the rest stays with L1 and the CUDA runtime).  ``--vmem-budget`` /
# ``vmem_budget=`` override it.
FUSED_SMEM_BUDGET = 232_448

# The fused kernels' register tiles are 8 or 16 columns wide, so the
# output-feature axis pads to a multiple of 8 floats.  (The reference pads it
# to ``block_g`` = 128 lanes, a TPU register shape; ``block_g`` is accepted
# everywhere for parity of the call and does not change the padding here.)
G_QUANTUM = 8
# The fused kernels (kernels/csrc/{abft_tile,fused_tile}.cuh): threads of a
# block, and stages of their cp.async ring.
FUSED_THREADS = 256
FUSED_STAGES = 4
# The combination (phase A): an item owns COMBINE_ROWS rows of H and at most
# COMBINE_COLS columns of X, and streams F in chunks of F_CHUNK features.
COMBINE_ROWS = 64
COMBINE_COLS = 64
F_CHUNK = 64
# The sweep (phase B): a stage holds at most SWEEP_CHUNK k-columns of a
# slot; a block owns a row slice of at most SLICE_ROWS rows of a stripe.
SWEEP_CHUNK = 32
SLICE_ROWS = 128
# columns of X (or of acc) one thread holds
FUSED_COLS = 8
# floats before the ring: the slot telescopes' double buffer, the block
# sum's warp partials, the last-slice flag and the sweep's mbarriers; the
# ring starts at the next FUSED_ALIGN-byte boundary (the TMA swizzle atom)
FUSED_HEADER_FLOATS = 64
FUSED_ALIGN = 1024
# The fused kernels' shape contract: at most this many 2 x 8 pieces in a
# [bk, gp] X tile — the bound of the first port's per-tile design, kept so
# that the engine routes the same layers to these kernels.
FUSED_MAX_X_PIECES = 512
# Most layers the whole-network kernel's launcher takes (its per-layer
# parameter struct has this many entries; a deeper model takes the
# per-layer ladder).
MAX_NETWORK_LAYERS = 8


def _lanes(n: int, block_g: int = 128) -> int:
    """Output-feature width as the kernels see it: ``n`` rounded up to the
    register-tile quantum.  ``block_g`` is ignored (see :data:`G_QUANTUM`)."""
    return -(-n // G_QUANTUM) * G_QUANTUM


# spmm_abft (kernels/csrc/spmm_abft.cu): a block owns at most this many rows
# of one stripe and at least this many k-columns of each of its slots; a
# stripe's blocks (at most SPMM_MAX_CLUSTER: one portable thread-block
# cluster) add their partial tiles and sums in rank order.
SPMM_SLICE_ROWS = 128
SPMM_PART_K = 64
SPMM_MAX_CLUSTER = 8
# stages of its TMA ring (fewer when a wide G would not fit); a stage holds
# 32 k-columns of a slot (16, 8 or 4 where the block's part has no 32)
SPMM_STAGES = 3
# k-groups fill a block up to this many warps
SPMM_TARGET_WARPS = 4
# most columns a thread holds (16 where G allows it, else 8), and most
# threads a block (128 registers a thread)
SPMM_MAX_COLS = 16
SPMM_MAX_THREADS = 512
# the block's and its warps' partial sums and the stages' mbarriers, then
# the ring from the next 1024-byte boundary (the 128-byte swizzle's atom;
# each stage is rounded up to it too)
SPMM_HEADER_BYTES = 256
SPMM_ALIGN = 1024


class SpmmPlan(NamedTuple):
    """How ``spmm_abft`` cuts a stripe: ``slices`` x ``parts`` blocks, each
    owning ``rows`` rows and ``kb`` k-columns of every slot, of
    ``threads`` threads; a thread holds ``rt`` rows x ``cw`` columns
    (``units`` of them make a k-group of ``span`` threads), the block's
    k-columns are split over ``groups`` k-groups, and they stream through a
    ``stages``-deep ring in chunks of ``kc`` — S box [rows, kc], X chunk
    [kc, gp], x_r chunk [kc], rounded to 1024 bytes — in ``smem`` bytes of
    dynamic shared memory: the header, alignment room, then ``stages``
    chunks, which after the sweep hold the k-groups' partials and then the
    block's partial tile."""
    slices: int
    parts: int
    rows: int
    kb: int
    rt: int
    cw: int
    units: int
    span: int
    groups: int
    threads: int
    kc: int
    stages: int
    smem: int


def spmm_parts(bk: int, slices: int) -> int:
    """k-parts each slot of a ``bk``-column block is cut into: the most, up
    to bk / SPMM_PART_K and the cluster's room beside ``slices``, that cut
    bk into whole 4-wide k-vectors."""
    n = min(bk // SPMM_PART_K, SPMM_MAX_CLUSTER // slices)
    while n > 1 and bk % (4 * n):
        n -= 1
    return max(n, 1)


def _spmm_tile(rows: int, gp: int, kc: int) -> Optional[tuple]:
    """(rt, cw, units, span, groups, threads) of a block of ``rows`` rows:
    16 columns a thread where G allows it and the block stays within
    :data:`SPMM_MAX_THREADS`, else 8; None when no tile fits."""
    for cw in ((16, 8) if SPMM_MAX_COLS == 16 and gp % 16 == 0 else (8,)):
        # the most rows a thread holds while a k-group still fills 16 lanes
        rt = next((r for r in (4, 2) if rows % r == 0
                   and (rows // r) * (gp // cw) >= 16), 1)
        units = (rows // rt) * (gp // cw)
        # two k-groups share a warp when a group needs at most 16 lanes
        span = 16 if units <= 16 else 32 * -(-units // 32)
        groups = max(1, min(32 * SPMM_TARGET_WARPS // span, kc // 4))
        threads = 32 * -(-groups * span // 32)
        if threads <= SPMM_MAX_THREADS:
            return rt, cw, units, span, groups, threads
    return None


def spmm_plan(g: int, bm: int, bk: int) -> Optional[SpmmPlan]:
    """The launch plan of ``spmm_abft`` for a [bm, bk] block and G = ``g``
    output columns (padded to :data:`G_QUANTUM`), or None when the kernel
    does not take the shape: row slices (the fewest, from bm /
    SPMM_SLICE_ROWS up, whose rows a block's tile covers) times k-parts,
    one cluster a stripe.  A pure function of the block shape and G — never
    of the stripe count — so a stripe's bits do not depend on the launch it
    is part of.  The kernel library exports the same plan and the wrapper
    asserts that the two agree."""
    gp = _lanes(g)
    if bm < 1 or bk < 4 or bk % 4:
        return None
    for slices in range(-(-bm // SPMM_SLICE_ROWS), SPMM_MAX_CLUSTER + 1):
        if bm % slices:
            continue
        rows, parts = bm // slices, spmm_parts(bk, slices)
        kb = bk // parts
        kc = 32
        while kb % kc:
            kc //= 2
        tile = _spmm_tile(rows, gp, kc)
        if tile is not None:
            break
    else:
        return None
    rt, cw, units, span, groups, threads = tile
    atom = SPMM_ALIGN // 4
    stage = -(-(rows * kc + kc * gp + kc) // atom) * atom
    # after the sweep: the k-groups' partials, then the block's tile
    red = max((groups - 1) * units * (cw + 1) * rt, rows * (gp + 1))
    for stages in range(SPMM_STAGES, 1, -1):
        smem = SPMM_HEADER_BYTES + SPMM_ALIGN + 4 * max(stages * stage, red)
        if smem <= FUSED_SMEM_BUDGET:
            return SpmmPlan(slices, parts, rows, kb, rt, cw, units, span,
                            groups, threads, kc, stages, smem)
    return None


class FusedTile(NamedTuple):
    """How one product of the fused kernels, [rows, nc] += [rows, kc] @
    [kc, nc] a stage, is cut over a block: a thread holds ``rt`` rows x
    :data:`FUSED_COLS` columns (``units`` of them), the stage's k-vectors
    are dealt out to ``groups`` k-groups of ``span`` threads, added in
    group order at the end.  The groups set the association of every
    sum."""
    rows: int
    nc: int
    kc: int
    rt: int
    rpos: int
    units: int
    span: int
    groups: int


def _fused_tile(rows: int, nc: int, kc: int) -> Optional[FusedTile]:
    """``make_tile`` of ``abft_tile.cuh``: 4 rows a thread where that still
    leaves a warp of units, else 2; None when the units outgrow a block."""
    cbs = nc // FUSED_COLS
    rt = 4 if rows % 4 == 0 and (rows // 4) * cbs >= 32 else 2
    if rows < 2 or rows % rt:
        return None
    rpos = rows // rt
    units = rpos * cbs
    span = 16 if units <= 16 else 32 * -(-units // 32)
    if span > FUSED_THREADS:
        return None
    groups = min(FUSED_THREADS // span, kc // 4)
    return FusedTile(rows, nc, kc, rt, rpos, units, span, groups)


def _stage_floats(t: FusedTile) -> int:
    """One combination stage: the H chunk [rows, kc + 4] (4 floats of
    padding a row), W's rows [kc, nc] and w_r's chunk [kc]."""
    return t.rows * (t.kc + 4) + t.kc * t.nc + t.kc


def _box_stage_floats(t: FusedTile) -> int:
    """One sweep stage: the S box [rows, kc] as TMA lands it (swizzled, no
    padding), X's rows [kc, nc] and x_r's [kc], rounded up to the 1024-byte
    atom."""
    atom = FUSED_ALIGN // 4
    return -(-(t.rows * t.kc + t.kc * t.nc + t.kc) // atom) * atom


def _fold_floats(t: FusedTile) -> int:
    """The k-groups' partial tiles that the fold writes (groups 1..)."""
    return (t.groups - 1) * t.units * t.rt * (FUSED_COLS + 1)


class FusedPlan(NamedTuple):
    """The cut of one fused layer (``make_plan`` of ``fused_tile.cuh``).
    Phase A, the combination X = H W: items of COMBINE_ROWS rows x ``ct``
    columns (``col_tiles`` of them across gp), the ``combine`` tile.  Phase
    B, the aggregation: a stripe cut into ``slices`` row slices of
    ``sweep.rows`` rows, one block each, the ``sweep`` tile.  ``smem``: the
    dynamic shared memory of a block (the header, then the larger ring or
    fold)."""
    ct: int
    col_tiles: int
    combine: FusedTile
    sweep: FusedTile
    slices: int
    smem: int

    def library_fields(self) -> tuple:
        """The figures the library's ``gcn_fused_plan`` exports, in its
        order."""
        a, b = self.combine, self.sweep
        return (self.ct, self.col_tiles, a.rt, a.units, a.groups, b.rows,
                b.kc, b.rt, b.units, b.groups, self.slices, self.smem)


def fused_plan(g: int, bm: int, bk: int, *,
               block_g: int = 128) -> Optional[FusedPlan]:
    """The launch plan of ``gcn_fused`` / ``gcn_network`` for a [bm, bk]
    block and G = ``g`` output columns (padded to :data:`G_QUANTUM`), or
    None when the kernels do not take the shape.  A pure function of the
    block shape and G: F only moves where the chunks' zero fill starts, and
    neither the stripe count nor the rows of H nor the grid enter, so the
    single-layer and the network kernel, a gathered stripe sub-system and a
    second run follow one association.  The combination's cut depends on G
    alone.  The kernel library exports the same plan and the wrappers
    assert that the two agree."""
    gp = _lanes(g, block_g)
    if bm < 2 or bm % 2 or bk < 4 or bk % 4 or \
            (bk // 2) * (gp // 8) > FUSED_MAX_X_PIECES:
        return None
    ct = next(c for c in range(COMBINE_COLS, 0, -8) if gp % c == 0)
    combine = _fused_tile(COMBINE_ROWS, ct, F_CHUNK)
    kc = SWEEP_CHUNK
    while bk % kc:
        kc //= 2
    for s in range(-(-bm // SLICE_ROWS), bm // 2 + 1):
        if bm % s == 0 and (bm // s) % 2 == 0:
            sweep = _fused_tile(bm // s, gp, kc)
            if sweep is not None:
                break
    else:
        return None
    floats = max(FUSED_STAGES * _stage_floats(combine),
                 FUSED_STAGES * _box_stage_floats(sweep),
                 _fold_floats(combine), _fold_floats(sweep))
    smem = 4 * FUSED_HEADER_FLOATS + FUSED_ALIGN + 4 * floats
    if smem > FUSED_SMEM_BUDGET:
        return None
    return FusedPlan(ct, gp // ct, combine, sweep, s, smem)


def combine_items(g: int, rows: int) -> int:
    """Blocks of the combination over ``rows`` rows of H: row tiles of
    COMBINE_ROWS times the column tiles of gp."""
    gp = _lanes(g)
    ct = next(c for c in range(COMBINE_COLS, 0, -8) if gp % c == 0)
    return -(-rows // COMBINE_ROWS) * (gp // ct)


def fused_workspace_bytes(g: int, rows: int, *, itemsize: int = 4) -> int:
    """The device workspace a fused layer's wrapper allocates: X [rows, gp]
    and x_r [rows], f32 — 1,253,376 B at Cora's served batch (18,432 rows,
    G = 16), which stays in the 50 MB L2 between the two phases."""
    return itemsize * rows * (_lanes(g) + 1)


def slice_part_floats(nbm: int, width: int, slices: int) -> int:
    """The sweep's scratch of slice sums: per (stripe, slice) block its
    running Σ acc and Σ ex after each slot and its Σ out, which the
    stripe's last slice adds in slice order."""
    return nbm * slices * (2 * width + 1)


def network_workspace_bytes(dims: Sequence[int], rows: int, *,
                            itemsize: int = 4) -> int:
    """The whole-network kernel's one workspace, reused by every layer: the
    widest layer's :func:`fused_workspace_bytes`."""
    return max(fused_workspace_bytes(g, rows, itemsize=itemsize)
               for g in dims[1:])


def fused_vmem_bytes(f: int, g: int, bm: int, bk: int, *,
                     block_g: int = 128, itemsize: int = 4) -> int:
    """Dynamic shared memory of one ``gcn_fused`` block (both of its
    kernels launch with it): :func:`fused_plan`'s ``smem`` — 4 stages of
    the larger phase's chunk (the combination's H chunk [64, 68], W rows
    [64, ct], w_r [64]; the sweep's TMA box of S [rows, kc], X rows
    [kc, gp], x_r [kc], to a 1024-byte atom), or the k-groups' fold where
    that is larger, after a 256-byte header and 1024 bytes of alignment
    room.  F does not enter (F is walked in chunks); 0 where
    the kernels do not take the shape.  ``itemsize`` is kept for the
    reference's call; the kernels are f32."""
    del f, itemsize
    plan = fused_plan(g, bm, bk, block_g=block_g)
    return 0 if plan is None else plan.smem


def fused_tile_supported(g: int, bm: int, bk: int, *,
                         block_g: int = 128) -> bool:
    """The fused kernels' shape contract: an even block_m, block_k % 4 ==
    0, and at most :data:`FUSED_MAX_X_PIECES` 2 x 8 pieces in a [bk, gp]
    X tile."""
    gp = _lanes(g, block_g)
    return bm % 2 == 0 and bk % 4 == 0 and \
        (bk // 2) * (gp // 8) <= FUSED_MAX_X_PIECES


def fused_layer_fits(f: int, g: int, bm: int, bk: int, *,
                     block_g: int = 128,
                     budget: int = FUSED_SMEM_BUDGET) -> bool:
    """True when the fused-layer kernel takes this layer: the shape
    contract holds and one block's shared memory fits the budget — the
    engine falls back to the two-pass kernel otherwise."""
    return fused_tile_supported(g, bm, bk, block_g=block_g) and \
        0 < fused_vmem_bytes(f, g, bm, bk, block_g=block_g) <= budget


def network_vmem_bytes(dims: Sequence[int], bm: int, rows: int, *,
                       block_g: int = 128, itemsize: int = 4) -> int:
    """Dynamic shared memory of one ``gcn_network`` block: the largest
    per-layer figure, ``fused_vmem_bytes(f_l, g_l, bm, bm)`` over the layers
    ``dims = [f_0, g_0 = f_1, ..., g_{L-1}]``.

    The port's design, not the TPU's: the TPU kernel kept two ping-pong
    activation buffers [rows, P] in one core's VMEM, which no Hopper block
    can hold at a real size.  Here every layer's activations live in device
    memory (one [rows, g_l] buffer per layer, read back through L2), so
    ``rows`` does not enter the figure; it is kept for the reference's
    call."""
    del rows
    return max(fused_vmem_bytes(f, g, bm, bm, block_g=block_g,
                                itemsize=itemsize)
               for f, g in zip(dims[:-1], dims[1:]))


def fused_network_fits(dims: Sequence[int], bm: int, rows: int, *,
                       bk: Optional[int] = None, block_g: int = 128,
                       budget: int = FUSED_SMEM_BUDGET) -> bool:
    """True when the whole-network kernel takes this model and block shape:
    square blocks (``bk`` defaults to ``bm``; the activations are indexed
    by the same table on both axes), at most :data:`MAX_NETWORK_LAYERS`
    layers (the launcher's parameter struct), every layer within the shape
    contract (:func:`fused_tile_supported`), and :func:`network_vmem_bytes`
    within the budget.  The engine runs the per-layer ladder (fused layer,
    then two-pass) otherwise.

    This is the port's own predicate: at Cora's widths [1433, 16, 7] and
    block 128 it holds, where the JAX package's (two [rows, P] activation
    buffers in one TPU core's VMEM) declines, so the serving statistics'
    ``network_hits`` follow this predicate, not the reference's."""
    bk = bm if bk is None else bk
    n_layers = len(dims) - 1
    return bm == bk and 1 <= n_layers <= MAX_NETWORK_LAYERS and \
        all(fused_tile_supported(g, bm, bk, block_g=block_g)
            for g in dims[1:]) and \
        0 < network_vmem_bytes(dims, bm, bm, block_g=block_g) <= budget


# ---------------------------------------------------------------------------
# The checked-op kernels (kernels/csrc/matmul_abft.cu, flash_checksum.cu).
# ---------------------------------------------------------------------------

# matmul_abft walks K in steps of this many columns; each step is summed
# into its own partial before it joins the accumulator (the plain version
# associates the same way).
MATMUL_BLOCK_K = 32
# M at or below this takes the thin split-K path (decode steps, the LM
# head): every row of A in one block, B streamed once.
MATMUL_SMALL_M = 16
# The thin path's column tile: one block's 256 threads own one column each.
MATMUL_THIN_N = 256
# The thin path's block_sums tile: 64 columns over all 16 rows, 128 values
# at M = 2.  The kernel and the plain version round each 32-wide chunk of C
# in their own order; over 512 of gemma's head logits (|C| ~ 45) the tile
# sums drift 5e-4 apart, over 128 they stay within 1e-4.
MATMUL_THIN_SUM_N = 64
# The card's streaming multiprocessors (an H100 SXM), a stated constant:
# the split count must be a pure function of the shape, so that the CPU's
# plain version follows the same association as the card.
MATMUL_SMS = 132
# The thin path cuts K into the largest power of two of splits that keeps
# its (column tile, split) items within this many: 4 per SM, so that a
# decode step's narrow products still fill every SM with the 2 resident
# blocks of the f32 M <= 2 kernel, each taking at most 2 items.
MATMUL_MAX_ITEMS = 4 * MATMUL_SMS


# Stages of both paths' cp.async rings (one chunk multiplied, the rest in
# flight).
MATMUL_STAGES = 3
# M > 16 (prefill): the C tile one block of the wide path owns (256
# threads, 8 x 8 outputs each) — a grouped launch's too, with or without
# row counts (its blocks skip the 16-row steps past a group's count; the
# tile, split count and shared memory are the single product's).
MATMUL_WIDE_TILE = (128, 128)
# M > 16: the block_sums tile, each 64-row half of a block's tile.
MATMUL_WIDE_SUM_TILE = (64, 128)


def matmul_tile(m: int) -> tuple:
    """(rows, columns) of the C tile ``block_sums`` is taken over for an
    ``m``-row product: one entry per tile.  M > 16: 64 x 128, each half of
    the 128 x 128 tile one block owns.  M <= 16: 64 columns over all 16
    rows (the reduction kernel's block sums four)."""
    return (MATMUL_SMALL_M, MATMUL_THIN_SUM_N) if m <= MATMUL_SMALL_M \
        else MATMUL_WIDE_SUM_TILE


def matmul_wide_smem_bytes(itemsize: int, trans_b: bool) -> int:
    """Dynamic shared memory of one wide-path block (M > 16): per stage A's
    [128, 32 + v] slice (rows of 32 k plus v elements of padding, v to a
    16-byte piece), B's [32, 128] slice ([128, 32 + v] for a transposed B)
    in the operand dtype, and b_r's 32 f32 values; a transposed B adds one
    k-major [32, 128] buffer, the chunk being multiplied.  104,832 B in f32,
    127,360 B transposed (one block an SM runs: its registers allow no
    second)."""
    v = 16 // itemsize
    bm, bn = MATMUL_WIDE_TILE
    a = bm * (MATMUL_BLOCK_K + v)
    b = bn * (MATMUL_BLOCK_K + v) if trans_b else MATMUL_BLOCK_K * bn
    k_major = MATMUL_BLOCK_K * bn * itemsize if trans_b else 0
    return MATMUL_STAGES * ((a + b) * itemsize + 4 * MATMUL_BLOCK_K) + \
        k_major


def _split_chunks(m: int, n: int, k: int) -> int:
    """32-wide K chunks per split: K cut into the largest power of two of
    splits that keeps ``tiles x splits`` within ``MATMUL_MAX_ITEMS`` and
    every split at least one chunk long; all of K at M > 16."""
    chunks = -(-k // MATMUL_BLOCK_K)
    if m > MATMUL_SMALL_M:
        return chunks
    tiles = -(-n // MATMUL_THIN_N)
    s = 1
    while 2 * s <= chunks and tiles * 2 * s <= MATMUL_MAX_ITEMS:
        s *= 2
    return -(-chunks // s)


def matmul_split_k(m: int, n: int, k: int) -> int:
    """Columns of K one split covers (a multiple of 32; the last split
    ends at K)."""
    return MATMUL_BLOCK_K * _split_chunks(m, n, k)


def matmul_splits(m: int, n: int, k: int) -> int:
    """S, the number of K splits of an ``m x k @ k x n`` product: split s
    covers ``[s * matmul_split_k, min((s + 1) * matmul_split_k, k))``; 1 at
    M > 16.  The kernel library exports the same function and the wrapper
    asserts that the two agree."""
    return -(-k // matmul_split_k(m, n, k))


def _thin_rows(m: int) -> int:
    """The thin path's compile-time row count for ``m`` rows."""
    return next(r for r in (1, 2, 4, 8, 16) if m <= r)


def matmul_thin_smem_bytes(m: int, itemsize: int, trans_b: bool) -> int:
    """Dynamic shared memory of one thin-path block (M <= 16): per stage the
    B chunk in the operand dtype ([32, 256], or [256, 32 + v] for a
    transposed B, v elements to a 16-byte piece), A's [rows, 40] slice and
    b_r's 32 f32 values.  111,936 B at gemma's head (f32, M = 2): two blocks
    a card's SM."""
    v = 16 // itemsize
    b = MATMUL_THIN_N * (MATMUL_BLOCK_K + v) if trans_b \
        else MATMUL_BLOCK_K * MATMUL_THIN_N
    a = _thin_rows(m) * (MATMUL_BLOCK_K + 8)
    return MATMUL_STAGES * ((b + a) * itemsize + 4 * MATMUL_BLOCK_K)


# flash_checksum: a block of 128 threads owns 32 query rows of one (batch,
# head) and walks its part of their key blocks of 32 in order; the head dim
# is a compile-time tile of 64, 128 or 256 (columns past dh are zero).
# 105,216 B at dh = 256 in f32: two blocks an SM.  (The TPU kernel's 128 x 128 blocks do not fit: at dh = 256
# in f32 a 128-row q tile alone is 128 KB of the 227 KB a block may use.)
FLASH_BLOCK_Q = 32
FLASH_BLOCK_K = 32
FLASH_THREADS = 128
FLASH_MAX_DH = 256
# a query tile's key blocks are split into FLASH_PARTS parts, one block of a
# cluster each, folded in part order (the longest block of gemma-2b's
# prefill walks 8 key blocks, not 16)
FLASH_PARTS = 2
# shared memory of one SM on sm_90 (228 KB), the 1 KB each resident block
# reserves included
SM_SMEM_BYTES = 233_472


def flash_head_tile(dh: int) -> int:
    """The kernel's compile-time head-dim tile for ``dh`` (the library's
    ``flash_checksum_head_tile``)."""
    return next(w for w in (64, 128, 256) if dh <= w)


def flash_key_blocks(qt: int, s: int, causal: bool = True) -> int:
    """End of the key blocks that query tile ``qt`` walks over ``s`` keys
    (those wholly above its diagonal skipped under the causal mask)."""
    last = min(s, (qt + 1) * FLASH_BLOCK_Q) if causal else s
    return -(-last // FLASH_BLOCK_K)


def flash_first_block(qt: int, s: int, causal: bool = True,
                      window: int = 0) -> int:
    """First key block that query tile ``qt`` walks: 0, or with a sliding
    window (> 0, causal only; key j is valid for query i iff
    ``i - window < j <= i``) the block of its first row's earliest key."""
    if not causal or window <= 0:
        return 0
    lo = max(0, qt * FLASH_BLOCK_Q - window + 1) // FLASH_BLOCK_K
    return min(lo, flash_key_blocks(qt, s, causal))


def flash_part_start(qt: int, s: int, causal: bool, p: int,
                     window: int = 0) -> int:
    """First key block of part ``p`` of query tile ``qt`` (``p`` =
    FLASH_PARTS: the end): the parts split the tile's key blocks
    ``[flash_first_block, flash_key_blocks)`` evenly, the earlier parts
    taking the extra ones (the library's ``flash_checksum_part_start``)."""
    lo = flash_first_block(qt, s, causal, window)
    return lo + -(-(p * (flash_key_blocks(qt, s, causal) - lo))
                  // FLASH_PARTS)


def flash_smem_bytes(dh: int, *, itemsize: int = 4) -> int:
    """Dynamic shared memory of one ``flash_checksum`` block: the q tile
    [32, w + pad] and the k tile [32, w + pad] (w the head tile, pad 32
    bytes a row: conflict-free 16-byte score reads) and the v tile [32, w],
    in the operands' dtype; then f32: p transposed [32, 32 + 4], the
    carried column's key block [32] and one float per query row (the
    rescale factor, then the final sum).  105,216 B at dh = 256 in f32
    (the library's ``flash_checksum_smem_bytes`` states the f32 figure)."""
    w, bq, bk = flash_head_tile(dh), FLASH_BLOCK_Q, FLASH_BLOCK_K
    return (bq + bk) * (w * itemsize + 32) + bk * w * itemsize \
        + 4 * (bk * (bq + 4) + bk + bq)


def flash_blocks_per_sm(dh: int, *, itemsize: int = 4) -> int:
    """Blocks of ``flash_checksum`` that one SM's shared memory holds (each
    also takes the 1 KB the card reserves a block)."""
    return SM_SMEM_BYTES // (flash_smem_bytes(dh, itemsize=itemsize) + 1024)


# ---------------------------------------------------------------------------
# RungTable lint: evaluate the streaming server's whole shape menu against
# the budget before warmup() runs a single rung.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RungVerdict:
    """Static shared-memory verdict for one rung of a streaming shape
    menu (the reference's fields; bytes are one block's shared memory)."""

    stripe_cap: int
    width_cap: int
    n_slots: int
    rows: int                 # stripe_cap * block — padded row count
    network_bytes: Optional[int]   # whole-network kernel (if requested)
    layer_bytes: int          # widest per-layer fused kernel
    budget: int
    network_fits: Optional[bool]
    layer_fits: bool

    @property
    def fits(self) -> bool:
        """The rung is lint-clean when its *requested* fusion tier fits:
        the whole-network tier when enabled, else the per-layer tier."""
        if self.network_fits is not None:
            return self.network_fits
        return self.layer_fits

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def lint_rung_table(table, dims: Sequence[int], *, block: int,
                    block_g: int = 128, budget: int = FUSED_SMEM_BUDGET,
                    fused_network: bool = False) -> List[RungVerdict]:
    """Evaluate every rung of a ``RungTable`` against the budget.

    ``table`` is duck-typed (anything with ``.rungs`` whose entries carry
    ``stripe_cap``/``width_cap``/``n_slots``) so this module never imports
    the engine.  ``dims`` is the layer-width stack ``[f0, f1, ..., fL]``;
    ``block`` the packed block size (bm == bk).  Uses the predicates the
    engine consults (:func:`fused_layer_fits`, :func:`fused_network_fits`),
    so a "fits" here is the decision the served step will take."""
    dims = [int(d) for d in dims]
    out: List[RungVerdict] = []
    for r in table.rungs:
        rows = int(r.stripe_cap) * int(block)
        layer_bytes = max(
            fused_vmem_bytes(dims[ell], dims[ell + 1], block, block,
                             block_g=block_g)
            for ell in range(len(dims) - 1))
        net_bytes = net_fits = None
        if fused_network:
            net_bytes = network_vmem_bytes(dims, block, rows,
                                           block_g=block_g)
            net_fits = fused_network_fits(dims, block, rows,
                                          block_g=block_g, budget=budget)
        out.append(RungVerdict(
            stripe_cap=int(r.stripe_cap), width_cap=int(r.width_cap),
            n_slots=int(r.n_slots), rows=rows,
            network_bytes=net_bytes, layer_bytes=layer_bytes,
            budget=int(budget), network_fits=net_fits,
            layer_fits=all(
                fused_layer_fits(dims[ell], dims[ell + 1], block, block,
                                 block_g=block_g, budget=budget)
                for ell in range(len(dims) - 1))))
    return out


def _rung_bytes(v: RungVerdict) -> int:
    """The bytes of a rung's requested fusion tier."""
    return v.network_bytes if v.network_fits is not None else v.layer_bytes


def assert_rung_table_fits(table, dims: Sequence[int], *, block: int,
                           block_g: int = 128,
                           budget: int = FUSED_SMEM_BUDGET,
                           fused_network: bool = False) -> List[RungVerdict]:
    """:func:`lint_rung_table`, raising ``ValueError`` naming each
    over-budget rung — the rejection a streaming server wants before
    ``warmup()`` runs anything."""
    verdicts = lint_rung_table(table, dims, block=block, block_g=block_g,
                               budget=budget, fused_network=fused_network)
    bad = [v for v in verdicts if not v.fits]
    if bad:
        tiers = [f"rung(stripes={v.stripe_cap}, width={v.width_cap}, "
                 f"slots={v.n_slots}): {_rung_bytes(v)} bytes > budget "
                 f"{v.budget}" for v in bad]
        raise ValueError(
            "RungTable exceeds the shared-memory budget at its requested "
            "fusion tier; these rungs would fall back at every step:\n  "
            + "\n  ".join(tiers))
    return verdicts


# ---------------------------------------------------------------------------
# Per-launch pricing of a traced graph: every kernel site node's shared
# memory, from its operand shapes, by the functions the wrappers assert.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelSmemEstimate:
    """Shared memory of one block of one traced kernel launch (the
    counterpart of the reference's ``PallasVmemEstimate``)."""

    name: str
    provenance: str
    shape: tuple              # (bm, bk, G), (M, N, K) or (dh,), by kernel
    total_bytes: int          # 0 where the kernel does not take the shape
    budget: int

    @property
    def fits(self) -> bool:
        return 0 < self.total_bytes <= self.budget

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _val(arg):
    if isinstance(arg, (list, tuple)):
        return [_val(a) for a in arg]
    return arg.meta["val"] if hasattr(arg, "meta") else arg


def kernel_site_smem(name: str, args: Sequence) -> tuple:
    """((shape key), shared-memory bytes) of one launch of kernel site
    ``name`` with the (traced) operands ``args``, in the op's argument
    order (``kernels/sites.py``)."""
    a = [_val(x) for x in args]
    if name == "spmm_abft":
        _nbm, _w, bm, bk = a[1].shape
        g = int(a[2].shape[1])
        plan = spmm_plan(g, bm, bk)
        return (bm, bk, g), 0 if plan is None else plan.smem
    if name == "gcn_fused":
        _nbm, _w, bm, bk = a[1].shape
        g = int(a[3].shape[1])
        plan = fused_plan(g, bm, bk)
        return (bm, bk, g), 0 if plan is None else plan.smem
    if name == "gcn_fused_combine":
        g, bm, bk = int(a[1].shape[1]), int(a[3]), int(a[4])
        plan = fused_plan(g, bm, bk)
        return (bm, bk, g), 0 if plan is None else plan.smem
    if name == "gcn_network":
        _nbm, _w, bm, _bk = a[1].shape
        dims = [int(a[2].shape[1])] + [int(w.shape[1]) for w in a[3]]
        return tuple(dims), network_vmem_bytes(dims, bm, a[2].shape[0])
    if name in ("matmul_abft", "matmul_abft_grouped"):
        x, y, trans_b = a[0], a[1], bool(a[3])
        m, k = x.shape[-2:]
        n = y.shape[-2] if trans_b else y.shape[-1]
        item = x.element_size()
        smem = matmul_thin_smem_bytes(m, item, trans_b) \
            if m <= MATMUL_SMALL_M else matmul_wide_smem_bytes(item, trans_b)
        return (int(m), int(n), int(k)), smem
    if name == "flash_checksum":
        dh = int(a[0].shape[3])
        return (dh,), flash_smem_bytes(dh, itemsize=a[0].element_size())
    raise ValueError(f"no shared-memory model for kernel site {name!r}")


def graph_smem_report(gm, *, budget: int = FUSED_SMEM_BUDGET
                      ) -> List[KernelSmemEstimate]:
    """Price every kernel site node of a graph traced by
    ``analysis.coverage.trace`` — the counterpart of the reference's
    ``jaxpr_vmem_report``: one estimate per launch, from the node's operand
    shapes, by :func:`spmm_plan`, :func:`fused_plan`,
    :func:`network_vmem_bytes`, :func:`matmul_thin_smem_bytes` /
    :func:`matmul_wide_smem_bytes` and :func:`flash_smem_bytes` — the
    functions the wrappers assert against the library."""
    from .coverage import PROV_KEY, site_kind

    out = []
    for node in gm.graph.nodes:
        if node.op != "call_function" or \
                site_kind(node.target) != "kernel":
            continue
        name = node.target._overloadpacket.__name__
        shape, smem = kernel_site_smem(name, node.args)
        out.append(KernelSmemEstimate(
            name=name, provenance=node.meta.get(PROV_KEY, "<unknown>"),
            shape=tuple(int(d) for d in shape), total_bytes=int(smem),
            budget=int(budget)))
    return out
