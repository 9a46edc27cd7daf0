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

from typing import NamedTuple, Optional, Sequence

# Dynamic shared memory one block can use on sm_90: 227 KB of the SM's
# 256 KB (the rest stays with L1 and the CUDA runtime).  ``--vmem-budget`` /
# ``vmem_budget=`` override it.
FUSED_SMEM_BUDGET = 232_448

# The CUDA kernels give each thread a 2-row x 8-column register tile, so the
# output-feature axis pads to a multiple of 8 floats.  (The reference pads it
# to ``block_g`` = 128 lanes, a TPU register shape; ``block_g`` is accepted
# everywhere for parity of the call and does not change the padding here.)
G_QUANTUM = 8
# threads of one kernel block
BLOCK_THREADS = 512
# Feature-axis chunk the fused kernel walks while forming x = h_tile @ W.
F_CHUNK = 32
# floats reserved for the block-wide reduction scratch
_REDUCE_SCRATCH = 32
# Most layers the whole-network kernel's launcher takes (its per-layer
# parameter struct has this many entries; a deeper model takes the
# per-layer ladder).
MAX_NETWORK_LAYERS = 8


def _lanes(n: int, block_g: int = 128) -> int:
    """Output-feature width as the kernels see it: ``n`` rounded up to the
    register-tile quantum.  ``block_g`` is ignored (see :data:`G_QUANTUM`)."""
    return -(-n // G_QUANTUM) * G_QUANTUM


def stripe_smem_bytes(g: int, bm: int, bk: int, *, itemsize: int = 4) -> int:
    """The stripe working set of one ``gcn_fused`` / ``gcn_network`` block,
    on which :func:`fused_vmem_bytes` builds: the accumulator [bm, gp], the
    X tile [bk, gp], the check column's accumulator [bm] and tile [bk], the
    reduction scratch, and the S tile with one padding float per row
    (bank-conflict-free row reads).  (Until its redesign ``spmm_abft`` held
    the same set; its ring is in :func:`spmm_plan`.)"""
    gp = _lanes(g)
    return itemsize * (bm * gp + bk * gp + bm + bk + _REDUCE_SCRATCH
                       + bm * (bk + 1))


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


def fused_vmem_bytes(f: int, g: int, bm: int, bk: int, *,
                     block_g: int = 128, itemsize: int = 4) -> int:
    """Dynamic shared memory of one ``gcn_fused`` block.

    The stripe working set (:func:`stripe_smem_bytes`), plus the staging
    of the on-the-fly combination: the kernel walks the input-feature axis in
    :data:`F_CHUNK` columns, so per step it holds an H chunk
    [bk, F_CHUNK + 1] and the matching W rows [F_CHUNK, gp] and w_r rows
    [F_CHUNK]; the recomputed x tile IS the [bk, gp] X-tile buffer.  ``W``
    is streamed, not resident, so the figure does not grow with ``f``.
    """
    gp = _lanes(g, block_g)
    return stripe_smem_bytes(g, bm, bk, itemsize=itemsize) + itemsize * (
        F_CHUNK * gp + F_CHUNK + bk * (F_CHUNK + 1))


def fused_tile_supported(g: int, bm: int, bk: int, *,
                         block_g: int = 128) -> bool:
    """The fused kernel keeps the recomputed x tile [bk, gp] in registers
    while it walks F, one 2 x 8 register tile per thread at most; the block
    edges must also split into row pairs and 16-byte groups."""
    gp = _lanes(g, block_g)
    return bm % 2 == 0 and bk % 4 == 0 and \
        (bk // 2) * (gp // 8) <= BLOCK_THREADS


def fused_layer_fits(f: int, g: int, bm: int, bk: int, *,
                     block_g: int = 128,
                     budget: int = FUSED_SMEM_BUDGET) -> bool:
    """True when the fused-layer kernel takes this layer: one block's shared
    memory fits the budget and the x tile fits the block's register tiles —
    the engine falls back to the two-pass kernel otherwise."""
    return fused_tile_supported(g, bm, bk, block_g=block_g) and \
        fused_vmem_bytes(f, g, bm, bk, block_g=block_g) <= budget


def network_vmem_bytes(dims: Sequence[int], bm: int, rows: int, *,
                       block_g: int = 128, itemsize: int = 4) -> int:
    """Dynamic shared memory of one ``gcn_network`` block: the largest
    per-layer fused working set, ``fused_vmem_bytes(f_l, g_l, bm, bm)``
    over the layers ``dims = [f_0, g_0 = f_1, ..., g_{L-1}]``.

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
    layers (the launcher's parameter struct), every layer's output tile
    within the register-tile condition (:func:`fused_tile_supported`), and
    :func:`network_vmem_bytes` within the budget.  The engine runs the
    per-layer ladder (fused layer, then two-pass) otherwise.

    This is the port's own predicate: at Cora's widths [1433, 16, 7] and
    block 128 it holds, where the JAX package's (two [rows, P] activation
    buffers in one TPU core's VMEM) declines, so the serving statistics'
    ``network_hits`` follow this predicate, not the reference's."""
    bk = bm if bk is None else bk
    n_layers = len(dims) - 1
    return bm == bk and 1 <= n_layers <= MAX_NETWORK_LAYERS and \
        all(fused_tile_supported(g, bm, bk, block_g=block_g)
            for g in dims[1:]) and \
        network_vmem_bytes(dims, bm, bm, block_g=block_g) <= budget


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
# threads, 8 x 8 outputs each).
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
    in the operand dtype, and b_r's 32 f32 values.  104,832 B in f32 (one
    block an SM runs: its registers allow no second)."""
    v = 16 // itemsize
    bm, bn = MATMUL_WIDE_TILE
    a = bm * (MATMUL_BLOCK_K + v)
    b = bn * (MATMUL_BLOCK_K + v) if trans_b else MATMUL_BLOCK_K * bn
    return MATMUL_STAGES * ((a + b) * itemsize + 4 * MATMUL_BLOCK_K)


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
    """Key blocks that query tile ``qt`` walks over ``s`` keys (those
    wholly above its diagonal skipped under the causal mask)."""
    last = min(s, (qt + 1) * FLASH_BLOCK_Q) if causal else s
    return -(-last // FLASH_BLOCK_K)


def flash_part_start(qt: int, s: int, causal: bool, p: int) -> int:
    """First key block of part ``p`` of query tile ``qt`` (``p`` =
    FLASH_PARTS: the end): the parts split the tile's key blocks evenly,
    the earlier parts taking the extra ones (the library's
    ``flash_checksum_part_start``)."""
    return -(-(p * flash_key_blocks(qt, s, causal)) // FLASH_PARTS)


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
