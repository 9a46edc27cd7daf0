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

from typing import Optional, Sequence

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


def spmm_smem_bytes(g: int, bm: int, bk: int, *, itemsize: int = 4) -> int:
    """Dynamic shared memory of one ``spmm_abft`` block: the accumulator
    [bm, gp], the gathered X tile [bk, gp], the check column's accumulator
    [bm] and tile [bk], the reduction scratch, and the S tile with one
    padding float per row (bank-conflict-free row reads)."""
    gp = _lanes(g)
    return itemsize * (bm * gp + bk * gp + bm + bk + _REDUCE_SCRATCH
                       + bm * (bk + 1))


def fused_vmem_bytes(f: int, g: int, bm: int, bk: int, *,
                     block_g: int = 128, itemsize: int = 4) -> int:
    """Dynamic shared memory of one ``gcn_fused`` block.

    What ``spmm_abft`` holds, plus the staging of the on-the-fly
    combination: the kernel walks the input-feature axis in
    :data:`F_CHUNK` columns, so per step it holds an H chunk
    [bk, F_CHUNK + 1] and the matching W rows [F_CHUNK, gp] and w_r rows
    [F_CHUNK]; the recomputed x tile IS the [bk, gp] X-tile buffer.  ``W``
    is streamed, not resident, so the figure does not grow with ``f``.
    """
    gp = _lanes(g, block_g)
    return spmm_smem_bytes(g, bm, bk, itemsize=itemsize) + itemsize * (
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
# M at or below this takes the thin 4 x 64 tile (one output per thread):
# a decode step's M = 2 would waste 32x the arithmetic in a 64-row tile.
MATMUL_SMALL_M = 16


def matmul_tile(m: int) -> tuple:
    """(rows, columns) of the C tile one ``matmul_abft`` block owns for an
    ``m``-row product; ``block_sums`` has one entry per such tile.  The
    tiles are static shared memory (under 48 KB), so no budget applies."""
    return (4, 64) if m <= MATMUL_SMALL_M else (64, 128)


# flash_checksum: 64 query rows per block, key blocks of 32, head_dim up to
# 256.  The TPU kernel's 128 x 128 blocks do not fit: at dh = 256 in f32 a
# 128-row q tile alone is 128 KB of the 227 KB a block may use.
FLASH_BLOCK_Q = 64
FLASH_BLOCK_K = 32
FLASH_MAX_DH = 256


def flash_smem_bytes(dh: int, *, itemsize: int = 4) -> int:
    """Dynamic shared memory of one ``flash_checksum`` block: the q tile
    [64, dh + 1] and the k tile [32, dh + 1] (one padding float per row:
    conflict-free score reads), the v tile [32, dh], the probabilities
    [64, 33], the carried column's key block [32] and one float per query
    row (the rescale factor, then the final sum).  140,288 B at dh = 256."""
    bq, bk = FLASH_BLOCK_Q, FLASH_BLOCK_K
    return itemsize * (bq * (dh + 1) + bk * (dh + 1) + bk * dh
                       + bq * (bk + 1) + bk + bq)
