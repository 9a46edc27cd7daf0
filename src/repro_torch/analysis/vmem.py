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

The predicates are **one object** shared by ``BlockEllBackend.layer`` (the
runtime fallback decision), ``PackedRunner.fusion_counts`` (the serving
statistics) and the kernel wrapper (the launch), so the three cannot drift.
"""
from __future__ import annotations

from typing import Sequence

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
    """Shared memory a whole-network sweep would need if ONE block kept the
    activation matrix on chip across layer boundaries: two ping-pong
    buffers [rows, P] at the shared padded width P, on top of the widest
    fused layer's working set.  The whole-network kernel is not ported yet;
    this is the model its fallback ladder will consult, kept so the serving
    statistics have one place to ask."""
    p = _lanes(max(dims), block_g)
    n_layers = len(dims) - 1
    act = 2 * rows * p if n_layers > 1 else 0
    return itemsize * act + fused_vmem_bytes(p, p, bm, bm, block_g=block_g,
                                             itemsize=itemsize)


def fused_network_fits(dims: Sequence[int], bm: int, rows: int, *,
                       block_g: int = 128,
                       budget: int = FUSED_SMEM_BUDGET) -> bool:
    """True when :func:`network_vmem_bytes` fits the budget."""
    return network_vmem_bytes(dims, bm, rows, block_g=block_g) <= budget
