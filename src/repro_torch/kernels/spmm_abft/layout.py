"""Padded block-ELL layout for the sparse aggregation step H_out = S X.

The normalized adjacency S of a static graph is converted ONCE, offline, to
a blocked ELL layout: rows are partitioned into ``block_m``-row stripes and
columns into ``block_k`` stripes; each row-stripe stores its nonzero
(block_m, block_k) tiles densely, padded to the widest stripe (``width`` =
max nonzero tiles per stripe).  Padding tiles point at column-block 0 with
all-zero values, so they contribute nothing and need no masking in the
kernel.

Why ELL and not CSR-of-blocks: a rectangular [n_block_rows, width] tile
table gives every row-stripe the same loop trip count and every tile the
same shape, so one CUDA block owns one stripe and walks its slots in order,
reading the column-block index of each tile itself.

The conversion is numpy-only (no torch import) so dataset and packing code
can use it without touching the accelerator path.  It is the port's own
copy of the JAX package's ``repro/kernels/spmm_abft/layout.py`` and gives
arrays equal to that module's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class BlockEll:
    """Padded block-ELL sparse matrix (host-side numpy buffers).

    values:     [n_block_rows, width, block_m, block_k] f32 tile table
    block_cols: [n_block_rows, width] int32 column-block index per tile
                (padding tiles: index 0, values 0)
    shape:      logical (unpadded) matrix shape
    """

    values: np.ndarray
    block_cols: np.ndarray
    shape: Tuple[int, int]

    @property
    def block_m(self) -> int:
        return self.values.shape[2]

    @property
    def block_k(self) -> int:
        return self.values.shape[3]

    @property
    def n_block_rows(self) -> int:
        return self.values.shape[0]

    @property
    def width(self) -> int:
        return self.values.shape[1]

    @property
    def padded_rows(self) -> int:
        return self.n_block_rows * self.block_m

    @property
    def padded_cols(self) -> int:
        # column-block indices address X row-stripes; X must be padded to
        # cover the largest referenced stripe
        return (int(self.block_cols.max()) + 1) * self.block_k \
            if self.block_cols.size else self.block_k

    @property
    def nnz_tiles(self) -> int:
        """Nonzero tiles actually stored (excludes ELL padding)."""
        return int((np.abs(self.values).sum(axis=(2, 3)) > 0).sum())

    @property
    def fill(self) -> float:
        """Stored-tile fraction of the full dense block grid."""
        n_bk = -(-self.shape[1] // self.block_k)
        return self.width / max(n_bk, 1)

    def todense(self) -> np.ndarray:
        """Dense [rows, cols] reconstruction (tests / small graphs only)."""
        m, k = self.shape
        nbk = -(-k // self.block_k)
        out = np.zeros((self.padded_rows, nbk * self.block_k), np.float32)
        for i in range(self.n_block_rows):
            for t in range(self.width):
                j = int(self.block_cols[i, t])
                out[i * self.block_m:(i + 1) * self.block_m,
                    j * self.block_k:(j + 1) * self.block_k] += \
                    self.values[i, t]
        return out[:m, :k]

    def col_sums(self, dtype=np.float64) -> np.ndarray:
        """e^T S over the logical columns — the offline s_c vector."""
        nbk = -(-self.shape[1] // self.block_k)
        out = np.zeros(nbk * self.block_k, dtype)
        # tile-local column sums scattered to their column-block slot
        local = self.values.astype(dtype).sum(axis=2)     # [nbr, width, bk]
        for i in range(self.n_block_rows):
            for t in range(self.width):
                j = int(self.block_cols[i, t])
                out[j * self.block_k:(j + 1) * self.block_k] += local[i, t]
        return out[:self.shape[1]]


def pad_block_rows(bell: BlockEll, multiple: int) -> BlockEll:
    """Pad the stripe count to a multiple (sharded aggregation: stripes must
    divide the mesh axis).  Padding stripes are all-zero tiles aliasing
    column-block 0 — they produce zero output rows and contribute nothing
    to either side of the check, so no masking anywhere downstream."""
    nbm = bell.n_block_rows
    add = (-nbm) % multiple
    if add == 0:
        return bell
    values = np.concatenate(
        [bell.values,
         np.zeros((add,) + bell.values.shape[1:], np.float32)], axis=0)
    block_cols = np.concatenate(
        [bell.block_cols, np.zeros((add, bell.width), np.int32)], axis=0)
    return BlockEll(values=values, block_cols=block_cols, shape=bell.shape)


def pad_width(bell: BlockEll, width_to: int) -> BlockEll:
    """Pad the ELL width (tiles per stripe) to an exact slot count.

    Canonical serving shapes need every batch of a rung to present the SAME
    [n_block_rows, width] tile table regardless of which graphs landed in
    it.  Padding slots follow the layout's standing convention —
    column-block 0 with all-zero values — so they contribute nothing to the
    product or either side of the check and need no masking downstream."""
    if width_to < bell.width:
        raise ValueError(f"cannot pad ELL width {bell.width} down to "
                         f"{width_to}")
    if width_to == bell.width:
        return bell
    add = width_to - bell.width
    nbm = bell.n_block_rows
    values = np.concatenate(
        [bell.values,
         np.zeros((nbm, add, bell.block_m, bell.block_k), np.float32)],
        axis=1)
    block_cols = np.concatenate(
        [bell.block_cols, np.zeros((nbm, add), np.int32)], axis=1)
    return BlockEll(values=values, block_cols=block_cols, shape=bell.shape)


def pad_block_rows_to(bell: BlockEll, n_block_rows: int) -> BlockEll:
    """Pad the stripe count to an exact value (the rung's stripe capacity).

    Unlike :func:`pad_block_rows` (round up to a multiple) this pins the
    stripe axis, so every batch of a canonical rung shares one shape.
    Padding stripes are the usual all-zero tiles aliasing column-block 0."""
    add = n_block_rows - bell.n_block_rows
    if add < 0:
        raise ValueError(f"cannot pad {bell.n_block_rows} block rows down "
                         f"to {n_block_rows}")
    if add == 0:
        return bell
    values = np.concatenate(
        [bell.values,
         np.zeros((add,) + bell.values.shape[1:], np.float32)], axis=0)
    block_cols = np.concatenate(
        [bell.block_cols, np.zeros((add, bell.width), np.int32)], axis=0)
    return BlockEll(values=values, block_cols=block_cols, shape=bell.shape)


def stack_block_ell(bells: Sequence[BlockEll],
                    col_block_offsets: Sequence[int],
                    shape: Optional[Tuple[int, int]] = None,
                    width_multiple: int = 1) -> BlockEll:
    """Stack the row-stripes of several BlockElls into one system, shifting
    each matrix's column-block indices by its offset.

    With ``col_block_offsets`` equal to the cumulative row-stripe offsets of
    square per-graph matrices this builds the *block-diagonal* packed system
    of a batch of graphs: graph g's stripes only reference graph g's column
    stripes, so stripe-local checksum partials segment exactly per graph.
    Widths pad to the widest input (rounded up to ``width_multiple`` to
    quantize packed shapes); padding slots keep column-block 0 with zero values
    — they reference some stripe's X rows but contribute nothing, the same
    no-masking trick as ELL padding within one matrix.
    """
    if not bells:
        raise ValueError("stack_block_ell needs at least one BlockEll")
    bm, bk = bells[0].block_m, bells[0].block_k
    for b in bells:
        if (b.block_m, b.block_k) != (bm, bk):
            raise ValueError("all stacked BlockElls must share block sizes; "
                             f"got {(b.block_m, b.block_k)} vs {(bm, bk)}")
    if len(col_block_offsets) != len(bells):
        raise ValueError("one column-block offset per stacked BlockEll")
    width = max(b.width for b in bells)
    width = -(-width // max(width_multiple, 1)) * max(width_multiple, 1)
    total = sum(b.n_block_rows for b in bells)
    values = np.zeros((total, width, bm, bk), np.float32)
    block_cols = np.zeros((total, width), np.int32)
    off = 0
    for b, coff in zip(bells, col_block_offsets):
        nbr, w = b.n_block_rows, b.width
        values[off:off + nbr, :w] = b.values
        block_cols[off:off + nbr, :w] = b.block_cols + np.int32(coff)
        off += nbr
    if shape is None:
        shape = (total * bm, (int(block_cols.max()) + 1) * bk)
    return BlockEll(values=values, block_cols=block_cols, shape=shape)


def coo_to_block_ell(row: np.ndarray, col: np.ndarray, data: np.ndarray,
                     shape: Tuple[int, int], block_m: int = 128,
                     block_k: int = 128) -> BlockEll:
    """Convert COO triplets to padded block-ELL (duplicates are summed)."""
    m, k = shape
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    data = np.asarray(data, np.float32)
    nbm = -(-m // block_m)
    nbk = -(-k // block_k)

    br = row // block_m
    bc = col // block_k
    tile_id = br * nbk + bc
    order = np.argsort(tile_id, kind="stable")
    tile_sorted = tile_id[order]
    uniq, starts = np.unique(tile_sorted, return_index=True)
    ends = np.append(starts[1:], tile_sorted.size)

    counts = np.zeros(nbm, np.int64)
    np.add.at(counts, uniq // nbk, 1)
    width = max(int(counts.max()) if counts.size else 1, 1)

    values = np.zeros((nbm, width, block_m, block_k), np.float32)
    block_cols = np.zeros((nbm, width), np.int32)
    slot = np.zeros(nbm, np.int64)
    for t, lo, hi in zip(uniq, starts, ends):
        i, j = int(t // nbk), int(t % nbk)
        s = int(slot[i])
        idx = order[lo:hi]
        np.add.at(values[i, s],
                  (row[idx] - i * block_m, col[idx] - j * block_k), data[idx])
        block_cols[i, s] = j
        slot[i] += 1
    return BlockEll(values=values, block_cols=block_cols, shape=(m, k))


def dense_to_block_ell(a: np.ndarray, block_m: int = 128,
                       block_k: int = 128) -> BlockEll:
    """Dense → block-ELL, dropping all-zero tiles (tests / small graphs)."""
    a = np.asarray(a, np.float32)
    r, c = np.nonzero(a)
    return coo_to_block_ell(r, c, a[r, c], a.shape, block_m, block_k)
