"""Tiled matmul with the FUSED ABFT checksum epilogue: the wrapper that
launches the CUDA kernel, and its plain PyTorch version.

Replaces the TPU kernel ``matmul_abft_kernel`` of the JAX package
(``src/repro/kernels/matmul_abft/kernel.py``); the CUDA source is
``kernels/csrc/matmul_abft.cu``, which also says what bounds the kernel on a
Hopper card and what its design does about it.

  outputs: c          = A @ B                [M, N]  (A's dtype)
           block_sums = Σ C per block tile   [ceil(M/tm), ceil(N/tn)] f32
                        (the f32 accumulator before the cast; the tile is
                        the kernel's own, ``analysis.vmem.matmul_tile``)
           extra      = A @ b_r              [M, 1]  f32 (b_r = B·e)

The association, the kernel's and the plain version's: K is cut into
``matmul_splits(m, n, k)`` splits of ``matmul_split_k(m, n, k)`` columns
(one split when M > 16); inside a split each 32-wide K chunk is summed
apart and the chunk sums are added in order; then the split sums are added
in order.

``trans_b=True`` takes B as its transpose ``[N, K]`` (the tied LM head's
embedding table as it lies).  ``br=None`` skips the extra column — an
unchecked product — and leaves ``c`` unchanged.

:func:`matmul_abft_grouped_kernel` runs ``G`` independent products of one
shape in one launch (an MoE layer's experts): the group is one more grid
axis, nothing else changes, so group ``g``'s outputs are bit for bit those
of :func:`matmul_abft_kernel` on product ``g``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.analysis.vmem import (MATMUL_BLOCK_K, MATMUL_SMALL_M,
                                      MATMUL_WIDE_TILE, matmul_split_k,
                                      matmul_splits, matmul_thin_smem_bytes,
                                      matmul_tile, matmul_wide_smem_bytes)
from repro_torch.kernels import acc_dtype

Tensor = torch.Tensor
DTYPES = (torch.float32, torch.bfloat16)
# the plain version also takes float64 (a witness run on the CPU), summed
# in float64 in the same association
PLAIN_DTYPES = DTYPES + (torch.float64,)


def _check_shapes(a: Tensor, b: Tensor, br: Optional[Tensor],
                  trans_b: bool, dtypes: Tuple = DTYPES
                  ) -> Tuple[int, int, int]:
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must be "
                         f"2-D")
    m, k = a.shape
    kb, n = (b.shape[1], b.shape[0]) if trans_b else b.shape
    if kb != k:
        raise ValueError(f"a is [{m}, {k}] but b is {tuple(b.shape)} "
                         f"(trans_b={trans_b})")
    if br is not None and br.numel() != k:
        raise ValueError(f"br has {br.numel()} entries, K = {k}")
    if a.dtype != b.dtype or a.dtype not in dtypes:
        raise ValueError(f"a ({a.dtype}) and b ({b.dtype}) must share one of "
                         f"{dtypes}")
    if br is not None and br.dtype != acc_dtype(a.dtype):
        raise ValueError(f"br has dtype {br.dtype}; it is "
                         f"{acc_dtype(a.dtype)}")
    return m, n, k


def tile_sums(acc: Tensor, m: int, n: int) -> Tensor:
    """Σ of the f32 accumulator over each kernel tile (zero padded)."""
    tm, tn = matmul_tile(m)
    mt, nt = -(-m // tm), -(-n // tn)
    pad = F.pad(acc, (0, nt * tn - n, 0, mt * tm - m))
    return pad.reshape(mt, tm, nt, tn).sum(dim=(1, 3))


def matmul_abft_plain(a: Tensor, b: Tensor, br: Optional[Tensor] = None, *,
                      trans_b: bool = False
                      ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Plain PyTorch version of :func:`matmul_abft_kernel`, in the kernel's
    association: f32 products of 32-wide K chunks, each added to its split's
    accumulator in order, the splits added in order.  The CPU tests and the
    port's CPU runs use this; on a GPU it is the yardstick the kernel is
    held against, never the serving path.  float64 operands are summed in
    float64 in the same association (``block_sums`` and ``extra`` too)."""
    matmul_abft_plain.calls += 1
    return _plain(a, b, br, trans_b)


def _plain(a: Tensor, b: Tensor, br: Optional[Tensor], trans_b: bool
           ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    m, n, k = _check_shapes(a, b, br, trans_b, PLAIN_DTYPES)
    f32 = acc_dtype(a.dtype)
    bk = b.t() if trans_b else b
    brc = None if br is None else br.reshape(k, 1)
    kc = matmul_split_k(m, n, k)
    acc = ex = None
    for k_lo in range(0, k, kc):
        part = torch.zeros((m, n), dtype=f32, device=a.device)
        pex = None if br is None else torch.zeros(
            (m, 1), dtype=f32, device=a.device)
        for k0 in range(k_lo, min(k_lo + kc, k), MATMUL_BLOCK_K):
            af = a[:, k0:k0 + MATMUL_BLOCK_K].to(f32)
            part.add_(af @ bk[k0:k0 + MATMUL_BLOCK_K].to(f32))
            if pex is not None:
                pex.add_(af @ brc[k0:k0 + MATMUL_BLOCK_K])
        acc = part if acc is None else acc.add_(part)
        if pex is not None:
            ex = pex if ex is None else ex.add_(pex)
    return acc.to(a.dtype), tile_sums(acc, m, n), ex


matmul_abft_plain.calls = 0


def _agreed_with_library(lib, what: str, m: int, n: int, k: int, a: Tensor,
                         trans_b: bool) -> tuple:
    """(tile_m, tile_n, splits) of an ``m x k @ k x n`` product as
    ``analysis.vmem`` states them (and, for ``a``'s dtype, the thin path's
    shared memory, or the wide path's block tile and shared memory); raises
    when the library disagrees."""
    tm, tn = matmul_tile(m)
    dt, item = DTYPES.index(a.dtype), a.element_size()
    thin = m <= MATMUL_SMALL_M
    ours = (tm, tn, matmul_splits(m, n, k), matmul_split_k(m, n, k),
            matmul_thin_smem_bytes(m, item, trans_b) if thin else 0,
            *((0, 0) if thin else MATMUL_WIDE_TILE),
            0 if thin else matmul_wide_smem_bytes(item, trans_b))
    theirs = (lib.matmul_abft_tile_m(m), lib.matmul_abft_tile_n(m),
              lib.matmul_abft_splits(m, n, k),
              lib.matmul_abft_split_k(m, n, k),
              lib.matmul_abft_thin_smem_bytes(m, dt, int(trans_b)),
              lib.matmul_abft_wide_tile_m(m), lib.matmul_abft_wide_tile_n(m),
              lib.matmul_abft_wide_smem_bytes(m, dt, int(trans_b)))
    if ours != theirs:
        raise RuntimeError(f"{what}: analysis.vmem models (tile_m, tile_n, "
                           f"splits, split_k, thin smem bytes, wide tile_m, "
                           f"wide tile_n, wide smem bytes) = {ours} for "
                           f"M={m} N={n} K={k}, the library {theirs}")
    return ours[:3]


def _launch(what: str, a: Tensor, b: Tensor, br: Optional[Tensor],
            trans_b: bool, g: int, m: int, n: int, k: int
            ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """One launcher call over ``g`` products of one shape: a [g, M, K], b
    [g, K, N] (or [g, N, K]), br g·K floats or None; returns (c [g, M, N],
    block_sums [g, mt, nt], extra [g, M, 1] | None)."""
    from repro_torch.kernels import runtime

    runtime.require_cuda_operands(what, allow=DTYPES, a=a, b=b)
    if br is not None:
        runtime.require_cuda_operands(what, br=br)
        if br.device != a.device:
            raise ValueError(f"{what}: br lies on {br.device}, a on "
                             f"{a.device}")
    lib = runtime.load_library()
    tm, tn, splits = _agreed_with_library(lib, what, m, n, k, a, trans_b)
    dev = a.device
    c = torch.empty((g, m, n), dtype=a.dtype, device=dev)
    sums = torch.empty((g, -(-m // tm), -(-n // tn)), dtype=torch.float32,
                       device=dev)
    extra = None if br is None else torch.empty(
        (g, m, 1), dtype=torch.float32, device=dev)
    # the thin path's split sums [S, M, N] and extra column [S, M], a group
    ws = torch.empty(g * splits * m * (n + 1), dtype=torch.float32,
                     device=dev) if m <= MATMUL_SMALL_M else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.matmul_abft_grouped_launch(
            a.data_ptr(), b.data_ptr(),
            None if br is None else br.data_ptr(), c.data_ptr(),
            sums.data_ptr(), None if extra is None else extra.data_ptr(),
            None if ws is None else ws.data_ptr(),
            g, m, n, k, int(trans_b), DTYPES.index(a.dtype), stream)
    runtime.check_launch(code, what)
    return c, sums, extra


def matmul_abft_kernel(a: Tensor, b: Tensor, br: Optional[Tensor] = None,
                       *, trans_b: bool = False
                       ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """a: [M, K]; b: [K, N] (or [N, K] with ``trans_b``), both float32 or
    both bfloat16; br: [K] or [K, 1] float32, or None.  Returns (c [M, N],
    block_sums [ceil(M/tm), ceil(N/tn)], extra [M, 1] | None).  Ragged M, N
    and K need no padding.

    Operands on a CUDA device launch the CUDA kernel (one launcher call —
    two kernels when M <= 16 — counted once in
    ``matmul_abft_kernel.launches``) or raise; only operands that lie on the
    CPU take :func:`matmul_abft_plain`."""
    if a.device.type == "cpu":
        return matmul_abft_plain(a, b, br, trans_b=trans_b)
    m, n, k = _check_shapes(a, b, br, trans_b)
    c, sums, extra = _launch("matmul_abft_kernel", a[None], b[None], br,
                             trans_b, 1, m, n, k)
    matmul_abft_kernel.launches += 1
    return c[0], sums[0], None if extra is None else extra[0]


matmul_abft_kernel.launches = 0


def _check_grouped(a: Tensor, b: Tensor, br: Optional[Tensor],
                   trans_b: bool, dtypes: Tuple = DTYPES
                   ) -> Tuple[int, int, int, int]:
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must be "
                         f"3-D with one group count")
    g = a.shape[0]
    if g < 1:
        raise ValueError("a grouped product needs at least one group")
    m, n, k = _check_shapes(a[0], b[0], None, trans_b, dtypes)
    if br is not None:
        if br.numel() != g * k:
            raise ValueError(f"br has {br.numel()} entries, G x K = {g} x {k}")
        if br.dtype != acc_dtype(a.dtype):
            raise ValueError(f"br has dtype {br.dtype}; it is "
                             f"{acc_dtype(a.dtype)}")
    return g, m, n, k


def matmul_abft_grouped_plain(a: Tensor, b: Tensor,
                              br: Optional[Tensor] = None, *,
                              trans_b: bool = False
                              ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Plain PyTorch version of :func:`matmul_abft_grouped_kernel`: the
    single product's plain version on each group in turn, stacked."""
    matmul_abft_grouped_plain.calls += 1
    g, _m, _n, k = _check_grouped(a, b, br, trans_b, PLAIN_DTYPES)
    brg = None if br is None else br.reshape(g, k)
    outs = [_plain(a[i], b[i], None if brg is None else brg[i], trans_b)
            for i in range(g)]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]),
            None if br is None else torch.stack([o[2] for o in outs]))


matmul_abft_grouped_plain.calls = 0


def matmul_abft_grouped_kernel(a: Tensor, b: Tensor,
                               br: Optional[Tensor] = None, *,
                               trans_b: bool = False
                               ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """``G`` products of one shape in one launch.  a: [G, M, K]; b:
    [G, K, N] (or [G, N, K] with ``trans_b``), both float32 or both
    bfloat16; br: [G, K] (or [G, K, 1]) float32, or None.  Returns
    (c [G, M, N], block_sums [G, ceil(M/tm), ceil(N/tn)],
    extra [G, M, 1] | None); group g's are bit for bit
    ``matmul_abft_kernel(a[g], b[g], br[g])``'s.

    Operands on a CUDA device launch the CUDA kernel (one launcher call,
    counted once in ``matmul_abft_grouped_kernel.launches``) or raise; only
    operands that lie on the CPU take :func:`matmul_abft_grouped_plain`.
    The group is a grid axis: the tile, the split count and the shared
    memory are the single product's, held against ``analysis.vmem`` as
    :func:`matmul_abft_kernel` holds them."""
    if a.device.type == "cpu":
        return matmul_abft_grouped_plain(a, b, br, trans_b=trans_b)
    g, m, n, k = _check_grouped(a, b, br, trans_b)
    out = _launch("matmul_abft_grouped_kernel", a, b, br, trans_b, g, m, n,
                  k)
    matmul_abft_grouped_kernel.launches += 1
    return out


matmul_abft_grouped_kernel.launches = 0
