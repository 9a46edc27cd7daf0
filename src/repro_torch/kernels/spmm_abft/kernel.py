"""Block-ELL SpMM with FUSED ABFT checksum epilogue: the wrapper that
launches the CUDA kernel, and its plain PyTorch version.

Replaces the TPU kernel ``spmm_abft_kernel`` of the JAX package
(``src/repro/kernels/spmm_abft/kernel.py``); the CUDA source is
``kernels/csrc/spmm_abft.cu``, which also says what bounds the kernel on a
Hopper card and what its design does about it.

  outputs: out  = S @ X                 [M, G]
           stripe_sums[i] = Σ out_stripe  (actual checksum — the final
                                           reduce is O(M/bm), done by ops.py)
           extra = S @ x_r             [M, 1]  (the carried eq.-5 column:
                    x_r = X e for a standalone check, or H w_r threaded
                    from the combination matmul for the full eq.-4 chain)

ELL padding tiles alias column-block 0 with zero values — they add nothing,
so neither version masks them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.analysis.vmem import (BLOCK_THREADS, FUSED_SMEM_BUDGET,
                                        G_QUANTUM, spmm_smem_bytes)

Tensor = torch.Tensor
Inject = Optional[Tuple[int, int, float]]


def _check_shapes(block_cols: Tensor, values: Tensor, x: Tensor, xr: Tensor):
    nbm, width, bm, bk = values.shape
    k, g = x.shape
    if tuple(block_cols.shape) != (nbm, width):
        raise ValueError(f"block_cols {tuple(block_cols.shape)} does not "
                         f"match values' [nbm, width] = {(nbm, width)}")
    if k % bk or tuple(xr.shape) != (k, 1):
        raise ValueError(f"x covers {k} rows (block_k {bk}) and xr is "
                         f"{tuple(xr.shape)}; need K % bk == 0 and xr [K, 1]")
    return nbm, width, bm, bk, k, g


def spmm_abft_plain(block_cols: Tensor, values: Tensor, x: Tensor,
                    xr: Tensor, *, inject: Inject = None
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of :func:`spmm_abft_kernel`: gather the X tile
    of every stored tile, one batched product per ell-slot, slots walked in
    order with the accumulator carried along — the same association, and the
    same inject hook (``acc[stripe, 0, 0] += delta`` after slot ``slot``),
    as the kernel.  The CPU tests run this; on a GPU it is the yardstick
    the kernel is held against, never the serving path."""
    spmm_abft_plain.calls += 1
    nbm, width, bm, bk, k, g = _check_shapes(block_cols, values, x, xr)
    xt = x.reshape(k // bk, bk, g)
    xrt = xr.reshape(k // bk, bk, 1).to(torch.float32)
    cols = block_cols.long()
    acc = torch.zeros((nbm, bm, g), dtype=torch.float32, device=x.device)
    ex = torch.zeros((nbm, bm, 1), dtype=torch.float32, device=x.device)
    for j in range(width):
        s = values[:, j]
        acc = acc + torch.einsum("imk,ikg->img", s, xt[cols[:, j]])
        ex = ex + torch.einsum("imk,iko->imo", s, xrt[cols[:, j]])
        if inject is not None and inject[1] == j and 0 <= inject[0] < nbm:
            acc[inject[0], 0, 0] += inject[2]
    out = acc.reshape(nbm * bm, g).to(x.dtype)
    return out, acc.sum(dim=(1, 2)).reshape(nbm, 1), ex.reshape(nbm * bm, 1)


spmm_abft_plain.calls = 0


def spmm_abft_kernel(block_cols: Tensor, values: Tensor, x: Tensor,
                     xr: Tensor, *, inject: Inject = None
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """block_cols: [nbm, width] i32; values: [nbm, width, bm, bk];
    x: [K, G]; xr: [K, 1].  K and G must be padded by the caller (ops.py)
    to a bk multiple covering max(block_cols)+1 stripes, and to a multiple
    of 8 features.  ``inject=(stripe, slot, delta)`` perturbs one
    accumulator element mid-sweep (CI fault hook).
    Returns (out [nbm*bm, G], stripe_sums [nbm, 1], extra [nbm*bm, 1]).

    Operands on a CUDA device launch the CUDA kernel (one launch, counted in
    ``spmm_abft_kernel.launches``) or raise; only operands that lie on the
    CPU take :func:`spmm_abft_plain`."""
    if values.device.type == "cpu":
        return spmm_abft_plain(block_cols, values, x, xr, inject=inject)
    from repro_torch.kernels import runtime

    what = "spmm_abft_kernel"
    nbm, width, bm, bk, k, g = _check_shapes(block_cols, values, x, xr)
    runtime.require_cuda_operands(what, cols=block_cols, vals=values, x=x,
                                  xr=xr)
    if g % G_QUANTUM or bk % 4 or bm % 2:
        raise ValueError(f"{what}: needs G % {G_QUANTUM} == 0 (got {g}; pad "
                         f"through ops.py), block_k % 4 == 0 (got {bk}) and "
                         f"an even block_m (got {bm})")
    lib = runtime.load_library()
    smem = spmm_smem_bytes(g, bm, bk)
    if smem != lib.spmm_abft_smem_bytes(bm, bk, g) \
            or BLOCK_THREADS != lib.abft_block_threads():
        raise RuntimeError(f"{what}: analysis.vmem models {smem} B of shared "
                           f"memory and {BLOCK_THREADS} threads, the library "
                           f"{lib.spmm_abft_smem_bytes(bm, bk, g)} B and "
                           f"{lib.abft_block_threads()}")
    if smem > FUSED_SMEM_BUDGET:
        raise ValueError(f"{what}: block ({bm}, {bk}) x G={g} needs {smem} B "
                         f"of shared memory, over the {FUSED_SMEM_BUDGET} B "
                         f"one block may use")
    dev = values.device
    out = torch.empty((nbm * bm, g), dtype=torch.float32, device=dev)
    sums = torch.empty((nbm, 1), dtype=torch.float32, device=dev)
    extra = torch.empty((nbm * bm, 1), dtype=torch.float32, device=dev)
    ii, jj, delta = (-1, -1, 0.0) if inject is None else inject
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.spmm_abft_launch(
            block_cols.data_ptr(), values.data_ptr(), x.data_ptr(),
            xr.data_ptr(), out.data_ptr(), sums.data_ptr(), extra.data_ptr(),
            nbm, width, bm, bk, g, int(ii), int(jj), float(delta), stream)
    runtime.check_launch(code, what)
    spmm_abft_kernel.launches += 1
    return out, sums, extra


spmm_abft_kernel.launches = 0
