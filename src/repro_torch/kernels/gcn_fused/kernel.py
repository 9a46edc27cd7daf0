"""ONE GCN-ABFT layer in a single sweep: the wrapper that launches the CUDA
kernel, and its plain PyTorch version.

Replaces the TPU kernel ``gcn_fused_kernel`` of the JAX package
(``src/repro/kernels/gcn_fused/kernel.py``); the CUDA source is
``kernels/csrc/gcn_fused.cu``, which also says what bounds the kernel on a
Hopper card and what its design does about it.

``spmm_abft`` executes the aggregation half of a layer: X = H @ W is written
to device memory first and the kernel reads X tiles back.  GCN output widths
are tiny, so the combination can be recomputed on the fly *inside* the
aggregation sweep and X never has to touch device memory:

  per stored tile:  h    = H[cols[i,j]]          (bk, f)
                    x    = h @ W                 (bk, g)  recomputed
                    x_r  = h @ w_r               (bk, 1)  eq.-5 column
                    acc += S_tile @ x;   ex += S_tile @ x_r

Check independence: x and x_r come from two *separate* products of the same
operands, so an arithmetic fault in one side cannot cancel against the
other — the same coverage as the two-pass path.

``inject`` is the CI fault-injection hook: a (stripe, slot, delta) triple
that perturbs one accumulator element mid-sweep.  The delta reaches the
output and the actual checksum but never the predicted side, so the eq.-6
corner must flag it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.analysis.vmem import (
    BLOCK_THREADS,
    F_CHUNK,
    FUSED_SMEM_BUDGET,
    G_QUANTUM,
    fused_tile_supported,
    fused_vmem_bytes,
)

Tensor = torch.Tensor
Inject = Optional[Tuple[int, int, float]]


def _check_shapes(block_cols: Tensor, values: Tensor, h: Tensor, w: Tensor,
                  wr: Tensor):
    nbm, width, bm, bk = values.shape
    k, f = h.shape
    fw, g = w.shape
    if tuple(block_cols.shape) != (nbm, width):
        raise ValueError(f"block_cols {tuple(block_cols.shape)} does not "
                         f"match values' [nbm, width] = {(nbm, width)}")
    if k % bk or fw != f or tuple(wr.shape) != (f, 1):
        raise ValueError(f"h is {tuple(h.shape)} (block_k {bk}), w "
                         f"{tuple(w.shape)}, wr {tuple(wr.shape)}; need "
                         f"K % bk == 0, w [F, G] and wr [F, 1]")
    return nbm, width, bm, bk, k, f, g


def gcn_fused_plain(block_cols: Tensor, values: Tensor, h: Tensor, w: Tensor,
                    wr: Tensor, *, inject: Inject = None,
                    with_check: bool = True, with_slots: bool = False):
    """Plain PyTorch version of :func:`gcn_fused_kernel`: per ell-slot, in
    order, gather each stripe's H tile, form x and x_r from two separate
    products, apply the S tiles, and carry the accumulators along; the
    inject hook and the telescoped running sums sit where the kernel has
    them (recording after the hook).  The CPU tests run this; on a GPU it is
    the yardstick the kernel is held against, never the serving path."""
    gcn_fused_plain.calls += 1
    nbm, width, bm, bk, k, f, g = _check_shapes(block_cols, values, h, w, wr)
    ht = h.reshape(k // bk, bk, f).to(torch.float32)
    w32, wr32 = w.to(torch.float32), wr.to(torch.float32)
    cols = block_cols.long()
    dev = h.device
    acc = torch.zeros((nbm, bm, g), dtype=torch.float32, device=dev)
    ex = torch.zeros((nbm, bm, 1), dtype=torch.float32, device=dev)
    slot_acts, slot_preds = [], []
    for j in range(width):
        s = values[:, j]
        hj = ht[cols[:, j]]                              # [nbm, bk, f]
        acc = acc + torch.einsum("imk,ikg->img", s, hj @ w32)
        if with_check:
            ex = ex + torch.einsum("imk,iko->imo", s, hj @ wr32)
        if inject is not None and inject[1] == j and 0 <= inject[0] < nbm:
            acc[inject[0], 0, 0] += inject[2]
        if with_slots:
            slot_acts.append(acc.sum(dim=(1, 2)))
            slot_preds.append(ex.sum(dim=(1, 2)))
    res = (acc.reshape(nbm * bm, g).to(h.dtype),
           acc.sum(dim=(1, 2)).reshape(nbm, 1), ex.reshape(nbm * bm, 1))
    if with_slots:
        res += (torch.stack(slot_acts, dim=1), torch.stack(slot_preds, dim=1))
    return res


gcn_fused_plain.calls = 0


def gcn_fused_kernel(block_cols: Tensor, values: Tensor, h: Tensor,
                     w: Tensor, wr: Tensor, *, inject: Inject = None,
                     with_check: bool = True, with_slots: bool = False):
    """block_cols: [nbm, width] i32; values: [nbm, width, bm, bk];
    h: [K, F]; w: [F, G]; wr: [F, 1].  K must be a bk multiple covering
    max(block_cols)+1 stripes and G a multiple of 8 (ops.py pads); F is
    taken as it is — the kernel walks it in chunks and masks the ragged end.
    ``with_check=False`` (mode="none") does none of the eq.-5 products; the
    tiny extra output is then all-zero.
    Returns (out [nbm*bm, G], stripe_sums [nbm, 1], extra [nbm*bm, 1]);
    ``with_slots=True`` appends the telescoped per-slot running sums
    (slot_acts [nbm, width], slot_preds [nbm, width]) for slot-granular
    corners (``ops.slot_check_corners``).

    Operands on a CUDA device launch the CUDA kernel (one launch, counted in
    ``gcn_fused_kernel.launches``) or raise; only operands that lie on the
    CPU take :func:`gcn_fused_plain`."""
    if values.device.type == "cpu":
        return gcn_fused_plain(block_cols, values, h, w, wr, inject=inject,
                               with_check=with_check, with_slots=with_slots)
    from repro_torch.kernels import runtime

    what = "gcn_fused_kernel"
    nbm, width, bm, bk, k, f, g = _check_shapes(block_cols, values, h, w, wr)
    runtime.require_cuda_operands(what, cols=block_cols, vals=values, h=h,
                                  w=w, wr=wr)
    if g % G_QUANTUM or not fused_tile_supported(g, bm, bk):
        raise ValueError(f"{what}: needs G % {G_QUANTUM} == 0 (got {g}; pad "
                         f"through ops.py), an even block_m, block_k % 4 == 0 "
                         f"and (block_k / 2) * (G / 8) <= {BLOCK_THREADS}; "
                         f"got block ({bm}, {bk}) — "
                         f"analysis.vmem.fused_layer_fits says when a layer "
                         f"must take the two-pass kernel instead")
    lib = runtime.load_library()
    smem = fused_vmem_bytes(f, g, bm, bk)
    if smem != lib.gcn_fused_smem_bytes(bm, bk, g) \
            or F_CHUNK != lib.gcn_fused_f_chunk() \
            or not lib.gcn_fused_supported(bm, bk, g):
        raise RuntimeError(f"{what}: analysis.vmem models {smem} B of shared "
                           f"memory at F_CHUNK={F_CHUNK}, the library "
                           f"{lib.gcn_fused_smem_bytes(bm, bk, g)} B at "
                           f"{lib.gcn_fused_f_chunk()}")
    if smem > FUSED_SMEM_BUDGET:
        raise ValueError(f"{what}: block ({bm}, {bk}) x G={g} needs {smem} B "
                         f"of shared memory, over the {FUSED_SMEM_BUDGET} B "
                         f"one block may use")
    dev = values.device
    out = torch.empty((nbm * bm, g), dtype=torch.float32, device=dev)
    sums = torch.empty((nbm, 1), dtype=torch.float32, device=dev)
    extra = torch.empty((nbm * bm, 1), dtype=torch.float32, device=dev)
    res = (out, sums, extra)
    if with_slots:
        res += (torch.empty((nbm, width), dtype=torch.float32, device=dev),
                torch.empty((nbm, width), dtype=torch.float32, device=dev))
    sa, sp = (res[3].data_ptr(), res[4].data_ptr()) if with_slots \
        else (None, None)
    ii, jj, delta = (-1, -1, 0.0) if inject is None else inject
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.gcn_fused_launch(
            block_cols.data_ptr(), values.data_ptr(), h.data_ptr(),
            w.data_ptr(), wr.data_ptr(), out.data_ptr(), sums.data_ptr(),
            extra.data_ptr(), sa, sp, nbm, width, bm, bk, f, g,
            int(bool(with_check)), int(bool(with_slots)), int(ii), int(jj),
            float(delta), stream)
    runtime.check_launch(code, what)
    gcn_fused_kernel.launches += 1
    return res


gcn_fused_kernel.launches = 0
