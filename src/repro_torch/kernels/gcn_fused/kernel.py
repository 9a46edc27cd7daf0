"""ONE GCN-ABFT layer, and a WHOLE network in one launch: the wrappers
that launch the CUDA kernels, and their plain PyTorch versions.

Replace the TPU kernels ``gcn_fused_kernel`` and ``gcn_network_kernel`` of
the JAX package (``src/repro/kernels/gcn_fused/kernel.py``); the CUDA
sources are ``kernels/csrc/gcn_fused.cu`` and ``kernels/csrc/
gcn_network.cu`` (both phases shared in ``fused_tile.cuh``), which also
say what bounds each kernel on a Hopper card and what its design does
about it.

The TPU kernel recomputed the combination inside the aggregation sweep, so
X never touched HBM.  On this card that recompute per stored tile cost 24
times the multiply-adds and read H 24 times; the CUDA kernels instead run
a layer in two phases:

  phase A, once per row:  X    = H @ W       (K, g)  into a workspace
                          x_r  = H @ w_r     (K, 1)  eq.-5 column
  phase B, per tile:      acc += S_tile @ X[cols[i,j]]
                          ex  += S_tile @ x_r[cols[i,j]]

The workspace ([K, gp] + [K] f32, ``analysis.vmem.fused_workspace_bytes``)
is allocated here with ``torch.empty`` and stays in L2 between the phases.

Check independence: x and x_r come from two *separate* products of the same
operands, and ex from its own product with S, so an arithmetic fault in one
side cannot cancel against the other — the same coverage as the two-pass
path.

``inject`` is the CI fault-injection hook: a (stripe, slot, delta) triple
that perturbs one accumulator element mid-sweep.  The delta reaches the
output and the actual checksum but never the predicted side, so the eq.-6
corner must flag it.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.vmem import (
    FUSED_MAX_X_PIECES,
    FUSED_SMEM_BUDGET,
    G_QUANTUM,
    MAX_NETWORK_LAYERS,
    _lanes,
    fused_network_fits,
    fused_plan,
    fused_tile_supported,
    fused_vmem_bytes,
    fused_workspace_bytes,
    network_vmem_bytes,
    network_workspace_bytes,
    slice_part_floats,
)
from repro_torch.core.marker import tagging_enabled

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


def _fused_sweep(cols: Tensor, values: Tensor, h: Tensor, w: Tensor,
                 wr: Tensor, inject: Inject, with_check: bool,
                 with_slots: bool):
    """One layer's sweep, slot by slot in order: gather each stripe's H
    tile, form x and x_r from two separate products, apply the S tiles and
    carry the accumulators; the inject hook and the telescoped running sums
    sit where the kernels have them (recording after the hook).  Returns
    (acc [nbm, bm, g], ex [nbm, bm, 1], slot_acts, slot_preds) — the last
    two [nbm, width], or None without ``with_slots``."""
    nbm, width, bm, bk = values.shape
    k, f = h.shape
    g = w.shape[1]
    ht = h.reshape(k // bk, bk, f).to(torch.float32)
    w32, wr32 = w.to(torch.float32), wr.to(torch.float32)
    cols = cols.long()
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
    if not with_slots:
        return acc, ex, None, None
    return acc, ex, torch.stack(slot_acts, dim=1), \
        torch.stack(slot_preds, dim=1)


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
    acc, ex, slot_acts, slot_preds = _fused_sweep(
        block_cols, values, h, w, wr, inject, with_check, with_slots)
    res = (acc.reshape(nbm * bm, g).to(h.dtype),
           acc.sum(dim=(1, 2)).reshape(nbm, 1), ex.reshape(nbm * bm, 1))
    if with_slots:
        res += (slot_acts, slot_preds)
    return res


gcn_fused_plain.calls = 0


def _agreed_with_library(lib, what: str, g: int, bm: int, bk: int):
    """The layer's ``analysis.vmem.fused_plan``; raises unless the kernel
    library plans it the same: the combination's and the sweep's cuts (they
    set the association of every sum) and the shared memory."""
    plan = fused_plan(g, bm, bk)
    ours = plan.library_fields() if plan is not None else None
    buf = (ctypes.c_int * 12)()
    ok = lib.gcn_fused_plan(bm, bk, g, ctypes.addressof(buf))
    theirs = tuple(buf) if ok else None
    if ours != theirs or (plan is not None and
                          plan.smem != lib.gcn_fused_smem_bytes(bm, bk, g)):
        raise RuntimeError(f"{what}: analysis.vmem plans {ours} for block "
                           f"({bm}, {bk}) x G={g}, the library {theirs}")
    return plan


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

    Operands on a CUDA device launch the CUDA kernels — the combination,
    then the sweep, in stream order from one C call, counted as one launch
    in ``gcn_fused_kernel.launches`` — or raise; only operands that lie on
    the CPU take :func:`gcn_fused_plain`.  Under check tagging the call is
    one ``repro_torch::gcn_fused`` op (``kernels/sites.py``)."""
    if tagging_enabled():
        from repro_torch.kernels import sites

        return sites.gcn_fused(block_cols, values, h, w, wr, inject=inject,
                               with_check=with_check,
                               with_slots=with_slots)
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
                         f"and (block_k / 2) * (G / 8) <= {FUSED_MAX_X_PIECES}"
                         f"; got block ({bm}, {bk}) — "
                         f"analysis.vmem.fused_layer_fits says when a layer "
                         f"must take the two-pass kernel instead")
    lib = runtime.load_library()
    plan = _agreed_with_library(lib, what, g, bm, bk)
    smem = fused_vmem_bytes(f, g, bm, bk)
    if smem > FUSED_SMEM_BUDGET:
        raise ValueError(f"{what}: block ({bm}, {bk}) x G={g} needs {smem} B "
                         f"of shared memory, over the {FUSED_SMEM_BUDGET} B "
                         f"one block may use")
    dev = values.device
    ws = torch.empty(fused_workspace_bytes(g, k) // 4, dtype=torch.float32,
                     device=dev)
    part = torch.empty(slice_part_floats(nbm, width, plan.slices),
                       dtype=torch.float32, device=dev)
    count = torch.zeros(nbm, dtype=torch.int32, device=dev)
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
            w.data_ptr(), wr.data_ptr(), ws.data_ptr(), part.data_ptr(),
            count.data_ptr(), out.data_ptr(), sums.data_ptr(),
            extra.data_ptr(), sa, sp, nbm, width, bm, bk, k, f, g,
            int(bool(with_check)), int(bool(with_slots)), int(ii), int(jj),
            float(delta), stream)
    runtime.check_launch(code, what)
    gcn_fused_kernel.launches += 1
    return res


gcn_fused_kernel.launches = 0


def gcn_fused_combine(h: Tensor, w: Tensor, wr: Tensor, *,
                      block: Tuple[int, int] = (128, 128),
                      with_check: bool = True) -> Tuple[Tensor, Tensor]:
    """Phase A of :func:`gcn_fused_kernel` alone: X = H W [K, G] and x_r =
    H w_r [K, 1] into a fresh workspace, by the same CUDA kernel and plan
    (the plan of a ``block`` = (bm, bk) layer; the combination's cut
    depends on G alone).  For measuring the phase and checking it
    (``chip_smoke.py``, ``tools/fused_ab.py``); the serving path runs it
    only inside :func:`gcn_fused_kernel`.  Operands on a CUDA device
    launch the kernel (one launch, counted in
    ``gcn_fused_combine.launches``) or raise; operands on the CPU take the
    plain products.  Under check tagging the call is one
    ``repro_torch::gcn_fused_combine`` op (``kernels/sites.py``)."""
    if tagging_enabled():
        from repro_torch.kernels import sites

        return sites.gcn_fused_combine(h, w, wr, block=block,
                                       with_check=with_check)
    if h.device.type == "cpu":
        return h.float() @ w.float(), h.float() @ wr.float()
    from repro_torch.kernels import runtime

    what = "gcn_fused_combine"
    k, f = h.shape
    g = w.shape[1]
    bm, bk = block
    runtime.require_cuda_operands(what, h=h, w=w, wr=wr)
    if tuple(w.shape) != (f, g) or tuple(wr.shape) != (f, 1) or \
            g % G_QUANTUM:
        raise ValueError(f"{what}: h {tuple(h.shape)}, w {tuple(w.shape)}, "
                         f"wr {tuple(wr.shape)}; need w [F, G], G % "
                         f"{G_QUANTUM} == 0 and wr [F, 1]")
    lib = runtime.load_library()
    _agreed_with_library(lib, what, g, bm, bk)
    ws = torch.empty(fused_workspace_bytes(g, k) // 4, dtype=torch.float32,
                     device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        code = lib.gcn_fused_combine_launch(
            h.data_ptr(), w.data_ptr(), wr.data_ptr(), ws.data_ptr(), bm,
            bk, k, f, g, int(bool(with_check)), stream)
    runtime.check_launch(code, what)
    gcn_fused_combine.launches += 1
    return ws[:k * g].view(k, g), ws[k * g:].view(k, 1)


gcn_fused_combine.launches = 0


# ---------------------------------------------------------------------------
# Whole-network kernel: an L-layer GCN in ONE launch.
# ---------------------------------------------------------------------------

NetInject = Optional[Tuple[int, int, int, float]]


def _check_network_shapes(block_cols: Tensor, values: Tensor, h0: Tensor,
                          ws: Sequence[Tensor], wrs: Sequence[Tensor]
                          ) -> List[int]:
    """The network kernels' operand contract; returns the layer widths as
    the launcher reads them: ``[F_0, F_1, ..., F_{L-1}, G_{L-1}]`` — each
    hidden width unpadded (it is the next layer's F), the last padded."""
    nbm, width, bm, bk = values.shape
    if bm != bk:
        raise ValueError(f"the network kernel needs square blocks; got "
                         f"block ({bm}, {bk})")
    if tuple(block_cols.shape) != (nbm, width):
        raise ValueError(f"block_cols {tuple(block_cols.shape)} does not "
                         f"match values' [nbm, width] = {(nbm, width)}")
    if h0.ndim != 2 or h0.shape[0] != nbm * bm:
        raise ValueError(f"h0 is {tuple(h0.shape)}; need [nbm * bm = "
                         f"{nbm * bm}, F] (every referenced column block is "
                         f"also an output stripe)")
    if not ws or len(ws) != len(wrs):
        raise ValueError(f"{len(ws)} weights and {len(wrs)} checksum "
                         f"columns; need one of each per layer")
    dims = [int(h0.shape[1])]
    for ell, (w, wr) in enumerate(zip(ws, wrs)):
        f, gp = w.shape
        nxt = int(ws[ell + 1].shape[0]) if ell + 1 < len(ws) else gp
        if f != dims[-1] or tuple(wr.shape) != (f, 1) or \
                gp != _lanes(nxt) or nxt > gp:
            raise ValueError(
                f"layer {ell}: w {tuple(w.shape)}, wr {tuple(wr.shape)}; "
                f"need w [F_{ell} = {dims[-1]}, G] with G the next layer's "
                f"F padded to a multiple of {G_QUANTUM} (ops.py pads) and "
                f"wr [F_{ell}, 1]")
        dims.append(nxt)
    return dims


def gcn_network_plain(block_cols: Tensor, values: Tensor, h0: Tensor,
                      ws: Sequence[Tensor], wrs: Sequence[Tensor], *,
                      inject: NetInject = None, with_check: bool = True,
                      stash_acts: bool = False):
    """Plain PyTorch version of :func:`gcn_network_kernel`: layer by layer,
    each one the single-layer sweep (slot by slot, in order), with the
    inject hook in its layer and the telescopes recorded after it, and
    ReLU between layers.  The CPU tests run this; on a GPU it is the
    yardstick the kernel is held against, never the serving path."""
    gcn_network_plain.calls += 1
    dims = _check_network_shapes(block_cols, values, h0, ws, wrs)
    nbm, _width, bm, _bk = values.shape
    h = h0
    tele_acts, tele_preds, acts = [], [], []
    for ell, (w, wr) in enumerate(zip(ws, wrs)):
        hook = tuple(inject[1:]) if inject is not None \
            and inject[0] == ell else None
        acc, _ex, sa, sp = _fused_sweep(block_cols, values, h, w, wr, hook,
                                        with_check, True)
        tele_acts.append(sa)
        tele_preds.append(sp)
        if ell < len(ws) - 1:
            g = dims[ell + 1]
            h = torch.relu(acc[:, :, :g]).reshape(nbm * bm, g)
            acts.append(h)
    out = acc.reshape(nbm * bm, dims[-1])
    return (out, torch.stack(tele_acts), torch.stack(tele_preds),
            tuple(acts) if stash_acts else None)


gcn_network_plain.calls = 0


def gcn_network_kernel(block_cols: Tensor, values: Tensor, h0: Tensor,
                       ws: Sequence[Tensor], wrs: Sequence[Tensor], *,
                       inject: NetInject = None, with_check: bool = True,
                       stash_acts: bool = False):
    """An L-layer GCN ``H_{l+1} = relu(S (H_l W_l))`` in one launch.

    block_cols: [nbm, width] i32; values: [nbm, width, bm, bm] (square
    blocks — activations are indexed by the same table on both axes);
    h0: [nbm * bm, F_0]; ``ws[l]``: [F_l, G_l] and ``wrs[l]``: [F_l, 1] per
    layer, G_l the next layer's F (the last layer's output width) padded
    to a multiple of 8 (``ops.py`` pads).  Per-layer widths, not one shared
    padded P.  ``inject=(layer, stripe, slot, delta)`` is the accumulator
    fault hook; ``with_check=False`` elides the eq.-5 products.

    Returns (out [nbm * bm, G_{L-1}], tele_acts [L, nbm, width],
    tele_preds [L, nbm, width], acts): ``acts`` is the tuple of the L - 1
    post-ReLU activations [nbm * bm, F_{l+1}] with ``stash_acts=True`` (the
    kernel keeps one device-memory buffer per layer, so the stash costs
    nothing extra), else ``None``.

    Operands on a CUDA device launch the CUDA kernel (one launch, counted
    in ``gcn_network_kernel.launches``) or raise; only operands that lie on
    the CPU take :func:`gcn_network_plain`.  Under check tagging the call is
    one ``repro_torch::gcn_network`` op (``kernels/sites.py``)."""
    if tagging_enabled():
        from repro_torch.kernels import sites

        return sites.gcn_network(block_cols, values, h0, ws, wrs,
                                 inject=inject, with_check=with_check,
                                 stash_acts=stash_acts)
    if values.device.type == "cpu":
        return gcn_network_plain(block_cols, values, h0, ws, wrs,
                                 inject=inject, with_check=with_check,
                                 stash_acts=stash_acts)
    from repro_torch.kernels import runtime

    what = "gcn_network_kernel"
    dims = _check_network_shapes(block_cols, values, h0, ws, wrs)
    nbm, width, bm, bk = values.shape
    n_layers = len(ws)
    runtime.require_cuda_operands(
        what, cols=block_cols, vals=values, h0=h0,
        **{f"w{ell}": w for ell, w in enumerate(ws)},
        **{f"wr{ell}": wr for ell, wr in enumerate(wrs)})
    if not fused_network_fits(dims, bm, nbm * bm, bk=bk):
        raise ValueError(f"{what}: layer widths {dims} at block ({bm}, {bk}) "
                         f"are outside what the kernel takes — "
                         f"analysis.vmem.fused_network_fits says when a "
                         f"model must take the per-layer ladder instead")
    lib = runtime.load_library()
    for g in dims[1:]:
        _agreed_with_library(lib, what, _lanes(g), bm, bk)
    c_dims = (ctypes.c_int * (n_layers + 1))(*dims)
    smem = network_vmem_bytes(dims, bm, nbm * bm)
    if smem != lib.gcn_network_smem_bytes(c_dims, n_layers, bm) \
            or MAX_NETWORK_LAYERS != lib.gcn_network_max_layers() \
            or not lib.gcn_network_supported(c_dims, n_layers, bm, bk):
        raise RuntimeError(
            f"{what}: analysis.vmem models {smem} B of shared memory and at "
            f"most {MAX_NETWORK_LAYERS} layers, the library "
            f"{lib.gcn_network_smem_bytes(c_dims, n_layers, bm)} B and "
            f"{lib.gcn_network_max_layers()}")
    dev = values.device
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((nbm * bm, dims[-1]), **f32)
    tele_acts = torch.empty((n_layers, nbm, width), **f32)
    tele_preds = torch.empty((n_layers, nbm, width), **f32)
    acts = [torch.empty((nbm * bm, dims[ell + 1]), **f32)
            for ell in range(n_layers - 1)]
    work = torch.empty(network_workspace_bytes(dims, nbm * bm) // 4, **f32)
    slices = max(fused_plan(g, bm, bk).slices for g in dims[1:])
    part = torch.empty(slice_part_floats(nbm, width, slices), **f32)
    # the grid barrier's two words, then each stripe's slice count
    barrier = torch.zeros(2 + nbm, dtype=torch.int32, device=dev)
    w_ptrs = (ctypes.c_void_p * n_layers)(*[w.data_ptr() for w in ws])
    wr_ptrs = (ctypes.c_void_p * n_layers)(*[wr.data_ptr() for wr in wrs])
    act_ptrs = (ctypes.c_void_p * max(n_layers - 1, 1))(
        *[a.data_ptr() for a in acts])
    il, ii, jj, delta = (-1, -1, -1, 0.0) if inject is None else inject
    grid = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.gcn_network_launch(
            block_cols.data_ptr(), values.data_ptr(), h0.data_ptr(),
            ctypes.addressof(w_ptrs), ctypes.addressof(wr_ptrs),
            ctypes.addressof(act_ptrs), ctypes.addressof(c_dims),
            out.data_ptr(), tele_acts.data_ptr(), tele_preds.data_ptr(),
            work.data_ptr(), part.data_ptr(), barrier.data_ptr(), n_layers,
            nbm, width, bm, bk,
            int(bool(with_check)), int(il), int(ii), int(jj), float(delta),
            stream, ctypes.addressof(grid))
    runtime.check_launch(code, what)
    gcn_network_kernel.launches += 1
    gcn_network_kernel.last_grid = grid.value
    return out, tele_acts, tele_preds, (tuple(acts) if stash_acts else None)


gcn_network_kernel.launches = 0
# blocks of the persistent grid the last launch chose (read by chip_smoke.py)
gcn_network_kernel.last_grid = 0
