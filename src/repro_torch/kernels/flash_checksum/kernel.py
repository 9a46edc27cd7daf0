"""Flash attention emitting the fused ABFT chain column: the wrapper that
launches the CUDA kernel, and its plain PyTorch version.

Replaces the TPU kernel ``flash_checksum_kernel`` of the JAX package
(``src/repro/kernels/flash_checksum/kernel.py``); the CUDA source is
``kernels/csrc/flash_checksum.cu``, which also says what bounds the kernel
on a Hopper card and what its design does about it.

The layout is the model's, not the TPU kernel's per-(batch·head) slices:
q [B, T, H, dh], k and v [B, S, Kh, dh] (the key/value head of query head h
is h // (H / Kh) — K and V are never repeated per query head), the carried
column vr [B, S, H] (= V·w_or, in q's dtype).  Outputs o [B, T, H, dh] in
q's dtype and o_extra [B, T, H] f32 with Σ o_extra = eᵀ(A·V·W_o)e.  The
causal mask compares query and key indices; a sliding ``window`` > 0
(causal only) keeps key j for query i iff ``i - window < j <= i``, the
reference's ``models/attention.py`` mask.  ``causal=False`` keeps all S
keys for every query, T and S independent (an encoder's self-attention, a
decoder's cross-attention); a ragged S is masked by the kernel, unpadded.  ``vr=None`` skips the column;
o does not change.

``with_stats=True`` also returns each row's softmax statistics after the
part fold, ``m`` and ``l`` [B, T, H] f32: m the largest scaled score
(``q·k · dh^-0.5``, natural exponent; -1e30 where a row has no valid key)
and l the sum of ``e^(score - m)`` over its valid keys, not floored — the
quantities the split baseline's second scoring pass rescales by, in the
units of the reference's ``streaming_attention``.  o and o_extra do not
change.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.analysis.vmem import (FLASH_BLOCK_K, FLASH_BLOCK_Q,
                                        FLASH_MAX_DH, FLASH_PARTS,
                                        FUSED_SMEM_BUDGET, flash_first_block,
                                        flash_head_tile, flash_part_start,
                                        flash_smem_bytes)
from repro_torch.core.marker import tagging_enabled
from repro_torch.kernels import acc_dtype, any_dtensor
from repro_torch.runtime.spans import span

Tensor = torch.Tensor
DTYPES = (torch.float32, torch.bfloat16)
# the plain version also takes float64 (a witness run on the CPU), with
# float64 statistics and accumulators in the same association
PLAIN_DTYPES = DTYPES + (torch.float64,)
NEG = -1e30


def _check_shapes(q: Tensor, k: Tensor, v: Tensor, vr: Optional[Tensor],
                  causal: bool = True, window: int = 0,
                  dtypes: Tuple = DTYPES):
    if window < 0 or (window and not causal):
        raise ValueError(f"window {window} must be >= 0, and > 0 only with "
                         f"the causal mask (causal={causal})")
    if q.ndim != 4 or k.ndim != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"q {tuple(q.shape)} must be [B, T, H, dh] and k, v "
                         f"{tuple(k.shape)}, {tuple(v.shape)} [B, S, Kh, dh]")
    b, t, h, dh = q.shape
    s, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or h % kh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"share B and dh, or H % Kh != 0")
    if vr is not None and tuple(vr.shape) != (b, s, h):
        raise ValueError(f"vr {tuple(vr.shape)} is not [B, S, H] = "
                         f"{(b, s, h)}")
    for name, x in (("k", k), ("v", v), ("vr", vr)):
        if x is not None and x.dtype != q.dtype:
            raise ValueError(f"{name} has dtype {x.dtype}, q {q.dtype}")
    if q.dtype not in dtypes:
        raise ValueError(f"q has dtype {q.dtype}, not one of {dtypes}")
    return b, t, h, dh, s, kh


def flash_checksum_plain(q: Tensor, k: Tensor, v: Tensor,
                         vr: Optional[Tensor] = None, *, causal: bool = True,
                         window: int = 0, with_stats: bool = False
                         ) -> Tuple[Tensor, ...]:
    """Plain PyTorch version of :func:`flash_checksum_kernel`, in the
    kernel's association: each query tile's key blocks (of the kernel's
    width) are cut into the kernel's parts (``analysis.vmem``
    ``flash_part_start``, the window's included); each part runs the online
    softmax over its blocks in order, with p cast to v's dtype before both
    products and ``acc * corr + p @ v``; then the parts are folded in part
    order, ``m = max(m, m_p)``, ``acc = acc * e^(m_old - m) + acc_p *
    e^(m_p - m)`` and l and ex alike.  A key block that lies wholly above a
    query row's diagonal, before its window, or in another part, changes
    nothing (p = 0, corr = 1), so processing it equals the kernel's skip;
    a part in which a row has no valid key leaves it m = -1e30, l = 0, and
    the fold adds nothing of it.  ``with_stats``: also (m, l) after the
    fold, the kernel's.  float64 operands run in float64 throughout."""
    flash_checksum_plain.calls += 1
    b, t, h, dh, s, kh = _check_shapes(q, k, v, vr, causal, window,
                                       PLAIN_DTYPES)
    g = h // kh
    f32 = acc_dtype(q.dtype)
    scale = dh ** -0.5
    dev = q.device
    qf = q.to(f32)
    ke = k.repeat_interleave(g, dim=2).to(f32)
    ve = v.repeat_interleave(g, dim=2)
    qpos = torch.arange(t, device=dev)[:, None]
    # [t, parts + 1]: the key blocks of each row's parts
    n_qt = -(-t // FLASH_BLOCK_Q)
    starts = torch.tensor([[flash_part_start(i, s, causal, p, window)
                            for p in range(FLASH_PARTS + 1)]
                           for i in range(n_qt)], device=dev)
    starts = starts[torch.arange(t, device=dev) // FLASH_BLOCK_Q]
    parts = [dict(m=torch.full((b, t, h), NEG, dtype=f32, device=dev),
                  l=torch.zeros((b, t, h), dtype=f32, device=dev),
                  acc=torch.zeros((b, t, h, dh), dtype=f32, device=dev),
                  ex=torch.zeros((b, t, h), dtype=f32, device=dev))
             for _ in range(FLASH_PARTS)]
    for kb, k0 in enumerate(range(0, s, FLASH_BLOCK_K)):
        k1 = min(k0 + FLASH_BLOCK_K, s)
        sc = torch.einsum("bthd,bchd->bthc", qf, ke[:, k0:k1]) * scale
        kpos = torch.arange(k0, k1, device=dev)[None, :]
        valid = (kpos <= qpos) if causal else torch.ones_like(kpos <= qpos)
        if window > 0:
            valid = valid & (kpos > qpos - window)
        vb = ve[:, k0:k1].to(f32)
        for p, st in enumerate(parts):
            mine = (starts[:, p] <= kb) & (kb < starts[:, p + 1])
            if not bool(mine.any()):
                continue
            ok = (valid & mine[:, None])[None, :, None, :]
            sp = torch.where(ok, sc, torch.full_like(sc, NEG))
            m_new = torch.maximum(st["m"], sp.amax(dim=-1))
            pp = torch.where(ok, torch.exp(sp - m_new[..., None]),
                             torch.zeros_like(sp))
            corr = torch.exp(st["m"] - m_new)
            st["l"] = st["l"] * corr + pp.sum(dim=-1)
            pr = pp.to(v.dtype).to(f32)
            st["acc"] = st["acc"] * corr[..., None] + torch.einsum(
                "bthc,bchd->bthd", pr, vb)
            if vr is not None:
                st["ex"] = st["ex"] * corr + torch.einsum(
                    "bthc,bch->bth", pr, vr[:, k0:k1].to(f32))
            st["m"] = m_new
    m, l, acc, ex = (parts[0][x] for x in ("m", "l", "acc", "ex"))
    for st in parts[1:]:
        m_new = torch.maximum(m, st["m"])
        c0, cp = torch.exp(m - m_new), torch.exp(st["m"] - m_new)
        l = l * c0 + st["l"] * cp
        ex = ex * c0 + st["ex"] * cp
        acc = acc * c0[..., None] + st["acc"] * cp[..., None]
        m = m_new
    lsafe = torch.clamp(l, min=1e-30)
    o = (acc / lsafe[..., None]).to(q.dtype)
    out = (o, None if vr is None else ex / lsafe)
    return out + (m, l) if with_stats else out


flash_checksum_plain.calls = 0


def _agreed_with_library(lib, what: str, dh: int, t: int = 1, s: int = 1,
                         causal: bool = True, window: int = 0) -> None:
    """Hold the library's head-dim limit, cut (query rows a block, keys a
    step and key parts — the plain version's —, the head-dim tile, the
    parts of the first and last query tiles of a launch over ``t`` queries
    and ``s`` keys, and of the first tile whose window starts past key 0)
    and shared memory against ``analysis.vmem``; raise on any
    difference."""
    if dh > FLASH_MAX_DH or FLASH_MAX_DH != lib.flash_checksum_max_dh():
        raise ValueError(f"{what}: head_dim {dh} over the kernel's "
                         f"{lib.flash_checksum_max_dh()} (analysis.vmem "
                         f"models {FLASH_MAX_DH})")
    smem = flash_smem_bytes(dh)
    last = (t - 1) // FLASH_BLOCK_Q
    tiles = sorted({0, last, next((i for i in range(last + 1)
                                   if flash_first_block(i, s, causal,
                                                        window)), last)})
    cut = (FLASH_BLOCK_Q, FLASH_BLOCK_K, FLASH_PARTS, flash_head_tile(dh),
           [flash_part_start(i, s, causal, p, window) for i in tiles
            for p in range(FLASH_PARTS + 1)])
    lib_cut = (lib.flash_checksum_block_q(), lib.flash_checksum_block_k(),
               lib.flash_checksum_parts(), lib.flash_checksum_head_tile(dh),
               [lib.flash_checksum_part_start(i, s, int(causal), p, window)
                for i in tiles for p in range(lib.flash_checksum_parts() + 1)])
    lib_smem = lib.flash_checksum_smem_bytes(dh)
    if smem != lib_smem or smem > FUSED_SMEM_BUDGET or cut != lib_cut:
        raise RuntimeError(f"{what}: analysis.vmem models {smem} B of shared "
                           f"memory and (query rows, keys, parts, head tile, "
                           f"part starts) {cut}, the library {lib_smem} B "
                           f"and {lib_cut} (budget {FUSED_SMEM_BUDGET} B)")


def flash_checksum_kernel(q: Tensor, k: Tensor, v: Tensor,
                          vr: Optional[Tensor] = None, *, causal: bool = True,
                          window: int = 0, with_stats: bool = False
                          ) -> Tuple[Tensor, ...]:
    """q: [B, T, H, dh]; k, v: [B, S, Kh, dh]; vr: [B, S, H] or None; one
    dtype (float32 or bfloat16), dh <= 256; ``window`` > 0 a sliding window
    (causal only).  Returns (o [B, T, H, dh], o_extra [B, T, H] f32 |
    None), and with ``with_stats`` (m, l) [B, T, H] f32 after them (one
    launch either way).

    Operands on a CUDA device launch the CUDA kernel (one launch, counted in
    ``flash_checksum_kernel.launches``) or raise; only operands that lie on
    the CPU take :func:`flash_checksum_plain`.  Under check tagging, or on
    DTensor operands, the call is one ``repro_torch::flash_checksum`` op
    (``kernels/sites.py``), which launches on each local shard."""
    if tagging_enabled() or any_dtensor(q, k, v, vr):
        from repro_torch.kernels import sites

        return sites.flash_checksum(q, k, v, vr, causal=causal, window=window,
                                    with_stats=with_stats)
    with span("op.flash_checksum"):
        if q.device.type == "cpu":
            return flash_checksum_plain(q, k, v, vr, causal=causal,
                                        window=window, with_stats=with_stats)
        from repro_torch.kernels import runtime

        what = "flash_checksum_kernel"
        b, t, h, dh, s, kh = _check_shapes(q, k, v, vr, causal, window)
        ops = dict(q=q, k=k, v=v) if vr is None else dict(q=q, k=k, v=v,
                                                          vr=vr)
        runtime.require_cuda_operands(what, allow=DTYPES, **ops)
        lib = runtime.load_library()
        _agreed_with_library(lib, what, dh, t, s, causal, window)
        dev = q.device
        o = torch.empty_like(q)
        o_extra = None if vr is None else torch.empty(
            (b, t, h), dtype=torch.float32, device=dev)
        stats = torch.empty((b, t, h, 2), dtype=torch.float32,
                            device=dev) if with_stats else None
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.flash_checksum_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if vr is None else vr.data_ptr(), o.data_ptr(),
                None if o_extra is None else o_extra.data_ptr(),
                b, t, s, h, kh, dh, float(dh ** -0.5), int(causal),
                DTYPES.index(q.dtype), stream, int(window),
                None if stats is None else stats.data_ptr())
        runtime.check_launch(code, what)
        flash_checksum_kernel.launches += 1
        if stats is None:
            return o, o_extra
        return o, o_extra, stats[..., 0], stats[..., 1]


flash_checksum_kernel.launches = 0
