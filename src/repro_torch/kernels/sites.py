"""Kernel sites: each kernel wrapper as ONE opaque op of a traced graph.

The port's stand-in for the JAX package's "a ``pallas_call`` is one site"
(``repro/analysis/coverage.py``).  Every kernel wrapper —
``spmm_abft_kernel`` (B1), ``gcn_fused_kernel`` and ``gcn_fused_combine``
(B2), ``gcn_network_kernel`` (B3), ``matmul_abft_kernel`` and
``matmul_abft_grouped_kernel`` (B4), ``flash_checksum_kernel`` (B5) — has
a ``torch.library`` custom op here, ``repro_torch::<name>``, with a fake
implementation that gives its output shapes.

A wrapper calls its op only while check tagging is on
(:func:`repro_torch.core.marker.check_tagging`): a lint trace then records
one node a launch, whose inputs and outputs are the launch's, and the
coverage pass treats it as one matmul-shaped site.  The op's
implementation runs the wrapper itself with tagging suspended — on a CUDA
tensor it launches the kernel (counted in ``launches``) or raises, on a
CPU tensor it runs the plain version (counted in ``calls``), exactly as
untagged.  An output that shares storage with an input or an earlier
output is cloned there (a custom op may return no alias), so that copy is
made on the tagged path only.  With tagging off no op here is called.

Scalars and the ``inject`` tuples travel as plain ``int``/``float``/
``bool`` arguments; ``None`` as a ``has_*`` flag.  Outputs are a list of
tensors, which the helpers below turn back into the wrapper's return.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.core.marker import check_tagging

Tensor = torch.Tensor


def _fresh(outs: Sequence[Tensor], ins: Sequence[Optional[Tensor]]
           ) -> List[Tensor]:
    """``outs``, each cloned when it shares storage with an input or an
    earlier output."""
    seen = {t.untyped_storage().data_ptr() for t in ins
            if t is not None and t.numel()}
    res = []
    for t in outs:
        key = t.untyped_storage().data_ptr() if t.numel() else None
        if key is not None and key in seen:
            t = t.clone()
            key = t.untyped_storage().data_ptr()
        seen.add(key)
        res.append(t)
    return res


def _inject(flag: bool, *vals):
    return tuple(vals) if flag else None


def _unpack_inject(inject, n: int) -> tuple:
    """(has, *fields) — ``n`` ints and a float, zeros when ``None``."""
    if inject is None:
        return (False,) + (0,) * n + (0.0,)
    return (True,) + tuple(int(v) for v in inject[:n]) + (float(inject[n]),)


def _empty(ref: Tensor, *shape, dtype=torch.float32) -> Tensor:
    return ref.new_empty(shape, dtype=dtype)


# ---------------------------------------------------------------------------
# B1: spmm_abft
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::spmm_abft", mutates_args=())
def _spmm_abft(block_cols: Tensor, values: Tensor, x: Tensor, xr: Tensor,
               has_inject: bool, stripe: int, slot: int, delta: float
               ) -> List[Tensor]:
    from .spmm_abft.kernel import spmm_abft_kernel
    with check_tagging(False):
        out = spmm_abft_kernel(block_cols, values, x, xr,
                               inject=_inject(has_inject, stripe, slot, delta))
    return _fresh(out, (block_cols, values, x, xr))


@_spmm_abft.register_fake
def _spmm_abft_fake(block_cols, values, x, xr, has_inject, stripe, slot,
                    delta):
    nbm, _width, bm, _bk = values.shape
    return [_empty(x, nbm * bm, x.shape[1], dtype=x.dtype),
            _empty(x, nbm, 1), _empty(x, nbm * bm, 1)]


def spmm_abft(block_cols, values, x, xr, *, inject=None):
    out = torch.ops.repro_torch.spmm_abft(
        block_cols, values, x, xr, *_unpack_inject(inject, 2))
    return tuple(out)


# ---------------------------------------------------------------------------
# B2: gcn_fused and its combination alone
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::gcn_fused", mutates_args=())
def _gcn_fused(block_cols: Tensor, values: Tensor, h: Tensor, w: Tensor,
               wr: Tensor, has_inject: bool, stripe: int, slot: int,
               delta: float, with_check: bool, with_slots: bool
               ) -> List[Tensor]:
    from .gcn_fused.kernel import gcn_fused_kernel
    with check_tagging(False):
        out = gcn_fused_kernel(block_cols, values, h, w, wr,
                               inject=_inject(has_inject, stripe, slot, delta),
                               with_check=with_check, with_slots=with_slots)
    return _fresh(out, (block_cols, values, h, w, wr))


@_gcn_fused.register_fake
def _gcn_fused_fake(block_cols, values, h, w, wr, has_inject, stripe, slot,
                    delta, with_check, with_slots):
    nbm, width, bm, _bk = values.shape
    out = [_empty(h, nbm * bm, w.shape[1], dtype=h.dtype),
           _empty(h, nbm, 1), _empty(h, nbm * bm, 1)]
    if with_slots:
        out += [_empty(h, nbm, width), _empty(h, nbm, width)]
    return out


def gcn_fused(block_cols, values, h, w, wr, *, inject=None, with_check=True,
              with_slots=False):
    out = torch.ops.repro_torch.gcn_fused(
        block_cols, values, h, w, wr, *_unpack_inject(inject, 2),
        bool(with_check), bool(with_slots))
    return tuple(out)


@torch.library.custom_op("repro_torch::gcn_fused_combine", mutates_args=())
def _gcn_fused_combine(h: Tensor, w: Tensor, wr: Tensor, bm: int, bk: int,
                       with_check: bool) -> List[Tensor]:
    from .gcn_fused.kernel import gcn_fused_combine as combine
    with check_tagging(False):
        out = combine(h, w, wr, block=(bm, bk), with_check=with_check)
    return _fresh(out, (h, w, wr))


@_gcn_fused_combine.register_fake
def _gcn_fused_combine_fake(h, w, wr, bm, bk, with_check):
    return [_empty(h, h.shape[0], w.shape[1]), _empty(h, h.shape[0], 1)]


def gcn_fused_combine(h, w, wr, *, block=(128, 128), with_check=True):
    out = torch.ops.repro_torch.gcn_fused_combine(
        h, w, wr, int(block[0]), int(block[1]), bool(with_check))
    return tuple(out)


# ---------------------------------------------------------------------------
# B3: gcn_network
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::gcn_network", mutates_args=())
def _gcn_network(block_cols: Tensor, values: Tensor, h0: Tensor,
                 ws: List[Tensor], wrs: List[Tensor], has_inject: bool,
                 layer: int, stripe: int, slot: int, delta: float,
                 with_check: bool, stash_acts: bool) -> List[Tensor]:
    from .gcn_fused.kernel import gcn_network_kernel
    with check_tagging(False):
        out, tele_acts, tele_preds, acts = gcn_network_kernel(
            block_cols, values, h0, ws, wrs,
            inject=_inject(has_inject, layer, stripe, slot, delta),
            with_check=with_check, stash_acts=stash_acts)
    return _fresh([out, tele_acts, tele_preds, *(acts or ())],
                  (block_cols, values, h0, *ws, *wrs))


@_gcn_network.register_fake
def _gcn_network_fake(block_cols, values, h0, ws, wrs, has_inject, layer,
                      stripe, slot, delta, with_check, stash_acts):
    from .gcn_fused.kernel import _check_network_shapes
    dims = _check_network_shapes(block_cols, values, h0, ws, wrs)
    nbm, width, bm, _bk = values.shape
    n_layers = len(ws)
    out = [_empty(h0, nbm * bm, dims[-1]),
           _empty(h0, n_layers, nbm, width), _empty(h0, n_layers, nbm, width)]
    if stash_acts:
        out += [_empty(h0, nbm * bm, dims[ell + 1])
                for ell in range(n_layers - 1)]
    return out


def gcn_network(block_cols, values, h0, ws, wrs, *, inject=None,
                with_check=True, stash_acts=False):
    out = torch.ops.repro_torch.gcn_network(
        block_cols, values, h0, list(ws), list(wrs),
        *_unpack_inject(inject, 3), bool(with_check), bool(stash_acts))
    return (out[0], out[1], out[2],
            tuple(out[3:]) if stash_acts else None)


# ---------------------------------------------------------------------------
# B4: matmul_abft, single and grouped
# ---------------------------------------------------------------------------

def _matmul_fake(a, b, br, trans_b, lead=()):
    from repro_torch.analysis.vmem import matmul_tile
    m, k = a.shape[-2:]
    n = b.shape[-2] if trans_b else b.shape[-1]
    tm, tn = matmul_tile(m)
    out = [_empty(a, *lead, m, n, dtype=a.dtype),
           _empty(a, *lead, -(-m // tm), -(-n // tn))]
    if br is not None:
        out.append(_empty(a, *lead, m, 1, dtype=br.dtype))
    return out


@torch.library.custom_op("repro_torch::matmul_abft", mutates_args=())
def _matmul_abft(a: Tensor, b: Tensor, br: Optional[Tensor],
                 trans_b: bool) -> List[Tensor]:
    from .matmul_abft.kernel import matmul_abft_kernel
    with check_tagging(False):
        c, sums, extra = matmul_abft_kernel(a, b, br, trans_b=trans_b)
    return _fresh([c, sums] + ([] if extra is None else [extra]), (a, b, br))


@_matmul_abft.register_fake
def _matmul_abft_fake(a, b, br, trans_b):
    return _matmul_fake(a, b, br, trans_b)


def matmul_abft(a, b, br=None, *, trans_b=False):
    out = torch.ops.repro_torch.matmul_abft(a, b, br, bool(trans_b))
    return out[0], out[1], (out[2] if br is not None else None)


@torch.library.custom_op("repro_torch::matmul_abft_grouped", mutates_args=())
def _matmul_abft_grouped(a: Tensor, b: Tensor, br: Optional[Tensor],
                         trans_b: bool) -> List[Tensor]:
    from .matmul_abft.kernel import matmul_abft_grouped_kernel
    with check_tagging(False):
        c, sums, extra = matmul_abft_grouped_kernel(a, b, br,
                                                    trans_b=trans_b)
    return _fresh([c, sums] + ([] if extra is None else [extra]), (a, b, br))


@_matmul_abft_grouped.register_fake
def _matmul_abft_grouped_fake(a, b, br, trans_b):
    return _matmul_fake(a, b, br, trans_b, lead=(a.shape[0],))


def matmul_abft_grouped(a, b, br=None, *, trans_b=False):
    out = torch.ops.repro_torch.matmul_abft_grouped(a, b, br, bool(trans_b))
    return out[0], out[1], (out[2] if br is not None else None)


# ---------------------------------------------------------------------------
# B5: flash_checksum
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::flash_checksum", mutates_args=())
def _flash_checksum(q: Tensor, k: Tensor, v: Tensor, vr: Optional[Tensor],
                    causal: bool, window: int, with_stats: bool
                    ) -> List[Tensor]:
    from .flash_checksum.kernel import flash_checksum_kernel
    with check_tagging(False):
        out = flash_checksum_kernel(q, k, v, vr, causal=causal,
                                    window=window, with_stats=with_stats)
    return _fresh([t for t in out if t is not None], (q, k, v, vr))


@_flash_checksum.register_fake
def _flash_checksum_fake(q, k, v, vr, causal, window, with_stats):
    b, t, h, _dh = q.shape
    out = [torch.empty_like(q)]
    if vr is not None:
        out.append(_empty(q, b, t, h))
    if with_stats:
        out += [_empty(q, b, t, h), _empty(q, b, t, h)]
    return out


def flash_checksum(q, k, v, vr=None, *, causal=True, window=0,
                   with_stats=False):
    out = list(torch.ops.repro_torch.flash_checksum(
        q, k, v, vr, bool(causal), int(window), bool(with_stats)))
    if vr is None:
        out.insert(1, None)
    return tuple(out)
