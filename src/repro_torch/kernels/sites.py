"""Kernel sites: each kernel wrapper as ONE opaque op of a traced graph.

The port's stand-in for the JAX package's "a ``pallas_call`` is one site"
(``repro/analysis/coverage.py``).  Every kernel wrapper —
``spmm_abft_kernel`` (B1), ``gcn_fused_kernel`` and ``gcn_fused_combine``
(B2), ``gcn_network_kernel`` (B3), ``matmul_abft_kernel`` and
``matmul_abft_grouped_kernel`` (B4), ``flash_checksum_kernel`` (B5) — has
a ``torch.library`` custom op here, ``repro_torch::<name>``, with a fake
implementation that gives its output shapes.

A wrapper calls its op while check tagging is on
(:func:`repro_torch.core.marker.check_tagging`): a lint trace then records
one node a launch, whose inputs and outputs are the launch's, and the
coverage pass treats it as one matmul-shaped site.  The LM's wrappers (B4,
B5) also call it when an operand is a DTensor: the op's sharding
strategies (registered here with ``register_sharding``) tell DTensor how
the launch splits over a mesh, and its implementation then runs on each
rank's local shards.  The op's
implementation runs the wrapper itself with tagging suspended — on a CUDA
tensor it launches the kernel (counted in ``launches``) or raises, on a
CPU tensor it runs the plain version (counted in ``calls``), exactly as
untagged.  An output that shares storage with an input or an earlier
output is cloned there (a custom op may return no alias), so that copy is
made on the tagged (or DTensor) path only.  With tagging off and no
DTensor operand no op here is called.

Scalars and the ``inject`` tuples travel as plain ``int``/``float``/
``bool`` arguments; ``None`` as a ``has_*`` flag.  Outputs are a list of
tensors (B4's and B5's a fixed tuple), which the helpers below turn back
into the wrapper's return.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.marker import check_tagging
from repro_torch.kernels import any_dtensor, reduce_partial

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
#
# B4 and B5 return a fixed tuple (DTensor's strategies name each output):
# an output the launch does not make (no ``br``, no ``vr``, no stats) is
# an empty placeholder that the helpers turn back into ``None``.  With
# ``whole_sums`` (every call on DTensor operands) ``block_sums`` is reduced
# over its tile grid to one value ([1, 1], [G, 1, 1] grouped): the tile
# follows the LOCAL M (``matmul_tile``), so a row-sharded launch's grid is
# not a slice of the global one, while the grid's total — the check's
# ``actual``, which reduces it anyway — is a partial sum of the global
# total under every layout.
# ---------------------------------------------------------------------------

def _absent(ref: Tensor) -> Tensor:
    """The placeholder of an output a launch does not make."""
    return ref.new_empty((0,), dtype=torch.float32)


def _product_outs(c, sums, extra, whole_sums, ins) -> Tuple[Tensor, ...]:
    if whole_sums:
        sums = sums.sum(dim=(-2, -1), keepdim=True)
    return tuple(_fresh([c, sums, _absent(c) if extra is None else extra],
                        ins))


def _matmul_fake(a, b, br, trans_b, whole_sums, lead=()):
    from repro_torch.analysis.vmem import matmul_tile
    m, k = a.shape[-2:]
    n = b.shape[-2] if trans_b else b.shape[-1]
    tm, tn = matmul_tile(m)
    grid = (1, 1) if whole_sums else (-(-m // tm), -(-n // tn))
    return (_empty(a, *lead, m, n, dtype=a.dtype), _empty(a, *lead, *grid),
            _absent(a) if br is None else
            _empty(a, *lead, m, 1, dtype=br.dtype))


@torch.library.custom_op("repro_torch::matmul_abft", mutates_args=())
def _matmul_abft(a: Tensor, b: Tensor, br: Optional[Tensor],
                 trans_b: bool, whole_sums: bool
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    from .matmul_abft.kernel import matmul_abft_kernel
    with check_tagging(False):
        c, sums, extra = matmul_abft_kernel(a, b, br, trans_b=trans_b)
    return _product_outs(c, sums, extra, whole_sums, (a, b, br))


@_matmul_abft.register_fake
def _matmul_abft_fake(a, b, br, trans_b, whole_sums):
    return _matmul_fake(a, b, br, trans_b, whole_sums)


def matmul_abft(a, b, br=None, *, trans_b=False):
    c, sums, extra = torch.ops.repro_torch.matmul_abft(
        a, b, br, bool(trans_b), any_dtensor(a, b, br))
    return reduce_partial(c), sums, (None if br is None else extra)


@torch.library.custom_op("repro_torch::matmul_abft_grouped", mutates_args=())
def _matmul_abft_grouped(a: Tensor, b: Tensor, br: Optional[Tensor],
                         trans_b: bool, whole_sums: bool,
                         rows: Optional[Tensor]
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    from .matmul_abft.kernel import matmul_abft_grouped_kernel
    with check_tagging(False):
        c, sums, extra = matmul_abft_grouped_kernel(a, b, br,
                                                    trans_b=trans_b,
                                                    rows=rows)
    return _product_outs(c, sums, extra, whole_sums, (a, b, br, rows))


@_matmul_abft_grouped.register_fake
def _matmul_abft_grouped_fake(a, b, br, trans_b, whole_sums, rows):
    return _matmul_fake(a, b, br, trans_b, whole_sums, lead=(a.shape[0],))


def matmul_abft_grouped(a, b, br=None, *, trans_b=False, rows=None):
    c, sums, extra = torch.ops.repro_torch.matmul_abft_grouped(
        a, b, br, bool(trans_b), any_dtensor(a, b, br, rows), rows)
    return reduce_partial(c), sums, (None if br is None else extra)


# ---------------------------------------------------------------------------
# B5: flash_checksum
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::flash_checksum", mutates_args=())
def _flash_checksum(q: Tensor, k: Tensor, v: Tensor, vr: Optional[Tensor],
                    causal: bool, window: int, with_stats: bool
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    from .flash_checksum.kernel import flash_checksum_kernel
    with check_tagging(False):
        out = flash_checksum_kernel(q, k, v, vr, causal=causal,
                                    window=window, with_stats=with_stats)
    out = list(out) + [None] * (4 - len(out))
    return tuple(_fresh([_absent(q) if t is None else t for t in out],
                        (q, k, v, vr)))


@_flash_checksum.register_fake
def _flash_checksum_fake(q, k, v, vr, causal, window, with_stats):
    b, t, h, _dh = q.shape
    return (torch.empty_like(q),
            _absent(q) if vr is None else _empty(q, b, t, h),
            *((_empty(q, b, t, h), _empty(q, b, t, h)) if with_stats
              else (_absent(q), _absent(q))))


def flash_checksum(q, k, v, vr=None, *, causal=True, window=0,
                   with_stats=False):
    o, extra, m, l = torch.ops.repro_torch.flash_checksum(
        q, k, v, vr, bool(causal), int(window), bool(with_stats))
    out = (o, None if vr is None else extra)
    return out + (m, l) if with_stats else out


# ---------------------------------------------------------------------------
# DTensor: the sharding strategies of the LM's sites.  Each is one mesh
# dim's layout (DTensor expands them over every mesh dim and drops the
# ones whose shapes do not divide); each gives GLOBAL outputs equal to one
# unsharded launch: ``c`` and ``o`` exactly, the check columns and sums
# up to the order of summation.  The implementation then runs the wrapper
# on each rank's local shards — on a CUDA shard a kernel launch.  A
# partial ``c`` (``K`` split) is all-reduced at once, as XLA reduces a
# contraction over a sharded axis: DTensor (torch 2.11) cannot add a
# partial sum to a sharded residual.
# ---------------------------------------------------------------------------

def _sharded(*specs) -> set:
    """The tensor dims some mesh dim shards, over ``specs`` (DTensor
    specs; ``None`` for an absent operand)."""
    return {p.dim for spec in specs if spec is not None
            for p in spec.placements if p.is_shard()}


def product_strategies(a_dims: set, b_dims: set, checked: bool,
                       trans_b: bool, grouped: bool, counted: bool = False
                       ) -> List[tuple]:
    """B4's layouts, ``(outputs, inputs)`` placements in the op's order
    (c, sums, extra; a, b, br, trans_b, whole_sums and, grouped, rows): all
    replicated; the rows of ``a`` (the batch axes); the columns of ``b``
    (``model``), with ``b_r`` the partial row sums of the local columns
    (``extra`` partial) or whole (``extra`` replicated); ``K`` (the FSDP
    axes: ``c`` partial); and, grouped, the group axis (``model``,
    experts).  Grouped row counts (``counted``) lie with the group axis —
    split with it, whole otherwise — and rule out the rows of ``a``: a
    count is a global row index, which a shard of the rows would misread
    (``a`` is gathered instead).  A layout is offered
    only where an operand already lies so (``a_dims``, ``b_dims``: the dims
    some mesh dim shards): a replicated operand is never split for free,
    so an output is sharded only as its inputs were (a free column split
    of a replicated weight would cut heads apart at the next view); ``K``
    only where ``a`` splits it (a row-parallel product, the heads or the
    hidden units on ``model``) — a weight split on ``K`` alone (FSDP) is
    gathered, as XLA gathers it, which keeps the batch on its axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    rep, part = Replicate(), Partial()
    o = 1 if grouped else 0                      # the group axis leads
    b_n, b_k = (o, o + 1) if trans_b else (o + 1, o)

    def row(c, sums, extra, a, b, br):
        ins = [a, b, br if checked else None, None, None]
        if grouped:
            ins.append((Shard(0) if a == Shard(0) else rep) if counted
                       else None)
        return [c, sums, extra if checked else rep], ins
    rows = [row(rep, rep, rep, rep, rep, rep)]
    if o in a_dims and not counted:
        rows.append(row(Shard(o), part, Shard(o), Shard(o), rep, rep))
    if b_n in b_dims:
        rows.append(row(Shard(o + 1), part, part, rep, Shard(b_n), part))
        if checked:
            rows.append(row(Shard(o + 1), part, rep, rep, Shard(b_n), rep))
    if o + 1 in a_dims:
        rows.append(row(part, part, part, Shard(o + 1), Shard(b_k),
                        Shard(o)))
    if grouped and 0 in a_dims | b_dims:
        rows.append(row(*(Shard(0),) * 6))
    return rows


def flash_strategies(q_dims: set, kv_dims: set, k_heads: int,
                     has_vr: bool, with_stats: bool) -> List[tuple]:
    """B5's layouts, in the op's order (o, o_extra, m, l; q, k, v, vr,
    causal, window, with_stats): all replicated; the batch; the heads of
    q, k, v and vr together (query head h reads key head h // (H / Kh),
    which a shard of both keeps); and, with one key head (MQA), the query
    heads over a replicated k and v — each offered where q or k already
    lies so (``q_dims``, ``kv_dims``, as for B4)."""
    from torch.distributed.tensor import Replicate, Shard

    rep = Replicate()

    def row(x, kv):
        return ([x, x if has_vr else rep, *((x, x) if with_stats
                                            else (rep, rep))],
                [x, kv, kv, x if has_vr else None, None, None, None])
    rows = [row(rep, rep)]
    if 0 in q_dims | kv_dims:
        rows.append(row(Shard(0), Shard(0)))
    if 2 in q_dims | kv_dims:
        rows.append(row(Shard(2), Shard(2)))
        if k_heads == 1:
            rows.append(row(Shard(2), rep))
    return rows


def product_flops(a_shape, b_shape, br_shape, trans_b, *_args, **_kw
                  ) -> int:
    """B4: 2MNK (the product) + 2MK (A·b_r, checked only), per group."""
    *lead, m, k = a_shape
    n = b_shape[-2] if trans_b else b_shape[-1]
    g = lead[0] if lead else 1
    return g * (2 * m * n * k + (2 * m * k if br_shape is not None else 0))


def flash_flops(q_shape, k_shape, _v_shape, vr_shape, causal, window,
                *_args, **_kw) -> int:
    """B5: the valid (query, key) pairs × (4·dh + 2) — q·k and p·v over
    dh, p·vr (checked only) — with the causal and window masks."""
    b, t, h, dh = q_shape
    s = k_shape[1]
    pairs = b * h * (sum(min(i + 1, s, window or s) for i in range(t))
                     if causal else t * s)
    return pairs * (4 * dh + (2 if vr_shape is not None else 0))


def _register_sharding() -> None:
    from torch.distributed.tensor.experimental import register_sharding
    from torch.utils.flop_counter import register_flop_formula

    ops = torch.ops.repro_torch

    @register_sharding(ops.matmul_abft.default)
    def _matmul_layouts(a, b, br, trans_b, whole_sums):
        return product_strategies(_sharded(a), _sharded(b), br is not None,
                                  trans_b, False)

    @register_sharding(ops.matmul_abft_grouped.default)
    def _grouped_layouts(a, b, br, trans_b, whole_sums, rows):
        return product_strategies(_sharded(a), _sharded(b), br is not None,
                                  trans_b, True, rows is not None)

    @register_sharding(ops.flash_checksum.default)
    def _flash_layouts(q, k, v, vr, causal, window, with_stats):
        return flash_strategies(_sharded(q, vr), _sharded(k, v),
                                k.tensor_meta.shape[2], vr is not None,
                                with_stats)

    register_flop_formula([ops.matmul_abft, ops.matmul_abft_grouped])(
        product_flops)
    register_flop_formula(ops.flash_checksum)(flash_flops)


if torch.distributed.is_available():
    _register_sharding()
