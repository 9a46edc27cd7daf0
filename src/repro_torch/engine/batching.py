"""Batching of variable-size graphs for serving: dense buckets + packed
block-diagonal block-ELL.

Serving traffic is many small-to-medium graphs of *different* sizes; the
serving step is cached per packed shape.  Two strategies live here:

* **Dense bucketing** (:func:`make_batches`): round every graph up to the
  smallest configured bucket that fits, stack same-bucket graphs into
  [B, N, N] / [B, N, F] dense batches, and let one engine step per
  (bucket, batch) shape serve the whole stream — O(B·N²·F) per bucket
  regardless of sparsity.

* **Block-diagonal packing** (:func:`pack_graphs` /
  :func:`make_packed_batches`): compose a batch of graphs into ONE packed
  block-ELL system — each graph's rows round up only to the block size, its
  row-stripes stack, and its column-block indices shift by its stripe
  offset, so the batch is exactly the block-diagonal matrix
  diag(S_1, …, S_G).  Aggregation then runs through the spmm_abft CUDA
  kernel and costs O(nnz tiles), not O(B·N²); the kernel's per-stripe
  checksum partials segment-sum into *per-graph* eq.-6 corners
  (``kernels.spmm_abft.ops.spmm_abft_packed``), so a flagged batch retries
  only the flagged graphs.

Zero-padding is exact for both the math and the check in both layouts:
padded node rows of S and H0 are all-zero, so they contribute zero to every
matmul, to the eq.-5 column, and to both sides of the checksum — padded
slots can never flag.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.kernels.spmm_abft.layout import (
    BlockEll,
    dense_to_block_ell,
    pad_block_rows,
    pad_block_rows_to,
    pad_width,
    stack_block_ell,
)


@dataclasses.dataclass
class GraphBatch:
    """Fixed-shape batch of padded graphs (host-side numpy)."""

    s: np.ndarray         # [B, N, N] zero-padded normalized adjacencies
    h0: np.ndarray        # [B, N, F]
    n_nodes: np.ndarray   # [B] logical (unpadded) node counts; 0 = pad slot
    bucket: int           # N
    indices: Optional[np.ndarray] = None  # [B] stream position; -1 = pad slot

    @property
    def n_graphs(self) -> int:
        """Real graphs in the batch (excludes all-zero pad slots)."""
        return int((self.n_nodes > 0).sum())


@dataclasses.dataclass
class PackedGraphs:
    """One block-diagonal packed batch of variable-size graphs.

    ``bell`` is the packed block-ELL system diag(S_1, …, S_G) with every
    graph padded to a whole number of square blocks; ``stripe_graph`` maps
    each row-stripe to its graph slot (padding stripes from
    ``pad_block_rows`` carry id ``n_slots`` — the overflow segment the
    kernel epilogue drops); ``h0`` stacks the node features at each graph's
    padded row offset.  ``items`` keeps the source (S, H0) pairs so a
    flagged graph can be re-packed and retried alone.
    """

    bell: BlockEll
    stripe_graph: np.ndarray   # [n_block_rows] int32 graph slot per stripe
    h0: np.ndarray             # [padded_rows, F] stacked features
    n_nodes: np.ndarray        # [n_slots] logical node counts; 0 = empty slot
    row_offsets: np.ndarray    # [n_slots] first padded row of each graph
    indices: Optional[np.ndarray] = None  # [n_slots] stream position; -1 pad
    items: Optional[List[Tuple[np.ndarray, np.ndarray]]] = \
        dataclasses.field(default=None, repr=False)
    # shape-quantization knobs this batch was packed with — retries re-pack
    # subsets with the SAME knobs so sub-pack shapes hit the step cache
    stripe_multiple: int = 1
    width_multiple: int = 1

    @property
    def n_slots(self) -> int:
        return int(self.n_nodes.shape[0])

    @property
    def n_graphs(self) -> int:
        return int((self.n_nodes > 0).sum())

    @property
    def block(self) -> int:
        return self.bell.block_m


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; raises if the graph outgrows every bucket."""
    for b in sorted(buckets):
        if n <= b:
            return b
    raise ValueError(f"graph with {n} nodes exceeds largest bucket "
                     f"{max(buckets)}")


def pad_graph(s: np.ndarray, h0: np.ndarray, n_to: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad one dense (S, H0) pair to ``n_to`` nodes, keeping dtypes —
    bf16 features and f64 reference streams must survive batching."""
    n = s.shape[0]
    if n > n_to:
        raise ValueError(f"cannot pad {n} nodes down to {n_to}")
    sp = np.zeros((n_to, n_to), s.dtype)
    sp[:n, :n] = s
    hp = np.zeros((n_to, h0.shape[1]), h0.dtype)
    hp[:n] = h0
    return sp, hp


def _validate_feat_dims(graphs: Sequence[Tuple[np.ndarray, np.ndarray]]):
    """All graphs feed one model: feature dims must agree.  Raise up front
    with the offending stream position instead of dying in a buffer
    assignment deep inside batching."""
    if not graphs:
        return
    feat = graphs[0][1].shape[1]
    for gi, (_, h0) in enumerate(graphs):
        if h0.shape[1] != feat:
            raise ValueError(
                f"graph {gi} has feature dim {h0.shape[1]} but graph 0 has "
                f"{feat}; all graphs in one stream must share the model's "
                f"input feature dim")


def make_batches(graphs: Iterable[Tuple[np.ndarray, np.ndarray]],
                 batch_size: int, buckets: Sequence[int]
                 ) -> List[GraphBatch]:
    """Group (S, H0) pairs by bucket and stack into fixed-shape batches.

    Partial batches are padded with empty (all-zero) slots so every batch
    of a given bucket has the same [batch_size, N, ...] shape — one step
    shape per bucket, not per residue.  Buffer dtypes are the numpy
    promotion of the inputs' dtypes (f32 in, f32 out; f64 in, f64 out).
    """
    graphs = list(graphs)
    _validate_feat_dims(graphs)
    by_bucket: dict = {}
    for gi, (s, h0) in enumerate(graphs):
        b = pick_bucket(s.shape[0], buckets)
        by_bucket.setdefault(b, []).append((gi, s, h0))
    out: List[GraphBatch] = []
    for b in sorted(by_bucket):
        items = by_bucket[b]
        feat = items[0][2].shape[1]
        s_dt = np.result_type(*[s.dtype for _, s, _ in items])
        h_dt = np.result_type(*[h.dtype for _, _, h in items])
        for lo in range(0, len(items), batch_size):
            chunk = items[lo:lo + batch_size]
            sb = np.zeros((batch_size, b, b), s_dt)
            hb = np.zeros((batch_size, b, feat), h_dt)
            nn = np.zeros(batch_size, np.int64)
            idx = np.full(batch_size, -1, np.int64)
            for i, (gi, s, h0) in enumerate(chunk):
                sb[i], hb[i] = pad_graph(s, h0, b)
                nn[i] = s.shape[0]
                idx[i] = gi
            out.append(GraphBatch(s=sb, h0=hb, n_nodes=nn, bucket=b,
                                  indices=idx))
    return out


def graph_pack_stats(s: np.ndarray, block: int) -> Tuple[int, int]:
    """(stripe count, block-ELL width) one graph contributes to a packed
    batch, computed from the nonzero pattern without building the tile
    table — the online packer calls this per request to fit a capacity
    rung, so it must be cheap."""
    s = np.asarray(s)
    n = s.shape[0]
    stripes = -(-n // block)
    r, c = np.nonzero(s)
    if r.size == 0:
        return stripes, 1
    tiles = np.unique(np.stack([r // block, c // block], axis=1), axis=0)
    width = int(np.bincount(tiles[:, 0], minlength=stripes).max())
    return stripes, max(width, 1)


def pack_graphs(graphs: Sequence[Tuple[np.ndarray, np.ndarray]],
                *, block: int = 32, n_slots: Optional[int] = None,
                stripe_multiple: int = 1, width_multiple: int = 1,
                stripe_cap: Optional[int] = None,
                width_cap: Optional[int] = None,
                indices: Optional[Sequence[int]] = None) -> PackedGraphs:
    """Compose (S, H0) pairs into one block-diagonal packed block-ELL batch.

    Each graph pads only to the next ``block`` multiple (not to a power-of-2
    bucket), converts to block-ELL, and stacks: row-stripes concatenate and
    column-block indices shift by the graph's stripe offset, yielding
    exactly diag(S_1, …, S_G).  ``n_slots`` pads the *graph* count with
    empty slots (zero stripes — their check corner is 0 = 0, never flags)
    and ``stripe_multiple``/``width_multiple`` quantize the stripe count
    (via ``pad_block_rows``) and tile width, so ragged traffic maps to few
    distinct packed shapes.

    ``stripe_cap``/``width_cap`` go further and pin the stripe count and
    ELL width to EXACT values — the canonical-rung contract of the
    streaming engine: every batch packed against the same rung presents
    one packed shape no matter which graphs landed in it.  Raises when the
    contents genuinely exceed a cap (the engine checks fit *before*
    admitting a graph to a rung's open bin).
    """
    if not graphs:
        raise ValueError("pack_graphs needs at least one graph")
    _validate_feat_dims(graphs)
    n_slots = len(graphs) if n_slots is None else n_slots
    if n_slots < len(graphs):
        raise ValueError(f"n_slots={n_slots} < {len(graphs)} graphs")
    feat = graphs[0][1].shape[1]
    h_dt = np.result_type(*[h.dtype for _, h in graphs])

    bells, offsets, stripe_graph = [], [], []
    n_nodes = np.zeros(n_slots, np.int64)
    row_offsets = np.zeros(n_slots, np.int64)
    off = 0  # running stripe offset == column-block offset (square blocks)
    for g, (s, _) in enumerate(graphs):
        bell_g = dense_to_block_ell(np.asarray(s), block_m=block,  # abftlint: sync-ok (host numpy packing, not device data)
                                    block_k=block)
        bells.append(bell_g)
        offsets.append(off)
        stripe_graph.extend([g] * bell_g.n_block_rows)
        n_nodes[g] = s.shape[0]
        row_offsets[g] = off * block
        off += bell_g.n_block_rows

    total_rows = off * block
    bell = stack_block_ell(bells, offsets, shape=(total_rows, total_rows),
                           width_multiple=width_multiple)
    bell = pad_block_rows(bell, stripe_multiple)
    if stripe_cap is not None:
        bell = pad_block_rows_to(bell, stripe_cap)
    if width_cap is not None:
        bell = pad_width(bell, width_cap)
    stripe_graph = np.asarray(stripe_graph, np.int32)
    if bell.n_block_rows > stripe_graph.shape[0]:
        # pad stripes land in the overflow segment (id n_slots), which the
        # segmented epilogue computes and drops
        pad = np.full(bell.n_block_rows - stripe_graph.shape[0], n_slots,
                      np.int32)
        stripe_graph = np.concatenate([stripe_graph, pad])

    h0 = np.zeros((bell.padded_rows, feat), h_dt)
    for g, (_, h) in enumerate(graphs):
        h0[row_offsets[g]:row_offsets[g] + n_nodes[g]] = h

    idx = np.full(n_slots, -1, np.int64)
    if indices is not None:
        idx[:len(graphs)] = np.asarray(indices, np.int64)
    return PackedGraphs(bell=bell, stripe_graph=stripe_graph, h0=h0,
                        n_nodes=n_nodes, row_offsets=row_offsets,
                        indices=idx, items=list(graphs),
                        stripe_multiple=stripe_multiple,
                        width_multiple=width_multiple)


def schedule_packs(stripes: Sequence[int], batch_size: int,
                   stripe_multiple: int = 1) -> List[List[int]]:
    """Size-aware pack scheduling: first-fit-decreasing bin-packing of graph
    indices by stripe count into ``ceil(n / batch_size)`` bins of at most
    ``batch_size`` graphs each.

    Arrival-order chunking makes each batch's stripe total (and therefore
    its padded kernel shape) track whatever sizes happened to arrive
    together — a ragged stream yields many distinct packed shapes and batches
    far above the mean pay ELL/slot padding for their widest member.  FFD
    instead fills every bin toward the same stripe capacity (the mean,
    rounded up to ``stripe_multiple`` — the shape quantum), which equalizes
    packed shapes across batches and cuts padding waste.  Graphs that fit
    no bin under the capacity spill into the currently-emptiest bin, so the
    schedule always places every graph.  Returns the per-bin index lists
    (deterministic: sizes tie-break by arrival position).
    """
    n = len(stripes)
    if n == 0:
        return []
    n_bins = -(-n // batch_size)
    q = max(stripe_multiple, 1)
    mean_up = -(-sum(stripes) // n_bins)
    cap = -(-mean_up // q) * q
    order = sorted(range(n), key=lambda i: (-stripes[i], i))
    bins: List[List[int]] = [[] for _ in range(n_bins)]
    load = [0] * n_bins
    for gi in order:
        placed = next((b for b in range(n_bins)
                       if len(bins[b]) < batch_size
                       and load[b] + stripes[gi] <= cap), None)
        if placed is None:  # doesn't fit anywhere: emptiest open bin
            placed = min((b for b in range(n_bins)
                          if len(bins[b]) < batch_size),
                         key=lambda b: (load[b], b))
        bins[placed].append(gi)
        load[placed] += stripes[gi]
    return [b for b in bins if b]


def make_packed_batches(graphs: Iterable[Tuple[np.ndarray, np.ndarray]],
                        batch_size: int, *, block: int = 32,
                        stripe_multiple: int = 1, width_multiple: int = 1,
                        schedule: str = "size") -> List[PackedGraphs]:
    """Chunk a stream into block-diagonal packed batches of ``batch_size``
    graph slots.  Every batch has exactly ``batch_size`` slots so the
    segmented check shape is fixed; stripe/width quantization bounds the
    number of distinct kernel shapes.

    ``schedule="size"`` (default) bin-packs graphs by stripe count with
    first-fit-decreasing (:func:`schedule_packs`) to equalize packed shapes
    across batches; ``"arrival"`` keeps plain stream-order chunking.
    Stream-order per-graph verdicts are preserved either way through each
    batch's ``indices``.
    """
    graphs = list(graphs)
    _validate_feat_dims(graphs)
    if schedule not in ("size", "arrival"):
        raise ValueError(f"schedule {schedule!r} not in ('size', 'arrival')")
    if schedule == "size":
        stripes = [-(-s.shape[0] // block) for s, _ in graphs]
        groups = schedule_packs(stripes, batch_size, stripe_multiple)
    else:
        groups = [list(range(lo, min(lo + batch_size, len(graphs))))
                  for lo in range(0, len(graphs), batch_size)]
    out: List[PackedGraphs] = []
    for idx in groups:
        out.append(pack_graphs(
            [graphs[i] for i in idx], block=block, n_slots=batch_size,
            stripe_multiple=stripe_multiple, width_multiple=width_multiple,
            indices=idx))
    return out


def synth_graph_stream(n_graphs: int, *, n_lo: int = 24, n_hi: int = 120,
                       feat: int = 16, avg_deg: int = 4, seed: int = 0
                       ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Deterministic stream of variable-size (S, H0) pairs for smoke runs."""
    from repro_torch.core.gcn import normalized_adjacency_dense

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_graphs):
        n = int(rng.integers(n_lo, n_hi + 1))  # abftlint: sync-ok (host RNG)
        m = max(n * avg_deg // 2, 1)
        e = rng.integers(0, n, size=(3 * m + 16, 2), dtype=np.int64)
        e = e[e[:, 0] != e[:, 1]]
        e = np.unique(np.sort(e, axis=1), axis=0)[:m]
        s = normalized_adjacency_dense(e, n)
        h0 = rng.normal(0, 0.5, size=(n, feat)).astype(np.float32)
        out.append((s, h0))
    return out
