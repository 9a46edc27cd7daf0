"""Closed-batch multi-graph GCN server (benchmark mode).

This server materializes a whole stream, packs it once, and replays the
batches — the right harness for apples-to-apples throughput measurements,
where arrival timing must not pollute the measurement.  It is a thin client
of ``engine.streaming``'s steps, retry ladder and the ``ABFTGuard``
escalation ladder.  Counterpart of the JAX package's
``repro/launch/serve_gcn.py``; it runs on the GPU unless ``--device cpu``
(or ``device="cpu"``) is given.

Variable-size graphs batch one of two ways:

* ``--backend dense``      — bucketed zero-padding into [B, N, N] dense
  batches (one step shape per bucket), O(B·N²·F) per bucket regardless of
  sparsity;
* ``--backend block_ell``  — block-diagonal packing into ONE block-ELL
  system per batch (``engine.batching.pack_graphs``): each graph pads only
  to the block size, aggregation runs through the hand-written CUDA
  spmm_abft kernel, and the fused epilogue segment-sums the per-stripe
  checksum partials into *per-graph* eq.-6 corners — serving cost scales
  with nnz, not N².  ``--fused-layer`` runs each layer through the
  single-pass gcn_fused kernel instead.

Both paths run under ``ABFTGuard.run_step_graphs``: the step emits a
per-graph verdict vector, so a flagged batch retries *only the flagged
graphs* (a small re-pack) instead of replaying the whole bucket; a
persistently flagged step falls back to restore->replay->verify.  Per-layer
``w_r`` is folded once at weight-load time (``engine.fold_w_r``), not
recomputed per step.  Reports graphs/sec over the sustained phase plus the
stream-order per-graph verdicts.

    PYTHONPATH=src python -m repro_torch.launch.serve_gcn --graphs 64 \
        --batch 8 --backend block_ell --block 32 --abft fused --fused-layer

``--fused-network`` and ``--check-granularity stripe|slot`` are accepted
and refused with an error until the whole-network kernel and the surgical
repair tiers are ported (slice 2 of the port).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.convert import params_to_device
from repro_torch.core.abft import ABFTConfig
from repro_torch.core.gcn import init_gcn
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine import GraphBatch, PackedGraphs, fold_w_r, \
    make_batches, make_packed_batches, synth_graph_stream
from repro_torch.engine.streaming import (
    PackedRunner,
    dense_retry_fn,
    make_serve_step,
)
from repro_torch.runtime import ABFTGuard

Batch = Union[GraphBatch, PackedGraphs]


def _sync(dev: torch.device) -> None:
    """Timing barrier: wait for the device (no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(batches: Sequence[Batch], params, cfg: ABFTConfig,
          guard: Optional[ABFTGuard] = None, verbose: bool = True, *,
          block_g: int = 128, fused_layer: bool = False,
          fused_network: bool = False, vmem_budget: Optional[int] = None,
          granularity: str = "graph", device: DeviceLike = "cuda"):
    """Run every batch through the guarded step; returns stats.

    Dispatches per batch type (GraphBatch -> dense, PackedGraphs -> packed
    block-ELL); both report per-graph verdicts, assembled into stream order
    via each batch's ``indices``.  Retries re-pack at each batch's own
    block size (``PackedGraphs.block``).  ``fused_layer=True`` selects the
    single-pass gcn_fused kernel on the packed path (dense path unaffected),
    falling back per layer to the two-pass kernel when one block's
    shared-memory working set exceeds ``vmem_budget``.  ``fused_network``
    and the ``"stripe"``/``"slot"`` granularities' surgical retry tiers
    raise ``NotImplementedError`` until they are ported.  ``device``
    defaults to the GPU and raises when there is none.
    """
    if granularity not in ("graph", "stripe", "slot"):
        raise ValueError(f"serve granularity {granularity!r} not in "
                         f"('graph', 'stripe', 'slot')")
    dev = resolve_device(device)
    guard = guard if guard is not None else ABFTGuard()
    params = fold_w_r(params_to_device(params, device=dev), cfg)
    dense_step = None
    packed = PackedRunner(params, cfg, block_g, fused_layer, granularity,
                          fused_network=fused_network,
                          vmem_budget=vmem_budget, device=dev)
    fusion = {"fused_hits": 0, "fused_fallbacks": 0,
              "network_hits": 0, "network_fallbacks": 0}

    def run_one(b: Batch, warm: bool):
        nonlocal dense_step
        stripe_retry = slot_retry = None
        if isinstance(b, PackedGraphs):
            step, args = packed.step_for(b), packed.args_for(b)
            retry = packed.retry_fn(b)
            if granularity in ("stripe", "slot"):
                stripe_retry = packed.stripe_retry_fn(b)
            if granularity == "slot":
                slot_retry = packed.slot_retry_fn(b)
            if not warm:
                for key, n in packed.fusion_counts(b).items():
                    fusion[key] += n
        else:
            if granularity != "graph":
                raise ValueError("dense batches have no row-stripes; "
                                 "--check-granularity stripe/slot needs "
                                 "--backend block_ell")
            if dense_step is None:
                dense_step = make_serve_step(params, cfg, device=dev)
            step = dense_step
            args = (torch.from_numpy(b.s).to(dev),
                    torch.from_numpy(b.h0).to(dev))
            retry = dense_retry_fn(dense_step, b, dev)
        if warm:
            out, metrics = step(*args)
        else:
            out, metrics = guard.run_step_graphs(
                step, retry, *args, stripe_retry_fn=stripe_retry,
                slot_retry_fn=slot_retry)
        return out, metrics

    # warmup runs each distinct shape once (excluded from the timed phase;
    # the first one also builds and loads the CUDA kernels)
    shapes = {}
    for b in batches:
        key = (b.s.shape, b.h0.shape) if isinstance(b, GraphBatch) \
            else (b.bell.values.shape, b.h0.shape, b.n_slots)
        shapes.setdefault(key, b)
    for b in shapes.values():
        run_one(b, warm=True)
        _sync(dev)                                   # timing barrier

    n_graphs = 0
    n_stream = sum(b.n_graphs for b in batches)
    graph_flags = np.zeros(n_stream, bool)
    graph_max_rel = np.zeros(n_stream, np.float32)
    t0 = time.perf_counter()
    for b in batches:
        logits, metrics = run_one(b, warm=False)
        _sync(dev)                                   # timing barrier
        n_graphs += b.n_graphs
        if b.indices is not None:
            live = b.indices >= 0
            graph_flags[b.indices[live]] = \
                _to_numpy(metrics["abft_graph_flags"])[live]
            graph_max_rel[b.indices[live]] = \
                _to_numpy(metrics["abft_graph_max_rel"])[live]
    dt = time.perf_counter() - t0
    gps = n_graphs / max(dt, 1e-9)
    kind = "packed block_ell" if any(isinstance(b, PackedGraphs)
                                     for b in batches) else "dense"
    if fused_layer and kind != "dense":
        kind += " (fused-layer)"
    if granularity == "stripe":
        kind += " [stripe corners]"
    elif granularity == "slot":
        kind += " [slot corners]"
    if verbose:
        print(f"served {n_graphs} graphs in {len(batches)} {kind} batches "
              f"({len(shapes)} shapes) in {dt*1e3:.1f} ms "
              f"-> {gps:.1f} graphs/sec")
        print(f"guard: steps={guard.steps} flags={guard.flags} "
              f"retries={guard.retries} graph_retries={guard.graph_retries} "
              f"stripe_retries={guard.stripe_retries} "
              f"slot_retries={guard.slot_retries} "
              f"recomputed_rows={guard.recomputed_rows} "
              f"flag_rate={guard.flag_rate:.4f} "
              f"evict={guard.should_evict()}")
        tiers = guard.repair_tiers()
        print(f"repair tiers: slot={tiers['slot']} "
              f"stripe={tiers['stripe']} graph={tiers['graph']} "
              f"restore={tiers['restore']} "
              f"persistent={tiers['persistent_escalations']} "
              f"suspect={tiers['suspect']}")
        if fusion["network_hits"] or fusion["network_fallbacks"] \
                or fusion["fused_hits"] or fusion["fused_fallbacks"]:
            print(f"fusion: network_hits={fusion['network_hits']} "
                  f"network_fallbacks={fusion['network_fallbacks']} "
                  f"fused_hits={fusion['fused_hits']} "
                  f"fused_fallbacks={fusion['fused_fallbacks']}")
    return {"graphs": n_graphs, "batches": len(batches), "seconds": dt,
            "graphs_per_sec": gps, "flags": guard.flags,
            "graph_retries": guard.graph_retries,
            "stripe_retries": guard.stripe_retries,
            "slot_retries": guard.slot_retries,
            "recomputed_rows": guard.recomputed_rows,
            "repair_tiers": guard.repair_tiers(),
            "graph_flags": graph_flags, "graph_max_rel": graph_max_rel,
            **fusion}


def _to_numpy(x) -> np.ndarray:
    """A metric (tensor, or numpy after a guard repair) as a host array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _device_label(dev: torch.device) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graphs", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--backend", default="dense",
                    choices=["dense", "block_ell"],
                    help="dense bucketed padding, or block-diagonal packed "
                         "block-ELL on the CUDA kernel path")
    ap.add_argument("--buckets", default="64,128",
                    help="comma list of node-count buckets (dense backend)")
    ap.add_argument("--block", type=int, default=32,
                    help="square block size of the packed block-ELL layout "
                         "(block_ell backend; a multiple of 4)")
    ap.add_argument("--nodes", default="24,120",
                    help="lo,hi node-count range of the synthetic stream")
    ap.add_argument("--feat", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--classes", type=int, default=7)
    ap.add_argument("--abft", default="fused",
                    choices=["none", "split", "fused"])
    ap.add_argument("--fused-layer", action="store_true",
                    help="run each packed layer through the single-pass "
                         "gcn_fused kernel (combination + aggregation + "
                         "check in one sweep; block_ell backend)")
    ap.add_argument("--fused-network", action="store_true",
                    help="whole network in one kernel sweep — not ported "
                         "yet (slice 2 of the port); refused")
    ap.add_argument("--vmem-budget", type=int, default=None,
                    help="override, in bytes, the shared memory one "
                         "gcn_fused thread block may use before a layer "
                         "falls back to the two-pass kernel (default: "
                         "analysis.vmem.FUSED_SMEM_BUDGET, the card's "
                         "per-block limit)")
    ap.add_argument("--check-granularity", default="graph",
                    choices=["graph", "stripe", "slot"],
                    help="fault attribution: per packed graph (default); "
                         "stripe/slot need the surgical retry tiers, not "
                         "ported yet (slice 2 of the port) — refused")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu' "
                         "(plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    if args.check_granularity != "graph" and args.backend != "block_ell":
        ap.error(f"--check-granularity {args.check_granularity} needs "
                 f"--backend block_ell (dense batches have no row-stripes)")
    if args.fused_network:
        ap.error("--fused-network needs the whole-network kernel, which "
                 "arrives with slice 2 of the port; use --fused-layer")
    if args.check_granularity != "graph":
        ap.error(f"--check-granularity {args.check_granularity} needs the "
                 f"surgical retry tiers (engine/localize.py), which arrive "
                 f"with slice 2 of the port; use --check-granularity graph")

    dev = resolve_device(args.device)
    # f32 end to end: TF32 would lift the clean divergence from ~1e-6 to
    # ~1e-3 and make tau = 1e-3 flag clean runs
    torch.backends.cuda.matmul.allow_tf32 = False
    buckets = [int(b) for b in args.buckets.split(",")]
    n_lo, n_hi = (int(v) for v in args.nodes.split(","))
    cfg = ABFTConfig(mode=args.abft, threshold=1e-3, relative=True)
    print(f"=== serve_gcn: {args.graphs} graphs, batch {args.batch}, "
          f"backend={args.backend}, abft={args.abft} "
          f"({_device_label(dev)}; allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}) ===")

    stream = synth_graph_stream(args.graphs, n_lo=n_lo, n_hi=n_hi,
                                feat=args.feat, seed=args.seed)
    if args.backend == "block_ell":
        batches: List[Batch] = make_packed_batches(
            stream, args.batch, block=args.block,
            stripe_multiple=4, width_multiple=4)
    else:
        batches = make_batches(stream, args.batch, buckets)
    gen = torch.Generator().manual_seed(args.seed)
    params = init_gcn(gen, (args.feat, args.hidden, args.classes),
                      device=dev)
    return serve(batches, params, cfg, fused_layer=args.fused_layer,
                 vmem_budget=args.vmem_budget,
                 granularity=args.check_granularity, device=dev)


if __name__ == "__main__":
    main()
