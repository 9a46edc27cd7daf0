"""Streaming GCN server: continuous traffic through the
``engine.streaming.StreamingEngine``.

Requests arrive one at a time (optionally rate-limited to simulate a live
client), are packed online into the canonical rung shapes planned from a
leading profile of the stream, and dispatch double-buffered under the ABFT
guard.  Reports the latency view a serving deployment watches — per-request
enqueue->verdict p50/p99 — alongside throughput, backpressure rejections,
and the bounded-shapes accounting (distinct packed step shapes vs rung-table
size).  Counterpart of the JAX package's ``repro/launch/serve_stream.py``;
it runs on the GPU unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve_stream --graphs 200 \
        --slots 8 --block 16 --deadline-ms 50 --assert-bounded-compiles

``--assert-bounded-compiles`` exits non-zero when the engine built steps
for more distinct packed shapes than the rung table holds (no oversize or
retry traffic in the synthetic stream, so rung shapes are the whole
budget) — the gate for the streaming engine's central contract.  The flag
keeps the JAX package's name, where each shape cost one compile.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

import torch

from repro_torch.core.abft import ABFTConfig
from repro_torch.core.gcn import init_gcn
from repro_torch.device import resolve_device
from repro_torch.engine import StreamingEngine, plan_rungs, \
    synth_graph_stream
from repro_torch.launch.serve_gcn import _device_label


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graphs", type=int, default=200,
                    help="synthetic stream length (requests)")
    ap.add_argument("--slots", type=int, default=8,
                    help="graph slots per canonical packed shape")
    ap.add_argument("--block", type=int, default=16,
                    help="square block size of the packed block-ELL layout "
                         "(a multiple of 4)")
    ap.add_argument("--nodes", default="8,48",
                    help="lo,hi node-count range of the synthetic stream")
    ap.add_argument("--feat", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=8)
    ap.add_argument("--classes", type=int, default=3)
    ap.add_argument("--abft", default="fused",
                    choices=["none", "split", "fused"])
    ap.add_argument("--fused-layer", action="store_true")
    ap.add_argument("--fused-network", action="store_true",
                    help="whole-network kernel: every layer in one launch "
                         "(falls back per batch to the per-layer ladder "
                         "when analysis.vmem.fused_network_fits declines)")
    ap.add_argument("--vmem-budget", type=int, default=None,
                    help="override, in bytes, the shared memory one fused "
                         "thread block may use")
    ap.add_argument("--check-granularity", default="graph",
                    choices=["graph", "stripe", "slot"])
    ap.add_argument("--profile", type=int, default=32,
                    help="leading requests used as the rung-planning "
                         "traffic profile")
    ap.add_argument("--queue-capacity", type=int, default=64)
    ap.add_argument("--deadline-ms", type=float, default=50.0,
                    help="flush-on-deadline for partial bins (<=0 disables)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="simulated request arrival rate in req/s "
                         "(0 = as fast as possible)")
    ap.add_argument("--oversize", default="singleton",
                    choices=["singleton", "reject"],
                    help="oversized-request policy: dedicated singleton "
                         "shape, or explicit rejection verdict")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default="",
                    help="write machine-readable stats to this file "
                         "(default: none)")
    ap.add_argument("--assert-bounded-compiles", action="store_true",
                    help="exit non-zero if the distinct packed step shapes "
                         "exceed the rung table size")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu' "
                         "(plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    # f32 end to end: TF32 would lift the clean divergence from ~1e-6 to
    # ~1e-3 and make tau = 1e-3 flag clean runs
    torch.backends.cuda.matmul.allow_tf32 = False
    n_lo, n_hi = (int(v) for v in args.nodes.split(","))
    cfg = ABFTConfig(mode=args.abft, threshold=1e-3, relative=True)
    label = _device_label(dev)
    print(f"=== serve_stream: {args.graphs} requests, slots {args.slots}, "
          f"block {args.block}, abft={args.abft} ({label}) ===")

    stream = synth_graph_stream(args.graphs, n_lo=n_lo, n_hi=n_hi,
                                feat=args.feat, seed=args.seed)
    rungs = plan_rungs(stream[:max(args.profile, 1)], n_slots=args.slots,
                       block=args.block, stripe_multiple=4,
                       width_multiple=4)
    print(f"rung table ({len(rungs)} canonical shapes): "
          + ", ".join(f"[{r.stripe_cap} stripes x {r.width_cap} wide "
                      f"x {r.n_slots} graphs]" for r in rungs.rungs))
    gen = torch.Generator().manual_seed(args.seed)
    params = init_gcn(gen, (args.feat, args.hidden, args.classes),
                      device=dev)
    engine = StreamingEngine(
        params, cfg, rungs,
        queue_capacity=args.queue_capacity,
        flush_deadline=(args.deadline_ms / 1e3
                        if args.deadline_ms > 0 else None),
        oversize_policy=args.oversize,
        fused_layer=args.fused_layer,
        fused_network=args.fused_network,
        vmem_budget=args.vmem_budget,
        granularity=args.check_granularity,
        keep_logits=False, device=dev)
    engine.warmup()

    results = []
    gap = 1.0 / args.rate if args.rate > 0 else 0.0
    for s, h0 in stream:
        engine.submit(s, h0)
        results.extend(engine.take_results())
        if gap:
            time.sleep(gap)
            engine.pump()
    results.extend(engine.drain())
    stats = engine.stats(results)

    p50 = stats["latency_p50_ms"]
    p99 = stats["latency_p99_ms"]
    print(f"served {stats['served']}/{stats['submitted']} requests in "
          f"{stats['batches']} batches "
          f"(rejected {stats['rejected']}, "
          f"oversize {stats['rejected_oversize']} "
          f"[{args.oversize}], singletons "
          f"{stats['singleton_dispatches']})")
    print(f"latency enqueue->verdict: p50 "
          + (f"{p50:.1f} ms" if p50 is not None else "n/a")
          + ", p99 "
          + (f"{p99:.1f} ms" if p99 is not None else "n/a")
          + (f"; {stats['graphs_per_sec']:.1f} graphs/sec"
             if stats["graphs_per_sec"] else "")
          + f" ({label})")
    print(f"compiles: {stats['compiles']} distinct step shapes vs rung "
          f"table {stats['rung_table_size']} "
          f"(+{stats['singleton_dispatches']} singleton dispatches); "
          f"guard flags={stats['guard_flags']} "
          f"retries={stats['guard_retries']}")
    tiers = stats["repair_tiers"]
    print(f"repair tiers: slot={tiers['slot']} "
          f"stripe={tiers['stripe']} graph={tiers['graph']} "
          f"restore={tiers['restore']} "
          f"persistent={tiers['persistent_escalations']}; "
          f"backend={stats['active_backend']} "
          f"(degrades={stats['degrades']} "
          f"failovers={stats['failovers']} "
          f"hang_flushes={stats['hang_flushes']})")
    if args.fused_layer or args.fused_network:
        print(f"fusion: network_hits={stats['network_hits']} "
              f"network_fallbacks={stats['network_fallbacks']} "
              f"fused_hits={stats['fused_hits']} "
              f"fused_fallbacks={stats['fused_fallbacks']}")

    if args.json:
        rec = {"bench": "serve_stream", "device": label,
               "config": {"graphs": args.graphs, "slots": args.slots,
                          "block": args.block, "nodes": [n_lo, n_hi],
                          "feat": args.feat, "hidden": args.hidden,
                          "classes": args.classes, "abft": args.abft,
                          "fused_layer": args.fused_layer,
                          "fused_network": args.fused_network,
                          "vmem_budget": args.vmem_budget,
                          "granularity": args.check_granularity,
                          "queue_capacity": args.queue_capacity,
                          "deadline_ms": args.deadline_ms,
                          "rate": args.rate, "seed": args.seed},
               "rungs": [vars(r) for r in rungs.rungs],
               "stats": stats}
        with open(args.json, "w") as fh:
            json.dump(rec, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"wrote {args.json}")

    if args.assert_bounded_compiles and \
            stats["compiles"] > stats["rung_table_size"]:
        print(f"FAIL: {stats['compiles']} distinct step shapes > rung table "
              f"size {stats['rung_table_size']} — step shapes are not "
              f"bounded", file=sys.stderr)
        sys.exit(1)
    return stats


if __name__ == "__main__":
    main()
