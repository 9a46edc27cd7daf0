"""Fault-injection campaign driver: sweep fault models x sites and
report what the online ABFT checks catch, miss, and falsely flag.

The port's counterpart of the JAX package's ``repro/launch/campaign.py``:
the same lanes, grids and gates, on the port's kernels.

    PYTHONPATH=src python -m repro_torch.launch.campaign --steps 4
    PYTHONPATH=src python -m repro_torch.launch.campaign --device cpu \\
        --smoke --assert-gates          # plain versions, on the CPU

``--smoke`` shrinks the sweep to one representative model per
(site, kind) cell for CI; ``--assert-gates`` exits non-zero unless
(a) every above-threshold accumulator upset was detected (the paper's
headline single-upset coverage claim) and (b) the clean control run
produced zero false positives.  Detection of data-path faults, measured
SDC rates for the architecturally-silent consistent-corruption sites
(features / cols_table), false-positive storms from finite check-path
corruption, and the would-be NaN false negatives closed by the NaN-safe
comparison + periodic self-check all land in the JSON payload, stamped
with the device (``authoritative`` only on the card).

``--lane lm`` runs the guarded-transformer grid instead (qkv_w / mlp_w
weight corruption + the attn_accumulator transient, on smoke-sized
gemma-2b); its gate is the LM mirror of the accumulator gate —
attn_accumulator AND weight detection 100%, clean control clean:

    PYTHONPATH=src python -m repro_torch.launch.campaign --lane lm \\
        --assert-gates

The payload goes to ``BENCH_torch_fault_campaign.json`` /
``BENCH_torch_lm_fault_campaign.json`` by default (``--json ''``
disables).  ``--device`` defaults to ``cuda``, which raises without a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from repro_torch.faults.campaign import (run_fault_campaign,
                                         run_lm_fault_campaign)
from repro_torch.faults.model import lm_sweep_models, sweep_models

# the per-lane gate prefixes asserted at 100% detection by --assert-gates
_GATED_SITES = {"gcn": ("accumulator/",),
                "lm": ("attn_accumulator/", "qkv_w/", "mlp_w/")}


def gate_failures(payload: dict, lane: str) -> list:
    """The ``--assert-gates`` verdict: one message per failed gate (empty
    when every gated site was detected at 100% and the clean control
    stayed clean)."""
    gated = _GATED_SITES[lane]
    failures = []
    for key, agg in payload["by_site_kind"].items():
        if key.startswith(gated) and agg["detection_rate"] < 1.0:
            failures.append(
                f"{key}: detection {agg['detection_rate']:.2f} < 1.0 "
                "for above-threshold gated-site upsets")
    if payload["clean_control"]["flagged"]:
        failures.append(
            f"clean control flagged {payload['clean_control']['flagged']} "
            "steps (expected zero false positives)")
    return failures


def print_table(payload: dict) -> None:
    """The per-(site, kind) table, the repair tiers and the clean control,
    one line each."""
    for key, agg in payload["by_site_kind"].items():
        lat = agg["mean_detection_latency"]
        print(f"  {key:24s} det={agg['detection_rate']:.2f} "
              f"sdc={agg['sdc_rate']:.2f} "
              f"fp/step={agg['false_positive_step_rate']:.2f} "
              f"selfcheck={agg['selfcheck_detection_rate']:.2f} "
              + (f"latency={lat:.1f} " if lat is not None else "")
              + (f"would-be-FN={agg['would_be_false_negatives']} "
                 if agg["would_be_false_negatives"] else "")
              + (f"escalations={agg['escalations']}"
                 if agg["escalations"] else ""))
    tiers = payload["repair_tiers_total"]
    print(f"repair tiers: slot={tiers['slot']} stripe={tiers['stripe']} "
          f"graph={tiers['graph']} restore={tiers['restore']} "
          f"persistent_escalations={tiers['persistent_escalations']} "
          f"persistent_sites={len(tiers['persistent_sites'])}")
    print(f"clean control: {payload['clean_control']['flagged']} flags "
          f"(false-positive rate "
          f"{payload['clean_control']['false_positive_rate']:.3f})")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lane", choices=("gcn", "lm"), default="gcn",
                    help="gcn: packed GCN serving grid (default); "
                         "lm: guarded transformer prefill/decode grid")
    ap.add_argument("--graphs", type=int, default=4,
                    help="graphs per packed serving batch")
    ap.add_argument("--steps", type=int, default=4,
                    help="serving steps per experiment")
    ap.add_argument("--reps", type=int, default=2,
                    help="seeded repetitions per (site, kind) cell")
    ap.add_argument("--nodes", default="12,32",
                    help="lo,hi node-count range of the synthetic graphs")
    ap.add_argument("--feat", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--block", type=int, default=8,
                    help="square block size of the packed block-ELL layout")
    ap.add_argument("--threshold", type=float, default=1e-3)
    ap.add_argument("--bit", type=int, default=30,
                    help="flipped bit position for bitflip kinds")
    ap.add_argument("--fault-step", type=int, default=1,
                    help="targeted-timing injection step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="one model per (site, kind) cell — the CI lane")
    ap.add_argument("--decode-steps", type=int, default=3,
                    help="[lm] decode steps after the prefill")
    ap.add_argument("--prompt-len", type=int, default=8,
                    help="[lm] prompt length of the prefill")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu "
                         "(the kernels' plain versions)")
    ap.add_argument("--json", default=None,
                    help="write the machine-readable payload here "
                         "(default BENCH_torch_<lane>_fault_campaign.json; "
                         "'' disables)")
    ap.add_argument("--assert-gates", action="store_true",
                    help="exit non-zero unless accumulator detection is "
                         "100%% and the clean control has zero flags")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.json is None:
        args.json = ("BENCH_torch_fault_campaign.json" if args.lane == "gcn"
                     else "BENCH_torch_lm_fault_campaign.json")

    if args.lane == "lm":
        models = lm_sweep_models(reps=1 if args.smoke else args.reps,
                                 step=args.fault_step, bit=args.bit,
                                 seed=args.seed)
        print(f"=== lm_fault_campaign: {len(models)} fault models x "
              f"prefill+{args.decode_steps} decode steps ===")
        payload = run_lm_fault_campaign(
            models, n_decode=args.decode_steps, prompt_len=args.prompt_len,
            threshold=args.threshold, seed=args.seed, verbose=args.verbose,
            device=args.device)
    else:
        n_lo, n_hi = (int(v) for v in args.nodes.split(","))
        models = sweep_models(reps=1 if args.smoke else args.reps,
                              step=args.fault_step, bit=args.bit,
                              seed=args.seed)
        print(f"=== fault_campaign: {len(models)} fault models x "
              f"{args.steps} steps ({args.graphs} graphs/batch) ===")
        payload = run_fault_campaign(
            models, n_graphs=args.graphs, n_steps=args.steps,
            n_lo=n_lo, n_hi=n_hi, feat=args.feat, hidden=args.hidden,
            n_out=args.classes, block=args.block, threshold=args.threshold,
            seed=args.seed, verbose=args.verbose, device=args.device)

    print_table(payload)
    if payload["interpret"]:
        print("NOTE: the kernels' plain versions on the CPU — detection "
              "results are functional, timings would NOT be authoritative")

    if args.json:
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"wrote {args.json}")

    if args.assert_gates:
        failures = gate_failures(payload, args.lane)
        if failures:
            for f in failures:
                print(f"FAIL: {f}", file=sys.stderr)
            sys.exit(1)
        gated = _GATED_SITES[args.lane]
        print(f"gates: {'/'.join(g.rstrip('/') for g in gated)} "
              "detection 100%, clean control clean")
    return payload


if __name__ == "__main__":
    main()
