"""Readings that set a cell's limits, in one process: the program's
comparison numbers on each of ``--seeds``, then, on each of
``--control-seeds``, a run with the plain reference computed in bfloat16
in the program's place (the lower precision's control, which has to come
out not correct).  Each seed is a whole run of the cell at its own sizes
(weights, warm-up, a window of ``--seconds``, the comparison); one JSON
line a run goes to standard output and ``--out``.

    python3 bench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        --control-seeds 11,12,13 --seconds 12 --out readings.jsonl

The benchmark's own runs never run the control."""
import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" /
                                              "repro_torch_kernels")
    import torch

    from bench.lib import runner, spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load(ROOT, args.workload)
    runs = [(int(s), False) for s in args.seeds.split(",") if s] + \
        [(int(s), True) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    for seed, control in runs:
        t0 = time.perf_counter()
        res = runner.run_cell(cell, seed, args.seconds, False,
                              torch.device("cuda", 0), t0, control=control)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "control": control,
                           "seconds": time.perf_counter() - t0,
                           "correct": res["correct"],
                           "metrics": {k: v["value"] for k, v in
                                       res["metrics"].items()},
                           "peak": res["device"]["memory_peak_bytes"],
                           **res["found"],
                           **{k: v["value"] for k, v in
                              res["checks"].items()}})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del res
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
