"""Digests of a benchmark cell's clean prefill logits, to hold two checkouts
to the same bits on one card.

    python3 tools/logits_digest.py --workload <cell> --seed <n> [ROOT ...]

from the root of a checkout, on a machine with the cell's card.  For each
ROOT (default ``.``), in a process of its own with that root's ``src/``
and ``bench/`` first on the path (its kernels built into its own
``build/``), draws the cell's weights and traffic from the seed as
``bench/run.py`` does, builds the program's ``LMEngine`` with the cell's
ABFT setting, runs one prefill of each prompt length of the cycle and
prints one JSON object: the sha256 of each prefill's float32 logits, by
prompt length.  Equal digests across roots mean bit-identical logits.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path


def digest(root: Path, workload: str, seed: int) -> dict:
    sys.path[:0] = [str(root), str(root / "src")]
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(root / "build" /
                                              "repro_torch_kernels")
    import torch
    from bench.lib import runner, spec, weights
    from bench.lib.traffic import Traffic
    from repro_torch.core.abft import ABFTConfig
    from repro_torch.engine.lm import LMEngine

    if not torch.cuda.is_available():
        raise SystemExit("logits_digest: no CUDA card")
    runner.set_numerics()
    cell = spec.load(root, workload)
    run, wl = cell.config["run"], cell.workload
    device = torch.device("cuda", 0)
    traffic = Traffic(wl["traffic"], seed, run["vocab_size"])
    eng = LMEngine(runner.model_config(cell.config),
                   ABFTConfig(**wl["guard"]),
                   weights.draw(run, seed, device),
                   cache_len=traffic.cache_len)
    out = {}
    for i in traffic.warmup_indices():
        logits, _, _ = eng.prefill(traffic.tokens(i, device))
        raw = logits.detach().to(torch.float32).contiguous().cpu().numpy()
        out[str(traffic.length(i))] = hashlib.sha256(raw.tobytes()).hexdigest()
    return {"root": str(root), "workload": workload, "seed": seed,
            "device": torch.cuda.get_device_name(device), "sha256": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("roots", nargs="*", default=["."])
    args = ap.parse_args()
    if args.one:
        print(json.dumps(digest(Path(args.roots[0]).resolve(), args.workload,
                                args.seed)), flush=True)
        return 0
    for root in args.roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        "--workload", args.workload, "--seed",
                        str(args.seed), root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
