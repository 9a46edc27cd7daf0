"""Smoke twins of the benchmark's cells for the CPU tests: the same
families, files and code paths at widths a test run can hold."""
from __future__ import annotations

import copy
import time
from pathlib import Path

import torch

from bench.lib import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.load_json(ROOT / "BENCHMARK.json")
CELLS = tuple(w["name"] for w in BENCH["workloads"])


def smoke_run(run: dict) -> dict:
    out = dict(run, n_layers=2, d_model=64, n_heads=4,
               n_kv_heads=min(run["n_kv_heads"], 2), head_dim=16, d_ff=96,
               vocab_size=256)
    if "moe" in run:        # the published routing: 64 experts, top 6
        out["moe"] = dict(run["moe"], d_ff_expert=32, d_ff_shared=32)
    return out


def smoke_cell(name: str, *, batch=2, lengths=(8, 12, 16), new=None,
               requests=3) -> spec.Cell:
    """The cell ``name`` as BENCHMARK.json defines it, at smoke widths and
    a small traffic."""
    cell = copy.deepcopy(spec.load(ROOT, name))
    cell.config["run"] = smoke_run(cell.config["run"])
    t = cell.workload["traffic"]
    new = t["new_tokens"] if new is None else new
    cell.workload["traffic"] = dict(t, batch=batch if t["batch"] > 1 else 1,
                                    prompt_lengths=list(lengths),
                                    new_tokens=new,
                                    cache_len=max(lengths) + new)
    cell.workload["compare"] = dict(cell.workload["compare"],
                                    requests=requests)
    return cell


def run_cpu(cell: spec.Cell, seed: int = 7, traced: bool = False, **kw):
    from bench.lib import runner
    return runner.run_cell(cell, seed, 0.0, traced, torch.device("cpu"),
                           time.perf_counter(), **kw)
