"""The harness on the CPU: files found by name, the traffic a seed gives,
names and units of well-formed characters, the result line's shape,
and no run without a card."""
import json
import re
import subprocess
import sys

import pytest
import torch

from bench.lib import runner, spec
from bench.lib.traffic import Traffic
from bench.tests.smoke import CELLS, ROOT, run_cpu, smoke_cell

BENCH = json.load(open(ROOT / "BENCHMARK.json"))


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = spec.load(ROOT, name)
    assert cell.workload["name"] == name
    assert cell.config["name"] == cell.workload["config"]
    names = {m.name for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    moved = {m.entry["moves"] for m in cell.per_layer}
    assert moved <= names
    for m in cell.end_to_end + cell.per_layer:
        assert callable(m.read)
        # a metric's entry is BENCHMARK.json's alone
        assert m.entry in BENCH["end_to_end"] + BENCH["per_layer"]
    for m in cell.per_layer:
        if "roofline" in m.name:
            assert m.extra["kernels"]
    assert hasattr(spec.reference_module(cell.config), "logits")


def test_every_file_is_named_in_benchmark_json():
    metrics = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    readers = {p.stem for p in (ROOT / "bench" / "metrics").glob("*.py")}
    assert readers == metrics
    extras = {p.stem for p in (ROOT / "bench" / "metrics").glob("*.json")}
    assert extras <= metrics
    cells = {w["name"] for w in BENCH["workloads"]}
    assert {p.stem for p in (ROOT / "bench" / "workloads").glob("*.json")} \
        == cells


def test_traffic_repeats_for_a_seed_and_differs_across_seeds():
    spec_ = json.load(open(ROOT / "bench" / "workloads" /
                           "deepseek-moe-16b.score_unguarded.json"))["traffic"]
    a, b = Traffic(spec_, 2 ** 31 + 5, 1000), Traffic(spec_, 2 ** 31 + 5, 1000)
    assert a.cycle == b.cycle
    assert torch.equal(a.tokens(3, "cpu"), b.tokens(3, "cpu"))
    others = [Traffic(spec_, s, 1000) for s in range(1, 9)]
    assert all(sorted(t.cycle) == sorted(a.cycle) for t in others)
    assert len({tuple(t.cycle) for t in others}) > 1
    assert not torch.equal(a.tokens(3, "cpu"), others[0].tokens(3, "cpu"))
    assert int(a.tokens(0, "cpu").max()) < 1000


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_units_and_keys_are_well_formed():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    r = BENCH["run_seconds"]
    assert 1 <= r <= 51 and (2 + 14 * 24) * (r + 60) + 24 * 180 + 1200 \
        <= 43200


def test_result_line_shape_and_checks_last():
    out = run_cpu(smoke_cell("deepseek-moe-16b.score_unguarded"))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks" and out["correct"] is True
    assert set(out["metrics"]) == {"tokens_per_s", "ttft_p90_ms", "setup_s"}
    assert set(out["checks"]) == {"logit_err", "served_gap"}
    traced = run_cpu(smoke_cell("chatglm3-6b.long_doc_unguarded"),
                     traced=True)
    # no kernel ran on a card: the rooflines find nothing and are left out
    assert "matmul_abft_roofline" not in traced["metrics"]
    assert set(traced["metrics"]) >= {"prefill_ms_per_ktok", "mfu"}
    assert traced["device"]["window_s"] > 0


def test_sample_holds_the_longest_prompt():
    batches = [runner.Batch(index=i, prompt_len=t, size=4, new=1)
               for i, t in enumerate([8, 16, 12, 8, 16, 12])]
    for seed in range(20):
        groups = runner.sample(batches, 3, seed)
        assert sum(len(v) for v in groups.values()) == 3
        assert any(batches[i].prompt_len == 16 for i in groups)


def test_no_run_without_a_card():
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    done = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         CELLS[0], "--seed", "3", "--seconds", "1",
         "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    assert not done.stdout.strip()
    assert "CUDA" in done.stderr
