"""The benchmark's reading of the program's spans and counters
(``bench/lib/spans.py`` and the six readers that use it), on the CPU:

  (d) on a hand-built chrome trace: self times, the innermost span of a
      device-idle gap, the synchronising calls inside an engine step, and
      nothing where the trace holds no ``repro.`` span;
  (e) ``bench.lib.trace.summarize`` gives the same fields with and without
      the program's spans (and their ``gpu_user_annotation`` twins);
  (f) a traced smoke run of each cell reports the new metrics, the MoE
      cell no dropped assignment and its live rows over its capacity rows
      as the traffic's shapes give them.
"""
import dataclasses
import json
from types import SimpleNamespace

import pytest

from bench.lib import spans, spec, trace
from bench.lib.traffic import Traffic
from bench.tests.smoke import BENCH, ROOT, run_cpu, smoke_cell
from repro_torch.runtime import spans as program_spans

NEW = ("host_syncs_per_step", "verdict_wait_pct", "op_host_us",
       "moe_idle_pct", "moe_live_row_pct", "moe_dropped_pct")
READERS = {m["name"]: spec.metric(m) for m in BENCH["per_layer"]
           if m["name"] in NEW}


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid,
            "ts": ts, "dur": dur}


# the program's spans of one prefill step (microseconds)
PROGRAM = [("repro.engine.prefill", 100, 600),
           ("repro.model.layer", 110, 400),
           ("repro.moe.route", 120, 100),
           ("repro.op.matmul_abft", 130, 20),
           ("repro.moe.experts", 250, 200),
           ("repro.guard.verdict", 550, 140)]
# device activity: gaps [0, 50), [140, 160), [240, 300), [690, 1000)
DEVICE = [("wide_kernel", "kernel", 50, 90), ("cumsum", "kernel", 160, 80),
          ("Memcpy DtoD", "gpu_memcpy", 300, 390)]


def _events(program: bool):
    ev = [_x("bench.window", "user_annotation", 0, 1000),
          _x("bench.prefill", "user_annotation", 90, 620),
          _x("aten::mm", "cpu_op", 130, 20),
          _x("aten::cumsum", "cpu_op", 230, 40),
          _x("cudaLaunchKernel", "cuda_runtime", 135, 5),
          _x("cudaMemcpy", "cuda_runtime", 200, 10),
          _x("cudaMemcpyAsync", "cuda_runtime", 560, 5),
          _x("cudaStreamSynchronize", "cuda_runtime", 566, 100),
          _x("cudaStreamSynchronize", "cuda_runtime", 800, 10)]
    ev += [_x(n, c, t, d, tid=20) for n, c, t, d in DEVICE]
    if program:
        ev += [_x(n, "user_annotation", t, d) for n, t, d in PROGRAM]
        # the device-side twins the profiler adds under each range
        ev += [_x(n, "gpu_user_annotation", t + 5, d, tid=20)
               for n, t, d in PROGRAM]
    return ev


def _write(tmp_path, program: bool):
    path = tmp_path / f"trace_{int(program)}.json"
    path.write_text(json.dumps({"traceEvents": _events(program)}))
    return str(path)


def _ctx(path):
    spans.install()
    return SimpleNamespace(trace=trace.summarize(path), metric=None)


def test_span_summary_of_a_hand_built_trace(tmp_path):
    s = spans.from_trace(_write(tmp_path, True))
    assert s.count == {n: 1 for n, _, _ in PROGRAM}
    own = {k: round(v * 1e6, 6) for k, v in s.self_s.items()}
    assert own == {"repro.engine.prefill": 60, "repro.model.layer": 100,
                   "repro.moe.route": 80, "repro.op.matmul_abft": 20,
                   "repro.moe.experts": 200, "repro.guard.verdict": 140}
    assert {k: round(v * 1e6, 6) for k, v in s.idle_s.items()} == \
        {"repro.moe.route": 20, "repro.moe.experts": 60}
    assert s.syncs == {"repro.moe.route": 1, "repro.guard.verdict": 1}
    assert s.steps == 1
    got = {n: r.read(_ctx(_write(tmp_path, True)))
           for n, r in READERS.items() if not n.startswith("moe_live")
           and not n.startswith("moe_dropped")}
    assert got == pytest.approx({"host_syncs_per_step": 2.0,
                                 "verdict_wait_pct": 100 * 140 / 600,
                                 "op_host_us": 20.0, "moe_idle_pct": 8.0})


def test_no_program_span_reads_nothing(tmp_path):
    assert spans.from_trace(_write(tmp_path, False)).empty
    program_spans.reset()
    for ctx in (_ctx(_write(tmp_path, False)),
                SimpleNamespace(trace=None, metric=None)):
        assert {n: r.read(ctx) for n, r in READERS.items()} == \
            {n: None for n in NEW}


def test_summarize_is_the_same_with_and_without_program_spans(tmp_path):
    plain = trace.summarize(_write(tmp_path, False))
    spans.install()
    with_spans = trace.summarize(_write(tmp_path, True))
    fields = [f.name for f in dataclasses.fields(trace.TraceSummary)
              if f.name != "events"]
    assert fields
    for f in fields:
        assert getattr(plain, f) == getattr(with_spans, f), f
    assert plain.top_ops() == with_spans.top_ops()
    assert plain.top_gaps() == with_spans.top_gaps()
    assert with_spans.events == plain.events + 2 * len(PROGRAM)
    assert not with_spans.spans.empty
    # one parse served both; the parsed trace is not kept after it
    assert trace.json.last is None


def _live_row_pct(cell, seed):
    """Kept over capacity rows of one cycle of the cell's traffic, from its
    shapes alone: no assignment drops at its capacity factor."""
    run = cell.config["run"]
    mc = run["moe"]
    t = Traffic(cell.workload["traffic"], seed, run["vocab_size"])
    kept = rows = 0
    for length in t.cycle:
        n = t.batch * length
        cap = max(int(n * mc["top_k"] * mc["capacity_factor"] /
                      mc["n_experts"]), mc["top_k"])
        kept += n * mc["top_k"]
        rows += mc["n_experts"] * cap
    return 100.0 * kept / rows


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_traced_smoke_run_reports_the_new_metrics(name):
    cell = smoke_cell(name)
    program_spans.reset()
    out = run_cpu(cell, seed=2 ** 31 + 11, traced=True)
    want = {m["name"] for m in BENCH["per_layer"]
            if m["name"] in NEW and name in m["workloads"]}
    assert want and want <= set(out["metrics"])
    got = {k: out["metrics"][k]["value"] for k in want}
    assert got["host_syncs_per_step"] == 0.0       # no card: no CUDA call
    assert 0 < got["verdict_wait_pct"] < 100 and got["op_host_us"] > 0
    if "moe_live_row_pct" in want:
        assert got["moe_dropped_pct"] == 0.0
        assert got["moe_live_row_pct"] == pytest.approx(
            _live_row_pct(cell, 2 ** 31 + 11), rel=1e-12)
        assert 0 <= got["moe_idle_pct"] <= 100


def test_new_metric_entries_name_their_source_and_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert {"engine", "checked-op wrappers, guard", "model step"} <= layers
    assert {p.stem for p in (ROOT / "bench" / "metrics").glob("*.py")} >= \
        set(NEW)
