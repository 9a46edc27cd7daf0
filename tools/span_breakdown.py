"""Where a benchmark cell's step time goes, by the program's own spans.

    python3 tools/span_breakdown.py --workload <cell> --seed <n> \
        --seconds <s> [--json <path>]

from the root of a checkout, on a machine with the cell's card.  Runs the
cell once as ``bench/run.py --trace 1`` runs it, and prints, beside the
result line's per-layer metrics, what ``bench/lib/spans.py`` reads from
the trace: each ``repro.`` span's count, inclusive and self seconds and
the device-idle seconds whose innermost host span it is; the synchronising
CUDA runtime calls inside the engine's steps, by (innermost span,
outermost ATen operator); the idle seconds by the same pair; and the
program's counters.  ``--json`` writes the whole of it to a file."""
import argparse
import json
import os
import sys
import time
from collections import defaultdict
from pathlib import Path

T_PROCESS = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]


def by_span_and_op(path: str) -> dict:
    """Sync calls inside engine spans and idle gaps, each keyed by
    ``"<innermost repro span> | <outermost ATen op>"`` on the serving
    thread (``-`` where none is open)."""
    from bench.lib import spans, trace

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window, dev, by_tid, syncs = spans.scan(events)
    if window is None or not by_tid:
        return {}
    w0, w1 = window
    host = max(by_tid, key=lambda k: len(by_tid[k]))
    sp = sorted((s for s in by_tid[host] if w0 <= s[0] <= w1),
                key=lambda s: (s[0], -s[1]))
    ops = trace._outermost([(float(e["ts"]), float(e["ts"]) +
                             float(e.get("dur", 0)), e["name"])
                            for e in events if e.get("ph") == "X"
                            and e.get("cat") == "cpu_op"
                            and (e.get("pid"), e.get("tid")) == host])
    op_starts = [o[0] for o in ops]
    calls = sorted(t for t in syncs.get(host, ()) if w0 <= t <= w1)
    mids = sorted((0.5 * (a + b), b - a)
                  for a, b in spans.device_gaps(dev, window))
    out = {"syncs": defaultdict(int), "idle_s": defaultdict(float)}
    parent, inner = spans._walk(sp, calls)
    for t, j in zip(calls, inner):
        k = j
        while k >= 0 and not sp[k][2].startswith(spans.ENGINE):
            k = parent[k]
        if k >= 0:
            op = trace._at(ops, op_starts, t) or "-"
            out["syncs"][f"{sp[j][2]} | {op}"] += 1
    _, at = spans._walk(sp, [m for m, _ in mids])
    for (m, d), j in zip(mids, at):
        name = sp[j][2] if j >= 0 else "-"
        op = trace._at(ops, op_starts, m) or "-"
        out["idle_s"][f"{name} | {op}"] += d * 1e-6
    return {k: dict(sorted(v.items(), key=lambda kv: -kv[1]))
            for k, v in out.items()}


def breakdown(cell, seed: int, seconds: float, device) -> dict:
    """One traced run of ``cell`` (a ``bench.lib.spec.Cell``) on
    ``device``, and what its spans say."""
    from bench.lib import runner, spans, trace
    from repro_torch.runtime import spans as program_spans

    spans.install()
    found = {}
    inner = trace.summarize

    def summarize(path):
        out = inner(path)
        found["summary"] = out
        found["by_op"] = by_span_and_op(path)
        return out

    trace.summarize = summarize
    program_spans.reset()
    try:
        out = runner.run_cell(cell, seed, seconds, True, device, T_PROCESS)
    finally:
        trace.summarize = inner
    s = found["summary"]
    return {
        "workload": cell.name, "seed": seed,
        "device": out["device"], "metrics": out["metrics"],
        "correct": out["correct"], "trace_events": s.events,
        "window_s": s.window_s, "busy_s": s.busy_s,
        "spans": {n: {"count": s.spans.count[n],
                      "inclusive_s": s.spans.inclusive_s[n],
                      "self_s": s.spans.self_s[n],
                      "idle_s": s.spans.idle_s.get(n, 0.0),
                      "syncs": s.spans.syncs.get(n, 0)}
                  for n in sorted(s.spans.count,
                                  key=lambda n: -s.spans.self_s[n])},
        "idle_outside_spans_s": s.window_s - s.busy_s
        - sum(s.spans.idle_s.values()),
        "counters": program_spans.read(),
        **found["by_op"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" /
                                              "repro_torch_kernels")
    import torch

    from bench.lib import spec

    report = breakdown(spec.load(ROOT, args.workload), args.seed,
                       args.seconds, torch.device("cuda", 0))
    text = json.dumps(report, indent=1)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
