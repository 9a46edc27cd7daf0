"""Reduction of a ``torch.profiler`` trace (its chrome-trace export) to the
numbers the per-layer readers take: device time by kernel name, the union
of device activity inside the traced window, and the idle gaps between it,
each named by what the host was doing.

The window is the ``bench.window`` annotation the serving loop opens; the
host's phases are its ``bench.prefill``, ``bench.decode`` and
``bench.client`` annotations; inside one, the outermost operator running
names the gap (``python`` where none runs)."""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
PHASES = ("bench.prefill", "bench.decode", "bench.client")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    by_name: Dict[str, float] = field(default_factory=dict)
    idle_by_host: Dict[str, float] = field(default_factory=dict)
    events: int = 0

    def device_seconds(self, patterns) -> float:
        """Device seconds of the kernels whose names hold any pattern."""
        return sum(s for name, s in self.by_name.items()
                   if any(p in name for p in patterns))

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.by_name.items(), key=lambda kv: -kv[1])[:n]

    def top_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:n]


def _outermost(spans: List[Tuple[float, float, str]]):
    """The spans not inside an earlier one, sorted by start."""
    out, end = [], float("-inf")
    for s in sorted(spans):
        if s[0] >= end:
            out.append(s)
            end = s[1]
    return out


def _at(spans, starts, t: float) -> str:
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][0] <= t < spans[i][1]:
        return spans[i][2]
    return ""


def summarize(path: str) -> TraceSummary:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = None
    dev, phases, ops = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0.0))
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in DEVICE_CATS:
            dev.append((t0, t1, name))
        elif cat == "user_annotation" and name == WINDOW:
            window = (t0, t1)
        elif cat == "user_annotation" and name in PHASES:
            phases.append((t0, t1, name.split(".", 1)[1]))
        elif cat == "cpu_op":
            ops.append((t0, t1, name))
    if window is None:
        raise RuntimeError(f"{path}: no {WINDOW} annotation in the trace")
    w0, w1 = window
    by_name: Dict[str, float] = defaultdict(float)
    busy, merged_end = 0.0, w0
    gaps = []
    for t0, t1, name in sorted(dev):
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 <= t0:
            continue
        by_name[name] += (t1 - t0) * 1e-6
        if t0 > merged_end:
            gaps.append((merged_end, t0))
        if t1 > merged_end:
            busy += t1 - max(t0, merged_end)
            merged_end = t1
    if w1 > merged_end:
        gaps.append((merged_end, w1))
    phases, ops = _outermost(phases), _outermost(ops)
    ph_starts, op_starts = [p[0] for p in phases], [o[0] for o in ops]
    idle: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        phase = _at(phases, ph_starts, mid) or "between"
        op = _at(ops, op_starts, mid) or "python"
        idle[f"{phase}: {op}"] += (g1 - g0) * 1e-6
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                        by_name=dict(by_name), idle_by_host=dict(idle),
                        events=len(events))
