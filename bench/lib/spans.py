"""The program's own spans in a ``torch.profiler`` trace (its chrome-trace
export): the ``repro.*`` ranges that ``repro_torch.runtime.spans`` opens
while the profiler records, on the same clock as the card's kernels.

From the trace's events and its ``bench.window`` it gives, by span name:

* the count, the inclusive seconds and the self seconds (the duration less
  that of its direct ``repro.`` children);
* the device-idle seconds whose gap midpoint falls, on the host, inside
  the span as the innermost ``repro.`` span open there (the gaps are
  those of ``bench.lib.trace``: the window less the union of kernels,
  copies and memsets);
* the CUDA runtime calls that wait for the card (``SYNCS``) inside each
  ``repro.engine.*`` span, by the innermost span they were issued in.

A trace with no ``repro.`` span gives an empty summary, which the readers
report as nothing.  :func:`install` hangs the summary on every
``TraceSummary`` that ``bench.lib.trace.summarize`` returns, as its
``spans`` attribute; a reader calls it when it is loaded, before the run."""
from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from bench.lib import trace

PREFIX = "repro."
ENGINE = "repro.engine."
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


@dataclass
class SpanSummary:
    count: Dict[str, int] = field(default_factory=dict)
    inclusive_s: Dict[str, float] = field(default_factory=dict)
    self_s: Dict[str, float] = field(default_factory=dict)
    idle_s: Dict[str, float] = field(default_factory=dict)
    syncs: Dict[str, int] = field(default_factory=dict)

    @property
    def empty(self) -> bool:
        return not self.count

    def total(self, prefix: str, what: str = "self_s") -> float:
        """The sum of ``what`` over the spans whose names start with
        ``prefix``."""
        return sum(v for k, v in getattr(self, what).items()
                   if k.startswith(prefix))

    @property
    def steps(self) -> int:
        return sum(n for k, n in self.count.items() if k.startswith(ENGINE))


Span = Tuple[float, float, str]


def _walk(spans: List[Span], queries: List[float]):
    """Spans of one thread, properly nested: (each span's direct parent
    index or -1, each sorted query's innermost span index or -1).  Spans
    sorted by (start, -end), queries ascending."""
    parent, inner, stack = [], [], []
    qi = 0

    def settle(t):
        while stack and spans[stack[-1]][1] <= t:
            stack.pop()

    for i, (t0, _t1, _n) in enumerate(spans):
        while qi < len(queries) and queries[qi] < t0:
            settle(queries[qi])
            inner.append(stack[-1] if stack else -1)
            qi += 1
        settle(t0)
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    for q in queries[qi:]:
        settle(q)
        inner.append(stack[-1] if stack else -1)
    return parent, inner


def scan(events: List[dict]):
    """One pass over a trace's events: (the ``bench.window`` range or None,
    the device intervals, the ``repro.`` spans by thread, the
    synchronising calls' start times by thread), in microseconds."""
    window = None
    dev: List[Tuple[float, float]] = []
    by_tid: Dict[tuple, List[Span]] = defaultdict(list)
    syncs: Dict[tuple, List[float]] = defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        t0 = float(e["ts"])
        if cat in trace.DEVICE_CATS:
            dev.append((t0, t0 + float(e.get("dur", 0.0))))
        elif cat == "user_annotation":
            if name.startswith(PREFIX):
                by_tid[(e.get("pid"), e.get("tid"))].append(
                    (t0, t0 + float(e.get("dur", 0.0)), name))
            elif name == trace.WINDOW:
                window = (t0, t0 + float(e.get("dur", 0.0)))
        elif name in SYNCS:
            syncs[(e.get("pid"), e.get("tid"))].append(t0)
    return window, dev, by_tid, syncs


def device_gaps(dev: List[Tuple[float, float]],
                window: Tuple[float, float]) -> List[Tuple[float, float]]:
    """The window's stretches with none of the device intervals ``dev``,
    by ``bench.lib.trace``'s rule."""
    w0, w1 = window
    gaps, end = [], w0
    for t0, t1 in sorted(dev):
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 <= t0:
            continue
        if t0 > end:
            gaps.append((end, t0))
        end = max(end, t1)
    if w1 > end:
        gaps.append((end, w1))
    return gaps


def analyse(events: List[dict]) -> SpanSummary:
    """The summary of the ``repro.`` spans of a trace's ``events`` that
    start inside its window (empty without a window or a span)."""
    window, dev, by_tid, syncs = scan(events)
    if window is None:
        return SpanSummary()
    w0, w1 = window
    by_tid = {k: [s for s in v if w0 <= s[0] <= w1]
              for k, v in by_tid.items()}
    by_tid = {k: v for k, v in by_tid.items() if v}
    if not by_tid:
        return SpanSummary()
    count: Dict[str, int] = defaultdict(int)
    incl: Dict[str, float] = defaultdict(float)
    own: Dict[str, float] = defaultdict(float)
    idle: Dict[str, float] = defaultdict(float)
    sync_by: Dict[str, int] = defaultdict(int)
    # the serving thread: the one that opens the most spans
    host = max(by_tid, key=lambda k: len(by_tid[k]))
    mids = sorted((0.5 * (g0 + g1), g1 - g0)
                  for g0, g1 in device_gaps(dev, window))
    for tid, spans in by_tid.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        calls = sorted(t for t in syncs.get(tid, ()) if w0 <= t <= w1)
        parent, inner = _walk(spans, calls)
        kids = [0.0] * len(spans)
        for i, (t0, t1, name) in enumerate(spans):
            count[name] += 1
            incl[name] += (t1 - t0) * 1e-6
            if parent[i] >= 0:
                kids[parent[i]] += t1 - t0
        for i, (t0, t1, name) in enumerate(spans):
            own[name] += (t1 - t0 - kids[i]) * 1e-6
        # a sync counts where it lies inside an engine span
        for j in inner:
            k = j
            while k >= 0 and not spans[k][2].startswith(ENGINE):
                k = parent[k]
            if k >= 0:
                sync_by[spans[j][2]] += 1
        if tid == host:
            _, at = _walk(spans, [m for m, _ in mids])
            for j, (_, d) in zip(at, mids):
                if j >= 0:
                    idle[spans[j][2]] += d * 1e-6
    return SpanSummary(dict(count), dict(incl), dict(own), dict(idle),
                       dict(sync_by))


def from_trace(path: str) -> SpanSummary:
    """The summary of the chrome trace at ``path``."""
    with open(path) as f:
        return analyse(json.load(f)["traceEvents"])


class _KeepLast:
    """``json`` as ``bench.lib.trace`` calls it, keeping the object its
    ``load`` returns, so that one parse of a trace serves both readers."""

    def __init__(self):
        self.last = None

    def load(self, f):
        self.last = json.load(f)
        return self.last

    def __getattr__(self, name):
        return getattr(json, name)


def install() -> None:
    """Make ``bench.lib.trace.summarize`` hang each trace's
    :class:`SpanSummary` on the ``TraceSummary`` it returns, as
    ``spans``, from the events it parsed.  Idempotent."""
    inner = trace.summarize
    if getattr(inner, "with_spans", False):
        return
    keep = trace.json = _KeepLast()

    def summarize(path: str) -> trace.TraceSummary:
        out = inner(path)
        doc, keep.last = keep.last, None
        out.spans = analyse(doc["traceEvents"])
        return out

    summarize.with_spans = True
    trace.summarize = summarize


def of(ctx) -> Optional[SpanSummary]:
    """The run's span summary, or None where the run was not traced or
    its trace holds no ``repro.`` span."""
    s = getattr(ctx.trace, "spans", None)
    return None if s is None or s.empty else s
