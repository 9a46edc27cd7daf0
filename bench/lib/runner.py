"""One run of one cell: weights from the seed, the program's ``LMEngine``
built over them, one warm-up batch of the cell's longest prompts, the
measured window of whole cycles of batches, then the comparison with the
plain reference and the metrics.

The program under test is ``repro_torch`` (``LMEngine.prefill`` and
``LMEngine.decode``, each under its ``ABFTGuard``, with the ABFT setting the
cell's ``guard`` states); the harness hands it the
tokens and feeds back the argmax of its logits, and reads nothing of it
but its outputs, its guard's counters and the profiler's kernel names."""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import random
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from bench.lib import seeds, spec as bspec, trace as btrace, weights
from bench.lib.traffic import Traffic

Tensor = torch.Tensor


@dataclasses.dataclass
class Batch:
    """One batch of the window: B requests of one prompt length."""
    index: int
    prompt_len: int
    size: int
    new: int
    t_start: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    prompt: Optional[Tensor] = None
    served: Optional[Tensor] = None            # [B, new] token ids
    logits: List[Tensor] = dataclasses.field(default_factory=list)
    prefill_s: float = 0.0
    decode_s: List[float] = dataclasses.field(default_factory=list)
    rel: List[Tensor] = dataclasses.field(default_factory=list)  # guard's


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""
    cell: bspec.Cell
    metric: Optional[bspec.Metric]
    batches: List[Batch]
    t_start: float
    t_end: float
    setup_s: float
    trace: Optional[btrace.TraceSummary]

    @property
    def run(self) -> dict:
        return self.cell.config["run"]

    @property
    def layout(self):
        """The configuration's layout (``bench/layouts/``)."""
        return bspec.layout_module(self.cell.config)

    @property
    def checked(self) -> bool:
        """Whether the cell's engine runs the ABFT checks."""
        return self.cell.workload["guard"]["mode"] != "none"

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start


def set_numerics() -> None:
    """float32 products in float32: TF32 off, for the program and the
    reference alike."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def model_config(config: dict):
    """The program's ``ModelConfig`` for a configuration file's ``run``."""
    from repro_torch.configs.base import ModelConfig, MoECfg

    run = dict(config["run"])
    moe = run.pop("moe", None)
    return ModelConfig(name=config["name"], moe=MoECfg(**moe) if moe else None,
                       **run)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mark(on: bool, name: str):
    return torch.profiler.record_function(name) if on else \
        contextlib.nullcontext()


def serve_batch(eng, traffic: Traffic, i: int, device: torch.device,
                traced: bool, label: str = "tokens") -> Batch:
    """Batch i through the engine: its prefill, then new - 1 greedy decode
    steps, each closed by a synchronisation."""
    b = Batch(index=i, prompt_len=traffic.length(i), size=traffic.batch,
              new=traffic.new)
    b.t_start = time.perf_counter()
    with _mark(traced, "bench.client"):
        b.prompt = traffic.tokens(i, device, label)
    with _mark(traced, "bench.prefill"):
        t0 = time.perf_counter()
        logits, states, m = eng.prefill(b.prompt)
        _sync(device)
        b.rel.append(m["abft_max_rel"])
        b.t_first = time.perf_counter()
        b.prefill_s = b.t_first - t0
    served = []
    for step in range(traffic.new):
        with _mark(traced, "bench.client"):
            last = logits[:, -1]
            b.logits.append(last)
            tok = torch.argmax(last, dim=-1).to(torch.int32)
            served.append(tok)
        if step == traffic.new - 1:
            break
        with _mark(traced, "bench.decode"):
            t0 = time.perf_counter()
            logits, states, m = eng.decode(states, tok[:, None],
                                           b.prompt_len + step)
            _sync(device)
            b.rel.append(m["abft_max_rel"])
            b.decode_s.append(time.perf_counter() - t0)
    del states
    b.served = torch.stack(served, dim=1)
    b.t_done = time.perf_counter()
    return b


def serve_window(eng, traffic: Traffic, seconds: float, device,
                 traced: bool) -> List[Batch]:
    """Whole cycles of batches until ``seconds`` have passed at the end of
    one."""
    out: List[Batch] = []
    t0 = time.perf_counter()
    with _mark(traced, "bench.window"):
        while True:
            for _ in traffic.cycle:
                out.append(serve_batch(eng, traffic, len(out), device,
                                       traced))
            if time.perf_counter() - t0 >= seconds:
                break
    return out


def sample(batches: List[Batch], n: int, seed: int) -> Dict[int, List[int]]:
    """``n`` requests (batch index -> rows) drawn from the seed, one of the
    longest prompts among them."""
    reqs = [(b.index, r) for b in batches for r in range(b.size)]
    longest = max(b.prompt_len for b in batches)
    rng = random.Random(seeds.stream(seed, "sample"))
    first = rng.choice([q for q in reqs if batches[q[0]].prompt_len ==
                        longest])
    rest = [q for q in reqs if q != first]
    picked = [first] + rng.sample(rest, min(n, len(reqs)) - 1)
    groups: Dict[int, List[int]] = {}
    for bi, r in sorted(picked):
        groups.setdefault(bi, []).append(r)
    return groups


def _readings(c: Tensor, mine: Tensor, tok: Tensor) -> tuple:
    """(relative logit error, served token's gap below the best) of logits
    ``mine`` [V] and served token ``tok`` against the reference's
    candidates ``c`` [m, V], each taken at the nearest candidate."""
    rms = c.pow(2).mean(-1).sqrt()
    err = ((mine[None] - c).abs().amax(-1) / rms).min()
    gap = (c.amax(-1) - c[:, tok.long()]).min()
    return float(err), float(gap)


class LowerPrecision:
    """The control: the plain reference computed in bfloat16 in the
    program's place.  Each call returns its logits at the last position of
    every sequence so far (the sequence is its state); it flags nothing."""

    def __init__(self, ref, params: dict, run: dict):
        self.ref, self.params, self.run = ref, params, run

    def _logits(self, seq: Tensor) -> Tensor:
        with torch.no_grad():
            cands, _ = self.ref.logits(self.params, self.run, seq,
                                       [seq.shape[1] - 1], 0.0,
                                       dtype=torch.bfloat16)
        return torch.stack([c[0][0] for c in cands])[:, None].float()

    def prefill(self, tokens: Tensor):
        return self._logits(tokens), tokens, {"abft_max_rel": 0.0}

    def decode(self, states: Tensor, tokens: Tensor, pos):
        seq = torch.cat([states, tokens.to(states.dtype)], 1)
        return self._logits(seq), seq, {"abft_max_rel": 0.0}

    def stats(self) -> dict:
        return {"flags": 0}


def compare(cell: bspec.Cell, params: dict, batches: List[Batch],
            seed: int) -> Dict[str, float]:
    """The served logits of the sampled requests against the plain
    reference's over each prompt with its served tokens: the largest
    relative logit error and the widest gap by which a served token's
    logit lies below the reference's best, each over every compared
    position."""
    cmp = cell.workload["compare"]
    run = cell.config["run"]
    ref = bspec.reference_module(cell.config)
    vocab = run["vocab_size"]
    found: Dict[str, float] = {"logit_err": 0.0, "served_gap": 0.0,
                               "compared": 0}
    for bi, rows in sample(batches, cmp["requests"], seed).items():
        b = batches[bi]
        rows_t = torch.tensor(rows, device=b.prompt.device)
        seq = torch.cat([b.prompt[rows_t], b.served[rows_t, :b.new - 1]], 1)
        positions = list(range(b.prompt_len - 1, b.prompt_len - 1 + b.new))
        with torch.no_grad():
            cands, st = ref.logits(params, run, seq, positions,
                                   cmp.get("tie", 0.0))
        st.pop("near", None)
        for key, v in st.items():
            found[f"ref_{key}"] = found.get(f"ref_{key}", 0) + v
        for r, row in enumerate(rows):
            for j in range(b.new):
                c = cands[r][j][:, :vocab]
                err, gap = _readings(c, b.logits[j][row, :vocab].float(),
                                     b.served[row, j])
                found["logit_err"] = max(found["logit_err"], err)
                found["served_gap"] = max(found["served_gap"], gap)
                found["compared"] += 1
        del cands
    return found


def run_cell(cell: bspec.Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, t_process: float, *,
             control: bool = False,
             wrap_engine: Optional[Callable] = None) -> dict:
    """One run; returns the result object the entry point prints.
    ``control`` serves the window with the lower precision's control
    (``LowerPrecision``) in the program's place, which has to come out not
    correct (never in the benchmark's own runs); ``wrap_engine`` puts a
    fault between the harness and the engine (tests)."""
    from repro_torch.core.abft import ABFTConfig
    from repro_torch.engine.lm import LMEngine

    set_numerics()
    config, wl = cell.config, cell.workload
    run = config["run"]
    traffic = Traffic(wl["traffic"], seed, run["vocab_size"])
    params = weights.draw(run, seed, device, bspec.layout_module(config))
    # the cell's ABFT setting: {"mode": "fused", "threshold", "relative"}
    # checks every product and attention chain, {"mode": "none"} none
    abft = ABFTConfig(**wl["guard"])
    if control:
        eng = LowerPrecision(bspec.reference_module(config), params, run)
    else:
        eng = LMEngine(model_config(config), abft, params,
                       cache_len=traffic.cache_len)
    if wrap_engine is not None:
        eng = wrap_engine(eng)
    # warm-up: one batch of each prompt length (a stream of its own), the
    # longest first, each with its prefill and at most two decode steps
    warm = Traffic(dict(wl["traffic"], new_tokens=min(traffic.new, 3)),
                   seed, run["vocab_size"])
    for i in warm.warmup_indices():
        serve_batch(eng, warm, i, device, False, "warmup")
    _sync(device)
    # the set-up's objects leave the collector's generations, so that no
    # collection in the window walks them
    gc.collect()
    gc.freeze()
    guard0 = dict(eng.stats())
    setup_s = time.perf_counter() - t_process

    prof = None
    if traced:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    batches = serve_window(eng, traffic, seconds, device, traced)
    _sync(device)
    gc.unfreeze()
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        path = Path(tempfile.gettempdir()) / f"bench_trace.{os.getpid()}.json"
        prof.export_chrome_trace(str(path))
        del prof
        try:
            summary = btrace.summarize(str(path))
        finally:
            path.unlink(missing_ok=True)
    t_end = batches[-1].t_done
    stats = eng.stats()
    flagged = stats["flags"] - guard0["flags"]
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    del eng
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    found = compare(cell, params, batches, seed)
    found["ref_seconds"] = time.perf_counter() - t_ref
    found["flagged_steps"] = flagged
    found["guard_max_rel"] = max(float(r) for b in batches for r in b.rel)
    if summary is not None:
        found["trace_events"] = summary.events

    ctx = Context(cell, None, batches, batches[0].t_start, t_end, setup_s,
                  summary)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        ctx.metric = m
        value = m.read(ctx)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.entry["unit"]}
    limits = wl["compare"]["limits"]
    checks = {k: {"value": found[k], "limit": lim}
              for k, lim in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct,
           "attempted": sum(b.size for b in batches),
           "failed": 0, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in summary.top_ops()],
                            "idle_gaps": [list(x) for x in summary.top_gaps()]}
    out["found"] = {k: v for k, v in found.items() if k not in limits}
    out["checks"] = checks
    return out
