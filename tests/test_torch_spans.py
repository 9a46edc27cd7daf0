"""The port's program spans and counters (``repro_torch.runtime.spans``),
on the CPU:

  (a) with the profiler off, a smoke MoE ``LMEngine`` prefill and decode
      enter no ``record_function`` and leave the counter registry empty;
      the off path is the profiler's module flag;
  (b) under ``torch.profiler.profile``, every span of the serving path
      appears, nested as documented, and each ``repro.op.*`` span count
      equals its wrapper's calls;
  (c) the MoE counters equal a recomputation from ``route`` and
      ``assign``, at a capacity that drops and at one that does not.
"""
import dataclasses
import json
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.abft import ABFTConfig
from repro_torch.engine.lm import LMEngine
from repro_torch.kernels import runtime
from repro_torch.models.moe import assign, init_moe, moe_block, route
from repro_torch.runtime import spans

NONE = ABFTConfig(mode="none")
FUSED = ABFTConfig(mode="fused", threshold=1e-3, relative=True)
STEP = {"engine.prefill", "engine.decode", "guard.repair"}
PARENTS = {
    "engine.prefill": {None}, "engine.decode": {None},
    "guard.verdict": STEP, "guard.repair": STEP - {"guard.repair"},
    "model.embed": STEP, "model.params": STEP, "model.layer": STEP,
    "model.cache": STEP, "model.head": STEP, "model.report": STEP,
    "attn": {"model.layer"}, "mlp": {"model.layer"},
    **{f"moe.{s}": {"model.layer"} for s in
       ("route", "assign", "dispatch", "br", "experts", "combine",
        "shared")},
    "op.matmul_abft": {"attn", "mlp", "moe.route", "moe.shared",
                       "model.head"},
    "op.matmul_abft_grouped": {"moe.experts"},
    "op.flash_checksum": {"attn"},
}
MODEL = {"engine.prefill", "engine.decode", "guard.verdict", "model.embed",
         "model.params", "model.layer", "model.cache", "model.head",
         "model.report", "attn", "op.matmul_abft", "op.flash_checksum"}
MOE = {"moe.route", "moe.assign", "moe.dispatch", "moe.experts",
       "moe.combine", "moe.shared", "op.matmul_abft_grouped"}


def _engine(arch, abft):
    cfg = smoke_config(get_config(arch))
    return LMEngine.init(cfg, abft, 0, device="cpu", cache_len=24)


def _serve(eng, inject=0.0):
    tokens = torch.randint(1, 200, (2, 16), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(3))
    _, states, _ = eng.prefill(tokens, inject=inject)
    eng.decode(states, tokens[:, :1], 16)


def _traced_spans(tmp_path, fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"][len(spans.PREFIX):]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith(spans.PREFIX))


def _parent(found, i):
    """The tightest span around span i (None at the top)."""
    t0, t1, _ = found[i]
    around = [s for j, s in enumerate(found)
              if j != i and s[0] <= t0 and t1 <= s[1]
              and (s[0], -s[1]) < (t0, -t1)]
    return min(around, key=lambda s: s[1] - s[0])[2] if around else None


def test_off_enters_no_record_function_and_counts_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with the profiler off")

    eng = _engine("deepseek-moe-16b", NONE)
    spans.reset()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not spans.recording()
    assert spans.span("attn") is spans.span("moe.route")
    _serve(eng)
    assert spans.read() == {}


def test_the_switch_is_the_profiler_module_flag(monkeypatch):
    from torch.autograd import profiler

    assert not profiler._is_profiler_enabled
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiler._is_profiler_enabled and spans.recording()
        assert spans.span("attn") is not spans.span("attn")
    monkeypatch.setattr(profiler, "_is_profiler_enabled", True)
    assert isinstance(spans.span("attn"), torch.profiler.record_function)


@pytest.mark.parametrize("arch, abft, inject, want", [
    ("deepseek-moe-16b", NONE, 0.0, MODEL | MOE),
    ("deepseek-moe-16b", FUSED, 1e3, MODEL | MOE | {"moe.br",
                                                     "guard.repair"}),
    ("chatglm3-6b", NONE, 0.0, MODEL | {"mlp"}),
])
def test_spans_nest_and_op_spans_count_the_wrapper_calls(
        tmp_path, arch, abft, inject, want):
    eng = _engine(arch, abft)
    runtime.reset_counts()
    found = _traced_spans(tmp_path, lambda: _serve(eng, inject))
    names = Counter(n for _, _, n in found)
    assert set(names) == want
    for i, (_, _, name) in enumerate(found):
        assert _parent(found, i) in PARENTS[name], (name, _parent(found, i))
    calls = runtime.plain_counts()
    for op in ("matmul_abft", "matmul_abft_grouped", "flash_checksum"):
        assert names[f"op.{op}"] == calls[op]
    assert not any(runtime.launch_counts().values())
    if inject:
        assert eng.stats()["retries"] == 1


def _moe_cfg(capacity_factor):
    cfg = smoke_config(get_config("deepseek-moe-16b"))
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))


@pytest.mark.parametrize("capacity_factor, drops", [(0.5, True),
                                                    (4.0, False)])
def test_moe_counters_equal_the_assignment(capacity_factor, drops):
    cfg = _moe_cfg(capacity_factor)
    gen = torch.Generator().manual_seed(5)
    p = init_moe(gen, cfg)
    x = torch.randn((2, 24, cfg.d_model), generator=gen)
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        moe_block(p, x, cfg, NONE)
    got = spans.read()
    _, _, experts, _ = route(p, x.reshape(-1, cfg.d_model), cfg, NONE)
    _, _, keep, cap = assign(experts, cfg.moe)
    n_tok, k, e = 48, cfg.moe.top_k, cfg.moe.n_experts
    assert got == {"moe.assignments": n_tok * k,
                   "moe.kept": int(keep.sum()),
                   "moe.capacity_rows": e * cap}
    dropped = int((~keep).sum())
    assert got["moe.assignments"] - got["moe.kept"] == dropped
    assert (dropped > 0) == drops
    spans.reset()
    assert spans.read() == {}
