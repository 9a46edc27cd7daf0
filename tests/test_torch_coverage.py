"""The port's ABFT coverage proof (``repro_torch.core.marker``,
``repro_torch.kernels.sites``, ``repro_torch.analysis.coverage``) on the
CPU, at smoke size:

  (a) the marker is inert: tagging is off by default and thread-local,
      tagged outputs and gradients equal the untagged ones bit for bit, and
      with tagging off no ``repro_torch::`` op is called;
  (b) falsifiability: an unchecked ``torch.matmul`` is flagged with this
      file's line, a fully checked fixture is clean, an unchecked matmul
      added to the GCN forward turns its manifest to one unchecked site,
      and products inside an ``nn.Module`` or an autograd Function are
      found;
  (c) kernel site nodes equal the plain versions' calls, kernel by kernel;
  (d) the port's manifests against the JAX package's own CLI, read live:
      the same unchecked counts (per layer where the reference walks a
      scan body once), sink granularities and sinks, the reference's
      ``pallas_call`` sites one for one onto kernel sites, and the GCN
      train step's unchecked backward products by shape.
"""
import collections
import dataclasses
import inspect
import json
import threading

import numpy as np
import pytest
import torch

import repro.analysis.coverage as j_coverage
from repro.analysis.lint import main as j_lint
from repro_torch.analysis.coverage import (analyze_step, format_report,
                                           kernel_site_counts, trace)
from repro_torch.analysis.lint import lm_step
from repro_torch.analysis.lint import main as lint
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.abft import ABFTConfig, check_matmul, summarize
from repro_torch.core.gcn import init_gcn
from repro_torch.core.marker import check_tagging, tagging_enabled
from repro_torch.engine import Graph, gcn_forward
from repro_torch.engine.api import fold_w_r
from repro_torch.engine.batching import pack_graphs
from repro_torch.engine.streaming import (make_packed_serve_step,
                                          packed_step_args)
from repro_torch.kernels import runtime

CFG = ABFTConfig(mode="fused")
CPU = torch.device("cpu")
ARCHS = ("gemma-2b", "qwen1.5-4b", "chatglm3-6b", "h2o-danube-3-4b",
         "deepseek-moe-16b", "qwen3-moe-30b-a3b", "rwkv6-7b",
         "recurrentgemma-9b", "whisper-medium", "internvl2-26b")
# the reference's pallas_call sites carry no kernel name; the step says
# which kernel each is
PALLAS_KERNEL = {"gcn-serve-graph": "spmm_abft",
                 "gcn-serve-stripe": "spmm_abft",
                 "gcn-serve-layer": "gcn_fused"}
# Each LM op's checks are stacked over the layers before any report reduces
# them — the reference's scan stacks them, the port's layer loop does — so
# one sink stands for one op of every layer: a sink count does not scale
# with the depth the reference's scan body covers.  The scan factor of the
# sinks is 1 (``test_lm_sinks_do_not_scale_with_depth`` holds it).
SINK_SCAN_FACTOR = 1


def _graph(nodes=12, feat=6, seed=0):
    rng = np.random.default_rng(seed)
    s = (rng.random((nodes, nodes)) < 0.4).astype(np.float32)
    s += np.eye(nodes, dtype=np.float32)
    h0 = rng.random((nodes, feat)).astype(np.float32)
    return s, h0


def _params(dims, seed=0):
    return init_gcn(torch.Generator().manual_seed(seed), dims, device="cpu")


def _packed(granularity="graph", fused_layer=False, fused_network=False,
            mode="fused"):
    cfg = ABFTConfig(mode=mode)
    params = fold_w_r(_params([8, 8, 3]), cfg)
    rng = np.random.default_rng(0)
    graphs = []
    for _ in range(3):
        s = (rng.random((24, 24)) < 0.3).astype(np.float32) + \
            np.eye(24, dtype=np.float32)
        graphs.append((s, rng.random((24, 8)).astype(np.float32)))
    pb = pack_graphs(graphs, block=8, n_slots=3)
    step = make_packed_serve_step(params, cfg, pb.n_slots,
                                  granularity=granularity,
                                  fused_layer=fused_layer,
                                  fused_network=fused_network)
    return step, packed_step_args(pb, "cpu")


def _leaves(tree):
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _assert_bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


class _OpLog(torch.utils._python_dispatch.TorchDispatchMode):
    """Names of the ``repro_torch::`` ops dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "repro_torch":
            self.names.append(func._overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# (a) marker inertness
# ---------------------------------------------------------------------------

def test_tagging_off_by_default_and_thread_local():
    assert not tagging_enabled()
    seen = {}
    with check_tagging():
        assert tagging_enabled()
        with check_tagging():              # nestable
            assert tagging_enabled()
        assert tagging_enabled()
        t = threading.Thread(target=lambda: seen.update(
            other=tagging_enabled()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert seen == {"other": False}
    assert not tagging_enabled()


def test_untagged_trace_has_no_sinks():
    w = torch.ones(6, 5)

    def fixture(x):
        y = x @ w
        return y, summarize([check_matmul(x, w, y, CFG)], CFG,
                            device="cpu").flag

    from torch.fx.experimental.proxy_tensor import make_fx
    gm = make_fx(fixture)(torch.ones(3, 6))
    assert not any("repro_torch" in str(n.target) for n in gm.graph.nodes)


@pytest.mark.parametrize("path", ["two-pass", "fused-layer",
                                  "fused-network"])
def test_tagging_changes_no_numerics_and_untagged_calls_no_op(path):
    step, ops = _packed("slot", fused_layer=path == "fused-layer",
                        fused_network=path == "fused-network")
    with _OpLog() as log:
        clean = step(*ops)
    assert log.names == []               # tagging off: no repro_torch:: op
    with check_tagging(), _OpLog() as log:
        tagged = step(*ops)
    assert log.names                     # the positive control
    assert "abft_check_sink" in log.names
    _assert_bitwise(clean, tagged)


def test_lm_step_tagged_equals_untagged_and_calls_no_op_untagged():
    cfg = smoke_config(get_config("deepseek-moe-16b"))
    fn, ops, _carry = lm_step(cfg, CFG, "lm-prefill", CPU)
    with _OpLog() as log:
        clean = fn(*ops)
    assert log.names == []
    with check_tagging(), _OpLog() as log:
        tagged = fn(*ops)
    assert {"matmul_abft", "matmul_abft_grouped", "flash_checksum",
            "abft_check_sink"} <= set(log.names)
    _assert_bitwise(clean[0], tagged[0])
    _assert_bitwise([v for v in clean[1].values()
                     if isinstance(v, torch.Tensor)],
                    [v for v in tagged[1].values()
                     if isinstance(v, torch.Tensor)])


def test_tagging_transparent_to_grad():
    from repro_torch.core.gcn import gcn_loss
    s, h0 = (torch.from_numpy(a) for a in _graph())
    labels = torch.arange(12) % 3
    params = _params([6, 8, 3])

    def grads():
        ws = [lay["w"].clone().requires_grad_() for lay in params["layers"]]
        loss, _rep = gcn_loss({"layers": [{"w": w} for w in ws]}, s, h0,
                              labels, None, CFG, device="cpu")
        return torch.autograd.grad(loss, ws)

    g0 = grads()
    with check_tagging(), _OpLog() as log:
        g1 = grads()
    assert "abft_check_sink" in log.names
    _assert_bitwise(g0, g1)

    # the sink's own formula: identity on both sides
    x = torch.randn(4, requires_grad=True)
    y = torch.randn(4, requires_grad=True)
    with check_tagging():
        p, a = torch.ops.repro_torch.abft_check_sink(x * 2, y * 3, "layer")
    gx, gy = torch.autograd.grad((p * 5 + a * 7).sum(), (x, y))
    assert torch.equal(gx, torch.full((4,), 10.0))
    assert torch.equal(gy, torch.full((4,), 21.0))


# ---------------------------------------------------------------------------
# (b) falsifiability
# ---------------------------------------------------------------------------

def test_unchecked_matmul_is_flagged_with_provenance():
    w = torch.ones(6, 5)

    def fixture(x):
        return torch.matmul(x, w)

    line = inspect.getsourcelines(fixture)[1] + 1
    m = analyze_step(fixture, torch.ones(3, 6), step="fixture")
    assert m.n_unchecked == 1 and m.n_checked == 0 and m.n_sinks == 0
    site = m.unchecked_ops[0]
    assert site.kind == "aten" and site.out_shape == (3, 5)
    assert site.provenance == \
        f"tests/test_torch_coverage.py:{line} (fixture)"
    assert f"UNCHECKED aten mm out=[3, 5] at {site.provenance}" in \
        format_report(m)


def test_fully_checked_fixture_is_clean():
    w = torch.ones(6, 5)

    def fixture(x):
        y = x @ w
        rep = summarize([check_matmul(x, w, y, CFG)], CFG, device="cpu")
        return y, rep.flag

    m = analyze_step(fixture, torch.ones(3, 6))
    assert m.n_unchecked == 0 and m.n_checked >= 1
    assert m.sink_granularities == ("layer",)


def test_injected_unchecked_matmul_flips_gcn_manifest():
    params = _params([6, 8, 3])
    s, h0 = (torch.from_numpy(a) for a in _graph())
    w_extra = torch.ones(3, 2)

    def fwd(h0, inject):
        logits, checks = gcn_forward(params, Graph(s=s, h0=h0), CFG,
                                     backend="dense", device="cpu")
        rep = summarize(checks, CFG, device="cpu")
        out = logits @ w_extra if inject else logits
        return out, rep.flag

    clean = analyze_step(lambda h: fwd(h, False), h0)
    dirty = analyze_step(lambda h: fwd(h, True), h0)
    assert clean.n_unchecked == 0
    assert dirty.n_unchecked == 1
    assert dirty.unchecked_ops[0].out_shape == (12, 2)


class _Head(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(6, 4, bias=True)

    def forward(self, x):
        return self.lin(x)


class _Square(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        return x @ w

    @staticmethod
    def backward(ctx, g):
        return g, g


def test_matmul_in_module_and_autograd_function_is_found():
    head = _Head()
    w = torch.ones(6, 3)
    m = analyze_step(lambda x: (head(x), _Square.apply(x, w)),
                     torch.ones(5, 6))
    assert m.n_unchecked == 2
    assert {s.out_shape for s in m.unchecked_ops} == {(5, 4), (5, 3)}
    assert all(s.provenance.startswith("tests/test_torch_coverage.py:")
               for s in m.unchecked_ops)


# ---------------------------------------------------------------------------
# (c) kernel sites equal the plain versions' calls
# ---------------------------------------------------------------------------

def _site_and_call_counts(fn, ops):
    runtime.reset_counts()
    m = analyze_step(fn, *ops)
    calls = {k: v for k, v in runtime.plain_counts().items() if v}
    assert not any(runtime.launch_counts().values())
    return kernel_site_counts(m), calls


@pytest.mark.parametrize("path", ["two-pass", "fused-layer",
                                  "fused-network"])
def test_gcn_kernel_sites_equal_plain_calls(path):
    step, ops = _packed("graph", fused_layer=path == "fused-layer",
                        fused_network=path == "fused-network")
    sites, calls = _site_and_call_counts(step, ops)
    assert sites == calls and sum(sites.values()) >= 1


@pytest.mark.parametrize("arch, step", [
    ("deepseek-moe-16b", "lm-prefill"),      # B4, grouped B4, B5
    ("recurrentgemma-9b", "lm-decode"),      # the RG-LRU's grouped gates
    ("whisper-medium", "lm-prefill"),        # B5 causal and not
])
def test_lm_kernel_sites_equal_plain_calls(arch, step):
    cfg = smoke_config(get_config(arch))
    fn, ops, _carry = lm_step(cfg, CFG, step, CPU)
    sites, calls = _site_and_call_counts(fn, ops)
    assert sites == calls and sites.get("matmul_abft", 0) >= 1


# ---------------------------------------------------------------------------
# (d) the manifests against the reference's, read through its own CLI
# ---------------------------------------------------------------------------

STEPS = {
    "gcn-serve-graph": ["--step", "gcn-serve", "--granularity", "graph"],
    "gcn-serve-stripe": ["--step", "gcn-serve", "--granularity", "stripe"],
    "gcn-serve-layer": ["--step", "gcn-serve", "--granularity", "graph",
                        "--fused-layer"],
    "gcn-forward-dense": ["--step", "gcn-forward", "--backend", "dense"],
    "gcn-forward-bcoo": ["--step", "gcn-forward", "--backend", "bcoo"],
    "gcn-train": ["--step", "gcn-train", "--expect-unchecked"],
    "gat-serve": ["--step", "gat-serve"],
    "lm-none": ["--step", "lm-prefill", "--mode", "none",
                "--expect-unchecked"],
}
for _arch in ARCHS:
    for _st in ("lm-prefill", "lm-decode"):
        STEPS[f"{_st}-{_arch}"] = ["--step", _st, "--arch", _arch]


def _manifests(name, tmp_path, monkeypatch):
    """(reference, port) manifests of one step, each by its own CLI.  This
    JAX names the pjit primitive ``"jit"``, which the reference's walker
    does not enter (ROADMAP C1); it is added for this test alone."""
    monkeypatch.setattr(j_coverage, "_CALL_PRIMS",
                        j_coverage._CALL_PRIMS + ("jit",))
    argv = STEPS[name] + ["--passes", "coverage", "--manifest"]
    assert j_lint(argv + [str(tmp_path / "ref.json")]) == 0
    assert lint(argv + [str(tmp_path / "port.json"), "--device", "cpu"]) == 0
    return (json.loads((tmp_path / "ref.json").read_text()),
            json.loads((tmp_path / "port.json").read_text()))


def _sites(m):
    return m["checked_ops"] + m["unchecked_ops"]


def _per_layer_unchecked(ref, n_layers):
    """The reference's unchecked count at the port's unrolled depth: its
    scan body's sites, walked once, times the layers, each attention's two
    products (scores, P·V) as the port's one B5 site; plus the sites
    outside the scan."""
    body = [s for s in ref["unchecked_ops"] if "/scan" in s["path"]]
    attn = [s for s in body if "(streaming_attention)" in s["provenance"]]
    assert len(attn) % 2 == 0
    return n_layers * (len(body) - len(attn) // 2) + \
        len(ref["unchecked_ops"]) - len(body)


@pytest.mark.parametrize("name", sorted(STEPS))
def test_manifest_parity_with_reference(name, tmp_path, monkeypatch):
    ref, port = _manifests(name, tmp_path, monkeypatch)
    assert set(port) == set(ref)
    assert port["sink_granularities"] == ref["sink_granularities"]
    assert port["n_sinks"] == ref["n_sinks"] * SINK_SCAN_FACTOR
    if name == "lm-none":
        cfg = smoke_config(get_config("gemma-2b"))
        assert port["n_unchecked"] == \
            _per_layer_unchecked(ref, cfg.n_layers) > 0
        assert port["n_checked"] == 0 == ref["n_checked"]
    else:
        assert port["n_unchecked"] == ref["n_unchecked"]
    pallas = [s for s in _sites(ref) if s["kind"] == "pallas_call"]
    kernels = [s for s in _sites(port) if s["kind"] == "kernel"]
    if pallas:
        assert [s["name"] for s in kernels] == [PALLAS_KERNEL[name]] * \
            len(pallas)
        assert [s["checked"] for s in kernels] == \
            [s["checked"] for s in pallas]
    if name == "gcn-train":
        shapes = collections.Counter
        assert shapes(tuple(sorted(s["out_shape"]))
                      for s in port["unchecked_ops"]) == \
            shapes(tuple(sorted(s["out_shape"]))
                   for s in ref["unchecked_ops"])
    for s in _sites(port):
        assert s["provenance"].startswith(("src/repro_torch/",
                                           "tests/")), s


@pytest.mark.parametrize("fused_network", [False, True])
def test_slot_steps_meet_the_reference_expectations(fused_network):
    """The reference's own expectations for ``--granularity slot``
    (``tests/test_abftlint.py``): zero unchecked; the two-pass path
    degrades to stripe sinks; the whole-network path has slot sinks and
    one ``gcn_network`` site."""
    step, ops = _packed("slot", fused_network=fused_network)
    m = analyze_step(step, *ops)
    assert m.n_unchecked == 0 and m.n_checked >= 1
    if fused_network:
        assert m.sink_granularities == ("slot",)
        assert kernel_site_counts(m) == {"gcn_network": 1}
    else:
        assert m.sink_granularities == ("stripe",)
        assert kernel_site_counts(m) == {"spmm_abft": 2}


def test_lm_sinks_do_not_scale_with_depth():
    base = smoke_config(get_config("gemma-2b"))
    counts = []
    for n_layers in (base.n_layers, 2 * base.n_layers):
        cfg = dataclasses.replace(base, n_layers=n_layers)
        fn, ops, _carry = lm_step(cfg, CFG, "lm-prefill", CPU)
        m = analyze_step(fn, *ops)
        assert m.n_unchecked == 0
        counts.append((m.n_sinks, kernel_site_counts(m)["matmul_abft"]))
    assert counts[0][0] == counts[1][0]          # sinks: factor 1
    assert counts[1][1] == 2 * counts[0][1] - 1  # B4: 7 a layer + the head


def test_decode_state_carry_is_what_checks_rwkv_decay():
    """rwkv6's decay LoRA products reach a decode step's checks only
    through the state the serving loop carries (the reference's scan
    carry): without the carry they are unchecked, with it clean."""
    cfg = smoke_config(get_config("rwkv6-7b"))
    fn, ops, carry = lm_step(cfg, CFG, "lm-decode", CPU)
    gm = trace(fn, *ops)
    from repro_torch.analysis.coverage import analyze_graph
    bare = analyze_graph(gm, step="no-carry")
    carried = analyze_graph(gm, step="carry", carry=carry)
    assert bare.n_unchecked == 2 * cfg.n_layers
    assert all("rwkv6.py" in s.provenance for s in bare.unchecked_ops)
    assert carried.n_unchecked == 0


def test_provenance_on_another_thread_is_the_tracing_threads():
    """A CUDA backward runs on the autograd engine's device thread, whose
    stack holds no user frame: a site stamped there takes the provenance of
    the tracing thread, waiting in the call that started the work."""
    import concurrent.futures

    from repro_torch.analysis.coverage import _Recorder
    rec = _Recorder()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        line = inspect.currentframe().f_lineno + 1
        prov = pool.submit(rec._provenance).result(timeout=30)
    assert prov == (f"tests/test_torch_coverage.py:{line} "
                    f"(test_provenance_on_another_thread_is_the_tracing_"
                    f"threads)")
