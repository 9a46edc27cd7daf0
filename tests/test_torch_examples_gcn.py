"""The port's GCN examples against the JAX package's, on the CPU.

Each of ``examples/torch_{fault_injection_demo,quickstart,train_gcn}.py``
runs as a process of its own (``python -X importtime``, ``PYTHONPATH=src``,
``--device cpu``): it must exit 0 and import no module of ``jax`` or of the
JAX package ``repro``.  Its printed numbers are then held against the
reference's functions called in this process (where ``tests/conftest.py``'s
JAX shim is active; a reference script in a fresh interpreter would lack
it), from the port's own seed-0 weights carried across with
``repro_torch.convert.params_to_numpy``:

* the fault demo equals the reference example's output line for line;
* the quickstart's Table II lines, every ``checks=`` count and every
  ``flag=`` / ``detected`` exactly; ``|predicted - actual|`` of the injected
  fault within ``rtol 1e-3`` of the reference's ``gcn_layer_fused`` on the
  same W; every printed logit difference ≤ 1e-4; the clean ``max_rel``
  ≤ 1e-4 (a tenth of tau);
* train_gcn's printed losses within ``1e-4`` plus half a unit of the last
  printed digit of the reference's ``gcn_loss`` + ``adamw_update`` loop
  (under its ``ABFTGuard``), and the same number of flagged steps.

Each output also shows what ``chip_smoke.py``'s ``examples`` phase asks
of that example on the card (``examples_run.chip_smoke_gates``).
"""
import re
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ABFTConfig as JABFTConfig
from repro.core import gcn_layer_fused as jgcn_layer_fused
from repro.core.datasets import make_reduced as jmake_reduced
from repro.core.gcn import dataset_to_dense as jdataset_to_dense
from repro.core.gcn import dataset_to_sparse as jdataset_to_sparse
from repro.core.gcn import gcn_apply as jgcn_apply
from repro.core.gcn import gcn_apply_sparse as jgcn_apply_sparse
from repro.core.gcn import gcn_loss as jgcn_loss
from repro.core.gcn import precompute_s_c as jprecompute_s_c
from repro.core.opcount import gcn_op_counts as jgcn_op_counts
from repro.engine import Graph as JGraph
from repro.engine import gcn_apply as jengine_apply
from repro.kernels.spmm_abft import dense_to_block_ell as jdense_to_block_ell
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_warmup as jcosine_warmup
from repro.runtime import ABFTGuard as JABFTGuard
from repro_torch import convert
from repro_torch.core.gcn import init_gcn
from examples_run import ROOT, chip_smoke_gates, run_example

LOGIT_ATOL = 1e-4          # the engine's logit gate (PERF.md §2)
INJECT_RTOL = 1e-3         # the injected fault's |predicted - actual|
LOSS_ATOL = 1e-4 + 0.5e-4  # 1e-4 + half a unit of the printed 4th decimal


def _port_gcn_params(dims):
    """The port's seed-0 GCN weights, as the example draws them, as a JAX
    params tree."""
    params = init_gcn(torch.Generator().manual_seed(0), dims, device="cpu")
    return jax.tree.map(jnp.asarray, convert.params_to_numpy(params))


def test_fault_demo_equals_the_reference_line_for_line(capsys):
    port = run_example("fault_injection_demo")
    runpy.run_path(str(ROOT / "examples" / "fault_injection_demo.py"),
                   run_name="__main__")
    ref = capsys.readouterr().out
    assert port.splitlines() == ref.splitlines()
    assert chip_smoke_gates("fault_injection_demo", port) == 1


def _float(pattern, text):
    return [float(x) for x in re.findall(pattern, text)]


def _bools(pattern, text):
    return [x == "True" for x in re.findall(pattern, text)]


def test_quickstart_matches_the_reference():
    out = run_example("quickstart", "--device", "cpu")

    ds = jmake_reduced("cora", scale=4, seed=0)
    s_np, h_np, _ = jdataset_to_dense(ds)
    s, h = jnp.asarray(s_np), jnp.asarray(h_np)
    params = _port_gcn_params(ds.stats.layer_dims)

    # clean forwards, both modes: flags and check counts exact
    clean = re.findall(r"^(split|fused) *: clean forward  flag=(\w+) "
                       r"max_rel=(\S+) checks=(\d+)$", out, re.M)
    assert [c[0] for c in clean] == ["split", "fused"]
    for mode, flag, max_rel, checks in clean:
        cfg = JABFTConfig(mode=mode, threshold=1e-3, relative=True)
        _, report = jgcn_apply(params, s, h, cfg)
        assert (flag == "True") == bool(report.flag), mode
        assert int(checks) == int(report.n_checks), mode
        assert float(max_rel) <= 1e-4, mode

    # the injected fault: the reference's gcn_layer_fused on the same W
    cfg = JABFTConfig(mode="fused", threshold=1e-3, relative=True)
    h_out, chk = jgcn_layer_fused(s, h, params["layers"][0]["w"], cfg)
    bad = h_out.at[5, 3].add(h_out.std() * 1e3)
    want = abs(float(chk.predicted) - float(bad.sum()))
    (diff,) = _float(r"\|predicted - actual\| = (\S+) ->", out)
    np.testing.assert_allclose(diff, want, rtol=INJECT_RTOL)
    assert _bools(r"-> detected: (\w+)", out) == [
        want > 1e-3 * abs(float(bad.sum()))]

    # the sparse path
    s_sp, h_sp, _ = jdataset_to_sparse(ds)
    s_c = jprecompute_s_c(s_sp, cfg)
    _, rep_sp = jgcn_apply_sparse(params, s_sp, h_sp, cfg, s_c)
    (err,) = _float(r"vs dense = (\S+) flag=", out)
    assert err <= LOGIT_ATOL
    assert _bools(r"vs dense = \S+ flag=(\w+)", out) == [bool(rep_sp.flag)]

    # the engine, one line a backend
    bell = jdense_to_block_ell(s_np, block_m=32, block_k=32)
    lines = re.findall(r"^  (\w+) +\|logit diff\|=(\S+) flag=(\w+) "
                       r"checks=(\d+)$", out, re.M)
    assert [x[0] for x in lines] == ["dense", "bcoo", "block_ell"]
    for (backend, err, flag, checks), graph in zip(lines, (
            JGraph(s, h), JGraph(s_sp, h_sp, s_c=s_c), JGraph(bell, h))):
        _, rep = jengine_apply(params, graph, cfg, backend=backend,
                               **({"block_g": 32}
                                  if backend == "block_ell" else {}))
        assert float(err) <= LOGIT_ATOL, backend
        assert (flag == "True") == bool(rep.flag), backend
        assert int(checks) == int(rep.n_checks), backend
    assert "python -m repro_torch.launch.serve_gcn" in out

    # Table II: numpy counts, the reference's lines exactly
    want = []
    for name in ("cora", "citeseer", "pubmed", "nell"):
        oc = jgcn_op_counts(name)
        want.append(f"  {name:9s} check ops: split "
                    f"{oc.split_check/1e6:7.3f}M fused "
                    f"{oc.fused_check/1e6:7.3f}M  "
                    f"(saves {oc.check_savings*100:.1f}%)")
    assert out.splitlines()[-4:] == want
    assert chip_smoke_gates("quickstart", out) == 1


@pytest.mark.parametrize("mode", ["fused", "split"])
def test_train_gcn_matches_the_reference(mode):
    steps, scale = 3, 8
    out = run_example("train_gcn", "--scale", str(scale), "--steps",
                      str(steps), "--mode", mode, "--device", "cpu")

    ds = jmake_reduced("cora", scale=scale, seed=0)
    s_np, h_np, y_np = jdataset_to_dense(ds)
    s, h, y = jnp.asarray(s_np), jnp.asarray(h_np), jnp.asarray(y_np)
    abft = JABFTConfig(mode=mode, threshold=1e-2, relative=True)
    opt_cfg = JAdamWConfig(lr=1e-2, weight_decay=1e-4)
    params = _port_gcn_params(ds.stats.layer_dims)
    state = {"params": params, "opt": jadamw_init(params)}

    @jax.jit
    def step(state):
        (loss, report), grads = jax.value_and_grad(
            lambda p: jgcn_loss(p, s, h, y, None, abft), has_aux=True
        )(state["params"])
        lr = jcosine_warmup(state["opt"]["step"], 20, steps)
        p2, o2 = jadamw_update(state["params"], grads, state["opt"],
                               opt_cfg, lr)
        return {"params": p2, "opt": o2}, {
            "loss": loss, "abft_flag": report.flag,
            "abft_max_rel": report.max_rel}

    guard, losses = JABFTGuard(), {}
    for i in range(steps):
        state, m = guard.run_step(step, state)
        losses[i] = float(m["loss"])

    printed = {int(i): float(v) for i, v in re.findall(
        r"^step +(\d+) loss=(\S+) ", out, re.M)}
    assert sorted(printed) == [0, steps - 1]
    for i, v in printed.items():
        np.testing.assert_allclose(v, losses[i], rtol=0, atol=LOSS_ATOL)
    (flagged,) = re.findall(r"flagged steps: (\d+)$", out, re.M)
    assert int(flagged) == guard.flags
    assert chip_smoke_gates("train_gcn", out) == 1
