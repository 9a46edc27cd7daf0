"""The port's ``abftlint`` CLI (``python -m repro_torch.analysis.lint``)
and its shared-memory passes (``repro_torch.analysis.vmem``), on the CPU:

  (e) exit codes 0 (clean), 1 (findings), 2 (usage); ``--expect-unchecked``
      inverts the coverage gate; ``--manifest`` writes the reference's
      keys; ``gcn-stream`` prints its rung verdicts before any trace and
      refuses an over-budget rung table before tracing; the rung lint's
      verdicts follow the engine's predicates; ``graph_smem_report`` prices
      every kernel site by the same function objects the wrappers assert
      against; the CLI runs as a process.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.analysis.coverage as j_coverage
from repro_torch.analysis import coverage, lint as lint_mod, vmem
from repro_torch.analysis.lint import main
from repro_torch.analysis.vmem import (FUSED_SMEM_BUDGET,
                                       assert_rung_table_fits,
                                       graph_smem_report, lint_rung_table)
from repro_torch.engine.streaming import Rung, RungTable

REPO = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
SMALL = ["--graphs", "2", "--nodes", "12"]


@pytest.mark.parametrize("argv", [
    ["--step", "gcn-serve", "--granularity", "slot", "--fused-network"],
    ["--step", "gcn-serve", "--granularity", "stripe"],
    ["--step", "gcn-serve", "--fused-layer"],
    ["--step", "gcn-forward", "--backend", "bcoo"],
    ["--step", "gat-serve"],
    ["--step", "lm-decode", "--arch", "qwen3-moe-30b-a3b"],
])
def test_guarded_steps_exit_zero_with_every_pass(argv, capsys):
    rc = main(argv + CPU + SMALL)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert " 0 unchecked" in out and "abftlint: clean" in out
    assert "[syncs] 0 finding(s)" in out


def test_manifest_has_the_reference_keys(tmp_path):
    path = tmp_path / "m.json"
    assert main(["--step", "gcn-serve", "--granularity", "slot",
                 "--passes", "coverage", "--manifest", str(path)]
                + CPU + SMALL) == 0
    payload = json.loads(path.read_text())
    ref = j_coverage.CoverageManifest("s", 0, (), [], []).to_dict()
    assert list(payload) == list(ref)
    site = payload["checked_ops"][0]
    ref_site = j_coverage.OpSite("k", "n", (1,), "p", "/").to_dict()
    assert list(site) == list(ref_site)
    assert payload["n_unchecked"] == 0 and payload["n_checked"] >= 1


def test_unguarded_step_exits_one_with_provenance(capsys):
    rc = main(["--step", "lm-prefill", "--mode", "none",
               "--passes", "coverage"] + CPU)
    out = capsys.readouterr().out
    assert rc == 1
    assert "UNCHECKED kernel matmul_abft" in out
    assert "UNCHECKED kernel flash_checksum" in out
    assert "src/repro_torch/models/" in out


def test_expect_unchecked_inverts_the_gate():
    none = ["--step", "gcn-serve", "--mode", "none", "--passes", "coverage"]
    assert main(none + CPU + SMALL) == 1
    assert main(none + ["--expect-unchecked"] + CPU + SMALL) == 0
    guarded = ["--step", "gcn-serve", "--granularity", "slot",
               "--passes", "coverage", "--expect-unchecked"]
    assert main(guarded + CPU + SMALL) == 1   # fully covered: inverted fails


def test_gcn_train_reports_the_backward_unchecked(capsys):
    train = ["--step", "gcn-train", "--passes", "coverage"] + CPU
    assert main(train) == 1
    out = capsys.readouterr().out
    assert "8 checked, 5 unchecked" in out
    assert main(train + ["--expect-unchecked"]) == 0


@pytest.mark.parametrize("argv", [["--passes", "nope"],
                                  ["--step", "gcn-forward", "--backend",
                                   "block_ell"]])
def test_usage_errors_exit_two(argv):
    assert main(argv + CPU) == 2


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--step", "gcn-serve", "--passes", "coverage"])


def test_gcn_stream_rung_lint_runs_before_traces(capsys, monkeypatch):
    traced = []
    real_trace = coverage.trace
    monkeypatch.setattr(coverage, "trace", lambda *a: traced.append(
        capsys.readouterr().out) or real_trace(*a))
    rc = main(["--step", "gcn-stream", "--granularity", "stripe",
               "--passes", "coverage,vmem"] + CPU)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert traced and "[vmem] rung" in traced[0]      # verdicts came first
    assert "[coverage] step=gcn-stream/rung" in out


def test_over_budget_rung_table_refused_before_tracing(capsys, monkeypatch):
    def no_trace(*a):
        raise AssertionError("traced an over-budget rung table")

    monkeypatch.setattr(coverage, "trace", no_trace)
    rc = main(["--step", "gcn-stream", "--vmem-budget", "4096",
               "--passes", "coverage,vmem"] + CPU)
    out = capsys.readouterr().out
    assert rc == 1
    assert "RUNG OVER BUDGET" in out and "[coverage] step" not in out


def test_rung_lint_follows_the_engine_predicates():
    table = RungTable(rungs=(Rung(4, 4, 2), Rung(64, 64, 4)), block=8,
                      stripe_multiple=4, width_multiple=4)
    dims = [128, 256, 64]
    with pytest.raises(ValueError, match="rung"):
        assert_rung_table_fits(table, dims, block=8, budget=4096)
    verdicts = assert_rung_table_fits(table, dims, block=8,
                                      budget=FUSED_SMEM_BUDGET)
    assert len(verdicts) == 2 and all(v.fits for v in verdicts)
    for v in verdicts:
        assert v.layer_fits == all(
            vmem.fused_layer_fits(f, g, 8, 8, budget=FUSED_SMEM_BUDGET)
            for f, g in zip(dims[:-1], dims[1:]))
        assert v.layer_bytes == max(vmem.fused_vmem_bytes(f, g, 8, 8)
                                    for f, g in zip(dims[:-1], dims[1:]))
    v, = lint_rung_table(RungTable(rungs=(Rung(2, 4, 2),), block=8,
                                   stripe_multiple=4, width_multiple=4),
                         [8, 8, 3], block=8, fused_network=True)
    assert v.rows == 16 and v.network_fits
    assert v.network_bytes == vmem.network_vmem_bytes([8, 8, 3], 8, 16)
    assert v.network_fits == vmem.fused_network_fits([8, 8, 3], 8, 16)


def test_smem_report_uses_the_wrappers_functions():
    from repro_torch.kernels.flash_checksum import kernel as flash
    from repro_torch.kernels.gcn_fused import kernel as fused
    from repro_torch.kernels.matmul_abft import kernel as matmul
    from repro_torch.kernels.spmm_abft import kernel as spmm
    assert spmm.spmm_plan is vmem.spmm_plan
    assert fused.fused_plan is vmem.fused_plan
    assert fused.network_vmem_bytes is vmem.network_vmem_bytes
    assert matmul.matmul_thin_smem_bytes is vmem.matmul_thin_smem_bytes
    assert matmul.matmul_wide_smem_bytes is vmem.matmul_wide_smem_bytes
    assert flash.flash_smem_bytes is vmem.flash_smem_bytes


@pytest.mark.parametrize("path", ["two-pass", "fused-layer",
                                  "fused-network"])
def test_smem_report_prices_every_kernel_site(path):
    args = lint_mod.argparse.Namespace(
        mode="fused", feat=8, hidden=8, classes=3, graphs=3, nodes=24,
        block=8, fused_layer=path == "fused-layer",
        fused_network=path == "fused-network", vmem_budget=None)
    step, ops = lint_mod._packed_step(args, torch.device("cpu"), "graph")
    gm = coverage.trace(step, *ops)
    m = coverage.analyze_graph(gm)
    ests = graph_smem_report(gm)
    assert len(ests) == sum(coverage.kernel_site_counts(m).values()) >= 1
    for e in ests:
        assert e.fits and e.budget == FUSED_SMEM_BUDGET
        assert e.provenance.startswith("src/repro_torch/")
        if e.name == "spmm_abft":
            bm, bk, g = e.shape
            assert e.total_bytes == vmem.spmm_plan(g, bm, bk).smem
        elif e.name == "gcn_fused":
            bm, bk, g = e.shape
            assert e.total_bytes == vmem.fused_plan(g, bm, bk).smem
        else:
            assert e.name == "gcn_network"
            assert e.total_bytes == vmem.network_vmem_bytes(
                list(e.shape), 8, 0)


def test_smem_report_prices_lm_kernels():
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.abft import ABFTConfig
    cfg = smoke_config(get_config("gemma-2b"))
    fn, ops, _carry = lint_mod.lm_step(cfg, ABFTConfig(), "lm-prefill",
                                       torch.device("cpu"))
    ests = graph_smem_report(coverage.trace(fn, *ops))
    names = {e.name for e in ests}
    assert names == {"matmul_abft", "flash_checksum"}
    for e in ests:
        if e.name == "flash_checksum":
            assert e.total_bytes == vmem.flash_smem_bytes(e.shape[0])
        else:
            m = e.shape[0]
            assert e.total_bytes in {
                vmem.matmul_thin_smem_bytes(m, 4, t)
                if m <= vmem.MATMUL_SMALL_M
                else vmem.matmul_wide_smem_bytes(4, t) for t in (0, 1)}


def test_cli_as_a_process():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    base = [sys.executable, "-m", "repro_torch.analysis.lint", "--device",
            "cpu", "--step", "lm-decode", "--arch", "gemma-2b",
            "--passes", "coverage"]
    ok = subprocess.run(base, env=env, capture_output=True, text=True,
                        timeout=300)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    bad = subprocess.run(base + ["--mode", "none"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert bad.returncode == 1 and "UNCHECKED" in bad.stdout
