"""Package-level contracts of the port: it stands alone (imports neither
``jax`` nor the JAX package ``repro``), it never carries on on the CPU by
itself, and a kernel wrapper never hands back its plain version's result for
a tensor that does not lie on the CPU."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.analysis import vmem
from repro_torch.core.abft import ABFTConfig
from repro_torch.kernels import runtime
from repro_torch.kernels.gcn_fused import kernel as fused_kernel
from repro_torch.kernels.gcn_fused import ops as fused_ops
from repro_torch.kernels.spmm_abft import kernel as spmm_kernel

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("MODULES", len(names))
print("BAD", bad)
"""


def test_every_module_imports_without_jax_or_the_jax_package():
    code = _IMPORT_ALL.format(src=str(ROOT / "src"), root=str(ROOT))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert done.returncode == 0, done.stderr
    lines = dict(line.split(" ", 1) for line in done.stdout.splitlines()
                 if line.startswith(("MODULES", "BAD")))
    assert int(lines["MODULES"]) >= 25
    assert lines["BAD"] == "[]"


def test_no_source_line_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)\b")
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 25
    hits = [f"{f.relative_to(ROOT)}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert hits == []


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device resolves")


@pytest.mark.parametrize("entry", ["resolve_device", "gcn_apply", "serve",
                                   "main", "init_gcn", "params_from_numpy",
                                   "packed_runner", "make_backend",
                                   "device_block_ell"])
def test_entry_points_raise_without_a_gpu_unless_cpu_is_asked_for(entry):
    _no_gpu()
    import numpy as np

    from repro_torch import convert
    from repro_torch.core.gcn import init_gcn
    from repro_torch.engine import (Graph, gcn_apply, make_backend,
                                    make_packed_batches, synth_graph_stream)
    from repro_torch.engine.streaming import PackedRunner
    from repro_torch.kernels.spmm_abft.layout import dense_to_block_ell
    from repro_torch.kernels.spmm_abft.ops import device_block_ell
    from repro_torch.launch import serve_gcn

    cfg = ABFTConfig()
    stream = synth_graph_stream(2, n_lo=10, n_hi=20, feat=4)
    params = init_gcn(torch.Generator().manual_seed(0), (4, 3), device="cpu")
    bell = dense_to_block_ell(stream[0][0], 8, 8)
    calls = {
        "resolve_device": lambda: repro_torch.resolve_device(),
        "gcn_apply": lambda: gcn_apply(params, Graph(*stream[0]), cfg),
        "serve": lambda: serve_gcn.serve(
            make_packed_batches(stream, 2, block=8), params, cfg,
            verbose=False),
        "main": lambda: serve_gcn.main(["--graphs", "2"]),
        "init_gcn": lambda: init_gcn(None, (4, 3)),
        "params_from_numpy": lambda: convert.params_from_numpy(
            {"w": np.zeros((2, 2), np.float32)}),
        "packed_runner": lambda: PackedRunner(params, cfg, 128),
        "make_backend": lambda: make_backend(bell, cfg),
        "device_block_ell": lambda: device_block_ell(bell),
    }
    with pytest.raises(RuntimeError, match="device='cuda' requested"):
        calls[entry]()


def test_cpu_runs_only_when_asked_for():
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")
    _no_gpu()
    with pytest.raises(RuntimeError):
        repro_torch.resolve_device("cuda:0")


@pytest.mark.parametrize("kernel", ["spmm_abft", "gcn_fused"])
def test_wrapper_never_takes_the_plain_version_off_the_cpu(kernel):
    """Tensors on any device other than the CPU go to the launch path, which
    raises when it cannot launch; the plain version is not consulted."""
    dev = "meta"
    cols = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    vals = torch.zeros((2, 2, 8, 8), device=dev)
    x, xr = torch.zeros((16, 4), device=dev), torch.zeros((16, 1), device=dev)
    w, wr = torch.zeros((4, 4), device=dev), torch.zeros((4, 1), device=dev)
    before = (spmm_kernel.spmm_abft_plain.calls,
              fused_kernel.gcn_fused_plain.calls,
              spmm_kernel.spmm_abft_kernel.launches,
              fused_kernel.gcn_fused_kernel.launches)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        if kernel == "spmm_abft":
            spmm_kernel.spmm_abft_kernel(cols, vals, x, xr)
        else:
            fused_kernel.gcn_fused_kernel(cols, vals, x, w, wr)
    assert before == (spmm_kernel.spmm_abft_plain.calls,
                      fused_kernel.gcn_fused_plain.calls,
                      spmm_kernel.spmm_abft_kernel.launches,
                      fused_kernel.gcn_fused_kernel.launches)


def test_launch_and_plain_counters():
    runtime.reset_counts()
    assert runtime.launch_counts() == {"spmm_abft": 0, "gcn_fused": 0}
    cols = torch.zeros((1, 1), dtype=torch.int32)
    vals = torch.ones((1, 1, 4, 4))
    spmm_kernel.spmm_abft_kernel(cols, vals, torch.ones(4, 4),
                                 torch.ones(4, 1))
    fused_kernel.gcn_fused_kernel(cols, vals, torch.ones(4, 3),
                                  torch.ones(3, 4), torch.ones(3, 1))
    assert runtime.plain_counts() == {"spmm_abft": 1, "gcn_fused": 1}
    assert runtime.launch_counts() == {"spmm_abft": 0, "gcn_fused": 0}
    runtime.reset_counts()
    assert runtime.plain_counts() == {"spmm_abft": 0, "gcn_fused": 0}


def test_cuda_sources_exist_and_carry_their_notes():
    paths = runtime.source_paths()
    assert {p.name for p in paths} == {"spmm_abft.cu", "gcn_fused.cu",
                                       "abft_tile.cuh"}
    for p in paths:
        assert p.is_file() and p.parent == PKG / "kernels" / "csrc"
    for name, ref in (("spmm_abft.cu", "src/repro/kernels/spmm_abft/kernel.py"),
                      ("gcn_fused.cu", "src/repro/kernels/gcn_fused/kernel.py")):
        text = (PKG / "kernels" / "csrc" / name).read_text()
        assert ref in text and "What bounds it" in text
        assert 'extern "C"' in text and "torch/extension.h" not in text
    assert "compute_90a" in " ".join(runtime.NVCC_FLAGS)
    assert set(runtime._SIGNATURES) >= {"spmm_abft_launch", "gcn_fused_launch"}


def test_build_without_nvcc_raises_instead_of_falling_back(monkeypatch,
                                                          tmp_path):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has the CUDA toolkit")
    assert runtime.build_root() == tmp_path
    with pytest.raises(RuntimeError, match="nvcc not found"):
        runtime.build()
    with pytest.raises(RuntimeError, match="launch refused"):
        runtime.check_launch(1, "probe")
    runtime.check_launch(0, "probe")


def test_shared_memory_model_is_one_object_everywhere():
    """The fallback predicate of the backend, the serving statistics and the
    kernel wrapper read the same model."""
    from repro_torch.engine import streaming
    assert fused_ops.fused_layer_fits is vmem.fused_layer_fits
    assert fused_ops.fused_vmem_bytes is vmem.fused_vmem_bytes
    assert streaming.fused_layer_fits is vmem.fused_layer_fits
    assert fused_kernel.fused_vmem_bytes is vmem.fused_vmem_bytes
    assert vmem.FUSED_SMEM_BUDGET == 232_448
    # Cora's first layer at 128-blocks: W is streamed, so F does not count
    cora = vmem.fused_vmem_bytes(1433, 16, 128, 128)
    assert cora == vmem.fused_vmem_bytes(16, 16, 128, 128) == 102_656
    assert vmem.fused_layer_fits(1433, 16, 128, 128)
    assert not vmem.fused_layer_fits(1433, 16, 128, 128, budget=100_000)
    assert not vmem.fused_layer_fits(64, 256, 128, 128)     # wide G
    # one 2 x 8 register tile per thread at most: (bk / 2) * (gp / 8) <= 512
    assert vmem.fused_tile_supported(64, 128, 128)
    assert not vmem.fused_tile_supported(65, 128, 128)
    assert vmem.fused_tile_supported(186, 32, 32)
    assert not vmem.fused_tile_supported(16, 7, 8)          # odd block_m
    assert not vmem.fused_layer_fits(16, 72, 128, 128)
    assert vmem.BLOCK_THREADS == 512 and vmem.G_QUANTUM == 8
    assert vmem.spmm_smem_bytes(16, 128, 128) == 83_584
    assert vmem._lanes(7) == vmem._lanes(7, 128) == 8
    assert vmem.network_vmem_bytes([16, 16, 7], 32, 256) > \
        vmem.network_vmem_bytes([16, 7], 32, 256)
    assert vmem.fused_network_fits([16, 16, 7], 32, 256)
    assert not vmem.fused_network_fits([1433, 16, 7], 128, 22528)
