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
from repro_torch.kernels.flash_checksum import kernel as flash_kernel
from repro_torch.kernels.gcn_fused import ops as fused_ops
from repro_torch.kernels.matmul_abft import kernel as mm_kernel
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
                                   "device_block_ell", "init_model",
                                   "lm_engine", "serve_lm",
                                   "lm_params_from_numpy",
                                   "init_decode_state"])
def test_entry_points_raise_without_a_gpu_unless_cpu_is_asked_for(entry):
    _no_gpu()
    import numpy as np

    from repro_torch import convert
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.gcn import init_gcn
    from repro_torch.engine import (Graph, gcn_apply, make_backend,
                                    make_packed_batches, synth_graph_stream)
    from repro_torch.engine.streaming import PackedRunner
    from repro_torch.kernels.spmm_abft.layout import dense_to_block_ell
    from repro_torch.kernels.spmm_abft.ops import device_block_ell
    from repro_torch.engine.lm import LMEngine
    from repro_torch.launch import serve_gcn, serve_lm
    from repro_torch.models.transformer import init_decode_state, init_model

    cfg = ABFTConfig()
    lm = smoke_config(get_config("gemma-2b"))
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
        "init_model": lambda: init_model(lm, 0),
        "lm_engine": lambda: LMEngine.init(lm, cfg, 0),
        "serve_lm": lambda: serve_lm.main(["--new", "1"]),
        "lm_params_from_numpy": lambda: convert.lm_params_from_numpy(
            convert.params_to_numpy(init_model(lm, 0, device="cpu")), lm),
        "init_decode_state": lambda: init_decode_state(lm, 1, 4),
    }
    with pytest.raises(RuntimeError, match="device='cuda' requested"):
        calls[entry]()


def test_cpu_runs_only_when_asked_for():
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")
    _no_gpu()
    with pytest.raises(RuntimeError):
        repro_torch.resolve_device("cuda:0")


@pytest.mark.parametrize("kernel", ["spmm_abft", "gcn_fused", "gcn_network",
                                    "matmul_abft", "matmul_abft_grouped",
                                    "flash_checksum"])
def test_wrapper_never_takes_the_plain_version_off_the_cpu(kernel):
    """Tensors on any device other than the CPU go to the launch path, which
    raises when it cannot launch; the plain version is not consulted."""
    dev = "meta"
    cols = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    vals = torch.zeros((2, 2, 8, 8), device=dev)
    x, xr = torch.zeros((16, 4), device=dev), torch.zeros((16, 1), device=dev)
    w, wr = torch.zeros((4, 4), device=dev), torch.zeros((4, 1), device=dev)
    before = (runtime.plain_counts(), runtime.launch_counts())
    with pytest.raises(ValueError, match="not on a CUDA device"):
        if kernel == "spmm_abft":
            spmm_kernel.spmm_abft_kernel(cols, vals, x, xr)
        elif kernel == "gcn_fused":
            fused_kernel.gcn_fused_kernel(cols, vals, x, w, wr)
        elif kernel == "gcn_network":
            fused_kernel.gcn_network_kernel(
                cols, vals, x, [torch.zeros((4, 8), device=dev)], [wr])
        elif kernel == "matmul_abft":
            mm_kernel.matmul_abft_kernel(x, w, wr[:, 0])
        elif kernel == "matmul_abft_grouped":
            mm_kernel.matmul_abft_grouped_kernel(x[None], w[None],
                                                 wr[:, 0][None])
        else:
            q = torch.zeros((1, 4, 2, 8), device=dev)
            kv = torch.zeros((1, 4, 1, 8), device=dev)
            flash_kernel.flash_checksum_kernel(q, kv, kv)
    assert before == (runtime.plain_counts(), runtime.launch_counts())


def test_launch_and_plain_counters():
    runtime.reset_counts()
    zero = {"spmm_abft": 0, "gcn_fused": 0, "gcn_network": 0,
            "matmul_abft": 0, "matmul_abft_grouped": 0, "flash_checksum": 0}
    assert runtime.launch_counts() == zero
    cols = torch.zeros((1, 1), dtype=torch.int32)
    vals = torch.ones((1, 1, 4, 4))
    spmm_kernel.spmm_abft_kernel(cols, vals, torch.ones(4, 4),
                                 torch.ones(4, 1))
    fused_kernel.gcn_fused_kernel(cols, vals, torch.ones(4, 3),
                                  torch.ones(3, 4), torch.ones(3, 1))
    fused_kernel.gcn_network_kernel(cols, vals, torch.ones(4, 3),
                                    [torch.ones(3, 8)], [torch.ones(3, 1)])
    mm_kernel.matmul_abft_kernel(torch.ones(3, 4), torch.ones(4, 5))
    # the grouped plain version loops the single one uncounted
    mm_kernel.matmul_abft_grouped_kernel(torch.ones(2, 3, 4),
                                         torch.ones(2, 4, 5))
    flash_kernel.flash_checksum_kernel(torch.ones(1, 3, 2, 4),
                                       torch.ones(1, 3, 1, 4),
                                       torch.ones(1, 3, 1, 4))
    assert runtime.plain_counts() == {"spmm_abft": 1, "gcn_fused": 1,
                                      "gcn_network": 1, "matmul_abft": 1,
                                      "matmul_abft_grouped": 1,
                                      "flash_checksum": 1}
    assert runtime.launch_counts() == zero
    runtime.reset_counts()
    assert runtime.plain_counts() == zero


def test_cuda_sources_exist_and_carry_their_notes():
    paths = runtime.source_paths()
    assert {p.name for p in paths} == {"spmm_abft.cu", "gcn_fused.cu",
                                       "gcn_network.cu", "matmul_abft.cu",
                                       "flash_checksum.cu", "abft_tile.cuh",
                                       "fused_tile.cuh"}
    for p in paths:
        assert p.is_file() and p.parent == PKG / "kernels" / "csrc"
    for name, ref in (("spmm_abft.cu", "src/repro/kernels/spmm_abft/kernel.py"),
                      ("gcn_fused.cu", "src/repro/kernels/gcn_fused/kernel.py"),
                      ("gcn_network.cu",
                       "src/repro/kernels/gcn_fused/kernel.py"),
                      ("matmul_abft.cu",
                       "src/repro/kernels/matmul_abft/kernel.py"),
                      ("flash_checksum.cu",
                       "src/repro/kernels/flash_checksum/kernel.py")):
        text = (PKG / "kernels" / "csrc" / name).read_text()
        assert ref in text and "What bounds it" in text
        assert 'extern "C"' in text and "torch/extension.h" not in text
    assert "compute_90a" in " ".join(runtime.NVCC_FLAGS)
    assert set(runtime._SIGNATURES) >= {"spmm_abft_launch", "gcn_fused_launch",
                                        "gcn_network_launch",
                                        "matmul_abft_launch",
                                        "matmul_abft_grouped_launch",
                                        "flash_checksum_launch"}


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
    # Cora's first layer at 128-blocks: F is streamed, so it does not count;
    # the combination's 4-stage ring (H chunk [64, 68], W rows [64, 16],
    # w_r [64]) after 256 header bytes and 1024 of alignment room
    cora = vmem.fused_vmem_bytes(1433, 16, 128, 128)
    assert cora == vmem.fused_vmem_bytes(16, 16, 128, 128) == 88_320
    assert vmem.fused_layer_fits(1433, 16, 128, 128)
    assert not vmem.fused_layer_fits(1433, 16, 128, 128, budget=86_000)
    assert not vmem.fused_layer_fits(64, 256, 128, 128)     # wide G
    # the shape contract: (bk / 2) * (gp / 8) <= 512 pieces of an X tile
    assert vmem.fused_tile_supported(64, 128, 128)
    assert not vmem.fused_tile_supported(65, 128, 128)
    assert vmem.fused_tile_supported(186, 32, 32)
    assert not vmem.fused_tile_supported(16, 7, 8)          # odd block_m
    assert not vmem.fused_layer_fits(16, 72, 128, 128)
    assert vmem.FUSED_MAX_X_PIECES == 512 and vmem.G_QUANTUM == 8
    assert vmem.FUSED_THREADS == 256 and vmem.FUSED_STAGES == 4
    assert vmem.FUSED_COLS == 8
    assert vmem._lanes(7) == vmem._lanes(7, 128) == 8
    assert vmem.network_vmem_bytes([16, 16, 7], 32, 256) > \
        vmem.network_vmem_bytes([16, 7], 32, 256)
    assert vmem.fused_network_fits([16, 16, 7], 32, 256)
    # the port's network predicate (activations in device memory): Cora at
    # 128-blocks fits; a non-square block, an output width past the register
    # tile and a model deeper than the launcher's struct do not
    assert vmem.fused_network_fits([1433, 16, 7], 128, 18432)
    assert vmem.network_vmem_bytes([1433, 16, 7], 128, 18432) == cora
    assert not vmem.fused_network_fits([1433, 16, 7], 128, 18432, bk=64)
    assert not vmem.fused_network_fits([16, 72, 7], 128, 18432)
    deep = [16] * (vmem.MAX_NETWORK_LAYERS + 2)
    assert vmem.fused_network_fits(deep[:-1], 32, 256)
    assert not vmem.fused_network_fits(deep, 32, 256)
    # the checked-op kernels: the launcher's figures, stated here too
    assert vmem.flash_smem_bytes(256) == 105_216
    assert vmem.flash_smem_bytes(256) <= vmem.FUSED_SMEM_BUDGET
    assert 2 * (vmem.flash_smem_bytes(256) + 1024) <= vmem.SM_SMEM_BYTES
    # M <= 16: the thin split-K path's sum tile, 64 columns over all 16
    # rows; M > 16: 64 x 128, each half of the 128 x 128 tile one block owns
    assert vmem.matmul_tile(2) == (16, 64) and vmem.matmul_tile(1024) == \
        (64, 128)
    assert vmem.matmul_tile(vmem.MATMUL_SMALL_M) == (16, 64)
    assert vmem.matmul_tile(vmem.MATMUL_SMALL_M + 1) == (64, 128)
    # the wide path's block tile is a whole number of sum tiles, and its
    # cp.async ring (3 stages of A's and B's slices and b_r; a transposed
    # B's k-major buffer after it) fits one block
    (bm, bn), (sm, sn) = vmem.MATMUL_WIDE_TILE, vmem.matmul_tile(1024)
    assert (bm, bn) == (128, 128) and bm % sm == 0 and bn % sn == 0
    assert vmem.matmul_wide_smem_bytes(4, False) == 104_832
    assert vmem.matmul_wide_smem_bytes(4, True) == 127_360
    assert vmem.matmul_wide_smem_bytes(2, False) == 55_680
    assert vmem.matmul_wide_smem_bytes(2, True) == 70_016
    assert max(vmem.matmul_wide_smem_bytes(i, t) for i in (2, 4)
               for t in (False, True)) <= vmem.FUSED_SMEM_BUDGET
    # the thin path's cp.async ring: 3 stages of B's chunk, A's slice and
    # b_r; two blocks fit an SM at gemma's head (f32, transposed, M = 2)
    assert vmem.matmul_thin_smem_bytes(2, 4, True) == 111_936
    assert vmem.matmul_thin_smem_bytes(2, 4, False) == 99_648
    assert vmem.matmul_thin_smem_bytes(16, 4, True) <= vmem.FUSED_SMEM_BUDGET
    assert vmem.matmul_thin_smem_bytes(1, 2, False) == \
        vmem.matmul_thin_smem_bytes(2, 2, False) - 3 * 40 * 2


def test_spmm_ring_plan_pins():
    """spmm_abft's launch plan: a stripe of 128 rows cut into 2 blocks of
    64 k-columns of every slot (one cluster), a 3-stage TMA ring of 32-wide
    chunks rounded to the 1024-byte swizzle atom, 4 x 16 register tiles at
    G = 16 in 128-thread blocks (3 an SM), 4 x 8 at G = 8; narrower chunks
    where a part has no 32 columns, row slices where a tall block needs
    them; and the shapes it refuses."""
    plan = vmem.spmm_plan(16, 128, 128)
    assert plan == vmem.SpmmPlan(slices=1, parts=2, rows=128, kb=64, rt=4,
                                 cw=16, units=32, span=32, groups=4,
                                 threads=128, kc=32, stages=3, smem=59_648)
    assert 3 * (plan.smem + 1024) <= 233_472      # 228 KB an SM
    assert vmem.spmm_plan(8, 128, 128)[:6] == (1, 2, 128, 64, 4, 8)
    assert vmem.spmm_plan(8, 128, 128).smem == 56_576
    assert vmem.spmm_plan(7, 128, 128).smem == 56_576     # pads to 8
    # block 32: one block a stripe
    assert vmem.spmm_plan(16, 32, 32)[:6] == (1, 1, 32, 32, 2, 16)
    assert vmem.spmm_plan(16, 32, 32).smem == 22_784
    # wide G: more threads, 8 columns a thread where G % 16 != 0
    wide = vmem.spmm_plan(72, 128, 128)
    assert (wide.cw, wide.threads, wide.groups) == (8, 288, 1)
    assert vmem.spmm_plan(144, 128, 128)[:6] == (1, 2, 128, 64, 4, 16)
    assert vmem.spmm_plan(16, 256, 256)[:4] == (2, 4, 128, 64)
    assert vmem.spmm_plan(16, 40, 40).kc == 8      # 40 = 5 chunks of 8
    assert vmem.spmm_plan(16, 1024, 4)[:3] == (8, 1, 128)
    assert vmem.spmm_plan(16, 2048, 4) is None    # 16 slices: no cluster
    assert vmem.spmm_plan(16, 128, 6) is None     # bk % 4
    assert vmem.spmm_plan(1024, 32, 32) is None   # the ring outgrows a block
    assert vmem.spmm_parts(128, 1) == 2 and vmem.spmm_parts(256, 1) == 4
    assert vmem.spmm_parts(256, 4) == 2 and vmem.spmm_parts(192, 1) == 3
    assert vmem.spmm_parts(32, 1) == vmem.spmm_parts(12, 1) == 1
    for g, bm, bk in ((8, 8, 8), (16, 128, 128), (72, 32, 32), (24, 16, 16),
                      (160, 128, 128), (16, 96, 96), (16, 256, 256),
                      (16, 40, 40)):
        p = vmem.spmm_plan(g, bm, bk)
        assert p.slices * p.rows == bm and p.parts * p.kb == bk
        assert p.slices * p.parts <= vmem.SPMM_MAX_CLUSTER
        assert p.kb % p.kc == 0 and p.kc in (4, 8, 16, 32)
        assert p.threads % 32 == 0 and p.threads <= vmem.SPMM_MAX_THREADS
        assert p.smem <= vmem.FUSED_SMEM_BUDGET
        assert p.units == (p.rows // p.rt) * (vmem._lanes(g) // p.cw)


def test_spmm_wrapper_refuses_a_library_that_plans_otherwise():
    """The B1 wrapper holds the library's block rows, k-parts, threads,
    stages and shared memory against ``analysis.vmem.spmm_plan``: a library
    that cuts the stripe otherwise would give other bits than the plan says
    (the k-parts and k-groups set the association), so it must not
    launch."""
    import types

    def lib_with(**other):
        def q(field):
            if field in other:
                return lambda bm, bk, g: other[field]
            return lambda bm, bk, g: getattr(vmem.spmm_plan(g, bm, bk),
                                             field)
        return types.SimpleNamespace(
            spmm_abft_slice_rows=q("rows"), spmm_abft_parts=q("parts"),
            spmm_abft_threads=q("threads"), spmm_abft_stages=q("stages"),
            spmm_abft_smem_bytes=q("smem"))
    plan = vmem.spmm_plan(16, 128, 128)
    spmm_kernel._agreed_with_library(lib_with(), "probe", plan, 16, 128, 128)
    for other in (dict(rows=64), dict(parts=4), dict(threads=256),
                  dict(stages=4), dict(smem=plan.smem + 16)):
        with pytest.raises(RuntimeError, match="analysis.vmem plans"):
            spmm_kernel._agreed_with_library(lib_with(**other), "probe",
                                             plan, 16, 128, 128)


def test_fused_plan_pins():
    """The two phases of gcn_fused / gcn_network at the served shapes: the
    combination in items of 64 rows x up to 64 columns, F in chunks of 64
    (4 x 8 register tiles, 8 k-groups at G = 16), the sweep one block a
    stripe up to 128 rows (4 x 8 tiles, 4 k-groups at block 128), 88,320 B
    of shared memory — two blocks an SM; the workspace is X and x_r,
    f32."""
    plan = vmem.fused_plan(16, 128, 128)
    assert plan.library_fields() == (16, 1, 4, 32, 8, 128, 32, 4, 64, 4, 1,
                                      88_320)
    assert 2 * (plan.smem + 1024) <= vmem.SM_SMEM_BYTES
    assert plan.combine.groups * plan.combine.span <= vmem.FUSED_THREADS
    # G = 8 (Cora's second layer): 2 rows a thread keep the combination's
    # 32 units
    assert vmem.fused_plan(8, 128, 128).library_fields() == \
        (8, 1, 2, 32, 8, 128, 32, 4, 32, 8, 1, 80_128)
    assert vmem.fused_plan(7, 128, 128) == vmem.fused_plan(8, 128, 128)
    # blocks 32 and 16: narrower chunks at 16
    assert vmem.fused_plan(16, 32, 32).library_fields()[5:] == \
        (32, 32, 2, 32, 8, 1, 88_320)
    assert vmem.fused_plan(16, 16, 16).library_fields()[5:] == \
        (16, 16, 2, 16, 4, 1, 88_320)
    # G = 24: three column blocks a row; G = 72: three column tiles of 24
    assert vmem.fused_plan(24, 32, 32)[:2] == (24, 1)
    assert vmem.fused_plan(72, 32, 32)[:2] == (24, 3)
    assert vmem.fused_plan(512, 16, 16)[:2] == (64, 8)
    # tall blocks: row slices of at most 128 rows, one block each
    assert vmem.fused_plan(16, 256, 256).slices == 2
    assert vmem.fused_plan(16, 96, 96).sweep.rows == 96
    assert vmem.fused_plan(16, 192, 192).sweep.rows == 96
    # bk != bm, and bk with no 32-wide chunk
    assert vmem.fused_plan(16, 6, 8).sweep[:3] == (6, 16, 8)
    assert vmem.fused_plan(16, 40, 40).sweep.kc == 8
    assert vmem.fused_plan(16, 7, 8) is None           # odd block_m
    assert vmem.fused_plan(16, 128, 6) is None         # bk % 4
    assert vmem.fused_plan(72, 128, 128) is None       # 576 X pieces
    assert vmem.fused_workspace_bytes(16, 18_432) == 4 * 18_432 * 17 == \
        1_253_376
    assert vmem.network_workspace_bytes([1433, 16, 7], 18_432) == 1_253_376
    assert vmem.slice_part_floats(144, 24, 1) == 144 * 49
    assert vmem.combine_items(16, 18_432) == 288
    assert vmem.combine_items(72, 18_432) == 3 * 288
    assert vmem.combine_items(16, 65) == 2


def test_fused_plan_is_a_function_of_shape_alone():
    """What sets the association of every sum — the combination's column
    tile and k-groups, the sweep's tile, chunk, k-groups and slices — is a
    function of (bm, bk, G) alone, and the combination's of G alone: F, the
    rows of H, the stripe count and the grid never enter (the wrappers take
    nothing else), so B2, B3 and a gathered sub-system share the bits."""
    import inspect
    assert list(inspect.signature(vmem.fused_plan).parameters) == \
        ["g", "bm", "bk", "block_g"]
    for g in (8, 16, 24, 64, 72, 136, 512):
        combines = {vmem.fused_plan(g, b, b)[:3] for b in (4, 8, 16, 32)
                    if vmem.fused_plan(g, b, b) is not None}
        assert len(combines) == 1, (g, combines)
    for g, bm, bk in ((16, 128, 128), (8, 32, 32), (24, 16, 16),
                      (16, 6, 8), (16, 256, 256), (72, 32, 32)):
        p = vmem.fused_plan(g, bm, bk)
        gp = vmem._lanes(g)
        assert p == vmem.fused_plan(g, bm, bk)
        assert p.slices * p.sweep.rows == bm and p.sweep.nc == gp
        assert bk % p.sweep.kc == 0 and p.sweep.kc in (4, 8, 16, 32)
        assert p.ct * p.col_tiles == gp and p.ct % 8 == 0
        for t in (p.combine, p.sweep):
            assert t.units == t.rpos * (t.nc // vmem.FUSED_COLS) <= t.span
            assert t.groups * t.span <= vmem.FUSED_THREADS
            assert t.groups <= t.kc // 4
        assert vmem.fused_vmem_bytes(1, g, bm, bk) == \
            vmem.fused_vmem_bytes(1433, g, bm, bk) == p.smem
        assert p.smem <= vmem.FUSED_SMEM_BUDGET


def test_fused_wrapper_refuses_a_library_that_plans_otherwise():
    """The B2 and B3 wrappers hold the library's plan (both phases' cuts and
    the shared memory) against ``analysis.vmem.fused_plan``: a library that
    cuts otherwise would sum in another order, so it must not launch."""
    import ctypes
    import types

    def lib_with(**other):
        def plan(bm, bk, g, addr):
            p = vmem.fused_plan(g, bm, bk)
            fields = list(p.library_fields())
            for i, v in other.items():
                fields[int(i[1:])] = v
            (ctypes.c_int * 12).from_address(addr)[:] = fields
            return 1
        return types.SimpleNamespace(
            gcn_fused_plan=plan,
            gcn_fused_smem_bytes=lambda bm, bk, g:
                vmem.fused_plan(g, bm, bk).smem)
    fused_kernel._agreed_with_library(lib_with(), "probe", 16, 128, 128)
    for other in (dict(f0=32), dict(f4=4), dict(f6=16), dict(f9=8),
                  dict(f10=2), dict(f11=88_320 + 16)):
        with pytest.raises(RuntimeError, match="analysis.vmem plans"):
            fused_kernel._agreed_with_library(lib_with(**other), "probe",
                                              16, 128, 128)


def test_matmul_wrapper_refuses_a_library_that_splits_otherwise():
    """The B4 wrapper holds the library's tile, split count, split width,
    thin-path shared memory, and the wide path's block tile and shared
    memory against ``analysis.vmem`` — the plain version's association
    follows vmem, so a library that splits K otherwise must not launch, nor
    one whose wide block owns another tile or asks for other bytes."""
    import types

    def lib_with(splits=vmem.matmul_splits, wide_tile=(128, 128),
                 wide_smem=vmem.matmul_wide_smem_bytes):
        small = vmem.MATMUL_SMALL_M
        return types.SimpleNamespace(
            matmul_abft_tile_m=lambda m: vmem.matmul_tile(m)[0],
            matmul_abft_tile_n=lambda m: vmem.matmul_tile(m)[1],
            matmul_abft_splits=splits,
            matmul_abft_split_k=vmem.matmul_split_k,
            matmul_abft_thin_smem_bytes=lambda m, dt, tb:
                vmem.matmul_thin_smem_bytes(m, 4 // (1 + dt), bool(tb))
                if m <= small else 0,
            matmul_abft_wide_tile_m=lambda m: 0 if m <= small
                else wide_tile[0],
            matmul_abft_wide_tile_n=lambda m: 0 if m <= small
                else wide_tile[1],
            matmul_abft_wide_smem_bytes=lambda m, dt, tb: 0 if m <= small
                else wide_smem(4 // (1 + dt), bool(tb)))
    a = torch.ones(2, 2048)
    assert mm_kernel._agreed_with_library(
        lib_with(), "probe", 2, 2048, 16384, a, False) == (16, 64, 64)
    with pytest.raises(RuntimeError, match="splits"):
        mm_kernel._agreed_with_library(lib_with(lambda m, n, k: 1), "probe",
                                       2, 2048, 16384, a, False)
    # M > 16: the wide path, f32 and bf16, B and B^T
    for dtype in (torch.float32, torch.bfloat16):
        wide = torch.ones(1024, 2048, dtype=dtype)
        for tb in (False, True):
            assert mm_kernel._agreed_with_library(
                lib_with(), "probe", 1024, 2048, 16384, wide, tb) == \
                (64, 128, 1)
        for other in (lib_with(wide_tile=(64, 128)),
                      lib_with(wide_smem=lambda item, tb:
                               vmem.matmul_wide_smem_bytes(item, tb) - 128)):
            with pytest.raises(RuntimeError, match="wide"):
                mm_kernel._agreed_with_library(other, "probe", 1024, 2048,
                                               16384, wide, False)


def test_flash_cut_pins():
    """flash_checksum's cut: 32 query rows a block of 128 threads, key
    blocks of 32 (the plain version's) split into 2 parts a query tile (one
    cluster of 2 blocks), the head dim in a compile-time tile of 64, 128 or
    256; 105,216 B of shared memory at dh 256 in f32 — two blocks an SM;
    bfloat16 tiles take half the q, k and v bytes."""
    assert (vmem.FLASH_BLOCK_Q, vmem.FLASH_BLOCK_K, vmem.FLASH_THREADS,
            vmem.FLASH_MAX_DH) == (32, 32, 128, 256)
    assert [vmem.flash_head_tile(d) for d in (1, 16, 64, 65, 70, 128, 129,
                                              256)] == \
        [64, 64, 64, 128, 128, 128, 256, 256]
    assert vmem.flash_smem_bytes(256) == 105_216
    assert vmem.flash_smem_bytes(256, itemsize=2) == 56_064
    assert vmem.flash_smem_bytes(64) == vmem.flash_smem_bytes(16) == 31_488
    assert vmem.flash_smem_bytes(70) == vmem.flash_smem_bytes(128) == 56_064
    assert vmem.flash_blocks_per_sm(256) == 2
    assert vmem.flash_blocks_per_sm(256, itemsize=2) == 4
    # the key parts: query tile qt of gemma-2b's prefill (T = S = 512)
    # walks qt + 1 key blocks, cut into 2 parts, the first taking the odd
    # one; the longest part is 8 key blocks, not 16
    assert vmem.FLASH_PARTS == 2
    assert [vmem.flash_key_blocks(i, 512) for i in (0, 1, 7, 15)] == \
        [1, 2, 8, 16]
    assert [vmem.flash_part_start(15, 512, True, p) for p in (0, 1, 2)] == \
        [0, 8, 16]
    assert [vmem.flash_part_start(0, 512, True, p) for p in (0, 1, 2)] == \
        [0, 1, 1]
    assert [vmem.flash_part_start(2, 512, True, p) for p in (0, 1, 2)] == \
        [0, 2, 3]
    # T < S, and no mask: every tile walks every key block
    assert vmem.flash_key_blocks(3, 256) == 4
    assert vmem.flash_key_blocks(0, 100, causal=False) == 4
    assert vmem.flash_part_start(0, 100, False, 1) == 2
    blocks = vmem.FLASH_PARTS * 2 * 8 * -(-512 // vmem.FLASH_BLOCK_Q)
    steps = 2 * 8 * sum(vmem.flash_key_blocks(i, 512) for i in range(16))
    assert (blocks, steps) == (512, 2176)
    assert max(vmem.flash_part_start(i, 512, True, p + 1)
               - vmem.flash_part_start(i, 512, True, p)
               for i in range(16) for p in range(2)) == 8


def test_flash_wrapper_refuses_a_library_that_cuts_otherwise():
    """The B5 wrapper holds the library's cut and shared memory against
    ``analysis.vmem``: the plain version's key blocks follow vmem, so a
    library that steps through keys otherwise must not launch, nor one
    that asks for other bytes or another head tile."""
    import types

    def lib_with(**other):
        fields = dict(max_dh=lambda: vmem.FLASH_MAX_DH,
                      block_q=lambda: vmem.FLASH_BLOCK_Q,
                      block_k=lambda: vmem.FLASH_BLOCK_K,
                      parts=lambda: vmem.FLASH_PARTS,
                      head_tile=vmem.flash_head_tile,
                      part_start=lambda i, s, c, p, w: vmem.flash_part_start(
                          i, s, bool(c), p, w),
                      smem_bytes=vmem.flash_smem_bytes)
        fields.update(other)
        return types.SimpleNamespace(**{f"flash_checksum_{k}": f
                                        for k, f in fields.items()})
    for dh in (16, 64, 70, 256):
        flash_kernel._agreed_with_library(lib_with(), "probe", dh, 512, 512)
    for other in (dict(block_q=lambda: 64), dict(block_k=lambda: 64),
                  dict(parts=lambda: 1), dict(head_tile=lambda dh: 128),
                  dict(part_start=lambda i, s, c, p, w: p * (i + 1)),
                  dict(smem_bytes=lambda dh: vmem.flash_smem_bytes(dh) + 16)):
        with pytest.raises(RuntimeError, match="analysis.vmem models"):
            flash_kernel._agreed_with_library(lib_with(**other), "probe",
                                              256, 512, 512)
    with pytest.raises(ValueError, match="head_dim 257"):
        flash_kernel._agreed_with_library(lib_with(), "probe", 257)


def test_checked_op_wrappers_refuse_what_the_kernels_do_not_take():
    """dtype, shape and layout checks run before anything is launched."""
    with pytest.raises(ValueError, match="share one of"):
        mm_kernel.matmul_abft_kernel(torch.ones(2, 3),
                                     torch.ones(3, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="trans_b"):
        mm_kernel.matmul_abft_kernel(torch.ones(2, 3), torch.ones(4, 5),
                                     trans_b=True)
    with pytest.raises(ValueError, match="float32"):
        mm_kernel.matmul_abft_kernel(torch.ones(2, 3), torch.ones(3, 4),
                                     torch.ones(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="H % Kh"):
        flash_kernel.flash_checksum_kernel(torch.ones(1, 2, 3, 4),
                                           torch.ones(1, 2, 2, 4),
                                           torch.ones(1, 2, 2, 4))
    with pytest.raises(ValueError, match=r"\[B, S, H\]"):
        flash_kernel.flash_checksum_kernel(torch.ones(1, 2, 2, 4),
                                           torch.ones(1, 2, 1, 4),
                                           torch.ones(1, 2, 1, 4),
                                           torch.ones(1, 2, 1))
    meta = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError, match="not on a CUDA device"):
        runtime.require_cuda_operands("probe", allow=mm_kernel.DTYPES,
                                      a=meta.to(torch.bfloat16))
