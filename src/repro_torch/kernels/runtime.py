"""Build and load the port's CUDA kernels.

Takes the place of the JAX package's ``repro/kernels/runtime.py``: there the
one policy question was "compiled or interpret mode?"; here it is "where is
the compiled library?".  There is no interpret mode for CUDA C++ — a wrapper
given a CUDA tensor launches its kernel or raises, and uses its plain PyTorch
version only for a tensor that lies on the CPU.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a`` — one ``nvcc -c`` per source, all started together, then one link
— into a shared library with a plain C interface that is loaded with
``ctypes`` (no PyTorch headers, so the build takes seconds).  The library
lands in ``build/repro_torch_kernels/<hash of the sources>/`` at the root of
the checkout (``REPRO_TORCH_BUILD_DIR`` overrides the directory) and is
reused while the sources do not change.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
# every translation unit of the library, and the headers they include
SOURCES = ("spmm_abft.cu", "gcn_fused.cu", "gcn_network.cu",
           "matmul_abft.cu", "flash_checksum.cu")
HEADERS = ("abft_tile.cuh", "fused_tile.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
LIB_NAME = "librepro_torch_kernels.so"

_ENV_BUILD_DIR = "REPRO_TORCH_BUILD_DIR"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: a pointer or a stream passed without argtypes would be cut
# to a 32-bit int.
_SIGNATURES = {
    "spmm_abft_smem_bytes": [_I, _I, _I],
    "spmm_abft_slice_rows": [_I, _I, _I],
    "spmm_abft_parts": [_I, _I, _I],
    "spmm_abft_threads": [_I, _I, _I],
    "spmm_abft_stages": [_I, _I, _I],
    "spmm_abft_launch": [_P] * 7 + [_I] * 7 + [_F, _P],
    "gcn_fused_smem_bytes": [_I, _I, _I],
    "gcn_fused_plan": [_I, _I, _I, _P],
    "gcn_fused_launch": [_P] * 13 + [_I] * 11 + [_F, _P],
    "gcn_fused_combine_launch": [_P] * 4 + [_I] * 6 + [_P],
    "gcn_network_max_layers": [],
    "gcn_network_supported": [_P, _I, _I, _I],
    "gcn_network_smem_bytes": [_P, _I, _I],
    "gcn_network_launch": [_P] * 13 + [_I] * 9 + [_F, _P, _P],
    "matmul_abft_tile_m": [_I],
    "matmul_abft_tile_n": [_I],
    "matmul_abft_splits": [_I, _I, _I],
    "matmul_abft_split_k": [_I, _I, _I],
    "matmul_abft_thin_smem_bytes": [_I, _I, _I],
    "matmul_abft_wide_tile_m": [_I],
    "matmul_abft_wide_tile_n": [_I],
    "matmul_abft_wide_smem_bytes": [_I, _I, _I],
    "matmul_abft_launch": [_P] * 7 + [_I] * 5 + [_P],
    "matmul_abft_grouped_launch": [_P] * 8 + [_I] * 6 + [_P],
    "flash_checksum_smem_bytes": [_I],
    "flash_checksum_max_dh": [],
    "flash_checksum_block_q": [],
    "flash_checksum_block_k": [],
    "flash_checksum_head_tile": [_I],
    "flash_checksum_parts": [],
    "flash_checksum_part_start": [_I, _I, _I, _I, _I],
    "flash_checksum_launch": [_P] * 6 + [_I] * 6 + [_F, _I, _I, _P, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
# seconds the last build took in this process (0.0 when the library was
# found already built), and the compiler's output of a verbose build; read
# by chip_smoke.py
last_build_seconds: float = 0.0
last_build_log: str = ""


def source_paths() -> List[Path]:
    """Every file the library is built from (sources, then headers)."""
    return [CSRC / n for n in SOURCES + HEADERS]


def build_root() -> Path:
    env = os.environ.get(_ENV_BUILD_DIR)
    if env:
        return Path(env)
    # src/repro_torch/kernels/runtime.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build" / \
        "repro_torch_kernels"


def find_nvcc() -> str:
    """Path of ``nvcc``; raises when the CUDA toolkit is not installed."""
    cands = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home:
            cands.append(os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME, /usr/local/cuda): the "
        "CUDA kernels cannot be built on this machine")


def _sources_digest() -> str:
    h = hashlib.sha256()
    for p in source_paths():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/`` into the shared library (if not built yet for these
    sources) and return its path.  Raises with the compiler's output when
    ``nvcc`` fails."""
    global last_build_seconds, last_build_log
    out_dir = build_root() / _sources_digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        last_build_seconds = 0.0
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        extra = ["-Xptxas", "-v"] if verbose else []
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-c",
                   str(CSRC / name), "-o", obj]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        objs, log = [], []
        for cmd, obj, proc in procs:
            text, _ = proc.communicate()
            log.append(text)
            if proc.returncode != 0:
                for _c, _o, other in procs:
                    if other.poll() is None:
                        other.kill()
                        other.wait()
                raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{text}")
            objs.append(obj)
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", tmp_lib, *objs]
        done = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if done.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({' '.join(link)}):\n{done.stdout}")
        if verbose:
            last_build_log = "".join(log) + done.stdout
            print(last_build_log)
        os.replace(tmp_lib, lib_path)       # atomic: readers never see half
    last_build_seconds = time.perf_counter() - t0
    return lib_path


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed.  Cached per
    process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build(verbose=verbose)))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_launch(code: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(
            f"{what}: kernel launch refused, cudaError {code} (see "
            f"cudaGetErrorString; 1 = invalid value, e.g. too much shared "
            f"memory; 98 = invalid device function, e.g. not an sm_90 card)")


def require_cuda_operands(what: str, *, allow=None, **tensors) -> None:
    """The kernels' operand contract: CUDA, one device, contiguous, 16-byte
    aligned, of a dtype the kernel takes — ``allow`` (default float32 only,
    the GCN kernels; the checked-op kernels pass float32 and bfloat16),
    ``cols`` always int32.  The float operands are copied by TMA and bulk
    copies, which need 16-byte aligned addresses (a stripe slab of ``vals``
    starts stripes x width x bm x bk floats in, with bk % 4 == 0, so it
    stays aligned); ``cols`` is read one index at a time, so a slab of it
    needs only its 4-byte alignment.  Raises on anything else — there is no
    silent copy or cast on the launch path."""
    import torch

    allow = (torch.float32,) if allow is None else tuple(allow)
    dev = None
    for name, t in tensors.items():
        want = (torch.int32,) if name == "cols" else allow
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} lies on {t.device}, not on "
                             f"a CUDA device")
        if dev is None:
            dev = t.device
        if t.device != dev:
            raise ValueError(f"{what}: {name} lies on {t.device}, other "
                             f"operands on {dev}")
        if t.dtype not in want:
            raise ValueError(f"{what}: {name} has dtype {t.dtype}, the "
                             f"kernel takes {' or '.join(map(str, want))}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        align = 4 if name == "cols" else 16
        if t.data_ptr() % align:
            raise ValueError(f"{what}: {name} is not {align}-byte aligned")


def _wrappers():
    """(name, launch wrapper, plain version) of every kernel."""
    from .gcn_fused.kernel import (gcn_fused_kernel, gcn_fused_plain,
                                   gcn_network_kernel, gcn_network_plain)
    from .flash_checksum.kernel import (flash_checksum_kernel,
                                        flash_checksum_plain)
    from .matmul_abft.kernel import (matmul_abft_grouped_kernel,
                                     matmul_abft_grouped_plain,
                                     matmul_abft_kernel, matmul_abft_plain)
    from .spmm_abft.kernel import spmm_abft_kernel, spmm_abft_plain
    return (("spmm_abft", spmm_abft_kernel, spmm_abft_plain),
            ("gcn_fused", gcn_fused_kernel, gcn_fused_plain),
            ("gcn_network", gcn_network_kernel, gcn_network_plain),
            ("matmul_abft", matmul_abft_kernel, matmul_abft_plain),
            ("matmul_abft_grouped", matmul_abft_grouped_kernel,
             matmul_abft_grouped_plain),
            ("flash_checksum", flash_checksum_kernel, flash_checksum_plain))


def launch_counts() -> Dict[str, int]:
    """Launches of every kernel wrapper so far in this process."""
    return {name: kernel.launches for name, kernel, _ in _wrappers()}


def plain_counts() -> Dict[str, int]:
    """Calls of every kernel's plain PyTorch version so far."""
    return {name: plain.calls for name, _, plain in _wrappers()}


def reset_counts() -> None:
    """Set every launch and plain-call count to 0."""
    for _, kernel, plain in _wrappers():
        kernel.launches = 0
        plain.calls = 0
