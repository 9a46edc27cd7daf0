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
SOURCES = ("spmm_abft.cu", "gcn_fused.cu")
HEADERS = ("abft_tile.cuh",)
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
    "spmm_abft_launch": [_P] * 7 + [_I] * 7 + [_F, _P],
    "gcn_fused_smem_bytes": [_I, _I, _I],
    "gcn_fused_f_chunk": [],
    "gcn_fused_supported": [_I, _I, _I],
    "abft_block_threads": [],
    "gcn_fused_launch": [_P] * 10 + [_I] * 10 + [_F, _P],
}

_lib: Optional[ctypes.CDLL] = None
# seconds the last build took in this process (0.0 when the library was
# found already built); read by chip_smoke.py
last_build_seconds: float = 0.0


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
    global last_build_seconds
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
            print("".join(log) + done.stdout)
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


def require_cuda_operands(what: str, **tensors) -> None:
    """The kernels' operand contract: CUDA, one device, contiguous, 16-byte
    aligned, float32 (``cols`` int32).  Raises on anything else — there is
    no silent copy or cast on the launch path."""
    import torch

    dev = None
    for name, t in tensors.items():
        want = torch.int32 if name == "cols" else torch.float32
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} lies on {t.device}, not on "
                             f"a CUDA device")
        if dev is None:
            dev = t.device
        if t.device != dev:
            raise ValueError(f"{what}: {name} lies on {t.device}, other "
                             f"operands on {dev}")
        if t.dtype != want:
            raise ValueError(f"{what}: {name} has dtype {t.dtype}, the "
                             f"kernel takes {want}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")


def launch_counts() -> Dict[str, int]:
    """Launches of every kernel wrapper so far in this process."""
    from .gcn_fused.kernel import gcn_fused_kernel
    from .spmm_abft.kernel import spmm_abft_kernel
    return {"spmm_abft": spmm_abft_kernel.launches,
            "gcn_fused": gcn_fused_kernel.launches}


def plain_counts() -> Dict[str, int]:
    """Calls of every kernel's plain PyTorch version so far."""
    from .gcn_fused.kernel import gcn_fused_plain
    from .spmm_abft.kernel import spmm_abft_plain
    return {"spmm_abft": spmm_abft_plain.calls,
            "gcn_fused": gcn_fused_plain.calls}


def reset_counts() -> None:
    """Set every launch and plain-call count to 0."""
    from .gcn_fused.kernel import gcn_fused_kernel, gcn_fused_plain
    from .spmm_abft.kernel import spmm_abft_kernel, spmm_abft_plain
    spmm_abft_kernel.launches = gcn_fused_kernel.launches = 0
    spmm_abft_plain.calls = gcn_fused_plain.calls = 0
