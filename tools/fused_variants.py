#!/usr/bin/env python3
"""Variants of B2 (``gcn_fused``) and B3 (``gcn_network``) timed side by
side on one NVIDIA GPU, with their registers and spills.

    python3 tools/fused_variants.py [NAME ...]     # default: every variant

Each variant is this checkout's ``src/`` with a few text replacements
(every replaced text must be found, or the run stops) in a root of its
own under ``build/fused_variants/``; a variant that changes the cut
changes ``analysis/vmem.py`` beside the CUDA source, so that the wrappers
accept the library.  For every root: ``ptxas -v`` of ``gcn_fused.cu`` and
``gcn_network.cu`` (registers, stack, spill bytes of the fused kernels and
of the functions they call), then ``tools/fused_ab.py`` over the roots
(base first and last): B2 at Cora's layers 0 and 1, its combination
alone, and B3, each by ``ms``, ``ms_50`` and ``device_ms`` (graph replay),
with a digest of the outputs.  Variants that keep the association
(``stages3``, ``fchunk32``, ``unroll2``, ``l2_256``,
``network_1_per_sm``) must give
the base's digests; ``slice64`` cuts a k-chunk over 8 k-groups, not 4,
and does not; the ``diag_*`` variants drop work to show where the time
goes, and their outputs are wrong.  Prints one JSON object per root and run, then the card's name and
power limit.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "fused_variants")
CSRC = "src/repro_torch/kernels/csrc"
VMEM = "src/repro_torch/analysis/vmem.py"
ABFT = f"{CSRC}/abft_tile.cuh"
FUSED = f"{CSRC}/fused_tile.cuh"
NET = f"{CSRC}/gcn_network.cu"

_SWEEP_COPIES = """      mbar_expect(bars + st, stage_bytes);
      tma_box(s_sm, smap, k0, srow0 + ij * a.bm, bars + st);
      tma_bulk(xs, a.x + xrow * gp, 4u * cut.kc * gp, bars + st);
      if (with_check)
        tma_bulk(xs + cut.kc * gp, a.xr + xrow, 4u * cut.kc, bars + st);
"""
_COMBINE_COPIES = """      if (q < n) {
        float* st = ring + (q % kStages) * sf;
        const int f0 = q * kFChunk;"""

VARIANTS = {
    "base": [],
    # 64-row sweep slices: two blocks a stripe at block 128
    "slice64": [(FUSED, "constexpr int kSliceRows = 128;",
                 "constexpr int kSliceRows = 64; "),
                (VMEM, "SLICE_ROWS = 128\n", "SLICE_ROWS = 64\n")],
    # a 3-stage ring in both phases
    "stages3": [(ABFT, "constexpr int kStages = 4; ",
                 "constexpr int kStages = 3; "),
                (VMEM, "FUSED_STAGES = 4\n", "FUSED_STAGES = 3\n")],
    # the combination's chunks of F 32 wide
    "fchunk32": [(FUSED, "constexpr int kFChunk = 64; ",
                  "constexpr int kFChunk = 32; "),
                 (VMEM, "F_CHUNK = 64\n", "F_CHUNK = 32\n")],
    # two k-vectors of a chunk unrolled in the product
    "unroll2": [(ABFT, "#pragma unroll 1\n  for (int k = 4 * l.kg;",
                 "#pragma unroll 2\n  for (int k = 4 * l.kg;")],
    # every copy asks L2 to fetch the 256-byte sector group around it
    "l2_256": [(ABFT, "cp.async.cg.shared.global [%0], [%1], 16, %2;",
                "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;"),
               (ABFT, "cp.async.ca.shared.global [%0], [%1], 4, %2;",
                "cp.async.ca.shared.global.L2::256B [%0], [%1], 4, %2;")],
    # the network kernel at one block an SM (no register cap)
    "network_1_per_sm": [
        (NET, "__launch_bounds__(kThreads, 2)\ngcn_network_kernel",
         "__launch_bounds__(kThreads, 1)\ngcn_network_kernel")],
    # the sweep without its copies (each stage's mbarrier still completes),
    # or without its product
    "diag_b_nocopy": [(FUSED, _SWEEP_COPIES,
                       "      mbar_expect(bars + st, 0);\n")],
    "diag_b_noproduct": [
        (FUSED, "        tile_product<RT, true>(s_sm, xs, xs + cut.kc * gp, "
                "cut, l, col, acc,\n                               ex);\n",
         "")],
    # the combination without its copies, or without its product
    "diag_a_nocopy": [(FUSED, _COMBINE_COPIES,
                       _COMBINE_COPIES.replace("if (q < n)", "if (false)"))],
    "diag_a_noproduct": [
        (FUSED, "        tile_product<RT>(st, ws, ws + kFChunk * ct, cut, "
                "l, col, acc, ex);\n", "")],
}


def make_root(name: str) -> str:
    root = os.path.join(OUT, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src"), os.path.join(root, "src"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for path, old, new in VARIANTS[name]:
        p = os.path.join(root, path)
        with open(p) as fh:
            text = fh.read()
        if old not in text:
            raise SystemExit(f"{name}: text to replace not found in {path}:"
                             f"\n{old}")
        with open(p, "w") as fh:
            fh.write(text.replace(old, new, 1))
    return root


def ptxas(root: str) -> dict:
    """Registers, stack and spills of the fused kernels of ``root``."""
    sys.path.insert(0, ROOT)
    from chip_smoke import ptxas_summary
    src = os.path.join(root, CSRC)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    log = []
    for unit in ("gcn_fused.cu", "gcn_network.cu"):
        done = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xptxas", "-v", "-I", src, "-c",
             os.path.join(src, unit), "-o", os.devnull],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if done.returncode:
            raise SystemExit(f"{root}: nvcc failed\n{done.stdout}")
        log.append(done.stdout)
    return {name: v for name, v in ptxas_summary("\n".join(log)).items()
            if any(k in name for k in ("combine_", "sweep_", "gcn_network"))}


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
    if "base" not in names:
        names = ["base"] + names
    roots = {name: make_root(name) for name in names}
    with ThreadPoolExecutor(len(roots)) as pool:
        regs = dict(zip(roots, pool.map(ptxas, roots.values())))
    for name in names:
        print(json.dumps({"variant": name, "ptxas": regs[name]}), flush=True)
    order = [roots[n] for n in names] + [roots["base"]]
    done = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "fused_ab.py"), *order],
        stdout=subprocess.PIPE, text=True)
    print(done.stdout, end="", flush=True)
    # the association-keeping variants against the base, digest by digest
    digests = {}
    for line in done.stdout.splitlines():
        if line.startswith("{"):
            res = json.loads(line)
            name = os.path.basename(res["root"])
            digests[name] = {k: v["digest"] for k, v in res.items()
                             if isinstance(v, dict) and "digest" in v}
    same = {n: digests[n] == digests["base"] for n in digests
            if n in ("stages3", "fchunk32", "unroll2", "l2_256",
                     "network_1_per_sm")}
    print(json.dumps({"same_bits_as_base": same}), flush=True)
    return done.returncode or (0 if all(same.values()) else 1)


if __name__ == "__main__":
    sys.exit(main())
