#!/usr/bin/env python3
"""Variants of B1 (``spmm_abft``), built and timed side by side on one NVIDIA
GPU.

    python3 tools/spmm_variants.py                  # every variant
    python3 tools/spmm_variants.py base cp_async    # some of them

Each variant is ``src/repro_torch/kernels/csrc/spmm_abft.cu`` with a few
lines replaced (every replaced text must be found, or the script stops),
plus a small ``main`` that calls ``spmm_abft_launch`` at the served two-pass
shapes — a packed batch of 144 stripes x 24 slots of 128 x 128 tiles (229 MB
of S) at G = 16 (layer 0) and G = 8 (layer 1), 144 stripes x 24 slots of
32 x 32 tiles at G = 16 — and the G = 16 batch cut to 132 and 66 stripes.
Operands are a hash of the index, the same in every variant.  The variants
are compiled in parallel with ``nvcc`` for ``sm_90a`` into
``build/spmm_variants/`` and run in turns, twice; each line gives the mean
of 20 back-to-back launches (CUDA events, after 2 warm-up launches), the
rate at which it streams S, and each kernel instance's registers and
spills.  A variant that keeps the association (stage count, unrolling,
copy route) must give the base's outputs bit for bit, which the script
checks; one that changes the cut or the tile gives another association and
reports its largest difference from the base.  ``cp_async`` fills the ring
with 16-byte ``cp.async`` pieces from every thread into padded rows instead
of the base's TMA tensor and bulk copies from one thread.  The ``diag_*``
variants drop work to show
where the time goes and compute wrong results: no product (copies only), no
copies after the ring's first fill (product only), no loads of X or of S,
no check column, no barrier before a chunk.  Prints one JSON object per run
and variant, then the card's name and power limit (the harness:
``tools/_variants.py``).
"""
from __future__ import annotations

import os
import re
import sys
from pathlib import Path

import _variants

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                      "spmm_abft.cu")
OUT = os.path.join(ROOT, "build", "spmm_variants")
# (nbm, width, bm = bk, gp): the served shapes, then the G = 16 batch cut to
# 132 and 66 stripes (2 and 1 blocks an SM at 2 blocks a stripe, where 144
# stripes put 3 on 24 SMs)
SHAPES = ((144, 24, 128, 16), (144, 24, 128, 8), (144, 24, 32, 16),
          (132, 24, 128, 16), (66, 24, 128, 16))

_STAGES = "constexpr int kStages = 3;"
_ROWS = "constexpr int kSliceRows = 128;"
_PART = "constexpr int kPartK = 64;"
_WARPS = "constexpr int kTargetWarps = 4;"
_PRODUCT = "      if (active)\n        product<RT, CW>("
_UNROLL = "#pragma unroll 2\n  for (int k = 4 * kg;"
_WAIT = "__device__ __forceinline__ void wait_stage(const Ring& r) {\n  __syncthreads();\n"
_Q = "  const int q = r.fill_j * r.chunks + r.fill_h - (r.stages - 1);\n"
_COPY_IF = "  if (r.fill_j < r.width && threadIdx.x == 0) {\n"
_S_READ = """      const uint32_t off = 4u * ((rp + i * p.pairs) * p.kc + k);
      const float4 v = *reinterpret_cast<const float4*>(
          sb + (off ^ (((off >> 7) & mask) << 4)));
"""
_RING_START = "// What the ring's steps need."
_RING_END = "__device__ __forceinline__ void fma8("

# the known-good route: every thread copies 16-byte pieces with cp.async into
# S rows of kc + 4 floats (no swizzle), one commit group a chunk
_CP_ASYNC_RING = r"""// A rows x n grid of 16-byte pieces walked by the block's threads.
struct Walk {
  int row, col, drow, dcol, rows, n;
  __device__ void init(int rows_, int n_) {
    rows = rows_;
    n = n_;
    row = threadIdx.x / n;
    col = threadIdx.x - row * n;
    drow = blockDim.x / n;
    dcol = blockDim.x - drow * n;
  }
  __device__ __forceinline__ void copy(float* dst, int dp, const float* src,
                                       size_t sp) const {
    int r = row, c = col;
    while (r < rows) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
          smem_addr(dst + r * dp + 4 * c)), "l"(src + r * sp + 4 * c)
          : "memory");
      r += drow;
      c += dcol;
      if (c >= n) {
        c -= n;
        ++r;
      }
    }
  }
};

struct Ring {
  const CUtensorMap* smap;
  const int* cols;
  const float* x;
  const float* xr;
  const float* vals;   // stripe base + row0 * bk + k0
  float* ring;
  uint64_t* bars;
  int row_base;
  int bm, width, bk, k0, gp, rows, kc, chunks, stage_floats, stages;
  int fill_j, fill_h, fill_st;
  Walk s_walk, x_walk, xr_walk;
};

__device__ __forceinline__ void ring_init(Ring& r) {
  r.fill_j = r.fill_h = r.fill_st = 0;
  r.s_walk.init(r.rows, r.kc >> 2);
  r.x_walk.init(r.kc, r.gp >> 2);
  r.xr_walk.init(1, r.kc >> 2);
}

__device__ __forceinline__ void refill(Ring& r) {
  if (r.fill_j < r.width) {
    const int c = __ldg(r.cols + r.fill_j);
    const int kh = r.fill_h * r.kc;
    const size_t kx = (size_t)c * r.bk + r.k0 + kh;
    float* s_sm = r.ring + (size_t)r.fill_st * r.stage_floats;
    float* x_sm = s_sm + r.rows * (r.kc + 4);
    r.s_walk.copy(s_sm, r.kc + 4,
                  r.vals + (size_t)r.fill_j * r.bm * r.bk + kh, r.bk);
    r.x_walk.copy(x_sm, r.gp, r.x + kx * r.gp, r.gp);
    r.xr_walk.copy(x_sm + r.kc * r.gp, 0, r.xr + kx, 0);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  if (++r.fill_h == r.chunks) {
    r.fill_h = 0;
    ++r.fill_j;
  }
  if (++r.fill_st == r.stages) r.fill_st = 0;
}

__device__ __forceinline__ void wait_stage(const Ring& r) {
  if (r.stages == 3)
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
}

"""


def _between(start: str, end: str, text: str) -> tuple:
    """(the source text from ``start`` up to ``end``, ``text``): a
    replacement of a whole region."""
    src = Path(SOURCE).read_text()
    return (src[src.index(start):src.index(end)], text)


# name -> [(text in the source, its replacement)]
VARIANTS = {
    "base": [],
    # 64-row slices: 2 x 2 blocks a stripe at bm = 128
    "rows64": [(_ROWS, "constexpr int kSliceRows = 64;")],
    # 32 k-columns a block: 4 blocks a stripe; 128: one block a stripe (the
    # mapping this kernel replaced)
    "part32": [(_PART, "constexpr int kPartK = 32;")],
    "part128": [(_PART, "constexpr int kPartK = 128;")],
    "stages2": [(_STAGES, "constexpr int kStages = 2;")],
    "stages4": [(_STAGES, "constexpr int kStages = 4;")],
    "warps2": [(_WARPS, "constexpr int kTargetWarps = 2;")],
    "warps8": [(_WARPS, "constexpr int kTargetWarps = 8;")],
    # 8 columns a thread at every G (not 16 where G allows it)
    "cw8": [("constexpr int kMaxCols = 16;", "constexpr int kMaxCols = 8;")],
    # at most 2 rows a thread
    "rt2": [("for (int rt = 4; rt > 1;", "for (int rt = 2; rt > 1;")],
    "unroll4": [(_UNROLL, "#pragma unroll 4\n  for (int k = 4 * kg;")],
    # the copy route: 16-byte cp.async pieces from every thread into padded
    # S rows (3 stages or fewer)
    "cp_async": [
        _between(_RING_START, _RING_END, _CP_ASYNC_RING),
        # the copy loops' registers: the 4 x 16 tile at 168, 3 blocks an SM
        ("__launch_bounds__(kMaxThreads)",
         "__launch_bounds__(RT * CW == 64 ? 128 : kMaxThreads, "
         "RT * CW == 64 ? 3 : 1)"),
        ("  p.stage_floats = (p.rows * p.kc + p.kc * gp",
         "  p.stage_floats = (p.rows * (p.kc + 4) + p.kc * gp"),
        (_S_READ, """      const float4 v = *reinterpret_cast<const float4*>(
          sb + 4 * ((rp + i * p.pairs) * (p.kc + 4) + k));
"""),
        ("      const float* x_sm = s_sm + p.rows * p.kc;",
         "      const float* x_sm = s_sm + p.rows * (p.kc + 4);"),
        ("  r.cols = cols + (size_t)stripe * width;",
         "  r.cols = cols + (size_t)stripe * width;\n"
         "  r.vals = vals + ((size_t)stripe * width * bm + row0) * bk + r.k0;")],
    # diagnostics (wrong results)
    "diag_noproduct": [(_PRODUCT, "      if (false)\n        product<RT, CW>(")],
    # only the ring's first fill is copied; later waits return at once
    "diag_nocopy": [
        (_COPY_IF, "  if (r.fill_j < r.width && threadIdx.x == 0 &&\n"
                   "      r.fill_j * r.chunks + r.fill_h < r.stages - 1) {\n"),
        (_Q, _Q + "  if (q >= r.stages - 1) return;\n")],
    # no loads of X (the product reads a value made from k) / of S
    "diag_nox": [("        const float4 lo = xc[(k + kk) * ld4 + 2 * b];\n        const float4 hi = xc[(k + kk) * ld4 + 2 * b + 1];\n",
                  "        const float4 lo = make_float4(k, kk, k + 1, b);\n        const float4 hi = make_float4(kk, k, 3, k + b);\n")],
    "diag_nos": [(_S_READ, "      const float4 v = make_float4(k + i, i, k, 1);\n")],
    "diag_nocheck": [("    if (col) {\n      const float4 e", "    if (false) {\n      const float4 e")],
    "diag_nosync": [(_WAIT, "__device__ __forceinline__ void wait_stage(const Ring& r) {\n")],
}
# variants whose outputs must equal the base's bit for bit
SAME_ASSOCIATION = {"stages2", "stages4", "unroll4", "cp_async"}

MAIN = r"""
#include <cstdio>
#include <vector>
// fills with a hash of the index: the same operands in every variant
__global__ void fill(float* p, size_t n, unsigned seed, float scale) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    unsigned x = (unsigned)i * 2654435761u ^ seed;
    x ^= x >> 13; x *= 0x5bd1e995u; x ^= x >> 15;
    p[i] = ((x & 0xffffff) / 16777216.0f - 0.5f) * scale;
  }
}
int main(int argc, char** argv) {
  const int shapes[][4] = {SHAPES};
  for (const auto& sh : shapes) {
    const int nbm = sh[0], width = sh[1], bm = sh[2], gp = sh[3];
    const size_t k = (size_t)nbm * bm;
    std::vector<int> hc((size_t)nbm * width);
    for (size_t i = 0; i < hc.size(); ++i)
      hc[i] = (int)(((unsigned)i * 2654435761u >> 7) % (unsigned)nbm);
    int* cols;
    float *vals, *x, *xr, *out, *sums, *ex;
    cudaMalloc(&cols, hc.size() * 4);
    cudaMemcpy(cols, hc.data(), hc.size() * 4, cudaMemcpyHostToDevice);
    cudaMalloc(&vals, (size_t)nbm * width * bm * bm * 4);
    cudaMalloc(&x, k * gp * 4);
    cudaMalloc(&xr, k * 4);
    cudaMalloc(&out, k * gp * 4);
    cudaMalloc(&sums, nbm * 4);
    cudaMalloc(&ex, k * 4);
    fill<<<1024, 256>>>(vals, (size_t)nbm * width * bm * bm, 1, 0.02f);
    fill<<<256, 256>>>(x, k * gp, 2, 2.f);
    fill<<<64, 256>>>(xr, k, 3, 2.f);
    auto launch = [&] {
      return spmm_abft_launch(cols, vals, x, xr, out, sums, ex, nbm, width,
                              bm, bm, gp, -1, -1, 0.f, nullptr);
    };
    int err = launch() | launch();
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    const int reps = 20;
    cudaEventRecord(e0);
    for (int r = 0; r < reps; ++r) err |= launch();
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, e0, e1);
    err |= (int)cudaGetLastError();
    std::vector<float> h(k * gp + nbm + k);
    cudaMemcpy(h.data(), out, k * gp * 4, cudaMemcpyDeviceToHost);
    cudaMemcpy(h.data() + k * gp, sums, nbm * 4, cudaMemcpyDeviceToHost);
    cudaMemcpy(h.data() + k * gp + nbm, ex, k * 4, cudaMemcpyDeviceToHost);
    char path[512];
    snprintf(path, sizeof path, "%s_%d_%d_%d_%d.bin", argv[1], nbm, width,
             bm, gp);
    FILE* f = fopen(path, "wb");
    fwrite(h.data(), 4, h.size(), f);
    fclose(f);
    printf("%d %d %d %d %.6f %d\n", nbm, width, bm, gp, ms / reps, err);
    cudaFree(cols); cudaFree(vals); cudaFree(x); cudaFree(xr); cudaFree(out);
    cudaFree(sums); cudaFree(ex);
  }
  return 0;
}
"""


def parse_registers(log: str) -> dict:
    """Registers and spill stores of each kernel instance (rows x columns a
    thread holds)."""
    regs, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"spmm_ring_kernelILi(\d+)ELi(\d+)E", line)
        if "Compiling entry function" in line and m:
            entry = f"{m.group(1)}x{m.group(2)}"
        elif entry and "spill stores" in line:
            regs[entry + "_spill_stores"] = int(
                line.split("bytes spill stores")[0].split(",")[-1])
        elif entry and "Used" in line:
            regs[entry] = int(line.split("Used")[1].split()[0])
            entry = None
    return regs


def describe(dims, ms: float) -> dict:
    """A shape's time and the rate at which it streams S."""
    nbm, width, bm, _gp = map(int, dims)
    return dict(ms=ms, s_gb_per_s=nbm * width * bm * bm * 4 / ms / 1e6)


def main() -> int:
    return _variants.run(sys.argv[1:], source=SOURCE, variants=VARIANTS,
                         main=MAIN, shapes=SHAPES, out=OUT,
                         parse_registers=parse_registers,
                         same_association=SAME_ASSOCIATION,
                         describe=describe)


if __name__ == "__main__":
    sys.exit(main())
