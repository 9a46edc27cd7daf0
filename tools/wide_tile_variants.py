#!/usr/bin/env python3
"""Variants of B4's wide (M > 16) tile, built and timed side by side on one
NVIDIA GPU.

    python3 tools/wide_tile_variants.py                # every variant
    python3 tools/wide_tile_variants.py base acc_smem  # some of them

Each variant is ``src/repro_torch/kernels/csrc/matmul_abft.cu`` with a few
lines replaced (every replaced text must be found, or the script stops), plus
a small ``main`` that calls ``matmul_abft_launch`` at gemma-2b's four prefill
shapes (f32, M = 1024).  The variants are compiled in parallel with ``nvcc``
for ``sm_90a`` into ``build/wide_tile_variants/`` and run in turns, twice;
each line gives the mean of 20 back-to-back launches (CUDA events, after 2
warm-up launches).  Every variant keeps the association, so its C must equal
the base's bit for bit, which the script checks — except the ``diag_*``
variants, which drop work to show where the time goes and compute wrong
results.  Prints one JSON object per run and variant, then the card's name
and power limit (the harness: ``tools/_variants.py``).
"""
from __future__ import annotations

import os
import sys

import _variants

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                      "matmul_abft.cu")
OUT = os.path.join(ROOT, "build", "wide_tile_variants")
SHAPES = ((1024, 2048, 16384), (1024, 16384, 2048), (1024, 2048, 2048),
          (1024, 2048, 256))

_ACC_INIT = """  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float ex = 0.f;
"""
_ACC_ADD = """#pragma unroll
      for (int i = 0; i < S; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
"""
_LOOP_END = """  cp_async_wait<0>();                // no copy outlives the block

  // C in the operand dtype"""
_SMEM = """  return kStages * WideStage<T, BM, TRANS>::BYTES +
         WideStage<T, BM, TRANS>::KM_BYTES;"""
_KQ = """#pragma unroll
      for (int kq = 0; kq < kBK; kq += 4) {
        float a[S][4];"""
_A_FRAG = """#pragma unroll
      for (int kq = 0; kq < kBK; kq += 4) {
        float a[S][4];
#pragma unroll
        for (int i = 0; i < S; ++i) load4(as + (ty + 16 * i) * LDK + kq, a[i]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {"""
_B_FRAG = """            load4(bs + (kq + kk) * kWideN + 4 * tx, b);
            load4(bs + (kq + kk) * kWideN + 64 + 4 * tx, b + 4);"""
_BLOCK = """  const int ni = blockIdx.x, mi = blockIdx.y;"""
_LAYOUT = """  const int tx = (warp & 1) * 8 + (lane & 7);
  const int ty = (warp >> 1) * 4 + (lane >> 3);"""
_REFILL = """    if (next < chunks) fetch(next % kStages, next * kBK);"""
_BARRIER = """    cp_async_wait<kStages - 2>();  // this thread's copies of chunk c
    __syncthreads();                   // everyone's; chunk c - 1 is read"""

# name -> [(text in the source, its replacement)]
VARIANTS = {
    "base": [],
    # the accumulator in shared memory (64 KB more), 64 registers freed
    "acc_smem": [
        (_ACC_INIT, """  float4* acc_s = reinterpret_cast<float4*>(
      wide_smem + kStages * St::BYTES + St::KM_BYTES);
#pragma unroll
  for (int q = 0; q < 2 * TM; ++q)
    acc_s[q * kThreads + t] = make_float4(0.f, 0.f, 0.f, 0.f);
  float ex = 0.f;
"""),
        (_ACC_ADD, """#pragma unroll
      for (int i = 0; i < S; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float4 v = acc_s[(2 * i + h) * kThreads + t];
          v.x = __fadd_rn(v.x, part[i][4 * h]);
          v.y = __fadd_rn(v.y, part[i][4 * h + 1]);
          v.z = __fadd_rn(v.z, part[i][4 * h + 2]);
          v.w = __fadd_rn(v.w, part[i][4 * h + 3]);
          acc_s[(2 * i + h) * kThreads + t] = v;
        }
"""),
        (_LOOP_END, """  cp_async_wait<0>();
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = acc_s[(2 * i + h) * kThreads + t];
      acc[i][4 * h] = v.x;
      acc[i][4 * h + 1] = v.y;
      acc[i][4 * h + 2] = v.z;
      acc[i][4 * h + 3] = v.w;
    }

  // C in the operand dtype"""),
        (_SMEM, _SMEM[:-1] + " + BM * kWideN * 4;")],
    # a 64 x 128 block tile (4 x 8 outputs a thread) for every shape
    "bm64": [("constexpr int kWideM = 128;", "constexpr int kWideM = 64;")],
    # blocks walk 8 row tiles before the next column tile (L2 reuse of B)
    "swizzle8": [(_BLOCK, """  const int gx = gridDim.x, gy = gridDim.y;
  const int bid = blockIdx.y * gx + blockIdx.x;
  const int first = bid / (8 * gx) * 8;
  const int band = min(gy - first, 8);
  const int mi = first + (bid % (8 * gx)) % band;
  const int ni = (bid % (8 * gx)) / band;""")],
    # a warp spans 8 row groups x 4 column groups (not 4 x 8)
    "warp8x4": [(_LAYOUT, """  const int tx = (warp & 3) * 4 + (lane & 3);
  const int ty = (warp >> 2) * 8 + (lane >> 2);""")],
    # A's fragments two k at a time (8-byte loads, half the registers)
    "a_pairs": [(_A_FRAG, """#pragma unroll
      for (int kq = 0; kq < kBK; kq += 2) {
        float a[S][2];
#pragma unroll
        for (int i = 0; i < S; ++i) {
          const float2 v = *reinterpret_cast<const float2*>(
              as + (ty + 16 * i) * LDK + kq);
          a[i][0] = v.x;
          a[i][1] = v.y;
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {""")],
    # the 4-k steps of a chunk not unrolled (1) or unrolled by 2
    "unroll1": [(_KQ, _KQ.replace("#pragma unroll\n", "#pragma unroll 1\n", 1))],
    "unroll2": [(_KQ, _KQ.replace("#pragma unroll\n", "#pragma unroll 2\n", 1))],
    # a 4-stage ring (both paths': only the wide one is timed here)
    "stages4": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    # diagnostics (wrong results): no refill of the ring after its first
    # chunks (the copy pipeline's cost); no refill and no barrier (the
    # compute ceiling); B's fragments read once per 4 k (fewer shared loads)
    "diag_norefill": [(_REFILL, "")],
    "diag_compute": [(_REFILL, ""), (_BARRIER, "")],
    "diag_b_once": [(_B_FRAG, """            if (kk == 0) {
              load4(bs + kq * kWideN + 4 * tx, b);
              load4(bs + kq * kWideN + 64 + 4 * tx, b + 4);
            }""")],
}

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
  const int shapes[][3] = {SHAPES};
  for (const auto& sh : shapes) {
    const int m = sh[0], k = sh[1], n = sh[2];
    float *a, *b, *br, *c, *sums, *ex;
    cudaMalloc(&a, (size_t)m * k * 4);
    cudaMalloc(&b, (size_t)k * n * 4);
    cudaMalloc(&br, (size_t)k * 4);
    cudaMalloc(&c, (size_t)m * n * 4);
    cudaMalloc(&sums, (size_t)((m + 63) / 64) * ((n + 127) / 128) * 4);
    cudaMalloc(&ex, (size_t)m * 4);
    fill<<<1024, 256>>>(a, (size_t)m * k, 1, 2.f);
    fill<<<1024, 256>>>(b, (size_t)k * n, 2, 0.05f);
    fill<<<64, 256>>>(br, k, 3, 1.f);
    auto launch = [&] {
      return matmul_abft_launch(a, b, br, c, sums, ex, nullptr, m, n, k, 0,
                                0, nullptr);
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
    std::vector<float> h((size_t)m * n);
    cudaMemcpy(h.data(), c, h.size() * 4, cudaMemcpyDeviceToHost);
    char path[512];
    snprintf(path, sizeof path, "%s_%d_%d_%d.bin", argv[1], m, k, n);
    FILE* f = fopen(path, "wb");
    fwrite(h.data(), 4, h.size(), f);
    fclose(f);
    printf("%d %d %d %.6f %d\n", m, k, n, ms / reps, err);
    cudaFree(a); cudaFree(b); cudaFree(br); cudaFree(c); cudaFree(sums);
    cudaFree(ex);
  }
  return 0;
}
"""


def parse_registers(log: str):
    """Registers of the f32, B (not B^T) instance."""
    regs, entry = None, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = "wide_kernelIfLi" in line and "ELb0E" in line
        elif entry and "Used" in line:
            regs = int(line.split("Used")[1].split()[0])
            entry = False
    return regs


def main() -> int:
    return _variants.run(sys.argv[1:], source=SOURCE, variants=VARIANTS,
                         main=MAIN, shapes=SHAPES, out=OUT,
                         parse_registers=parse_registers)


if __name__ == "__main__":
    sys.exit(main())
