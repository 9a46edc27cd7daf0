#!/usr/bin/env python3
"""Variants of B4's wide Bᵀ path (``wide_kernel<float, 128, true, false>``),
built and timed side by side on one NVIDIA GPU.

    python3 tools/bt_variants.py                # every variant
    python3 tools/bt_variants.py base pipe      # some of them

Each variant is ``src/repro_torch/kernels/csrc/matmul_abft.cu`` with a few
lines replaced (every replaced text must be found, or the script stops),
plus a small ``main`` that calls ``matmul_abft_launch`` with ``trans_b`` at
a gemma-2b train step's four dA shapes (dC [1024, N] times B [K, N] as it
lies, unchecked) and its tied head's forward (x [1024, 2048] times the
table [256000, 2048], with ``b_r``), f32.  The variants are compiled in
parallel with ``nvcc`` for ``sm_90a`` into ``build/bt_variants/`` and run
in turns, twice; each line gives the mean of 20 back-to-back launches (CUDA
events, after 2 warm-up launches).  Every variant keeps the association, so
its C must equal the base's bit for bit, which the script checks.  Prints
one JSON object per run and variant, then the card's name and power limit
(the harness: ``tools/_variants.py``).

The base transposes chunk c of the Bᵀ stage into the k-major buffer after
the chunk's barrier and waits at a second barrier before multiplying it.
``pipe`` keeps two k-major buffers and transposes chunk c + 1 while chunk c
is multiplied, so one barrier a chunk covers both; chunk c + 1 must then
have landed at chunk c's barrier, which leaves one chunk's compute to hide
the copy of chunk c + 2 (the base: two).  ``pipe4`` adds a fourth ring
stage to win that chunk back (to both paths' ring: only Bᵀ is timed here).
"""
from __future__ import annotations

import os
import sys

import _variants

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                      "matmul_abft.cu")
OUT = os.path.join(ROOT, "build", "bt_variants")
# (M, K, N, checked): dA = dC [M, K] · Bᵀ with B [N, K] as it lies — the
# q/o, k/v, gate/up and down products' dA — and the tied head's forward
SHAPES = ((1024, 2048, 2048, 0), (1024, 256, 2048, 0),
          (1024, 16384, 2048, 0), (1024, 2048, 16384, 0),
          (1024, 2048, 256000, 1))

_KM = ("  static constexpr int KM_BYTES = TRANS ? kBK * kWideN * (int)sizeof(T) "
       ": 0;")
_LOOP = """  for (int c = 0; c < chunks; ++c) {
    const int st = c % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk c
    __syncthreads();                   // everyone's; chunk c - 1 is read
    const int next = c + kStages - 1;
    if (next < chunks) fetch(next % kStages, next * kBK);
    cp_async_commit();
    if constexpr (TRANS) {   // the barrier above: chunk c - 1 read km
      const int tk = 4 * (t % 8), tn = 4 * (t / 8);   // this thread's block
      transpose4x4(stage_b(st) + tn * LDK + tk, LDK,
                   km + tk * kWideN + 4 * km_group<V>(tk, tn / 4), kWideN);
      __syncthreads();
    }

    const T* as = stage_a(st);
    const T* bs = TRANS ? km : stage_b(st);"""
_PIPE_LOOP = """  const int tk = 4 * (t % 8), tn = 4 * (t / 8);   // this thread's block
  auto to_km = [&](int ch) {     // chunk ch's k-major copy, buffer ch % 2
    transpose4x4(stage_b(ch % kStages) + tn * LDK + tk, LDK,
                 km + (ch & 1) * kBK * kWideN + tk * kWideN +
                     4 * km_group<V>(tk, tn / 4),
                 kWideN);
  };
  if constexpr (TRANS) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    to_km(0);
  }
  for (int c = 0; c < chunks; ++c) {
    const int st = c % kStages;
    if constexpr (TRANS)
      cp_async_wait<kStages - 3>();  // chunks c and c + 1
    else
      cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = c + kStages - 1;
    if (next < chunks) fetch(next % kStages, next * kBK);
    cp_async_commit();
    if constexpr (TRANS) {
      if (c + 1 < chunks) to_km(c + 1);
    }

    const T* as = stage_a(st);
    const T* bs = TRANS ? km + (c & 1) * kBK * kWideN : stage_b(st);"""

# name -> [(text in the source, its replacement)]
VARIANTS = {
    "base": [],
    "pipe": [(_KM, _KM.replace("TRANS ? kBK", "TRANS ? 2 * kBK")),
             (_LOOP, _PIPE_LOOP)],
    "pipe4": [(_KM, _KM.replace("TRANS ? kBK", "TRANS ? 2 * kBK")),
              (_LOOP, _PIPE_LOOP),
              ("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
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
  const int shapes[][4] = {SHAPES};
  for (const auto& sh : shapes) {
    const int m = sh[0], k = sh[1], n = sh[2], checked = sh[3];
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
      return matmul_abft_launch(a, b, checked ? br : nullptr, c, sums,
                                checked ? ex : nullptr, nullptr, m, n, k, 1,
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
    // C, every block sum and (checked) every extra entry
    const size_t nc = (size_t)m * n;
    const size_t ns = (size_t)((m + 63) / 64) * ((n + 127) / 128);
    std::vector<float> h(nc + ns + m);
    cudaMemcpy(h.data(), c, nc * 4, cudaMemcpyDeviceToHost);
    cudaMemcpy(h.data() + nc, sums, ns * 4, cudaMemcpyDeviceToHost);
    if (checked) cudaMemcpy(h.data() + nc + ns, ex, m * 4,
                            cudaMemcpyDeviceToHost);
    char path[512];
    snprintf(path, sizeof path, "%s_%d_%d_%d_%d.bin", argv[1], m, k, n,
             checked);
    FILE* f = fopen(path, "wb");
    fwrite(h.data(), 4, h.size(), f);
    fclose(f);
    printf("%d %d %d %d %.6f %d\n", m, k, n, checked, ms / reps, err);
    cudaFree(a); cudaFree(b); cudaFree(br); cudaFree(c); cudaFree(sums);
    cudaFree(ex);
  }
  return 0;
}
"""


def parse_registers(log: str):
    """Registers of the f32 Bᵀ instance (not counted)."""
    regs, entry = None, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = "wide_kernelIfLi" in line and "ELb1ELb0E" in line
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
