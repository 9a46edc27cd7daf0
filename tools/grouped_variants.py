#!/usr/bin/env python3
"""Variants of B4's grouped launch with per-group row counts, built and
timed side by side on one NVIDIA GPU.

    python3 tools/grouped_variants.py               # every variant
    python3 tools/grouped_variants.py base tile64   # some of them

Each variant is ``src/repro_torch/kernels/csrc/matmul_abft.cu`` with a few
lines replaced (every replaced text must be found, or the script stops),
plus a small ``main`` that calls ``matmul_abft_grouped_launch`` (f32, with
``b_r``) at the MoE models' served prefill expert shapes: deepseek-moe-16b
64 × [120, 2048] @ [2048, 1408] (up/gate) and [120, 1408] @ [1408, 2048]
(down), qwen3-moe-30b-a3b 128 × [80, 2048] @ [2048, 768] and
[80, 768] @ [768, 2048] — each with row counts (``counted`` 1: the tokens
× top-k assignments of a 1024-token prefill dealt to the experts by a hash
of their index, each count capped at the capacity) and without (0).  The
variants are compiled in parallel with ``nvcc`` for ``sm_90a`` into
``build/grouped_variants/`` and run in turns, twice; each line gives the
mean of 20 back-to-back launches (CUDA events, after 2 warm-up launches)
and the counted launches' live rows.  Every variant keeps the association,
so its C, block sums and extra column must equal the base's bit for bit,
which the script checks.  Prints one JSON object per run and variant, then
the card's name and power limit (the harness: ``tools/_variants.py``).

The base skips a 128-row block's 16-row steps past its group's count; the
variants give a counted launch a 64-row block tile (two blocks an SM),
without the step skip (``tile64``) and with it (``tile64_steps``).
"""
from __future__ import annotations

import os
import sys

import _variants

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                      "matmul_abft.cu")
OUT = os.path.join(ROOT, "build", "grouped_variants")
# (G, M, K, N, tokens, top-k)
SHAPES = ((64, 120, 2048, 1408, 1024, 6), (64, 120, 1408, 2048, 1024, 6),
          (128, 80, 2048, 768, 1024, 8), (128, 80, 768, 2048, 1024, 8))

_COUNTED = "launch_wide<T, kWideM, false, true>("
_TILE64 = [
    (_COUNTED, "launch_wide<T, 64, false, true>("),
    ("""__global__ void __launch_bounds__(kThreads, 1)
wide_kernel(""", """__global__ void __launch_bounds__(kThreads, BM == 64 ? 2 : 1)
wide_kernel(""")]
_STEPS = "  const int steps = COUNTED ? min(TM, (mg - m0 + 15) / 16) : TM;"

# name -> [(text in the source, its replacement)]
VARIANTS = {
    "base": [],
    # a 64-row block tile for counted launches, every step multiplied
    "tile64": _TILE64 + [(_STEPS, "  const int steps = TM;")],
    # a 64-row block tile for counted launches, steps past the count skipped
    "tile64_steps": list(_TILE64),
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
  const int shapes[][6] = {SHAPES};
  for (const auto& sh : shapes) {
    const int g = sh[0], m = sh[1], k = sh[2], n = sh[3];
    // the assignments dealt to the experts by a hash, capped at m
    std::vector<int> counts(g, 0);
    for (int i = 0; i < sh[4] * sh[5]; ++i) {
      unsigned x = (unsigned)i * 2654435761u ^ 0x9e3779b9u;
      x ^= x >> 15; x *= 0x2c1b3c6du; x ^= x >> 12;
      counts[x % g] += 1;
    }
    long live = 0;
    for (int& c : counts) { c = c < m ? c : m; live += c; }
    const size_t nsum = (size_t)g * ((m + 63) / 64) * ((n + 127) / 128);
    float *a, *b, *br, *out;
    int* rows;
    cudaMalloc(&a, (size_t)g * m * k * 4);
    cudaMalloc(&b, (size_t)g * k * n * 4);
    cudaMalloc(&br, (size_t)g * k * 4);
    const size_t nout = (size_t)g * m * n + nsum + (size_t)g * m;
    cudaMalloc(&out, nout * 4);
    cudaMalloc(&rows, g * 4);
    cudaMemcpy(rows, counts.data(), g * 4, cudaMemcpyHostToDevice);
    fill<<<1024, 256>>>(a, (size_t)g * m * k, 1, 2.f);
    fill<<<1024, 256>>>(b, (size_t)g * k * n, 2, 0.05f);
    fill<<<64, 256>>>(br, (size_t)g * k, 3, 1.f);
    float* c = out;
    float* sums = c + (size_t)g * m * n;
    float* ex = sums + nsum;
    for (int counted = 1; counted >= 0; --counted) {
      auto launch = [&] {
        return matmul_abft_grouped_launch(a, b, br, c, sums, ex, nullptr,
                                          counted ? rows : nullptr, g, m, n,
                                          k, 0, 0, nullptr);
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
      std::vector<float> h(nout);
      cudaMemcpy(h.data(), out, nout * 4, cudaMemcpyDeviceToHost);
      char path[512];
      snprintf(path, sizeof path, "%s_%d_%d_%d_%d_%d.bin", argv[1], g, m, k,
               n, counted);
      FILE* f = fopen(path, "wb");
      fwrite(h.data(), 4, h.size(), f);
      fclose(f);
      printf("%d %d %d %d %d %.6f %d\n", g, m, k, n, counted, ms / reps,
             err);
      fprintf(stderr, "%d %d %d %d live rows %ld of %ld\n", g, m, k, n, live,
              (long)g * m);
    }
    cudaFree(a); cudaFree(b); cudaFree(br); cudaFree(out); cudaFree(rows);
  }
  return 0;
}
"""


def parse_registers(log: str):
    """Registers of each f32 wide_kernel instance, by its mangled template
    arguments after the dtype (row tile, trans_b, counted)."""
    regs, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = None
            if "wide_kernelIfLi" in line:
                entry = line.split("wide_kernelIfLi")[1].split("EEEv")[0]
        elif entry and "Used" in line:
            regs[entry] = int(line.split("Used")[1].split()[0])
            entry = None
    return regs


def main() -> int:
    return _variants.run(sys.argv[1:], source=SOURCE, variants=VARIANTS,
                         main=MAIN, shapes=SHAPES, out=OUT,
                         parse_registers=parse_registers)


if __name__ == "__main__":
    sys.exit(main())
