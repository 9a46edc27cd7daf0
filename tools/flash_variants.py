#!/usr/bin/env python3
"""Variants of B5 (``flash_checksum``), built and timed side by side on one
NVIDIA GPU.

    python3 tools/flash_variants.py                     # every variant
    python3 tools/flash_variants.py base unroll_d2      # some of them

Each variant is ``src/repro_torch/kernels/csrc/flash_checksum.cu`` with a
few lines replaced (every replaced text must be found, or the script
stops), plus a small ``main`` that calls ``flash_checksum_launch`` in
float32 with the carried column at the served prefill shape — gemma-2b,
B 2, T = S = 512, H 8, Kh 1 (MQA), dh 256 — then at T < S (B 2, T 128,
S 256, H 4, Kh 2, dh 64) and at a ragged T and dh (B 1, T = S = 70, H 4,
Kh 4, dh 16).  Operands are a hash of the index, the same in every variant.
The variants are compiled in parallel with ``nvcc`` for ``sm_90a`` into
``build/flash_variants/`` and run in turns, twice; each line gives the mean
of 20 back-to-back launches (CUDA events, after 2 warm-up launches), the
rate of the causal work in TFLOP/s, and each kernel instance's registers
and spills.  A variant that keeps the association (the grid order,
unrolling, the copy route) must give the base's outputs bit for bit, which
the script checks; one that changes the cut (``parts1``: a query tile's
keys in one block, as before the key parts; ``parts3``; ``bq64``: 64-row
tiles) or the order of the sums (``acc_fma``) reports its
largest difference from the base.  The ``diag_*`` variants drop work to
show where the time goes and compute wrong results: no score product, no
exchange of partial scores between lane groups, no P·V product, no
exponentials or shuffles in the softmax, no copies after the first K and V
tiles.  Prints one JSON object per run and variant, then the card's name
and power limit (the harness: ``tools/_variants.py``).
"""
from __future__ import annotations

import os
import re
import sys

import _variants

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                      "flash_checksum.cu")
OUT = os.path.join(ROOT, "build", "flash_variants")
# (b, t, s, h, kh, dh)
SHAPES = ((2, 512, 512, 8, 1, 256), (2, 128, 256, 4, 2, 64),
          (1, 70, 70, 4, 4, 16))

_ORDER = "const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;"
_PARTS = "constexpr int kParts = 2;"
_UNROLL_D = ("#pragma unroll 1\n"
             "    for (int d = 0; d < DHT; d += 4 * kDGroups) {")
_UNROLL_C = "#pragma unroll 4\n    for (int c = 0; c < kBKey; ++c) {"
_SHFL = "      for (int off = 1; off < kKeyLanes; off <<= 1)"
_FETCH = "#pragma unroll 2\n  for (int e = 0; e < ROWS * PR / kThreads; ++e) {"
_PV0 = """    float pv[RT][8];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) pv[i][j] = 0.f;"""
_ACC_FMA = [(_PV0, """    float (&pv)[RT][8] = acc;
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        pv[i][j] = __fmul_rn(acc[i][j], rowc[rg * RT + i]);"""),
            ("        acc[i][j] = __fadd_rn(__fmul_rn(acc[i][j], corr), "
             "pv[i][j]);", "        (void)corr;")]

# name -> [(text in the source, its replacement)]
VARIANTS = {
    "base": [],
    # one part a query tile (no key split, no cluster); three parts
    "parts1": [(_PARTS, "constexpr int kParts = 1;")],
    "parts3": [(_PARTS, "constexpr int kParts = 3;")],
    # the query tiles in index order (lightest first under the mask)
    "order_natural": [(_ORDER, "const int qt = blockIdx.y;")],
    # 64 query rows and 256 threads a block: one block an SM at dh 256
    "bq64": [("constexpr int kBQ = 32;", "constexpr int kBQ = 64;"),
             ("constexpr int kThreads = 128;",
              "constexpr int kThreads = 256;"),
             ("__launch_bounds__(kThreads, 2)",
              "__launch_bounds__(kThreads, 1)")],
    # another association: p·v added into the rescaled accumulator (no
    # separate partial: 64 registers fewer)
    "acc_fma": _ACC_FMA,
    # the tile copies as a loop (no piece offsets held across the key loop)
    "fetch_u1": [(_FETCH, _FETCH.replace("unroll 2", "unroll 1"))],
    "unroll_d2": [(_UNROLL_D, _UNROLL_D.replace("unroll 1", "unroll 2"))],
    "unroll_c2": [(_UNROLL_C, _UNROLL_C.replace("unroll 4", "unroll 2"))],
    # every tile copied element by element through registers (the route of
    # a dh whose rows are not whole 16-byte pieces)
    "sync_copy": [("  const int vec = (dh * (int)sizeof(T)) % 16 == 0;",
                   "  const int vec = 0;")],
    # diagnostics (wrong results)
    "diag_noscore": [(_UNROLL_D, _UNROLL_D.replace("d < DHT", "d < 0"))],
    # the partial scores not exchanged between the lane groups
    "diag_noreduce": [
        ("keep + __shfl_xor_sync(0xffffffffu, give, 16);", "keep + give;"),
        ("keep + __shfl_xor_sync(0xffffffffu, give, 8);", "keep + give;"),
        ("keep + __shfl_xor_sync(0xffffffffu, give, 4);", "keep + give;")],
    "diag_nopv": [(_UNROLL_C, _UNROLL_C.replace("c < kBKey", "c < 0"))],
    "diag_nosoftmax": [
        ("      const float corr = expf(m_i - m_new);",
         "      const float corr = 1.f;"),
        ("valid[j] ? expf(sc[j] - m_new) : 0.f",
         "valid[j] ? sc[j] : 0.f"),
        (_SHFL, "      for (int off = kKeyLanes; off < kKeyLanes; off <<= 1)"),
        (_SHFL, "      for (int off = kKeyLanes; off < kKeyLanes; off <<= 1)")],
    # only q and the first K and V tiles are copied
    "diag_nocopy": [
        ("    fetch_tile<T, kBKey, DHT>(vs, DHT,",
         "    if (step == first) fetch_tile<T, kBKey, DHT>(vs, DHT,"),
        ("    if (step + 1 < steps) {", "    if (false) {")],
}
# variants whose outputs must equal the base's bit for bit
SAME_ASSOCIATION = {"order_natural", "fetch_u1", "unroll_d2", "unroll_c2",
                    "sync_copy"}

MAIN = r"""
#include <cmath>
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
    const int b = sh[0], t = sh[1], s = sh[2], h = sh[3], kh = sh[4],
              dh = sh[5];
    const size_t nq = (size_t)b * t * h * dh, nk = (size_t)b * s * kh * dh,
                 nr = (size_t)b * s * h, ne = (size_t)b * t * h;
    float *q, *k, *v, *vr, *o, *ex;
    cudaMalloc(&q, nq * 4);
    cudaMalloc(&k, nk * 4);
    cudaMalloc(&v, nk * 4);
    cudaMalloc(&vr, nr * 4);
    cudaMalloc(&o, nq * 4);
    cudaMalloc(&ex, ne * 4);
    fill<<<256, 256>>>(q, nq, 1, 2.f);
    fill<<<256, 256>>>(k, nk, 2, 2.f);
    fill<<<256, 256>>>(v, nk, 3, 2.f);
    fill<<<64, 256>>>(vr, nr, 4, 2.f);
    const float scale = 1.f / sqrtf((float)dh);
    auto launch = [&] {
      return flash_checksum_launch(q, k, v, vr, o, ex, b, t, s, h, kh, dh,
                                   scale, 1, 0, nullptr);
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
    std::vector<float> hst(nq + ne);
    cudaMemcpy(hst.data(), o, nq * 4, cudaMemcpyDeviceToHost);
    cudaMemcpy(hst.data() + nq, ex, ne * 4, cudaMemcpyDeviceToHost);
    char path[512];
    snprintf(path, sizeof path, "%s_%d_%d_%d_%d_%d_%d.bin", argv[1], b, t, s,
             h, kh, dh);
    FILE* f = fopen(path, "wb");
    fwrite(hst.data(), 4, hst.size(), f);
    fclose(f);
    printf("%d %d %d %d %d %d %.6f %d\n", b, t, s, h, kh, dh, ms / reps, err);
    cudaFree(q); cudaFree(k); cudaFree(v); cudaFree(vr); cudaFree(o);
    cudaFree(ex);
  }
  return 0;
}
"""


def parse_registers(log: str) -> dict:
    """Registers and spill stores of each kernel instance (dtype and head
    tile)."""
    regs, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"flash_checksum_kernelI(f|\w*bfloat16\w*?)Li(\d+)E",
                      line)
        if "Compiling entry function" in line and m:
            entry = ("f32" if m.group(1) == "f" else "bf16") + \
                f"_{m.group(2)}"
        elif entry and "spill stores" in line:
            regs[entry + "_spill_stores"] = int(
                line.split("bytes spill stores")[0].split(",")[-1])
        elif entry and "Used" in line:
            regs[entry] = int(line.split("Used")[1].split()[0])
            entry = None
    return regs


def causal_flops(b: int, t: int, s: int, h: int, dh: int) -> int:
    """The causal pairs' work, as ``chip_smoke.py``'s ``flash_bound``
    counts it: q·k and p·v over dh, p·vr."""
    return b * h * sum(min(i + 1, s) for i in range(t)) * (4 * dh + 2)


def describe(dims, ms: float) -> dict:
    """A shape's time and the rate of its causal work."""
    b, t, s, h, _kh, dh = map(int, dims)
    return dict(ms=ms, tflops=causal_flops(b, t, s, h, dh) / ms / 1e9)


def main() -> int:
    return _variants.run(sys.argv[1:], source=SOURCE, variants=VARIANTS,
                         main=MAIN, shapes=SHAPES, out=OUT,
                         parse_registers=parse_registers,
                         same_association=SAME_ASSOCIATION,
                         describe=describe)


if __name__ == "__main__":
    sys.exit(main())
