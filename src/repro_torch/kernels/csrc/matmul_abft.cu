// Tiled matrix product with the fused ABFT checksum epilogue, for NVIDIA
// Hopper.
//
// Replaces the TPU kernel `matmul_abft_kernel` (`_kernel`) of
// src/repro/kernels/matmul_abft/kernel.py:
//
//   C                  = A @ B                 [M, N]   (A's dtype)
//   block_sums[mi, ni] = Σ of the f32 accumulator over C's tile (mi, ni)
//   extra              = A @ b_r               [M]      (f32; b_r = B·e)
//
// A is [M, K] row-major; B is [K, N] row-major, or (trans_b) its transpose
// stored [N, K] row-major — the tied LM head multiplies by the embedding
// table [V, d] as it lies, so no transposed copy of it (2.1 GB at gemma-2b's
// width, refreshed on every restore) is ever made.  f32 or bf16 operands,
// f32 accumulation.  b_r may be null: then `extra` is not computed (the
// unchecked products of an unguarded step), and C does not change.
//
// What bounds it on this card: at M = 2 (decode steps, the LM head) bytes —
// every element of B is read once for 4 FLOP; at M = 1024 (a 512-token
// prefill of 2 sequences) operations, at the f32 pipes' 67 TFLOP/s, since
// float32 operands are multiplied with FFMA, never TF32 (a TF32 product
// moves the clean check divergence to ~1e-3, the detection threshold).
//
// Design.  One thread block owns one C tile and walks K in 32-wide steps;
// two tile shapes, chosen by the caller from M (`matmul_abft_tile_m/n`):
// 4 x 64 with one output per thread when M <= 16 (no row padding: a decode
// step's M = 2 would waste 32x the arithmetic in a 64-row tile), 64 x 128
// with a 4 x 8 register tile per thread otherwise.  A and B tiles are staged
// through shared memory (one padding float per row: conflict-free stores for
// both B layouts); the next step's tiles are loaded into registers while the
// current one is multiplied.  Each 32-wide K step is summed into a separate
// partial that is then added to the accumulator — the association of the
// plain version (kernel.py), so the card and the CPU agree to ~1e-5 on
// gemma-2b's logits.  Out-of-range rows/columns/depth load as 0 (no padded
// copies).  The tile's block sum reduces in one fixed order (per thread,
// then a warp shuffle tree, then warp by warp), with no atomics, so results
// repeat bit for bit.  The ni == 0 blocks also accumulate A @ b_r, a
// broadcast multiply-reduce over the staged A tile (a [32, 1] column is no
// product for the tensor cores).
//
// What holds it back: no tensor cores (bf16 too runs on the FMA pipes), no
// TMA / cp.async pipeline, few blocks for a narrow N at M = 2 (N = 256 gives
// 4 blocks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 32;        // K step, and the accumulation chunk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmallM = 16;    // M <= this takes the 4 x 64 tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// BM x BN tile per block, TM x TN outputs per thread: thread t owns rows
// t / TPR + RG * i and columns t % TPR + TPR * j, where TPR = BN / TN
// threads share a row group and RG = BM / TM row groups cover the tile.
template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
matmul_abft_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   const float* __restrict__ br, T* __restrict__ C,
                   float* __restrict__ block_sums,
                   float* __restrict__ extra, int M, int N, int K,
                   int trans_b) {
  constexpr int TPR = BN / TN;
  constexpr int RG = BM / TM;
  static_assert(TPR * RG == kThreads, "tile does not match the block");
  constexpr int A_PER = (BM * kBK + kThreads - 1) / kThreads;
  constexpr int B_PER = (kBK * BN) / kThreads;

  __shared__ float As[kBK][BM + 1];
  __shared__ float Bs[kBK][BN + 1];
  __shared__ float brs[kBK];
  __shared__ float red[kWarps];

  const int t = threadIdx.x;
  const int ni = blockIdx.x, mi = blockIdx.y;
  const int m0 = mi * BM, n0 = ni * BN;
  const int tm = t / TPR, tn = t % TPR;
  const bool with_extra = (br != nullptr) && ni == 0;

  float ra[A_PER], rb[B_PER];
  auto load = [&](int k0) {
#pragma unroll
    for (int e = 0; e < A_PER; ++e) {
      const int idx = t + e * kThreads;
      const int m = idx / kBK, kk = idx % kBK;
      float val = 0.f;
      if (idx < BM * kBK && m0 + m < M && k0 + kk < K)
        val = to_f(A[(size_t)(m0 + m) * K + k0 + kk]);
      ra[e] = val;
    }
#pragma unroll
    for (int e = 0; e < B_PER; ++e) {
      const int idx = t + e * kThreads;
      float val = 0.f;
      if (trans_b) {          // B^T [N, K]: consecutive threads walk k
        const int n = idx / kBK, kk = idx % kBK;
        if (n0 + n < N && k0 + kk < K)
          val = to_f(B[(size_t)(n0 + n) * K + k0 + kk]);
      } else {                // B [K, N]: consecutive threads walk n
        const int kk = idx / BN, n = idx % BN;
        if (n0 + n < N && k0 + kk < K)
          val = to_f(B[(size_t)(k0 + kk) * N + n0 + n]);
      }
      rb[e] = val;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int e = 0; e < A_PER; ++e) {
      const int idx = t + e * kThreads;
      if (idx < BM * kBK) As[idx % kBK][idx / kBK] = ra[e];
    }
#pragma unroll
    for (int e = 0; e < B_PER; ++e) {
      const int idx = t + e * kThreads;
      if (trans_b) Bs[idx % kBK][idx / kBK] = rb[e];
      else Bs[idx / BN][idx % BN] = rb[e];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float ex = 0.f;

  load(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();                 // the previous step's tiles are read
    store();
    if (with_extra && t < kBK)
      brs[t] = (k0 + t < K) ? br[k0 + t] : 0.f;
    __syncthreads();
    if (k0 + kBK < K) load(k0 + kBK);   // in flight while this step runs

    float part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][tm + RG * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tn + TPR * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);

    if (with_extra && t < BM) {
      float p = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) p = fmaf(As[kk][t], brs[kk], p);
      ex = __fadd_rn(ex, p);
    }
  }

  // epilogue: C in the operand dtype, the tile's f32 sum, the extra column
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm + RG * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn + TPR * j;
      s += acc[i][j];                // out-of-range entries are exactly 0
      if (m < M && n < N) C[(size_t)m * N + n] = from_f<T>(acc[i][j]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if ((t & 31) == 0) red[t >> 5] = s;
  __syncthreads();
  if (t == 0) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tot += red[w];
    block_sums[(size_t)mi * gridDim.x + ni] = tot;
  }
  if (with_extra && t < BM && m0 + t < M) extra[m0 + t] = ex;
}

template <typename T>
int launch_typed(const void* a, const void* b, const float* br, void* c,
                 float* sums, float* extra, int m, int n, int k, int trans_b,
                 cudaStream_t stream) {
  if (m <= kSmallM) {
    dim3 grid((n + 63) / 64, (m + 3) / 4);
    matmul_abft_kernel<T, 4, 64, 1, 1><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), br,
        static_cast<T*>(c), sums, extra, m, n, k, trans_b);
  } else {
    dim3 grid((n + 127) / 128, (m + 63) / 64);
    matmul_abft_kernel<T, 64, 128, 4, 8><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), br,
        static_cast<T*>(c), sums, extra, m, n, k, trans_b);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The C tile one block owns for an M-row product (rows, then columns);
// analysis/vmem.py `matmul_tile` states the same and the wrapper checks it.
extern "C" int matmul_abft_tile_m(int m) { return m <= kSmallM ? 4 : 64; }
extern "C" int matmul_abft_tile_n(int m) { return m <= kSmallM ? 64 : 128; }

// Launch on `stream`; allocates nothing, does not synchronise, returns
// cudaGetLastError() (0 on success).  dtype 0 = float32, 1 = bfloat16 (A, B
// and C); br/extra f32 and both null for an unchecked product; sums
// [ceil(M/tm), ceil(N/tn)] f32.
extern "C" int matmul_abft_launch(const void* a, const void* b,
                                  const float* br, void* c, float* sums,
                                  float* extra, int m, int n, int k,
                                  int trans_b, int dtype, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || (br == nullptr) != (extra == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_typed<float>(a, b, br, c, sums, extra, m, n, k, trans_b, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(a, b, br, c, sums, extra, m, n, k,
                                       trans_b, s);
  return (int)cudaErrorInvalidValue;
}
