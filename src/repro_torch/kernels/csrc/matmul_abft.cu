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
// What bounds it on this card: at M <= 16 (decode steps, the LM head) bytes —
// every element of B is read once for at most 32 FLOP, <= 8 per byte in f32;
// at M = 1024 (a 512-token prefill of 2 sequences) operations, at the f32
// pipes' 67 TFLOP/s, since float32 operands are multiplied with FFMA, never
// TF32 (a TF32 product moves the clean check divergence to ~1e-3, the
// detection threshold).
//
// The association, one rule for every path and for the plain version
// (kernels/matmul_abft/kernel.py `matmul_abft_plain`): K is cut into S
// splits of a whole number of 32-wide chunks (S = `matmul_abft_splits`, a
// pure function of M, N and K; 1 when M > 16).  Inside a split each 32-wide
// chunk is summed apart (one thread, k in order) and the chunk sums are
// added to the split's accumulator in chunk order; then the S split sums are
// added in split order.  `extra` follows the same rule.  So the card and the
// CPU agree to ~1e-5 on gemma-2b's logits, and no sum depends on timing:
// no atomics, results repeat bit for bit, and b_r = null changes nothing in
// C (the check column has its own accumulators).
//
// M > 16: one thread block owns one 64 x 128 C tile with a 4 x 8 register
// tile per thread and walks all of K in 32-wide steps.  A and B tiles are
// staged through shared memory (one padding float per row: conflict-free
// stores for both B layouts); the next step's tiles are loaded into
// registers while the current one is multiplied.  The tile's block sum
// reduces in one fixed order (per thread, a warp shuffle tree, then warp by
// warp).  The ni == 0 blocks also accumulate A @ b_r.  What holds it back:
// no tensor cores, no TMA / cp.async pipeline, 255 registers (one block per
// SM).
//
// M <= 16, two kernels launched back to back on one stream:
//  * `thin_split`: the work is (column tile, split) items — 256 columns of
//    C, all M rows, one split of K — taken by persistent blocks, as many as
//    are resident (2 an SM for f32 at M <= 2, by shared memory), item
//    blockIdx.x, then + gridDim.x, ...  Every 32-wide chunk of B is copied
//    in 16-byte pieces (4 f32 or 8 bf16) with cp.async straight into a
//    3-stage shared-memory ring, so two chunks are in flight per block
//    without holding a register, and the ring runs on across the block's
//    items.  For B [K, N] neighbouring threads copy neighbouring pieces of
//    one row of B; for B^T [N, K] eight (f32) or four (bf16) neighbouring
//    threads copy one row's 128 or 64 contiguous bytes, so a warp reads
//    whole lines of B^T as it lies and stores them as rows of 36 (40)
//    elements.  Each thread then sums its own column's chunk for every row
//    of A (A's [M, 32] slice rides in the same stage).  Reading B^T's chunk
//    by rows, not with the TPU-style warp-per-row shuffle reduction, keeps
//    one thread per chunk and so the association above.  An item's split
//    sums go to a workspace [S, M, N], tile 0's extra column to [S, M]
//    after it.  S is a power of two chosen so that every gemma-2b decode
//    shape makes >= 264 items (2 per SM) where K has that many chunks, and
//    no more than 528, so the blocks' shares differ by at most one item.
//  * `thin_reduce`: one block per 256 columns adds the S split sums in
//    order (32 loads in flight per thread), writes C in the operand dtype
//    and the f32 sums of its four 16 x 64 tiles (a fixed tree), and block
//    0 adds the extra column's splits.
//  Ragged shapes take a scalar tail: a 16-byte piece is copied whole only
//  when N (B) or K (B^T and A) is a multiple of its element count, so that
//  every row starts 16-byte aligned; otherwise element by element into the
//  stage.
//  What holds it back: two launches and a ring to fill per product, which
//  the narrow products (k/v, q/o) do not amortise, and one chunk of
//  arithmetic per barrier.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kBK = 32;        // K step, and the accumulation chunk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmallM = 16;    // M <= this takes the thin split-K path
constexpr int kThinN = 256;    // thin path: columns of one block, one a thread
constexpr int kSumN = 64;      // thin path: columns of one block_sums tile
constexpr int kSMs = 132;      // an H100 SXM's SMs: a stated constant, not
                               // queried, so S is a pure function of the shape
constexpr int kMaxItems = 4 * kSMs;    // thin path: most (tile, split) items

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

// ---------------------------------------------------------------------------
// The thin path (M <= 16)
// ---------------------------------------------------------------------------

// 32-wide K chunks per split (analysis/vmem.py `_split_chunks`): K is cut
// into the largest power of two of splits that keeps (tile, split) items
// within kMaxItems and splits at least one chunk long; all of K when M > 16.
int split_chunks(int m, int n, int k) {
  const int chunks = (k + kBK - 1) / kBK;
  if (m > kSmallM) return chunks;
  const int tiles = (n + kThinN - 1) / kThinN;
  int s = 1;
  while (2 * s <= chunks && (long long)tiles * 2 * s <= kMaxItems) s *= 2;
  return (chunks + s - 1) / s;
}

// One 16-byte piece of an operand: V elements of T, unpacked to floats in
// element order.
template <typename T> struct Piece;
template <> struct Piece<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void unpack(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <> struct Piece<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void unpack(uint4 u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {     // little-endian: element 2i is low
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// 16 bytes global -> shared without passing through registers (L2 only);
// the first `src_bytes` are read, the rest of the 16 are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One pipeline stage in shared memory, raw operand elements: the chunk of B
// ([32 k][256 n] for B, [256 n][32 k + pad] for B^T: 16-byte rows, and
// conflict-free 16-byte row reads by neighbouring threads), A's [MT][32 + 8]
// slice, and b_r's 32 values (f32).
template <typename T, int MT, bool TRANS> struct ThinStage {
  static constexpr int V = Piece<T>::V;
  static constexpr int LDT = kBK + V;       // B^T row: 36 f32 / 40 bf16
  static constexpr int LDA = kBK + 8;       // A row: 40 elements
  static constexpr int B_ELEMS = TRANS ? kThinN * LDT : kBK * kThinN;
  static constexpr int A_ELEMS = MT * LDA;
  static constexpr int BYTES = (B_ELEMS + A_ELEMS) * (int)sizeof(T) +
                               kBK * (int)sizeof(float);
};
// pipeline depth: one chunk multiplied while the next two are in flight
constexpr int kStages = 3;

template <typename T, int MT, bool TRANS>
constexpr int thin_smem_bytes() {
  return kStages * ThinStage<T, MT, TRANS>::BYTES;
}

// Persistent blocks over the (tile, split) items: item i is column tile
// i % tiles (256 columns, thread t owns column 256 tile + t, all M rows; MT
// >= M is the compile-time row count) and split i / tiles (K [s kc,
// min((s + 1) kc, K))).  A block takes items blockIdx.x, + gridDim.x, ...,
// and walks their chunks as one stream through a kStages-deep cp.async
// ring, so the next item's first chunks are in flight while the current
// item's last one is multiplied.  An item's sums go to ws[s, m, n] and, for
// tile 0 with br, A @ b_r's to ws[S M N + s M + m].  Which block runs which
// item changes no sum.
template <typename T, int MT, bool TRANS>
__global__ void __launch_bounds__(kThreads)
thin_split_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  const float* __restrict__ br, float* __restrict__ ws,
                  int M, int N, int K, int kc, int splits) {
  using P = Piece<T>;
  using St = ThinStage<T, MT, TRANS>;
  constexpr int V = P::V;
  constexpr int NP = kBK * kThinN / V / kThreads;   // B pieces a thread copies
  constexpr int PR = (TRANS ? kBK : kThinN) / V;    // pieces along a row
  constexpr int AP = MT * kBK / V;                  // A pieces of a chunk
  extern __shared__ __align__(16) unsigned char thin_smem[];

  const int t = threadIdx.x;
  const int tiles = (N + kThinN - 1) / kThinN;
  const int items = tiles * splits;
  // every row of the operand starts 16-byte aligned (the bases are: the
  // wrapper checks it), so pieces are whole or wholly outside
  const bool vec_a = K % V == 0;
  const bool vec_b = TRANS ? vec_a : (N % V == 0);

  auto stage_b = [&](int st) {
    return reinterpret_cast<T*>(thin_smem + st * St::BYTES);
  };
  auto stage_a = [&](int st) { return stage_b(st) + St::B_ELEMS; };
  auto stage_br = [&](int st) {
    return reinterpret_cast<float*>(stage_a(st) + St::A_ELEMS);
  };
  auto chunks_of = [&](int item) {
    const int k0 = (item / tiles) * kc;
    return (min(k0 + kc, K) - k0 + kBK - 1) / kBK;
  };

  // copy chunk `ch` of `item` into stage `st` (the scalar tail stores
  // directly: the stage is not read before a later barrier)
  auto fetch = [&](int st, int item, int ch) {
    const int n0 = (item % tiles) * kThinN;
    const int k0 = (item / tiles) * kc + ch * kBK;
    T* bs = stage_b(st);
#pragma unroll
    for (int e = 0; e < NP; ++e) {
      const int idx = t + e * kThreads;
      const int row = idx / PR, col = (idx % PR) * V;
      const int n = TRANS ? n0 + row : n0 + col;
      const int k = TRANS ? k0 + col : k0 + row;
      T* dst = bs + (TRANS ? row * St::LDT + col : row * kThinN + col);
      const T* src = TRANS ? B + (size_t)n * K + k : B + (size_t)k * N + n;
      // elements of this piece inside the matrix
      int valid = TRANS ? (n < N ? K - k : 0) : (k < K ? N - n : 0);
      valid = max(0, min(valid, V));
      if (vec_b) {
        cp_async16(dst, valid ? src : B, valid * (int)sizeof(T));
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) dst[j] = j < valid ? src[j] : from_f<T>(0.f);
      }
    }
    T* as = stage_a(st);
    for (int p = t; p < AP; p += kThreads) {
      const int m = p / (kBK / V), col = (p % (kBK / V)) * V;
      const int valid = m < M ? max(0, min(K - (k0 + col), V)) : 0;
      const T* src = A + (size_t)m * K + k0 + col;
      T* dst = as + m * St::LDA + col;
      if (vec_a) {
        cp_async16(dst, valid ? src : A, valid * (int)sizeof(T));
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) dst[j] = j < valid ? src[j] : from_f<T>(0.f);
      }
    }
    if (br != nullptr && n0 == 0 && t < kBK / 4) {
      const int k = k0 + 4 * t;
      const int valid = max(0, min(K - k, 4));
      cp_async16(stage_br(st) + 4 * t, valid ? br + k : br, 4 * valid);
    }
  };

  // the fetch cursor runs kStages - 1 chunks ahead of the compute cursor
  int item_i = blockIdx.x, ch_i = 0;
  auto fetch_next = [&](int st) {
    if (item_i < items) {
      fetch(st, item_i, ch_i);
      if (++ch_i == chunks_of(item_i)) {
        ch_i = 0;
        item_i += gridDim.x;
      }
    }
    cp_async_commit();               // one group per step, empty or not
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) fetch_next(st);

  float acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = 0.f;
  float ex = 0.f;
  int st = 0;
  for (int item = blockIdx.x, ch = 0; item < items;) {
    cp_async_wait<kStages - 2>();    // this thread's copies of the chunk
    __syncthreads();                 // everyone's; the last stage is free
    fetch_next((st + kStages - 1) % kStages);

    const T* bs = stage_b(st);
    const T* as = stage_a(st);
    // this chunk, summed apart, k in order
    float part[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) part[i] = 0.f;
#pragma unroll
    for (int p = 0; p < kBK / V; ++p) {
      float b[V];
      if constexpr (TRANS) {
        P::unpack(*reinterpret_cast<const uint4*>(bs + t * St::LDT + p * V),
                  b);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) b[j] = to_f(bs[(p * V + j) * kThinN + t]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float a[V];
        P::unpack(*reinterpret_cast<const uint4*>(as + i * St::LDA + p * V),
                  a);
#pragma unroll
        for (int j = 0; j < V; ++j) part[i] = fmaf(a[j], b[j], part[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) acc[i] = __fadd_rn(acc[i], part[i]);

    const int tile = item % tiles, split = item / tiles;
    const bool with_extra = br != nullptr && tile == 0;
    if (with_extra && t < MT) {
      const float* brs = stage_br(st);
      float p = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk)
        p = fmaf(to_f(as[t * St::LDA + kk]), brs[kk], p);
      ex = __fadd_rn(ex, p);
    }

    if (++ch == chunks_of(item)) {   // the item's last chunk: its sums
      const int n = tile * kThinN + t;
      if (n < N) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if (i < M) ws[((size_t)split * M + i) * N + n] = acc[i];
      }
      if (with_extra && t < M)
        ws[(size_t)splits * M * N + (size_t)split * M + t] = ex;
#pragma unroll
      for (int i = 0; i < MT; ++i) acc[i] = 0.f;
      ex = 0.f;
      ch = 0;
      item += gridDim.x;
    }
    st = (st + 1) % kStages;
  }
  cp_async_wait<0>();                // no copy outlives the block
}

// Block ni: columns [256 ni, 256 ni + 256).  C = the S split sums added in
// split order, in the operand dtype; block_sums[4 ni + j] = their f32 sum
// over the 64-column tile j (per thread in row order, a warp shuffle tree,
// then the tile's two warps in order); block 0 adds the extra column's split
// sums in order.  Each thread keeps 32 loads in flight across its rows.
template <typename T, int MT>
__global__ void __launch_bounds__(kThreads)
thin_reduce_kernel(const float* __restrict__ ws, T* __restrict__ C,
                   float* __restrict__ block_sums, float* __restrict__ extra,
                   int M, int N, int S) {
  constexpr int kBatch = MT >= 32 ? 1 : 32 / MT;   // splits per round trip
  __shared__ float red[kWarps];
  const int t = threadIdx.x;
  const int n = blockIdx.x * kThinN + t;
  const size_t plane = (size_t)M * N;
  float s = 0.f;
  if (n < N) {
    float v[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) v[i] = i < M ? ws[(size_t)i * N + n] : 0.f;
    for (int s0 = 1; s0 < S; s0 += kBatch) {
      float x[MT][kBatch];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          x[i][j] = (i < M && s0 + j < S)
                        ? ws[(s0 + j) * plane + (size_t)i * N + n] : 0.f;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (s0 + j < S) v[i] = __fadd_rn(v[i], x[i][j]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < M) {
        C[(size_t)i * N + n] = from_f<T>(v[i]);
        s = __fadd_rn(s, v[i]);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if ((t & 31) == 0) red[t >> 5] = s;
  __syncthreads();
  constexpr int kWarpsPerTile = kSumN / 32;
  const int tile = blockIdx.x * (kThinN / kSumN) + t;
  if (t < kThinN / kSumN && tile * kSumN < N) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsPerTile; ++w) tot += red[t * kWarpsPerTile + w];
    block_sums[tile] = tot;
  }
  if (extra != nullptr && blockIdx.x == 0 && t < M) {
    const float* e = ws + (size_t)S * plane + t;
    float v = e[0];
    for (int sp = 1; sp < S; ++sp) v = __fadd_rn(v, e[(size_t)sp * M]);
    extra[t] = v;
  }
}

// Resident blocks of one thin_split instantiation on the current device
// (asked once: the grid is a schedule and changes no sum), after raising
// its dynamic shared memory limit.
template <typename T, int MT, bool TRANS>
int thin_capacity() {
  static const int capacity = [] {
    constexpr int bytes = thin_smem_bytes<T, MT, TRANS>();
    auto* fn = thin_split_kernel<T, MT, TRANS>;
    if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes) != cudaSuccess)
      return 0;
    int per_sm = 0, dev = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      bytes) != cudaSuccess ||
        cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    return per_sm * sms;
  }();
  return capacity;
}

template <typename T, int MT, bool TRANS>
int launch_thin_split(const T* a, const T* b, const float* br, float* ws,
                      int m, int n, int k, int kc, int splits,
                      cudaStream_t stream) {
  const int capacity = thin_capacity<T, MT, TRANS>();
  if (capacity <= 0) return (int)cudaErrorInvalidConfiguration;
  const int items = ((n + kThinN - 1) / kThinN) * splits;
  const int grid = items < capacity ? items : capacity;
  thin_split_kernel<T, MT, TRANS>
      <<<grid, kThreads, thin_smem_bytes<T, MT, TRANS>(), stream>>>(
          a, b, br, ws, m, n, k, kc, splits);
  return (int)cudaGetLastError();
}

template <typename T, int MT>
int launch_thin(const T* a, const T* b, const float* br, T* c, float* sums,
                float* extra, float* ws, int m, int n, int k, int trans_b,
                cudaStream_t stream) {
  const int kc = kBK * split_chunks(m, n, k);
  const int splits = (k + kc - 1) / kc;
  const int err =
      trans_b ? launch_thin_split<T, MT, true>(a, b, br, ws, m, n, k, kc,
                                               splits, stream)
              : launch_thin_split<T, MT, false>(a, b, br, ws, m, n, k, kc,
                                                splits, stream);
  if (err != cudaSuccess) return err;
  thin_reduce_kernel<T, MT><<<(n + kThinN - 1) / kThinN, kThreads, 0,
                              stream>>>(ws, c, sums, extra, m, n, splits);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, MT>{}) with MT the compile-time row count
// the thin path uses for m rows.
template <typename F> int with_rows(int m, F&& f) {
  if (m == 1) return f(std::integral_constant<int, 1>{});
  if (m == 2) return f(std::integral_constant<int, 2>{});
  if (m <= 4) return f(std::integral_constant<int, 4>{});
  if (m <= 8) return f(std::integral_constant<int, 8>{});
  return f(std::integral_constant<int, 16>{});
}

template <typename T>
int launch_typed(const void* a, const void* b, const float* br, void* c,
                 float* sums, float* extra, float* ws, int m, int n, int k,
                 int trans_b, cudaStream_t stream) {
  if (m <= kSmallM) {
    if (ws == nullptr) return (int)cudaErrorInvalidValue;
    return with_rows(m, [&](auto rows) {
      return launch_thin<T, decltype(rows)::value>(
          static_cast<const T*>(a), static_cast<const T*>(b), br,
          static_cast<T*>(c), sums, extra, ws, m, n, k, trans_b, stream);
    });
  } else {
    dim3 grid((n + 127) / 128, (m + 63) / 64);
    matmul_abft_kernel<T, 64, 128, 4, 8><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), br,
        static_cast<T*>(c), sums, extra, m, n, k, trans_b);
  }
  return (int)cudaGetLastError();
}

template <typename T> int thin_smem_typed(int m, int trans_b) {
  return with_rows(m, [&](auto rows) {
    constexpr int MT = decltype(rows)::value;
    return trans_b ? thin_smem_bytes<T, MT, true>()
                   : thin_smem_bytes<T, MT, false>();
  });
}

}  // namespace

// The C tile `block_sums` is taken over for an M-row product (rows, then
// columns): the block's tile when M > 16, 64 columns over all 16 rows
// otherwise; analysis/vmem.py `matmul_tile` states the same and the wrapper
// checks it.
extern "C" int matmul_abft_tile_m(int m) { return m <= kSmallM ? kSmallM : 64; }
extern "C" int matmul_abft_tile_n(int m) { return m <= kSmallM ? kSumN : 128; }

// K columns of one split (a multiple of 32) and the number of splits S of an
// M x K @ K x N product; analysis/vmem.py `matmul_split_k` / `matmul_splits`
// state the same and the wrapper checks them.  S = 1 when M > 16.
extern "C" int matmul_abft_split_k(int m, int n, int k) {
  return kBK * split_chunks(m, n, k);
}
extern "C" int matmul_abft_splits(int m, int n, int k) {
  const int kc = kBK * split_chunks(m, n, k);
  return (k + kc - 1) / kc;
}

// Dynamic shared memory of one thin_split block for an M-row product
// (M <= 16; dtype as for the launch); analysis/vmem.py
// `matmul_thin_smem_bytes` states the same and the wrapper checks it.
extern "C" int matmul_abft_thin_smem_bytes(int m, int dtype, int trans_b) {
  if (m <= 0 || m > kSmallM) return 0;
  return dtype == 0 ? thin_smem_typed<float>(m, trans_b)
                    : thin_smem_typed<__nv_bfloat16>(m, trans_b);
}

// Launch on `stream` (two kernels when M <= 16, one otherwise); allocates
// nothing, does not synchronise, returns cudaGetLastError() (0 on success).
// dtype 0 = float32, 1 = bfloat16 (A, B and C); br/extra f32 and both null
// for an unchecked product; sums [ceil(M/tm), ceil(N/tn)] f32; ws, when
// M <= 16, f32 scratch of S * M * (N + 1) floats (S = matmul_abft_splits),
// else ignored.
extern "C" int matmul_abft_launch(const void* a, const void* b,
                                  const float* br, void* c, float* sums,
                                  float* extra, float* ws, int m, int n,
                                  int k, int trans_b, int dtype,
                                  void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || (br == nullptr) != (extra == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_typed<float>(a, b, br, c, sums, extra, ws, m, n, k,
                               trans_b, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(a, b, br, c, sums, extra, ws, m, n, k,
                                       trans_b, s);
  return (int)cudaErrorInvalidValue;
}
