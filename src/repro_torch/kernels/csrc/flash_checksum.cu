// Online-softmax (flash) attention, causal or not, carrying the fused ABFT
// chain column, for NVIDIA Hopper.
//
// Replaces the TPU kernel `flash_checksum_kernel` (`_kernel`) of
// src/repro/kernels/flash_checksum/kernel.py:
//
//   o       = softmax(q kᵀ · dh^-0.5, mask) v     [B, T, H, dh] (q's dtype)
//   o_extra = softmax(q kᵀ · dh^-0.5, mask) vr    [B, T, H]     (f32)
//
// with the key/value head of query head h at h / (H / Kh) (GQA / MQA: the
// wrapper never repeats K and V per query head), and vr = V·w_or the carried
// check column, so Σ o_extra = eᵀ(A V W_o)e.  The causal mask compares
// query and key *indices*, as the TPU kernel does; the LM calls it so only
// for self-attention over positions 0..T-1, where indices and positions
// agree.  Without it (causal = 0) every one of the S keys is valid for
// every query, T and S independent: an encoder's self-attention (T = S) and
// a decoder's cross-attention over its encoder's output (T ≠ S, keys at
// 0..S-1); the key block past S is masked here, so S needs no padding.
// An optional sliding window (causal only; the reference's
// models/attention.py masks so) keeps key j for query i iff
// i - window < j <= i: a query tile then walks only the key blocks from
// its first row's earliest key through its diagonal, and the block on the
// window's edge is masked per element.
// vr may be null: then o_extra is not computed and o is unchanged — the
// output accumulator runs the same code either way, so a guarded step's
// attention output equals the unguarded one's bit for bit.
//
// What bounds it on this card: operations.  At gemma-2b's prefill (B 2,
// T = S = 512, H 8, Kh 1, dh 256, f32) the causal work is 2.16 GFLOP, on the
// f32 FMA pipes (never TF32): 0.032 ms at 67 TFLOP/s, against ~19 MB of
// q/k/v/o (6 µs).
//
// Design.  One block of 128 threads per (32-query tile, batch x head, key
// part): 105 KB of shared memory at dh 256 f32 (analysis/vmem.py
// `flash_smem_bytes`), two blocks an SM.  The head dim is a compile-time
// tile (64, 128 or 256; columns past dh are zero), so no inner loop
// divides.  What the design does about the four things that held a
// one-block-an-SM kernel of 64-row tiles at 13x this bound:
//   - Causal imbalance.  Query tile qt walks qt + 1 key blocks of 32.  Its
//     key blocks are split into kParts = 2 parts, one block each, the two
//     blocks one cluster; part p runs the online softmax over its blocks in
//     order, and part 0 folds part 1's state (m, l, ex, acc) into its own
//     through distributed shared memory, in part order.  The cut is a
//     function of (T, S, the mask) only (`part_start`, exported and checked
//     against analysis/vmem.py by the wrapper), so two runs add in one
//     order.  At the served shape that is 512 blocks whose longest walks 8
//     key blocks, not 16: more blocks than the 264 resident slots, taken
//     heaviest first (the grid's y index runs the query tiles from the last),
//     so the block scheduler balances the SMs: 2176 block-steps of 32 x 32,
//     16.5 an SM.  (Unsplit, all 256 tiles are resident at once, and an SM
//     holding a 16-step tile runs it alone once its partner ends.)
//   - Products from register tiles.  A 16-byte shared load is served a
//     quarter-warp at a time, so an SM feeds its 128 FMA lanes only while
//     a thread loads at most one float for 4 FFMA.  Scores: a warp owns 8
//     rows x 32 keys; its 8 lane groups of 4 each take every 8th 4-wide
//     chunk of dh, a lane 8 rows x 8 keys of partial scores (16 loads, 256
//     FFMA a chunk; the q and k rows are padded by 32 bytes, so a
//     quarter-warp's loads hit distinct banks), then a shuffle
//     reduce-scatter (3 levels) leaves each lane one whole row of 8 scores,
//     each row's sum one fixed tree.  P·V: a thread owns 8 rows x 8 columns
//     of the output (64 accumulators), and per key loads 2 float4 of p (the
//     same for the whole warp) and 2 of v for 64 FFMA.  Sums run in a fixed
//     order: p·v over the block's keys in order into a separate partial,
//     then acc * corr + partial.
//   - The softmax in parallel.  The 4 lanes that hold a score row reduce
//     its max, sum and carried column with xor shuffles (every lane ends
//     with the same bits); the row state (m, l, ex) lives in those lanes'
//     registers; one lane writes the rescale factor for the P·V threads.
//     Two barriers a key step.
//   - Copies overlapped with compute.  q and the part's first K tile are
//     copied once with cp.async; then, FlashAttention-2's stagger: V(j) is
//     in flight while the scores of step j and the softmax run, K(j + 1)
//     while P·V(j) runs.  One buffer each of q, K and V (two blocks an SM
//     do not leave room for two of K and V at dh 256).  Rows past T or S,
//     and columns past dh, are zero-filled by the copy; a dh whose rows are
//     not whole 16-byte pieces is copied element by element instead.
// p is rounded to v's dtype before both products; l is floored at 1e-30.
// One owner per output, no atomics: two runs of one input agree bit for
// bit.
//
// What is left: FFMA only (f32 stays off the tensor cores); the two
// products and the softmax take the time, the copies of one step are not
// double-buffered and K and V are read once per query tile and part from
// L2 (the 8 heads of an MQA group do not share a tile).  PERF.md has the
// measured split (tools/flash_variants.py).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kBQ = 32;        // query rows of one block
constexpr int kBKey = 32;      // keys of one step
constexpr int kThreads = 128;
constexpr int kMaxDH = 256;
constexpr int kKeyLanes = 4;   // lanes that share one score row
constexpr int kDGroups = 8;    // lane groups of a warp that split dh
constexpr int kLDP = kBQ + 4;  // row stride of the transposed p tile
constexpr int kParts = 2;      // key parts of a query tile: one cluster
constexpr float kNeg = -1e30f;

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

// four consecutive elements, widened to f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

// 16 bytes global -> shared (L2 only); the first `src_bytes` are read, the
// rest zero-filled
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The key blocks query tile qt walks, [first_block, key_blocks): under the
// causal mask they end at its diagonal, and with a sliding window (> 0,
// causal only) they start at the block of the first row's earliest key,
// q0 - window + 1.  The first key block of part p of them (part kParts: the
// end): the parts split the tile's range evenly, the earlier parts taking
// the extra ones.  A function of the shape and the mask only.
__host__ __device__ inline int key_blocks(int qt, int n_s, int causal) {
  const int last = causal ? min(n_s, (qt + 1) * kBQ) : n_s;
  return (last + kBKey - 1) / kBKey;
}
__host__ __device__ inline int first_block(int qt, int n_s, int causal,
                                           int window) {
  if (!causal || window <= 0) return 0;
  return min(max(0, qt * kBQ - window + 1) / kBKey,
             key_blocks(qt, n_s, causal));
}
__host__ __device__ inline int part_start(int qt, int n_s, int causal,
                                          int window, int p) {
  const int lo = first_block(qt, n_s, causal, window);
  return lo + (p * (key_blocks(qt, n_s, causal) - lo) + kParts - 1) / kParts;
}

// the compile-time head-dim tile of a head dim
__host__ __device__ inline int head_tile(int dh) {
  return dh <= 64 ? 64 : dh <= 128 ? 128 : 256;
}

// the q tile [kBQ][dht + pad] and the k tile [kBKey][dht + pad] (pad: 32
// bytes a row), the v tile [kBKey][dht], in the operands' dtype;
// then f32: p transposed [kBKey][kLDP], the carried column's key block
// [kBKey], one float per query row (the rescale factor, then the final sum)
__host__ __device__ inline int smem_bytes(int dht, int itemsize) {
  return (kBQ + kBKey) * (dht * itemsize + 32) + kBKey * dht * itemsize +
         4 * (kBKey * kLDP + kBKey + kBQ);
}

// Copy ROWS x DHT elements of a matrix with row stride `stride` into a
// shared tile with row stride `lds`; rows from `valid_rows` and columns from
// `dh` on are zeros.  `vec`: rows are whole 16-byte pieces (cp.async, to be
// waited for), else element by element.
template <typename T, int ROWS, int DHT>
__device__ __forceinline__ void fetch_tile(T* dst, int lds, const T* src,
                                           size_t stride, int valid_rows,
                                           int dh, bool vec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int PR = DHT / V;              // pieces of a row
  static_assert((ROWS * PR) % kThreads == 0, "whole pieces a thread");
#pragma unroll 2
  for (int e = 0; e < ROWS * PR / kThreads; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    const int r = idx / PR, c = (idx % PR) * V;
    T* d = dst + r * lds + c;
    const T* s = src + r * stride + c;
    const bool row_ok = r < valid_rows;
    if (vec) {
      const int ok = row_ok && c < dh;
      cp_async16(d, ok ? s : src, ok * 16);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        d[j] = row_ok && c + j < dh ? s[j] : from_f<T>(0.f);
    }
  }
}

template <typename T, int DHT>
__global__ void __launch_bounds__(kThreads, 2)
flash_checksum_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ vr,
                      T* __restrict__ o, float* __restrict__ o_extra,
                      float* __restrict__ stats,
                      int n_t, int n_s, int n_h, int n_kh, int dh,
                      float scale, int causal, int window, int vec) {
  // q and k row stride: 32 bytes of padding put the 8 pieces a
  // quarter-warp reads (4 keys x 2 lane groups) in distinct banks
  constexpr int LD = DHT + 32 / (int)sizeof(T);
  // scores: a warp owns SR = 8 rows x every key; its lanes are kDGroups
  // groups of kKeyLanes, group g over the 4-wide chunks g, g + kDGroups, ...
  // of dh, a lane SR rows x SK keys of partial scores
  constexpr int SK = kBKey / kKeyLanes;
  constexpr int SR = 8;
  // the output: RT rows x 8 columns a thread (4 ct + j and DHT / 2 + 4 ct
  // + j), CT threads across the row
  constexpr int CT = DHT / 8;
  constexpr int RT = kBQ * CT / kThreads;
  static_assert(kThreads == 4 * kBQ && SR == kDGroups && SK == 8 &&
                    RT >= 1 && CT <= kThreads, "thread mapping");
  // a part's accumulator fits over its q, k and v tiles, its row state
  // (and part 0's second factor) in the p tile
  static_assert(((kBQ + kBKey) * LD + kBKey * DHT) * (int)sizeof(T) >=
                    kBQ * DHT * 4 && 3 * kBQ <= kBKey * kLDP, "part state");

  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);             // [kBQ][LD]
  T* ks = qs + kBQ * LD;                           // [kBKey][LD]
  T* vs = ks + kBKey * LD;                         // [kBKey][DHT]
  float* pt = reinterpret_cast<float*>(vs + kBKey * DHT);  // [kBKey][kLDP]
  float* vrs = pt + kBKey * kLDP;                  // [kBKey]
  float* rowc = vrs + kBKey;                       // [kBQ]

  const int t = threadIdx.x;
  cg::cluster_group cluster = cg::this_cluster();
  const int part = (int)cluster.block_rank();
  const int bh = blockIdx.x / kParts;
  // heaviest query tile first under the causal mask
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kBQ;
  const int b = bh / n_h, h = bh - b * n_h;
  const int kh = h / (n_h / n_kh);
  const bool with_extra = vr != nullptr;
  const size_t kv_stride = (size_t)n_kh * dh;
  const T* kbase = k + ((size_t)b * n_s * n_kh + kh) * dh;
  const T* vbase = v + ((size_t)b * n_s * n_kh + kh) * dh;
  const T* vrbase = with_extra ? vr + (size_t)b * n_s * n_h + h : nullptr;

  // this part's key blocks
  const int first = part_start(qt, n_s, causal, window, part);
  const int steps = part_start(qt, n_s, causal, window, part + 1);

  // q and the first K tile, one copy group
  if (first < steps) {
    const int k0 = first * kBKey;
    fetch_tile<T, kBQ, DHT>(qs, LD,
                            q + (((size_t)b * n_t + q0) * n_h + h) * dh,
                            (size_t)n_h * dh, n_t - q0, dh, vec);
    fetch_tile<T, kBKey, DHT>(ks, LD, kbase + k0 * kv_stride, kv_stride,
                              n_s - k0, dh, vec);
    cp_async_commit();
    if (t < kBKey)
      vrs[t] = with_extra && k0 + t < n_s
                   ? to_f(vrbase[(size_t)(k0 + t) * n_h]) : 0.f;
  }

  // score mapping: lane = dg * kKeyLanes + kq holds the partial scores of
  // its warp's rows sr0 + i over dh chunks dg + kDGroups c, keys
  // kq + kKeyLanes j; after the reduce-scatter it owns the whole row
  // sr0 + dg
  const int lane = t & 31, kq = lane % kKeyLanes;
  const int dg = lane / kKeyLanes;
  const int sr0 = (t >> 5) * SR;
  const int row = sr0 + dg;                 // the row this lane owns
  float m_i = kNeg, l_i = 0.f, ex_i = 0.f;  // its state
  // output mapping: rows rg * RT + i, columns 4 ct + j and DHT / 2 + 4 ct
  // + j
  const int ct = t % CT, rg = t / CT;
  float acc[RT][8];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int step = first; step < steps; ++step) {
    const int k0 = step * kBKey;
    cp_async_wait_all();             // this thread's copies of K(step)
    __syncthreads();                 // everyone's; P·V(step - 1) is done
    fetch_tile<T, kBKey, DHT>(vs, DHT, vbase + k0 * kv_stride, kv_stride,
                              n_s - k0, dh, vec);
    cp_async_commit();               // V(step) flies during the scores

    // partial scores over this lane group's chunks of dh, in order
    float s[SR][SK];
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SK; ++j) s[i][j] = 0.f;
    const T* qd = qs + sr0 * LD + 4 * dg;
    const T* kd = ks + kq * LD + 4 * dg;
#pragma unroll 1
    for (int d = 0; d < DHT; d += 4 * kDGroups) {
      float4 qv[SR], kv[SK];
#pragma unroll
      for (int i = 0; i < SR; ++i) qv[i] = load4(qd + i * LD + d);
#pragma unroll
      for (int j = 0; j < SK; ++j) kv[j] = load4(kd + kKeyLanes * j * LD + d);
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SK; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // reduce-scatter of the partial scores across the lane groups: at each
    // level the groups that differ in one bit of dg (bit 2, 1, then 0) add
    // the half of their rows whose bit is theirs, so row i's sum is one
    // fixed tree over the groups
    float sc[SK];
    {
      const bool b2 = dg & 4, b1 = dg & 2, b0 = dg & 1;
      float h4[4][SK], h2[2][SK];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < SK; ++j) {
          const float keep = b2 ? s[4 + r][j] : s[r][j];
          const float give = b2 ? s[r][j] : s[4 + r][j];
          h4[r][j] = keep + __shfl_xor_sync(0xffffffffu, give, 16);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < SK; ++j) {
          const float keep = b1 ? h4[2 + r][j] : h4[r][j];
          const float give = b1 ? h4[r][j] : h4[2 + r][j];
          h2[r][j] = keep + __shfl_xor_sync(0xffffffffu, give, 8);
        }
#pragma unroll
      for (int j = 0; j < SK; ++j) {
        const float keep = b0 ? h2[1][j] : h2[0][j];
        const float give = b0 ? h2[0][j] : h2[1][j];
        sc[j] = keep + __shfl_xor_sync(0xffffffffu, give, 4);
      }
    }

    // online softmax of the row: its kKeyLanes lanes reduce by xor shuffles
    {
      const int qpos = q0 + row;
      // a sliding window's earliest key of the row (0: none)
      const int kmin = window > 0 ? qpos - window + 1 : 0;
      bool valid[SK];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < SK; ++j) {
        const int kpos = k0 + kq + kKeyLanes * j;
        valid[j] = kpos < n_s && (!causal || (kpos <= qpos && kpos >= kmin));
        sc[j] = valid[j] ? sc[j] * scale : kNeg;
        mx = fmaxf(mx, sc[j]);
      }
#pragma unroll
      for (int off = 1; off < kKeyLanes; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i, mx);
      const float corr = expf(m_i - m_new);
      float psum = 0.f, pex = 0.f;
#pragma unroll
      for (int j = 0; j < SK; ++j) {
        const int key = kq + kKeyLanes * j;
        const float p = valid[j] ? expf(sc[j] - m_new) : 0.f;
        const float pr = to_f(from_f<T>(p));
        psum += p;
        pex = fmaf(pr, vrs[key], pex);
        pt[key * kLDP + row] = pr;
      }
#pragma unroll
      for (int off = 1; off < kKeyLanes; off <<= 1) {
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
        pex += __shfl_xor_sync(0xffffffffu, pex, off);
      }
      l_i = __fadd_rn(__fmul_rn(l_i, corr), psum);
      ex_i = __fadd_rn(__fmul_rn(ex_i, corr), pex);
      m_i = m_new;
      if (kq == 0) rowc[row] = corr;
    }

    cp_async_wait_all();             // this thread's copies of V(step)
    __syncthreads();                 // p, corr and V visible; K(step) read
    if (step + 1 < steps) {
      const int k1 = k0 + kBKey;
      fetch_tile<T, kBKey, DHT>(ks, LD, kbase + k1 * kv_stride, kv_stride,
                                n_s - k1, dh, vec);
      if (t < kBKey)
        vrs[t] = with_extra && k1 + t < n_s
                     ? to_f(vrbase[(size_t)(k1 + t) * n_h]) : 0.f;
    }
    cp_async_commit();               // K(step + 1) flies during P·V

    // acc = acc * corr + p @ v on this thread's RT x 8 tile
    float pv[RT][8];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) pv[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kBKey; ++c) {
      const float4 v0 = load4(vs + c * DHT + 4 * ct);
      const float4 v1 = load4(vs + c * DHT + DHT / 2 + 4 * ct);
      const float* prow = pt + c * kLDP + rg * RT;
      float p[RT];
      if constexpr (RT % 4 == 0) {
#pragma unroll
        for (int i = 0; i < RT; i += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(prow + i);
          p[i] = p4.x;
          p[i + 1] = p4.y;
          p[i + 2] = p4.z;
          p[i + 3] = p4.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < RT; ++i) p[i] = prow[i];
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        pv[i][0] = fmaf(p[i], v0.x, pv[i][0]);
        pv[i][1] = fmaf(p[i], v0.y, pv[i][1]);
        pv[i][2] = fmaf(p[i], v0.z, pv[i][2]);
        pv[i][3] = fmaf(p[i], v0.w, pv[i][3]);
        pv[i][4] = fmaf(p[i], v1.x, pv[i][4]);
        pv[i][5] = fmaf(p[i], v1.y, pv[i][5]);
        pv[i][6] = fmaf(p[i], v1.z, pv[i][6]);
        pv[i][7] = fmaf(p[i], v1.w, pv[i][7]);
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float corr = rowc[rg * RT + i];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] = __fadd_rn(__fmul_rn(acc[i][j], corr), pv[i][j]);
    }
  }

  // the parts, folded in part order into part 0: part p leaves its row
  // state and its accumulator (over its k and v tiles) in its shared
  // memory; part 0 reads them through the cluster:
  //   m = max(m, m_p), acc = acc * e^(m_old - m) + acc_p * e^(m_p - m),
  //   and l and ex alike
  float* st = pt;                                    // m, l, ex a row
  float* accs = reinterpret_cast<float*>(qs);        // [kBQ][DHT]
  cp_async_wait_all();
  __syncthreads();                   // P·V is done with v, p and rowc
  if (part > 0) {
    if (kq == 0) {
      st[row] = m_i;
      st[kBQ + row] = l_i;
      st[2 * kBQ + row] = ex_i;
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float* arow = accs + (rg * RT + i) * DHT + 4 * ct;
      *reinterpret_cast<float4*>(arow) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(arow + DHT / 2) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
  cluster.sync();
  if (part > 0) {
    cluster.sync();                  // part 0 has read this part's state
    return;
  }
  for (int p = 1; p < kParts; ++p) {
    const float* pst = cluster.map_shared_rank(st, p);
    const float mp = pst[row];
    const float m_new = fmaxf(m_i, mp);
    const float c0 = expf(m_i - m_new), cp = expf(mp - m_new);
    l_i = __fadd_rn(__fmul_rn(l_i, c0), __fmul_rn(pst[kBQ + row], cp));
    ex_i = __fadd_rn(__fmul_rn(ex_i, c0), __fmul_rn(pst[2 * kBQ + row], cp));
    m_i = m_new;
    if (kq == 0) {
      rowc[row] = c0;
      st[row] = cp;                  // part 0's own st is free
    }
    __syncthreads();
    const float* pacc = cluster.map_shared_rank(accs, p);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = rg * RT + i;
      const float* arow = pacc + r * DHT + 4 * ct;
      const float4 a0 = *reinterpret_cast<const float4*>(arow);
      const float4 a1 = *reinterpret_cast<const float4*>(arow + DHT / 2);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float c = rowc[r], d = st[r];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] = __fadd_rn(__fmul_rn(acc[i][j], c), __fmul_rn(a[j], d));
    }
    __syncthreads();                 // the factors are read
  }

  // epilogue: divide by l (floored at 1e-30), write o and o_extra, and
  // the row's folded softmax statistics (m, l) when asked
  if (kq == 0) {
    const float lsafe = fmaxf(l_i, 1e-30f);
    rowc[row] = lsafe;
    if (with_extra && q0 + row < n_t)
      o_extra[((size_t)b * n_t + q0 + row) * n_h + h] =
          __fdiv_rn(ex_i, lsafe);
    if (stats != nullptr && q0 + row < n_t) {
      float* srow = stats + (((size_t)b * n_t + q0 + row) * n_h + h) * 2;
      srow[0] = m_i;
      srow[1] = l_i;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = rg * RT + i;
    if (q0 + r >= n_t) continue;
    const float lsafe = rowc[r];
    T* orow = o + (((size_t)b * n_t + q0 + r) * n_h + h) * dh;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = 4 * ct + j % 4 + (j / 4) * (DHT / 2);
      if (d < dh) orow[d] = from_f<T>(__fdiv_rn(acc[i][j], lsafe));
    }
  }
  cluster.sync();
}

template <typename T, int DHT>
int launch_tiled(const void* q, const void* k, const void* v, const void* vr,
                 void* o, float* o_extra, float* stats, int n_b, int n_t,
                 int n_s, int n_h, int n_kh, int dh, float scale, int causal,
                 int window, cudaStream_t stream) {
  const int smem = smem_bytes(DHT, (int)sizeof(T));
  auto fn = flash_checksum_kernel<T, DHT>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  // rows of whole 16-byte pieces (the wrapper checks that the bases are
  // 16-byte aligned) take cp.async
  const int vec = (dh * (int)sizeof(T)) % 16 == 0;
  // x: (batch x head, part), a cluster of kParts blocks; y: query tiles
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_b * n_h * kParts),
                     (unsigned)((n_t + kBQ - 1) / kBQ));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kParts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, fn, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(vr), static_cast<T*>(o),
      o_extra, stats, n_t, n_s, n_h, n_kh, dh, scale, causal, window, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, const void* vr,
                 void* o, float* o_extra, float* stats, int n_b, int n_t,
                 int n_s, int n_h, int n_kh, int dh, float scale, int causal,
                 int window, cudaStream_t stream) {
  switch (head_tile(dh)) {
    case 64:
      return launch_tiled<T, 64>(q, k, v, vr, o, o_extra, stats, n_b, n_t,
                                 n_s, n_h, n_kh, dh, scale, causal, window,
                                 stream);
    case 128:
      return launch_tiled<T, 128>(q, k, v, vr, o, o_extra, stats, n_b, n_t,
                                  n_s, n_h, n_kh, dh, scale, causal, window,
                                  stream);
    default:
      return launch_tiled<T, 256>(q, k, v, vr, o, o_extra, stats, n_b, n_t,
                                  n_s, n_h, n_kh, dh, scale, causal, window,
                                  stream);
  }
}

}  // namespace

// shared memory of one block at f32 (bfloat16 tiles take half the q, k and
// v bytes)
extern "C" int flash_checksum_smem_bytes(int dh) {
  return smem_bytes(head_tile(dh), 4);
}

extern "C" int flash_checksum_max_dh() { return kMaxDH; }

// the cut: query rows of a block, keys of a step (the plain version's key
// blocks), the compile-time head-dim tile of a head dim
extern "C" int flash_checksum_block_q() { return kBQ; }
extern "C" int flash_checksum_block_k() { return kBKey; }
extern "C" int flash_checksum_head_tile(int dh) { return head_tile(dh); }
// key parts of a query tile, and the first key block of part p of tile qt
// (window 0: no sliding window)
extern "C" int flash_checksum_parts() { return kParts; }
extern "C" int flash_checksum_part_start(int qt, int n_s, int causal,
                                         int p, int window) {
  return part_start(qt, n_s, causal, window, p);
}

// Launch on `stream`; allocates nothing, does not synchronise, returns
// cudaGetLastError() (0 on success).  q [B, T, H, dh], k and v [B, S, Kh, dh],
// vr [B, S, H] or null, o [B, T, H, dh], o_extra [B, T, H] f32 or null (with
// vr); dtype 0 = float32, 1 = bfloat16 (q, k, v, vr, o).  window > 0 (causal
// only): key j is valid for query i iff i - window < j <= i; 0 is none (the
// default keeps a C++ caller of the window-less signature building).
// stats [B, T, H, 2] f32 or null: each row's (m, l) after the part fold —
// m the largest scaled score (natural exponent, -1e30 for a row with no
// valid key), l the sum of e^(score - m), unfloored — which the split
// baseline's second pass rescales by; null writes nothing else and leaves
// every other output as it was.
extern "C" int flash_checksum_launch(const void* q, const void* k,
                                     const void* v, const void* vr, void* o,
                                     float* o_extra, int n_b, int n_t,
                                     int n_s, int n_h, int n_kh, int dh,
                                     float scale, int causal, int dtype,
                                     void* stream, int window = 0,
                                     float* stats = nullptr) {
  if (n_b <= 0 || n_t <= 0 || n_s <= 0 || n_kh <= 0 || n_h % n_kh ||
      dh <= 0 || dh > kMaxDH || (vr == nullptr) != (o_extra == nullptr) ||
      (n_t + kBQ - 1) / kBQ > 65535 || window < 0 || (window && !causal))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_typed<float>(q, k, v, vr, o, o_extra, stats, n_b, n_t,
                               n_s, n_h, n_kh, dh, scale, causal, window, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k, v, vr, o, o_extra, stats, n_b,
                                       n_t, n_s, n_h, n_kh, dh, scale, causal,
                                       window, s);
  return (int)cudaErrorInvalidValue;
}
