// Building blocks shared by the fused block-ELL aggregation kernels
// (gcn_fused.cu, gcn_network.cu).
//
// One thread block owns one row-stripe of the block-ELL matrix and walks
// the stripe's ell-slots in order.  Everything a stripe accumulates lives in
// that block's shared memory, every accumulator element is written by one
// thread at a time in a fixed order, and block-wide sums reduce in one fixed
// order: there are no atomics, so results repeat bit for bit from run to run.
//
// Products are register-tiled: a thread owns 2 rows x 8 columns of a tile
// product (rows r and r + rows/2, so the 32 threads of a warp read 32
// different shared-memory banks), and when there are fewer such units than
// threads the reduction axis is split over thread groups whose partial sums
// are then added group by group.
#pragma once

#include <cuda_runtime.h>

namespace abft {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kReduceScratch = 32;   // floats; >= kWarps + 1
constexpr int kMaxSplit = 8;         // most groups the reduction axis splits into

// Sum of one value per thread over the block, the same in every thread.
// Warp shuffle tree, then thread 0 adds the warps' partials in warp order.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();                   // scratch may still be read by a caller
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w];
    red[kWarps] = t;
  }
  __syncthreads();
  return red[kWarps];
}

// Sum of a shared-memory array over the block (fixed strided order).
__device__ __forceinline__ float block_sum_array(const float* a, int n,
                                                 float* red) {
  float part = 0.f;
  for (int t = threadIdx.x; t < n; t += kThreads) part += a[t];
  return block_sum(part, red);
}

// Ask for `bytes` at `p` to be brought into L2 (one 128-byte line per thread
// and pass).  A hint only: the data is read by ordinary loads later.
__device__ __forceinline__ void prefetch_l2(const void* p, int bytes) {
  const char* c = static_cast<const char*>(p);
  for (int off = threadIdx.x * 128; off < bytes; off += kThreads * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + off));
}

// Stage one [bm, bk] tile of S: coalesced float4 reads from global memory,
// rows stored bk + 1 floats apart so that the 32 threads of a warp, each
// walking its own row, hit 32 different banks.
__device__ __forceinline__ void load_s_tile(const float* __restrict__ tile,
                                            float* s_sm, int bm, int bk) {
  const int ld = bk + 1;
  const int n4 = (bm * bk) >> 2;
  const float4* t4 = reinterpret_cast<const float4*>(tile);
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    const float4 v = __ldg(t4 + i);
    const int e = i << 2;
    const int r = e / bk;
    const int k = e - r * bk;
    float* d = s_sm + r * ld + k;
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
}

// How a [rows, gp] product is cut into 2 x 8 register tiles ("units") and
// how the reduction axis is split when units are fewer than threads.
struct UnitMap {
  int half;     // rows / 2: a unit owns rows rp and rp + half
  int units;    // half * (gp / 8)
  int split;    // groups the reduction axis is split into (>= 1)
  int per_pass; // units handled at once (kThreads / split)
  int group;    // this thread's group (>= split: the thread idles)
  int lane;     // this thread's unit within a pass
};

__device__ __forceinline__ UnitMap unit_map(int rows, int gp, int depth) {
  UnitMap m;
  m.half = rows >> 1;
  m.units = m.half * (gp >> 3);
  m.split = max(1, min(min(kThreads / m.units, kMaxSplit), depth));
  m.per_pass = kThreads / m.split;
  m.group = threadIdx.x / m.per_pass;
  m.lane = threadIdx.x - m.group * m.per_pass;
  return m;
}

struct RegTile {
  float a0[8];   // row rp,        8 columns
  float a1[8];   // row rp + half, 8 columns
  float e0, e1;  // the check column's two rows (own accumulators)
};

__device__ __forceinline__ void reg_tile_zero(RegTile& t) {
#pragma unroll
  for (int c = 0; c < 8; ++c) { t.a0[c] = 0.f; t.a1[c] = 0.f; }
  t.e0 = 0.f; t.e1 = 0.f;
}

__device__ __forceinline__ void reg_tile_fma(RegTile& t, float l0, float l1,
                                             const float4& lo,
                                             const float4& hi) {
  t.a0[0] = fmaf(l0, lo.x, t.a0[0]); t.a0[1] = fmaf(l0, lo.y, t.a0[1]);
  t.a0[2] = fmaf(l0, lo.z, t.a0[2]); t.a0[3] = fmaf(l0, lo.w, t.a0[3]);
  t.a0[4] = fmaf(l0, hi.x, t.a0[4]); t.a0[5] = fmaf(l0, hi.y, t.a0[5]);
  t.a0[6] = fmaf(l0, hi.z, t.a0[6]); t.a0[7] = fmaf(l0, hi.w, t.a0[7]);
  t.a1[0] = fmaf(l1, lo.x, t.a1[0]); t.a1[1] = fmaf(l1, lo.y, t.a1[1]);
  t.a1[2] = fmaf(l1, lo.z, t.a1[2]); t.a1[3] = fmaf(l1, lo.w, t.a1[3]);
  t.a1[4] = fmaf(l1, hi.x, t.a1[4]); t.a1[5] = fmaf(l1, hi.y, t.a1[5]);
  t.a1[6] = fmaf(l1, hi.z, t.a1[6]); t.a1[7] = fmaf(l1, hi.w, t.a1[7]);
}

// dst[rp, 8cb..] (+)= t.a0 and dst[rp + half, 8cb..] (+)= t.a1; `first`
// stores instead of adding.  Row pitch gp floats (a multiple of 8).
__device__ __forceinline__ void reg_tile_flush(const RegTile& t, float* dst,
                                               int rp, int half, int cb,
                                               int gp, bool first) {
  float4* d0 = reinterpret_cast<float4*>(dst + rp * gp) + 2 * cb;
  float4* d1 = reinterpret_cast<float4*>(dst + (rp + half) * gp) + 2 * cb;
  float4 o;
  o = first ? make_float4(0.f, 0.f, 0.f, 0.f) : d0[0];
  d0[0] = make_float4(o.x + t.a0[0], o.y + t.a0[1], o.z + t.a0[2], o.w + t.a0[3]);
  o = first ? make_float4(0.f, 0.f, 0.f, 0.f) : d0[1];
  d0[1] = make_float4(o.x + t.a0[4], o.y + t.a0[5], o.z + t.a0[6], o.w + t.a0[7]);
  o = first ? make_float4(0.f, 0.f, 0.f, 0.f) : d1[0];
  d1[0] = make_float4(o.x + t.a1[0], o.y + t.a1[1], o.z + t.a1[2], o.w + t.a1[3]);
  o = first ? make_float4(0.f, 0.f, 0.f, 0.f) : d1[1];
  d1[1] = make_float4(o.x + t.a1[4], o.y + t.a1[5], o.z + t.a1[6], o.w + t.a1[7]);
}

// acc += S_tile @ x and, with `with_col`, ex += S_tile @ x_r for the staged
// tile.  The column product shares the loop (it reuses the S values already
// in registers) but has its own multiply-adds and accumulators: it is never
// derived from the x product.  Every thread of the block must call this.
__device__ __forceinline__ void aggregate_tile(const float* s_sm,
                                               const float* x_sm,
                                               const float* xr_sm,
                                               float* acc_sm, float* ex_sm,
                                               int bm, int bk, int gp,
                                               bool with_col) {
  const int ld = bk + 1;
  const int ncg = gp >> 2;
  const float4* x4 = reinterpret_cast<const float4*>(x_sm);
  const UnitMap m = unit_map(bm, gp, bk);
  for (int u0 = 0; u0 < m.units; u0 += m.per_pass) {
    const int u = u0 + m.lane;
    const bool active = m.group < m.split && u < m.units;
    const int cb = u / m.half;
    const int rp = u - cb * m.half;
    const bool col = with_col && cb == 0;
    RegTile t;
    reg_tile_zero(t);
    if (active) {
      const float* s0 = s_sm + rp * ld;
      const float* s1 = s_sm + (rp + m.half) * ld;
      const float4* xc = x4 + 2 * cb;
#pragma unroll 4
      for (int k = m.group; k < bk; k += m.split) {
        const float l0 = s0[k], l1 = s1[k];
        reg_tile_fma(t, l0, l1, xc[k * ncg], xc[k * ncg + 1]);
        if (col) {
          const float xv = xr_sm[k];
          t.e0 = fmaf(l0, xv, t.e0);
          t.e1 = fmaf(l1, xv, t.e1);
        }
      }
    }
    // add the groups' partial products to the accumulator, group by group
    for (int g = 0; g < m.split; ++g) {
      if (active && m.group == g) {
        reg_tile_flush(t, acc_sm, rp, m.half, cb, gp, false);
        if (col) { ex_sm[rp] += t.e0; ex_sm[rp + m.half] += t.e1; }
      }
      __syncthreads();
    }
  }
}

// Write the stripe's results: out rows, Σ acc, and the check column.
__device__ __forceinline__ void stripe_epilogue(const float* acc_sm,
                                                const float* ex_sm,
                                                float* red, float* out,
                                                float* sums, float* extra,
                                                int stripe, int bm, int gp) {
  const int n = bm * gp;
  float* o = out + (size_t)stripe * n;
  for (int t = threadIdx.x; t < n; t += kThreads) o[t] = acc_sm[t];
  const float tot = block_sum_array(acc_sm, n, red);
  if (threadIdx.x == 0) sums[stripe] = tot;
  for (int t = threadIdx.x; t < bm; t += kThreads)
    extra[(size_t)stripe * bm + t] = ex_sm[t];
}

}  // namespace abft
