// One row-stripe of a GCN layer S (H W) in a single sweep: the per-tile code
// shared by the single-layer kernel (gcn_fused.cu) and the whole-network
// kernel (gcn_network.cu).
//
// Both kernels run a stripe through `fused_stripe_sweep`, so a layer's stripe
// executes the same instructions in the same order whichever kernel runs it:
// the network kernel's logits, telescopes and activations are bit for bit
// those of a chain of single-layer launches.
//
// Per stored tile (stripe i, slot j):
//
//   h    = H[block_cols[i, j]]        [bk, F]
//   x    = h @ W                      [bk, G]   recomputed, never in device memory
//   x_r  = h @ w_r                    [bk]      the carried checksum column
//   acc += S_tile @ x ;  ex += S_tile @ x_r
//
// x and x_r come from two separate sets of multiply-adds on the same staged
// operands, and ex from its own S_tile @ x_r — never from row sums of x or
// acc — so a fault in one side cannot cancel against the other.
//
// A [128, 1433] H tile is 733 KB and one block has 227 KB, so the sweep WALKS
// F IN CHUNKS of kFChunk columns: it stages an H chunk [bk, kFChunk] (rows
// padded by one float against bank conflicts) and the matching rows of W and
// w_r.  The next chunk is loaded into registers while the current one is
// multiplied.  Each thread keeps a 2 x 8 register tile of x for the whole walk
// over F (the chunk's columns are split over thread groups), and the groups'
// partial sums are added into shared memory once per tile, group by group.
// W is streamed with the chunks (it stays in L2), not held resident, so the
// shared-memory footprint does not depend on F; analysis/vmem.py states the
// same footprint.
#pragma once

#include "abft_tile.cuh"

namespace abft {

constexpr int kFChunk = 32;
// register windows of the chunk prefetch: a thread's share of the next H
// chunk (bk * kFChunk / kThreads), W rows (kFChunk * gp / kThreads) and w_r
// rows; shares beyond a window are loaded when the chunk is committed
constexpr int kHWin = 8;
constexpr int kWWin = 1;

__host__ __device__ inline int fused_smem_floats(int bm, int bk, int gp) {
  return bm * gp + bk * gp + kFChunk * gp + bm + bk + kFChunk +
         kReduceScratch + bk * (kFChunk + 1) + bm * (bk + 1);
}

__host__ __device__ inline bool fused_supported(int bm, int bk, int gp) {
  return !(bm & 1) && !(bk & 3) && !(gp & 7) &&
         (bk >> 1) * (gp >> 3) <= kThreads;
}

// A load from L2, bypassing L1 and the read-only path: for data that other
// blocks wrote earlier in the same launch (after a grid-wide barrier).
// `volatile` keeps the compiler from moving it across that barrier.
__device__ __forceinline__ float ld_l2(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// H through the read-only path (`kL2 == false`: nothing writes H during the
// launch) or from L2 (`kL2 == true`: H may have been written by this
// launch).
template <bool kL2>
__device__ __forceinline__ float load_h(const float* p) {
  if constexpr (kL2) return ld_l2(p);
  else return __ldg(p);
}

struct ChunkRegs {
  float h[kHWin];
  float w[kWWin];
  float wr;
};

// One operand chunk starting at feature f0: element readers (zero beyond F).
template <bool kL2>
struct ChunkSrc {
  const float* hrows;  // H rows of this tile
  const float* w;
  const float* wr;
  int f, gp, f0;
  __device__ __forceinline__ float h_at(int i) const {
    const int kr = i / kFChunk, ff = i - kr * kFChunk;
    return f0 + ff < f ? load_h<kL2>(hrows + (size_t)kr * f + f0 + ff) : 0.f;
  }
  __device__ __forceinline__ float w_at(int i) const {
    return f0 + i / gp < f ? __ldg(w + (size_t)f0 * gp + i) : 0.f;
  }
  __device__ __forceinline__ float wr_at(int i) const {
    return f0 + i < f ? __ldg(wr + f0 + i) : 0.f;
  }
};

template <bool kL2>
__device__ __forceinline__ void chunk_issue(ChunkRegs& r,
                                            const ChunkSrc<kL2>& s, int bk,
                                            int with_check) {
#pragma unroll
  for (int u = 0; u < kHWin; ++u) {
    const int i = threadIdx.x + u * kThreads;
    r.h[u] = i < bk * kFChunk ? s.h_at(i) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kWWin; ++u) {
    const int i = threadIdx.x + u * kThreads;
    r.w[u] = i < kFChunk * s.gp ? s.w_at(i) : 0.f;
  }
  r.wr = (with_check && threadIdx.x < kFChunk) ? s.wr_at(threadIdx.x) : 0.f;
}

template <bool kL2>
__device__ __forceinline__ void chunk_commit(const ChunkRegs& r,
                                             const ChunkSrc<kL2>& s, int bk,
                                             int with_check, float* h_sm,
                                             float* w_sm, float* wr_sm) {
  constexpr int ldh = kFChunk + 1;
#pragma unroll
  for (int u = 0; u < kHWin; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < bk * kFChunk) h_sm[(i / kFChunk) * ldh + i % kFChunk] = r.h[u];
  }
  for (int i = threadIdx.x + kHWin * kThreads; i < bk * kFChunk; i += kThreads)
    h_sm[(i / kFChunk) * ldh + i % kFChunk] = s.h_at(i);
#pragma unroll
  for (int u = 0; u < kWWin; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < kFChunk * s.gp) w_sm[i] = r.w[u];
  }
  for (int i = threadIdx.x + kWWin * kThreads; i < kFChunk * s.gp; i += kThreads)
    w_sm[i] = s.w_at(i);
  if (with_check && threadIdx.x < kFChunk) wr_sm[threadIdx.x] = r.wr;
}

// x_sm = H[c] @ W and (with_check) xr_sm = H[c] @ w_r, walking F in chunks.
// Every thread of the block must call this; it ends with a barrier.
template <bool kL2>
__device__ __forceinline__ void combine_tile(
    const float* h, const float* __restrict__ w, const float* __restrict__ wr,
    int c, int bk, int f, int gp, int with_check, float* x_sm, float* xr_sm,
    float* w_sm, float* wr_sm, float* h_sm) {
  constexpr int ldh = kFChunk + 1;
  const int ncg = gp >> 2;
  const UnitMap m = unit_map(bk, gp, kFChunk);   // units <= kThreads: one pass
  const bool active = m.group < m.split && m.lane < m.units;
  const int cb = m.lane / m.half;
  const int rp = m.lane - cb * m.half;
  const bool col = with_check && cb == 0;
  const float4* w4 = reinterpret_cast<const float4*>(w_sm) + 2 * cb;
  const float* h0 = h_sm + rp * ldh;
  const float* h1 = h_sm + (rp + m.half) * ldh;

  RegTile t;
  reg_tile_zero(t);
  ChunkSrc<kL2> src{h + (size_t)c * bk * f, w, wr, f, gp, 0};
  ChunkRegs regs;
  chunk_issue(regs, src, bk, with_check);
  for (int f0 = 0; f0 < f; f0 += kFChunk) {
    __syncthreads();          // the previous chunk's readers are done
    src.f0 = f0;
    chunk_commit(regs, src, bk, with_check, h_sm, w_sm, wr_sm);
    __syncthreads();
    if (f0 + kFChunk < f) {   // next chunk's loads fly during this product
      src.f0 = f0 + kFChunk;
      chunk_issue(regs, src, bk, with_check);
    }
    if (active) {
#pragma unroll 4
      for (int ff = m.group; ff < kFChunk; ff += m.split) {
        const float l0 = h0[ff], l1 = h1[ff];
        reg_tile_fma(t, l0, l1, w4[ff * ncg], w4[ff * ncg + 1]);
        if (col) {
          // the eq.-5 column: its own multiply-adds on the staged chunk
          const float wv = wr_sm[ff];
          t.e0 = fmaf(l0, wv, t.e0);
          t.e1 = fmaf(l1, wv, t.e1);
        }
      }
    }
  }
  // the groups' partial sums, added group by group (group 0 stores)
  for (int g = 0; g < m.split; ++g) {
    if (active && m.group == g) {
      reg_tile_flush(t, x_sm, rp, m.half, cb, gp, g == 0);
      if (col) {
        xr_sm[rp] = (g == 0 ? 0.f : xr_sm[rp]) + t.e0;
        xr_sm[rp + m.half] = (g == 0 ? 0.f : xr_sm[rp + m.half]) + t.e1;
      }
    }
    __syncthreads();
  }
}

// The shared-memory carve of one fused sweep at output width gp; the total is
// fused_smem_floats(bm, bk, gp).
struct FusedSmem {
  float *acc, *x, *w, *ex, *xr, *wr, *red, *h, *s;
};

__device__ __forceinline__ FusedSmem carve_fused_smem(float* base, int bm,
                                                      int bk, int gp) {
  FusedSmem m;
  m.acc = base;
  m.x = m.acc + bm * gp;
  m.w = m.x + bk * gp;
  m.ex = m.w + kFChunk * gp;
  m.xr = m.ex + bm;
  m.wr = m.xr + bk;
  m.red = m.wr + kFChunk;
  m.h = m.red + kReduceScratch;
  m.s = m.h + bk * (kFChunk + 1);
  return m;
}

// Sweep stripe i's slots in order into sm.acc [bm, gp] and sm.ex [bm].  The
// inject hook adds `inj_delta` to acc[0, 0] after slot `inj_slot` (-1: never).
// With `with_slots`, the telescoped running sums Σ acc and Σ ex are recorded
// after every slot, AFTER the inject hook: an accumulator upset between two
// recordings lands in exactly one adjacent difference.  Every thread of the
// block must call this; it ends with a barrier (acc and ex final).
template <bool kL2>
__device__ __forceinline__ void fused_stripe_sweep(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const float* h, const float* __restrict__ w, const float* __restrict__ wr,
    int i, int width, int bm, int bk, int f, int gp, int with_check,
    int with_slots, int inj_slot, float inj_delta, float* slot_acts,
    float* slot_preds, const FusedSmem& sm) {
  for (int t = threadIdx.x; t < bm * gp; t += kThreads) sm.acc[t] = 0.f;
  for (int t = threadIdx.x; t < bm; t += kThreads) sm.ex[t] = 0.f;
  __syncthreads();

  const size_t tile_floats = (size_t)bm * bk;
  for (int j = 0; j < width; ++j) {
    const int c = cols[i * width + j];
    const float* tile = vals + ((size_t)i * width + j) * tile_floats;
    load_s_tile(tile, sm.s, bm, bk);
    if (j + 1 < width)
      prefetch_l2(tile + tile_floats, (int)(tile_floats * sizeof(float)));
    combine_tile<kL2>(h, w, wr, c, bk, f, gp, with_check, sm.x, sm.xr, sm.w,
                      sm.wr, sm.h);

    aggregate_tile(sm.s, sm.x, sm.xr, sm.acc, sm.ex, bm, bk, gp,
                   with_check != 0);

    if (j == inj_slot && threadIdx.x == 0) sm.acc[0] += inj_delta;
    if (with_slots) {
      __syncthreads();
      const float sa = block_sum_array(sm.acc, bm * gp, sm.red);
      const float sp = block_sum_array(sm.ex, bm, sm.red);
      if (threadIdx.x == 0) {
        slot_acts[i * width + j] = sa;
        slot_preds[i * width + j] = sp;
      }
    }
  }
  __syncthreads();
}

}  // namespace abft
