// One GCN-ABFT layer out = S (H W) in a single sweep, for NVIDIA Hopper.
//
// Replaces the TPU kernel `gcn_fused_kernel` (`_make_kernel`) of
// src/repro/kernels/gcn_fused/kernel.py.  Per stored tile (stripe i, slot j):
//
//   h    = H[block_cols[i, j]]        [bk, F]
//   x    = h @ W                      [bk, G]   recomputed, never in device memory
//   x_r  = h @ w_r                    [bk]      the carried checksum column
//   acc += S_tile @ x ;  ex += S_tile @ x_r
//
// and the same three outputs as spmm_abft (out, stripe_sums, extra), plus,
// with `with_slots`, the telescoped running sums Σ acc and Σ ex recorded
// after every slot (after the inject hook), from which slot-granular check
// corners are differenced.  `with_check == 0` does none of the check
// products and leaves `extra` all zero.
//
// Check independence: x and x_r come from two separate sets of multiply-adds
// on the same staged operands, and ex from its own S_tile @ x_r — never from
// row sums of x or acc — so a fault in one side cannot cancel against the
// other.
//
// What bounds it on this card: at narrow F, bytes (the S tiles, as in
// spmm_abft).  At Cora's F = 1433 the recomputed combination is 5.9 MFLOP
// per stored tile against 0.56 for the aggregation, and the sweep is bound
// by f32 operations and by re-reading H tiles.
//
// Design.  One block owns one row-stripe and walks its slots in order, as in
// spmm_abft.  The TPU kernel held a whole [bk, F] H tile and all of W in
// on-chip memory; a [128, 1433] tile is 733 KB and one block has 227 KB, so
// this kernel WALKS F IN CHUNKS of kFChunk columns: it stages an H chunk
// [bk, kFChunk] (rows padded by one float against bank conflicts) and the
// matching rows of W and w_r.  The next chunk is loaded into registers while
// the current one is multiplied.  Each thread keeps a 2 x 8 register tile of
// x for the whole walk over F (the chunk's columns are split over thread
// groups), and the groups' partial sums are added into shared memory once
// per tile, group by group.  W is streamed with the chunks (it stays in L2),
// not held resident, so the shared-memory footprint does not depend on F;
// analysis/vmem.py states the same footprint, and the condition that a
// [bk, G] tile has at most one register tile per thread, and the engine's
// fallback predicate reads both there.
//
// What holds it back: one block per stripe (few blocks), scalar f32 FMAs for
// a product that wgmma could carry in TF32 only by giving up the check's f32
// noise floor, and the recomputation per stored tile itself, padding tiles
// included.
#include "abft_tile.cuh"

using namespace abft;

namespace {

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

struct ChunkRegs {
  float h[kHWin];
  float w[kWWin];
  float wr;
};

// One operand chunk starting at feature f0: element readers (zero beyond F).
struct ChunkSrc {
  const float* hrows;  // H rows of this tile
  const float* w;
  const float* wr;
  int f, gp, f0;
  __device__ __forceinline__ float h_at(int i) const {
    const int kr = i / kFChunk, ff = i - kr * kFChunk;
    return f0 + ff < f ? __ldg(hrows + (size_t)kr * f + f0 + ff) : 0.f;
  }
  __device__ __forceinline__ float w_at(int i) const {
    return f0 + i / gp < f ? __ldg(w + (size_t)f0 * gp + i) : 0.f;
  }
  __device__ __forceinline__ float wr_at(int i) const {
    return f0 + i < f ? __ldg(wr + f0 + i) : 0.f;
  }
};

__device__ __forceinline__ void chunk_issue(ChunkRegs& r, const ChunkSrc& s,
                                            int bk, int with_check) {
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

__device__ __forceinline__ void chunk_commit(const ChunkRegs& r,
                                             const ChunkSrc& s, int bk,
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
__device__ __forceinline__ void combine_tile(
    const float* __restrict__ h, const float* __restrict__ w,
    const float* __restrict__ wr, int c, int bk, int f, int gp,
    int with_check, float* x_sm, float* xr_sm, float* w_sm, float* wr_sm,
    float* h_sm) {
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
  ChunkSrc src{h + (size_t)c * bk * f, w, wr, f, gp, 0};
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

__global__ void __launch_bounds__(kThreads, 2)
gcn_fused_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                 const float* __restrict__ h, const float* __restrict__ w,
                 const float* __restrict__ wr, float* __restrict__ out,
                 float* __restrict__ sums, float* __restrict__ extra,
                 float* __restrict__ slot_acts, float* __restrict__ slot_preds,
                 int width, int bm, int bk, int f, int gp, int with_check,
                 int with_slots, int inj_stripe, int inj_slot,
                 float inj_delta) {
  extern __shared__ float4 smem4[];
  float* acc_sm = reinterpret_cast<float*>(smem4);
  float* x_sm = acc_sm + bm * gp;
  float* w_sm = x_sm + bk * gp;
  float* ex_sm = w_sm + kFChunk * gp;
  float* xr_sm = ex_sm + bm;
  float* wr_sm = xr_sm + bk;
  float* red = wr_sm + kFChunk;
  float* h_sm = red + kReduceScratch;
  float* s_sm = h_sm + bk * (kFChunk + 1);

  const int i = blockIdx.x;
  for (int t = threadIdx.x; t < bm * gp; t += kThreads) acc_sm[t] = 0.f;
  for (int t = threadIdx.x; t < bm; t += kThreads) ex_sm[t] = 0.f;
  __syncthreads();

  const size_t tile_floats = (size_t)bm * bk;
  for (int j = 0; j < width; ++j) {
    const int c = cols[i * width + j];
    const float* tile = vals + ((size_t)i * width + j) * tile_floats;
    load_s_tile(tile, s_sm, bm, bk);
    if (j + 1 < width)
      prefetch_l2(tile + tile_floats, (int)(tile_floats * sizeof(float)));
    combine_tile(h, w, wr, c, bk, f, gp, with_check, x_sm, xr_sm, w_sm, wr_sm,
                 h_sm);

    aggregate_tile(s_sm, x_sm, xr_sm, acc_sm, ex_sm, bm, bk, gp,
                   with_check != 0);

    if (i == inj_stripe && j == inj_slot && threadIdx.x == 0)
      acc_sm[0] += inj_delta;
    if (with_slots) {
      // telescoped running sums, recorded AFTER the inject hook: an
      // accumulator upset between two recordings lands in exactly one
      // adjacent difference
      __syncthreads();
      const float sa = block_sum_array(acc_sm, bm * gp, red);
      const float sp = block_sum_array(ex_sm, bm, red);
      if (threadIdx.x == 0) {
        slot_acts[i * width + j] = sa;
        slot_preds[i * width + j] = sp;
      }
    }
  }
  __syncthreads();
  stripe_epilogue(acc_sm, ex_sm, red, out, sums, extra, i, bm, gp);
}

}  // namespace

extern "C" int gcn_fused_smem_bytes(int bm, int bk, int gp) {
  return fused_smem_floats(bm, bk, gp) * (int)sizeof(float);
}

extern "C" int gcn_fused_f_chunk() { return kFChunk; }

extern "C" int gcn_fused_supported(int bm, int bk, int gp) {
  return fused_supported(bm, bk, gp) ? 1 : 0;
}

// Launch on `stream`; allocates nothing, does not synchronise, returns
// cudaGetLastError() (0 on success).  `slot_acts`/`slot_preds` are written
// only when `with_slots` is set.
extern "C" int gcn_fused_launch(const int* cols, const float* vals,
                                const float* h, const float* w,
                                const float* wr, float* out, float* sums,
                                float* extra, float* slot_acts,
                                float* slot_preds, int nbm, int width, int bm,
                                int bk, int f, int gp, int with_check,
                                int with_slots, int inj_stripe, int inj_slot,
                                float inj_delta, void* stream) {
  if (!fused_supported(bm, bk, gp)) return (int)cudaErrorInvalidValue;
  const int smem = gcn_fused_smem_bytes(bm, bk, gp);
  cudaError_t err = cudaFuncSetAttribute(
      gcn_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gcn_fused_kernel<<<nbm, kThreads, smem, (cudaStream_t)stream>>>(
      cols, vals, h, w, wr, out, sums, extra, slot_acts, slot_preds, width,
      bm, bk, f, gp, with_check, with_slots, inj_stripe, inj_slot, inj_delta);
  return (int)cudaGetLastError();
}
