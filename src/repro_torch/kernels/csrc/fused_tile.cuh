// One GCN layer S (H W) in two phases: the code shared by the single-layer
// kernel (gcn_fused.cu) and the whole-network kernel (gcn_network.cu).
//
// Phase A, the combination, once per row of H (not once per stored tile):
//
//   X   = H @ W      [K, gp]   into a device workspace (1.2 MB at Cora: L2)
//   x_r = H @ w_r    [K]       the carried checksum column
//
// An item is 64 rows x ct columns of X (ct the largest multiple of 8 up to
// 64 that divides gp; the first column tile also carries x_r).  F streams
// through a cp.async ring in chunks of 64 features (the H chunk, W's rows
// and w_r's), the ragged end of F zero-filled.
//
// Phase B, the aggregation, a row slice of a stripe at a time:
//
//   acc += S[i,j] @ X[cols[i,j]] ;  ex += S[i,j] @ x_r[cols[i,j]]
//
// over the stripe's slots in order, padding tiles included.  S streams
// through a 4-stage ring in chunks of kc k-columns (32, or 16, 8, 4 where bk
// has no 32), each with the X and x_r rows it meets: thread 0 issues one
// TMA box of S (swizzled as its rows are long, from a tensor map the
// launcher makes) and two bulk copies on the stage's mbarrier, and the
// other threads issue no copy at all; the column block of the next slot is
// loaded a slot ahead, so that no copy waits on it.  A stripe
// is cut into row slices of at most 128 rows, one block each (one a stripe
// up to block 128; 64-row slices, two blocks a stripe there, were slower:
// 288 blocks run in two waves of 264).  The inject hook adds `inj_delta`
// to acc[0, 0] after slot `inj_slot`; with `with_slots`, Σ acc and Σ ex
// are recorded after every slot, after the hook, from warp sums (no
// barrier of their own), so an accumulator upset lands in exactly one
// adjacent difference.  Each slice records its own running sums (and its
// Σ out); the stripe's last slice to finish adds them in slice order — a
// counter says which is last, the values never pass through an atomic.
//
// x and x_r are two separate sets of multiply-adds on the same staged
// operands, and ex its own product with S, never derived from acc: a fault
// in the workspace or in one product shows at the check corner.
//
// The cut is a pure function of (bm, bk, gp) (`make_plan`, mirrored by
// analysis/vmem.py `fused_plan`): F only moves where the zero fill starts,
// and neither the stripe count nor the grid enters, so B2 and B3, a gathered
// stripe sub-system and a second run give the same bits.
#pragma once

#include "abft_tile.cuh"

namespace abft {

constexpr int kCombineRows = 64;    // rows of H a combine item owns
constexpr int kCombineCols = 64;    // most columns of X a combine item owns
constexpr int kFChunk = 64;         // features a combine stage holds
constexpr int kSweepChunk = 32;     // most k-columns a sweep stage holds
constexpr int kSliceRows = 128;     // most rows one sweep block owns
constexpr int kSmemBudget = 232448;
// floats before the ring: the telescopes' double buffer [2][kWarps][2],
// the block sum's warp partials [kWarps], the last-slice flag, and from
// float kBarsAt the sweep's mbarriers, one a stage; the ring starts at the
// next 1024-byte boundary (the TMA swizzle's atom)
constexpr int kHeaderFloats = 64;
constexpr int kBarsAt = 48;
constexpr int kAlign = 1024;
// the fused kernels' shape contract: at most this many 2 x 8 pieces in a
// [bk, gp] X tile, the bound of the first port's per-tile design, kept so
// that the engine routes the same layers to these kernels (with the ring,
// every such shape fits)
constexpr int kMaxXPieces = 512;

// floats of one sweep stage: the S box [rows][kc] as TMA swizzles it, the
// X rows [kc][nc], the x_r rows [kc], rounded up to the 1024-byte atom
__host__ __device__ inline int box_stage_floats(const Tile& t) {
  constexpr int atom = kAlign / 4;
  return (t.rows * t.kc + t.kc * t.nc + t.kc + atom - 1) / atom * atom;
}

// The ring: the first 1024-byte boundary after the header.
__device__ __forceinline__ float* ring_of(float* smem) {
  const uint32_t base = smem_u32(smem);
  const uint32_t at = (base + 4 * kHeaderFloats + kAlign - 1) / kAlign * kAlign;
  return smem + (at - base) / 4;
}

struct Plan {
  int ct;         // combine: columns of X an item owns (divides gp)
  int col_tiles;  // gp / ct
  Tile a;         // combine: [kCombineRows, ct] += H chunk @ W chunk
  Tile b;         // sweep: [rows, gp] += S chunk @ X rows
  int slices;     // sweep blocks a stripe takes: bm / b.rows
  int smem;       // dynamic shared memory, bytes (0: shape not supported)
};

__host__ __device__ inline Plan make_plan(int bm, int bk, int gp) {
  Plan p{};
  if (bm < 2 || (bm & 1) || bk < 4 || (bk & 3) || gp < 8 || (gp & 7) ||
      (bk / 2) * (gp / 8) > kMaxXPieces)
    return p;
  for (p.ct = kCombineCols; gp % p.ct; p.ct -= 8) {}
  p.col_tiles = gp / p.ct;
  if (!make_tile(p.a, kCombineRows, p.ct, kFChunk)) return p;
  int kc = kSweepChunk;
  while (bk % kc) kc >>= 1;
  for (int s = (bm + kSliceRows - 1) / kSliceRows; s <= bm / 2; ++s)
    if (bm % s == 0 && (bm / s) % 2 == 0 && make_tile(p.b, bm / s, gp, kc)) {
      p.slices = s;
      break;
    }
  if (!p.slices) return p;
  int fl = kStages * stage_floats(p.a);
  if (kStages * box_stage_floats(p.b) > fl) fl = kStages * box_stage_floats(p.b);
  if (fold_floats(p.a) > fl) fl = fold_floats(p.a);
  if (fold_floats(p.b) > fl) fl = fold_floats(p.b);
  const int bytes = 4 * kHeaderFloats + kAlign + 4 * fl;
  if (bytes <= kSmemBudget) p.smem = bytes;
  return p;
}

// --- phase A --------------------------------------------------------------

struct CombineArgs {
  const float* h;    // [k_rows, f]
  const float* w;    // [f, gp]
  const float* wr;   // [f, 1]
  float* x;          // [k_rows, gp]
  float* xr;         // [k_rows]
  int k_rows, f, gp, with_check;
};

__host__ __device__ inline int combine_items(const Plan& p, int k_rows) {
  return (k_rows + kCombineRows - 1) / kCombineRows * p.col_tiles;
}

// X and x_r of combine items first, first + stride, ... (item i: row tile
// i / col_tiles, column tile i % col_tiles).  H is copied 4 bytes a thread
// (its rows need not be 16-byte aligned: F = 1433), a warp 32 features of
// a row; with `kL2` (H written earlier in the same launch: the network
// kernel's activations) it is loaded from L2 and stored by the issuing
// thread instead.  Every thread of the block must call this; it ends with
// a barrier.
template <int RT, bool kL2>
__device__ __forceinline__ void combine_items_from(const CombineArgs& g,
                                                   const Plan& p, int first,
                                                   int stride, float* smem) {
  constexpr int ld = kFChunk + 4;
  constexpr int kRowStep = kThreads / kFChunk;           // 4
  constexpr int kPer = kCombineRows / kRowStep;          // 16 rows a thread
  // what the chunk loop reads, in registers: the copies' "memory" clobbers
  // would have it reloaded from parameter memory every chunk
  const Cut cut = cut_of(p.a);
  const int ct = p.ct;
  const float* __restrict__ w = g.w;   // also the source of zero-size copies
  const int k_rows = g.k_rows, f = g.f, gp = g.gp;
  const Lane l = lane_of(p.a);
  const int sf = stage_floats(p.a);
  const int n = (f + kFChunk - 1) / kFChunk;
  const int tid = threadIdx.x;
  // this thread's H elements: feature f0 + hf of rows hr + 4 i
  const int hf = tid % kFChunk, hr = tid / kFChunk;
  const int hstep = kRowStep * f;
  const int pr = ct >> 2;   // 16-byte pieces of a W row
  float* ring = ring_of(smem);
  const int items = combine_items(p, k_rows);
#pragma unroll 1
  for (int item = first; item < items; item += stride) {
    const int ctile = item % p.col_tiles;
    const int r0 = item / p.col_tiles * kCombineRows;
    const int c0 = ctile * ct;
    const bool check = g.with_check && ctile == 0;
    const bool col = check && l.cb == 0;
    const float* hsrc = g.h + (size_t)(r0 + hr) * f + hf;
    const bool all_rows = r0 + kCombineRows <= k_rows;

    auto issue = [&](int q) {
      if (q < n) {
        float* st = ring + (q % kStages) * sf;
        const int f0 = q * kFChunk;
        float* hdst = st + hr * ld + hf;
        const float* src = hsrc + f0;
        if (all_rows && f0 + kFChunk <= f) {
#pragma unroll
          for (int i = 0; i < kPer; ++i, src += hstep) {
            if constexpr (kL2) hdst[i * kRowStep * ld] = ld_cg(src);
            else cp4(hdst + i * kRowStep * ld, src, 4);
          }
        } else {   // the ragged end of F, or rows past K
#pragma unroll
          for (int i = 0; i < kPer; ++i, src += hstep) {
            const bool ok = f0 + hf < f && r0 + hr + i * kRowStep < k_rows;
            if constexpr (kL2) hdst[i * kRowStep * ld] = ok ? ld_cg(src) : 0.f;
            else cp4(hdst + i * kRowStep * ld, ok ? src : w, ok ? 4 : 0);
          }
        }
        float* ws = st + kCombineRows * ld;
        for (int e = tid; e < kFChunk * pr; e += kThreads) {
          const int ff = e / pr, v = e - ff * pr;
          const bool ok = f0 + ff < f;
          cp16(ws + ff * ct + 4 * v,
               ok ? w + (size_t)(f0 + ff) * gp + c0 + 4 * v : w, ok ? 16 : 0);
        }
        if (check && tid < kFChunk) {
          const bool ok = f0 + tid < f;
          cp4(ws + kFChunk * ct + tid, ok ? g.wr + f0 + tid : g.wr,
              ok ? 4 : 0);
        }
      }
      cp_commit();
    };

    float acc[RT][kCw], ex[RT];
    tile_zero(acc, ex);
    ring_run(n, issue, [&](int q) {
      if (l.active) {
        const float* st = ring + (q % kStages) * sf;
        const float* ws = st + kCombineRows * ld;
        tile_product<RT>(st, ws, ws + kFChunk * ct, cut, l, col, acc, ex);
      }
    });
    fold_groups(ring, p.a, l, acc, ex);
    if (l.active && l.kg == 0) {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int row = r0 + l.rp + i * cut.rpos;
        if (row >= k_rows) continue;
        float4* d = reinterpret_cast<float4*>(g.x + (size_t)row * gp + c0 +
                                              kCw * l.cb);
        d[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        d[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        if (col) g.xr[row] = ex[i];
      }
    }
  }
  // the sweep reads X and x_r with TMA (the async proxy), after a barrier
  fence_proxy_async_global();
}

template <bool kL2>
__device__ __forceinline__ void combine_any(const CombineArgs& g,
                                            const Plan& p, int first,
                                            int stride, float* smem) {
  if (p.a.rt == 4) combine_items_from<4, kL2>(g, p, first, stride, smem);
  else combine_items_from<2, kL2>(g, p, first, stride, smem);
}

// --- phase B --------------------------------------------------------------

// What a swept stripe writes: the layer's outputs (out [.., gp], the stripe
// sum, extra), the next layer's activations (relu, [.., g] unpadded), or
// the network's logits (out [.., gp]).
enum Epilogue { kEpiLayer = 0, kEpiAct = 1, kEpiLogits = 2 };

struct SweepArgs {
  const int* cols;       // [nbm, width]
  const float* vals;     // [nbm, width, bm, bk]
  const float* x;        // [K, gp] (the workspace)
  const float* xr;       // [K]
  float* out;            // see Epilogue
  float* sums;           // [nbm] (kEpiLayer)
  float* extra;          // [nbm * bm] (kEpiLayer)
  float* slot_acts;      // [nbm, width] (with_slots)
  float* slot_preds;     // [nbm, width] (with_slots)
  float* part;           // [nbm * slices, 2 * width + 1]: a slice's sums
  unsigned int* count;   // [nbm], 0 at launch: slices of a stripe done
  int nbm, width, bm, bk, gp, g, with_check, with_slots, epilogue;
  int inj_stripe, inj_slot;
  float inj_delta;
};

__host__ __device__ inline int part_floats(int width) { return 2 * width + 1; }

// The end of a swept slice: its rows of the epilogue's output, its Σ out,
// and, in the stripe's last slice to finish, the slices' sums added in
// slice order.  Every thread of the block must call this; it ends with a
// barrier.
template <int RT>
__device__ __forceinline__ void sweep_epilogue(const SweepArgs& a,
                                               const Plan& p, int item,
                                               const Lane& l,
                                               const float (&acc)[RT][kCw],
                                               const float (&ex)[RT],
                                               float* smem) {
  const int stripe = item / p.slices;
  const int row0 = (item - stripe * p.slices) * p.b.rows;
  float* wsum = smem + 4 * kWarps;     // [kWarps]
  int* last = reinterpret_cast<int*>(smem + 5 * kWarps);
  const int width = a.width, gp = a.gp, epilogue = a.epilogue;
  const int tid = threadIdx.x;
  const bool own = l.active && l.kg == 0;
  const size_t grow0 = (size_t)stripe * a.bm + row0 + l.rp;
  if (own) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const size_t row = grow0 + (size_t)i * p.b.rpos;
      if (epilogue == kEpiAct) {
        const int g = a.g;
#pragma unroll
        for (int c = 0; c < kCw; ++c) {
          const int cc = kCw * l.cb + c;
          const float v = acc[i][c];
          if (cc < g) a.out[row * g + cc] = v < 0.f ? 0.f : v;
        }
      } else {
        float4* d = reinterpret_cast<float4*>(a.out + row * gp + kCw * l.cb);
        d[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        d[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        if (epilogue == kEpiLayer && l.cb == 0) a.extra[row] = ex[i];
      }
    }
  }
  float* mine = a.part + (size_t)item * part_floats(width);
  if (epilogue == kEpiLayer) {
    const float v = block_sum(own ? tile_sum(acc) : 0.f, wsum);
    if (tid == 0) mine[2 * width] = v;
  }

  // the stripe's last slice adds the slices' sums in slice order
  const int slices = p.slices;
  if (tid == 0) {
    __threadfence();
    *last = atomicAdd(a.count + stripe, 1u) == (unsigned)slices - 1;
    __threadfence();
  }
  __syncthreads();
  if (*last) {
    const float* first = a.part + (size_t)stripe * slices * part_floats(width);
    const int nv = a.with_slots ? 2 * width + 1 : 1;
    for (int e = tid; e < nv; e += kThreads) {
      const int idx = a.with_slots ? e : 2 * width;
      float v = 0.f;
      for (int s = 0; s < slices; ++s)
        v += ld_cg(first + s * part_floats(width) + idx);
      if (idx == 2 * width) {
        if (epilogue == kEpiLayer) a.sums[stripe] = v;
      } else if (idx & 1) {
        a.slot_preds[stripe * width + (idx >> 1)] = v;
      } else {
        a.slot_acts[stripe * width + (idx >> 1)] = v;
      }
    }
    if (tid == 0) a.count[stripe] = 0;
  }
  __syncthreads();
}

// Sweep items first, first + stride, ...: row slice `item % slices` of
// stripe `item / slices`, and write its rows of what the epilogue says; the
// stripe's last slice to finish writes its telescopes and Σ out.  Every
// thread of the block must call this; it ends with a barrier.
template <int RT>
__device__ __forceinline__ void sweep_slices_from(const SweepArgs& a,
                                                  const Plan& p,
                                                  const CUtensorMap* smap,
                                                  int first, int stride,
                                                  float* smem) {
  // what the chunk loop reads, in registers: the copies' "memory" clobbers
  // would have it reloaded from parameter memory every chunk; the rest is
  // read from the arguments where it is used
  const Cut cut = cut_of(p.b);
  const int rows = p.b.rows, slices = p.slices;
  const int width = a.width, bk = a.bk, gp = a.gp;
  const bool with_check = a.with_check, with_slots = a.with_slots;
  const Lane l = lane_of(p.b);
  const bool col = with_check && l.cb == 0;
  const int sf = box_stage_floats(p.b);
  const int chunks = bk / cut.kc;
  const int n = width * chunks;
  const int tid = threadIdx.x;
  const uint32_t stage_bytes =
      4u * (rows * cut.kc + cut.kc * gp + (with_check ? cut.kc : 0));
  float* tele = smem;                  // [2][kWarps][2]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarsAt);
  float* ring = ring_of(smem);
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bars + st);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // chunks through the ring so far: chunk qq lands in stage qq % kStages,
  // whose mbarrier completes its (qq / kStages)-th phase
  int qq = 0;
#pragma unroll 1
  for (int item = first; item < a.nbm * slices; item += stride) {
    const int stripe = item / slices;
    const int slice = item - stripe * slices;
    // the slot after which the inject hook fires in this thread (-1: none)
    const int inj_slot = stripe == a.inj_stripe && slice == 0 &&
                                 l.kg == 0 && l.u == 0
                             ? a.inj_slot
                             : -1;
    // the S row of slot 0's tile: stripe's tile rows, then this slice's
    const int srow0 = stripe * width * a.bm + slice * rows;
    // thread 0: slot j's Σ acc and Σ ex, the warps' partials in warp order
    auto flush = [&](int j) {
      const float* b = tele + (j & 1) * 2 * kWarps;
      float sa = 0.f, se = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        sa += b[2 * w];
        se += b[2 * w + 1];
      }
      float* mine = a.part + (size_t)item * part_floats(width);
      mine[2 * j] = sa;
      mine[2 * j + 1] = se;
    };

    // thread 0 alone copies: chunk q of this item (nothing past the last)
    // as one TMA box of S and bulk copies of the X and x_r rows it meets;
    // the next slot's column block is loaded a slot ahead
    int ij = 0, ih = 0, ic = 0;
    int ic_next = 0;
    auto issue = [&](int q) {
      if (q >= n) return;
      if (ih == 0) {
        ic = ic_next;
        if (ij + 1 < width)
          ic_next = __ldg(a.cols + (size_t)stripe * width + ij + 1);
      }
      const int k0 = ih * cut.kc;
      const int st = (qq + q) % kStages;
      float* s_sm = ring + st * sf;
      float* xs = s_sm + rows * cut.kc;
      const size_t xrow = (size_t)ic * bk + k0;
      mbar_expect(bars + st, stage_bytes);
      tma_box(s_sm, smap, k0, srow0 + ij * a.bm, bars + st);
      tma_bulk(xs, a.x + xrow * gp, 4u * cut.kc * gp, bars + st);
      if (with_check)
        tma_bulk(xs + cut.kc * gp, a.xr + xrow, 4u * cut.kc, bars + st);
      if (++ih == chunks) {
        ih = 0;
        ++ij;
      }
    };

    float acc[RT][kCw], ex[RT];
    tile_zero(acc, ex);
    // the ring was last written by the generic proxy (the previous item's
    // fold, or the combination); hand it to TMA
    __syncthreads();
    if (tid == 0) {
      fence_proxy_async_shared();
      if (width > 0) ic_next = __ldg(a.cols + (size_t)stripe * width);
      for (int q = 0; q < kStages - 1; ++q) issue(q);
    }
    int cj = 0, ch = 0;   // the slot and chunk being multiplied
#pragma unroll 1
    for (int q = 0; q < n; ++q) {
      // one barrier a chunk: everyone is done with chunk q - 1, whose stage
      // chunk q + kStages - 1 then fills
      __syncthreads();
      if (tid == 0) issue(q + kStages - 1);
      const int st = (qq + q) % kStages;
      mbar_wait(bars + st, ((qq + q) / kStages) & 1);
      // slot cj - 1's partials were recorded before this chunk's barrier
      if (with_slots && ch == 0 && cj > 0 && tid == 0) flush(cj - 1);
      if (l.active) {
        const float* s_sm = ring + st * sf;
        const float* xs = s_sm + rows * cut.kc;
        tile_product<RT, true>(s_sm, xs, xs + cut.kc * gp, cut, l, col, acc,
                               ex);
      }
      if (ch == chunks - 1) {
        if (cj == inj_slot) acc[0][0] += a.inj_delta;
        if (with_slots) {
          float se = 0.f;
#pragma unroll
          for (int i = 0; i < RT; ++i) se += ex[i];
          const float va = warp_sum(l.active ? tile_sum(acc) : 0.f);
          const float ve = warp_sum(l.active ? se : 0.f);
          if ((tid & 31) == 0) {
            float* b = tele + (cj & 1) * 2 * kWarps + 2 * (tid >> 5);
            b[0] = va;
            b[1] = ve;
          }
        }
        ch = 0;
        ++cj;
      } else {
        ++ch;
      }
    }
    qq += n;
    __syncthreads();
    if (with_slots && n > 0 && tid == 0) flush(width - 1);
    fold_groups(ring, p.b, l, acc, ex);
    sweep_epilogue<RT>(a, p, item, l, acc, ex, smem);
  }
  __syncthreads();
  if (tid == 0)
    for (int st = 0; st < kStages; ++st) mbar_inval(bars + st);
}

// The tensor map the sweep's TMA boxes come from: `vals` seen as a
// [nbm * width * bm, bk] matrix, boxes of the sweep tile's [rows, kc], with
// the swizzle whose rows are kc floats long (the product reads them back
// through the same pattern).  The driver's encoder is reached through the
// runtime's entry point: no -lcuda.
inline cudaError_t encode_vals_map(CUtensorMap* map, const float* vals,
                                   long long rows_total, int bk,
                                   const Tile& t) {
  typedef CUresult (*EncodeTiled)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static EncodeTiled encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult q;
    void* fp = nullptr;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fp, cudaEnableDefault, &q);
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess || !fp)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fp);
  }
  const cuuint64_t gdim[2] = {(cuuint64_t)bk, (cuuint64_t)rows_total};
  const cuuint64_t gstride[1] = {(cuuint64_t)bk * 4};
  const cuuint32_t box[2] = {(cuuint32_t)t.kc, (cuuint32_t)t.rows};
  const cuuint32_t estride[2] = {1, 1};
  const CUtensorMapSwizzle sw = t.kc == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : t.kc == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : t.kc == 8 ? CU_TENSOR_MAP_SWIZZLE_32B
                                            : CU_TENSOR_MAP_SWIZZLE_NONE;
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(vals), gdim, gstride, box, estride,
             CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

__host__ __device__ inline int sweep_items(const Plan& p, int nbm) {
  return nbm * p.slices;
}

__device__ __forceinline__ void sweep_any(const SweepArgs& a, const Plan& p,
                                          const CUtensorMap* smap, int first,
                                          int stride, float* smem) {
  if (p.b.rt == 4) sweep_slices_from<4>(a, p, smap, first, stride, smem);
  else sweep_slices_from<2>(a, p, smap, first, stride, smem);
}

}  // namespace abft
