// Block-ELL SpMM with the fused ABFT checksum epilogue, for NVIDIA Hopper.
//
// Replaces the TPU kernel `spmm_abft_kernel` (`_make_kernel`) of
// src/repro/kernels/spmm_abft/kernel.py:
//
//   out            = S @ X                       [nbm*bm, G]
//   stripe_sums[i] = Σ out over row-stripe i     [nbm]
//   extra          = S @ x_r                     [nbm*bm]
//
// with S a padded block-ELL table (values [nbm, width, bm, bk], block_cols
// [nbm, width]); padding tiles alias column-block 0 with zero values and are
// multiplied like any other tile, no mask (0 * inf = NaN: skipping them
// would change what a non-finite X does to the check).
//
// What bounds it on this card: bytes.  At G = 16 a [128, 128] tile costs
// 64 KB of device-memory traffic for 0.56 MFLOP, about 8 FLOP per byte, under
// the card's f32 balance of about 20; a served batch of Cora-sized graphs
// (144 stripes x 24 slots) streams 229 MB of S, 0.068 ms at 3.35 TB/s.  Its
// FFMA alone would fill about half of the SMs' issue slots in that time, so
// the product has to hide under the copy.
//
// Design.
//  * Work item = (stripe, row slice, k-part).  A stripe is cut into slices
//    of at most 128 rows and each slot's k-columns into parts of at least
//    64: at bm = bk = 128, 2 blocks a stripe, each owning every row and 64
//    k-columns of every slot (288 blocks for the served batch, all resident
//    at 3 an SM, where one block a stripe gave 144 for 132 SMs); at
//    bm = 32, one block a stripe.  A k-part needs only its own rows of the
//    gathered X tile, so no two blocks copy the same X bytes.  A stripe's
//    blocks are one thread-block cluster; a tall block takes row slices.
//  * A TMA ring.  `kStages` stages, each a chunk of kc = 32 (or 16, 8, 4)
//    k-columns of a slot: the S box [rows, kc], one 2-D tensor copy with the
//    128-byte swizzle (16-byte chunk c of row r lands at c ^ (r % 8), so 8
//    lanes reading a k-vector of 8 rows hit 32 banks), then X's rows
//    [kc, gp] and x_r [kc] as two 1-D bulk copies.  Thread 0 issues the
//    three copies on the stage's mbarrier; the other threads issue no copy
//    at all.  Two chunks are in flight while one is multiplied; one block
//    barrier a chunk frees the stage the next copy overwrites.
//  * The product on FFMA (never TF32).  A thread holds 4 rows x 16 columns
//    (x 8 where G is not a multiple of 16, fewer rows on small blocks) in
//    registers for the whole sweep, the check column beside them in its own
//    accumulators (its own multiply-adds, never derived from X's product);
//    neighbouring lanes own neighbouring rows, so a warp's X loads are
//    broadcasts.  The chunk's k-vectors are split over k-groups of a warp
//    (or half a warp on small blocks), whose partials are added in group
//    order once, after the sweep.
//  * Fixed orders, no atomics on values.  After the sweep each block writes
//    its partial tile [rows, gp + 1] to shared memory; after a cluster
//    barrier each block adds one share of the slice's rows over the k-parts
//    in part order from distributed shared memory and writes out and extra;
//    each block sums its share (thread, warp tree, warps in order) and rank
//    0 adds the shares' sums in rank order.
//  * The inject hook adds `delta` to the accumulator of out[row 0, col 0]
//    in the first k-group of k-part 0 after slot `inj_slot` of stripe
//    `inj_stripe` (stripe -1: none).
//  The slices, k-parts, tile, k-groups and stage count are functions of
//  (bm, bk, gp) alone (`make_plan`, mirrored by analysis/vmem.py
//  `spmm_plan`), never of nbm or width, so a stripe's bits do not depend on
//  what else is in the launch: the surgical repair's replay of a few
//  gathered stripes equals those stripes of the full sweep bit for bit.
//
// What still holds it back (tools/spmm_variants.py; NVIDIA H100 80GB HBM3,
// 700.00 W; G = 16): the product — alone (`diag_nocopy`) it takes 0.097 ms
// where the copies alone (`diag_noproduct`) take 0.084, 82 % of the card's
// memory rate, and together 0.109; its shared-memory loads of S and of X
// cost 15 % and 13 % (`diag_nos`, `diag_nox`), the check column 6 %.  288
// blocks put 3 on 24 SMs and 2 on the rest.  Padding tiles cost what real
// ones do.  16-byte `cp.async` pieces from every thread (`cp_async`) took
// 0.132 ms; 1-D bulk copies, one a 128-byte S row, slower still.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSliceRows = 128;    // most rows of a stripe one block owns
constexpr int kPartK = 64;         // least k-columns of a slot one block owns
constexpr int kMaxCluster = 8;     // blocks of a stripe: one portable cluster
constexpr int kStages = 3;         // ring depth (fewer if a wide G needs it)
constexpr int kTargetWarps = 4;    // k-groups fill a block up to this many
constexpr int kMaxCols = 16;       // most columns a thread holds (16 or 8)
constexpr int kMaxThreads = 512;   // 128 registers a thread
constexpr int kSmemBudget = 232448;
// the block's partial sum at 0, its warps' at 64, the stages' mbarriers at
// 128; the ring starts at the next 1024-byte boundary (the swizzle atom)
constexpr int kHeaderBytes = 256;
constexpr int kAlign = 1024;
static_assert(kStages >= 2 && kStages <= 8, "ring depth");

struct Plan {
  int slices;        // row slices of a stripe (0: shape not supported)
  int parts;         // k-parts of a slot: blocks a stripe = slices * parts
  int kb;            // k-columns of a slot one block owns: bk / parts
  int rows;          // R = bm / slices
  int rt;            // rows a thread holds (1, 2 or 4)
  int cw;            // columns a thread holds (8 or 16)
  int pairs;         // R / rt: row positions of a column block
  int units;         // pairs * gp / cw (row position, column block) units
  int span;          // threads of one k-group: 16, or units rounded to 32
  int groups;        // k-groups
  int threads;
  int kc;            // k-columns of a stage (a slot's chunk): 32, 16, 8 or 4
  int chunks;        // stages a slot takes: kb / kc
  int stage_floats;  // S box [rows, kc], X chunk [kc, gp], x_r chunk [kc],
                     // rounded to the 1024-byte swizzle atom
  int stages;
  int smem;          // dynamic shared memory, bytes (0: not supported)
};

// k-parts of a slot: the most, up to bk / kPartK and the cluster's room,
// that cut bk into whole 4-wide k-vectors
__host__ __device__ inline int parts_of(int bk, int slices) {
  int n = bk / kPartK;
  if (n > kMaxCluster / slices) n = kMaxCluster / slices;
  for (; n > 1; --n)
    if (bk % (4 * n) == 0) return n;
  return 1;
}

// The register tile and thread count of a block of `rows` rows: 16 columns
// a thread where G allows it and the block stays within kMaxThreads, else 8;
// false when no tile fits.
__host__ __device__ inline bool tile_of(Plan& p, int gp) {
  for (p.cw = (kMaxCols == 16 && gp % 16 == 0) ? 16 : 8;; p.cw = 8) {
    // the most rows a thread holds while a k-group still fills 16 lanes
    p.rt = 1;
    for (int rt = 4; rt > 1; rt >>= 1)
      if (p.rows % rt == 0 && (p.rows / rt) * (gp / p.cw) >= 16) {
        p.rt = rt;
        break;
      }
    p.pairs = p.rows / p.rt;
    p.units = p.pairs * (gp / p.cw);
    // two k-groups share a warp when a group needs at most 16 lanes (their
    // X loads, 4 k apart, may meet on a bank: small blocks only)
    p.span = p.units <= 16 ? 16 : 32 * ((p.units + 31) / 32);
    p.groups = 32 * kTargetWarps / p.span;
    if (p.groups > p.kc / 4) p.groups = p.kc / 4;
    if (p.groups < 1) p.groups = 1;
    p.threads = 32 * ((p.groups * p.span + 31) / 32);
    if (p.threads <= kMaxThreads) return true;
    if (p.cw == 8) return false;
  }
}

// The launch plan: row slices (the fewest, from bm / kSliceRows up, whose
// rows a block's tile covers) times k-parts, one cluster a stripe.
__host__ __device__ inline Plan make_plan(int bm, int bk, int gp) {
  Plan p{};
  if (bm < 1 || bk < 4 || gp < 8 || (bk & 3) || (gp & 7)) return p;
  int slices = (bm + kSliceRows - 1) / kSliceRows;
  for (;; ++slices) {
    if (slices > kMaxCluster) return p;
    if (bm % slices) continue;
    p.rows = bm / slices;
    p.parts = parts_of(bk, slices);
    p.kb = bk / p.parts;
    p.kc = 32;
    while (p.kb % p.kc) p.kc >>= 1;
    p.chunks = p.kb / p.kc;
    if (tile_of(p, gp)) break;
  }
  // the S box at the stage's start (1024-byte aligned), then X and x_r
  const int atom = kAlign / 4;
  p.stage_floats = (p.rows * p.kc + p.kc * gp + p.kc + atom - 1) / atom * atom;
  // after the sweep the ring holds the k-groups' partials, then the block's
  // partial tile [rows, gp + 1]
  int red = (p.groups - 1) * p.units * (p.cw + 1) * p.rt;
  if (red < p.rows * (gp + 1)) red = p.rows * (gp + 1);
  for (p.stages = kStages; p.stages >= 2; --p.stages) {
    const int ring = p.stages * p.stage_floats;
    const int bytes = kHeaderBytes + kAlign + 4 * (ring > red ? ring : red);
    if (bytes <= kSmemBudget) {
      p.smem = bytes;
      p.slices = slices;
      break;
    }
  }
  return p;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// What the ring's steps need.  Chunk h of slot j is k-columns
// k0 + [h * kc, h * kc + kc) of the slot's tile, k0 the first k-column of
// the block's k-part; its S box starts at row (stripe * width + j) * bm +
// row0 of vals seen as a [nbm * width * bm, bk] matrix.
struct Ring {
  const CUtensorMap* smap;  // vals, box [rows, kc], 128-byte swizzle
  const int* cols;     // this stripe's block_cols row
  const float* x;
  const float* xr;
  float* ring;         // stage 0 (1024-byte aligned)
  uint64_t* bars;      // one mbarrier a stage
  int row_base;        // stripe * width * bm + row0
  int bm, width, bk, k0, gp, rows, kc, chunks, stage_floats, stages;
  int fill_j, fill_h, fill_st;   // the next chunk to copy, and its stage
};

__device__ __forceinline__ void ring_init(Ring& r) {
  r.fill_j = r.fill_h = r.fill_st = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < r.stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   ::"r"(smem_addr(r.bars + s)), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Start copying the next chunk into its stage (nothing past the last slot):
// thread 0 tells the stage's mbarrier how many bytes will land, then issues
// one 2-D tensor copy for the S box and two 1-D bulk copies for X and x_r.
// The stage must no longer be read: the caller's barrier says so.
__device__ __forceinline__ void refill(Ring& r) {
  if (r.fill_j < r.width && threadIdx.x == 0) {
    const int c = __ldg(r.cols + r.fill_j);
    const int kh = r.k0 + r.fill_h * r.kc;
    const size_t kx = (size_t)c * r.bk + kh;
    float* s_sm = r.ring + (size_t)r.fill_st * r.stage_floats;
    float* x_sm = s_sm + r.rows * r.kc;
    const uint32_t bar = smem_addr(r.bars + r.fill_st);
    const uint32_t x_bytes = 4u * r.kc * r.gp, xr_bytes = 4u * r.kc;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar), "r"(4u * r.rows * r.kc + x_bytes + xr_bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];"
        ::"r"(smem_addr(s_sm)), "l"(reinterpret_cast<uint64_t>(r.smap)),
        "r"(kh), "r"(r.row_base + r.fill_j * r.bm), "r"(bar) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(x_sm)),
        "l"(r.x + kx * r.gp), "r"(x_bytes), "r"(bar) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(x_sm + r.kc * r.gp)),
        "l"(r.xr + kx), "r"(xr_bytes), "r"(bar) : "memory");
  }
  if (++r.fill_h == r.chunks) {
    r.fill_h = 0;
    ++r.fill_j;
  }
  if (++r.fill_st == r.stages) r.fill_st = 0;
}

// Wait until everyone is past the stage the next refill overwrites, and
// the oldest chunk in flight has landed.  A phase that never completes (a
// copy that faulted) traps after 2^26 polls instead of hanging.
__device__ __forceinline__ void wait_stage(const Ring& r) {
  __syncthreads();
  const int q = r.fill_j * r.chunks + r.fill_h - (r.stages - 1);
  const uint32_t bar = smem_addr(r.bars + q % r.stages);
  const uint32_t parity = (q / r.stages) & 1;
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls > (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void fma8(float* a, float s, const float4& lo,
                                     const float4& hi) {
  a[0] = fmaf(s, lo.x, a[0]); a[1] = fmaf(s, lo.y, a[1]);
  a[2] = fmaf(s, lo.z, a[2]); a[3] = fmaf(s, lo.w, a[3]);
  a[4] = fmaf(s, hi.x, a[4]); a[5] = fmaf(s, hi.y, a[5]);
  a[6] = fmaf(s, hi.z, a[6]); a[7] = fmaf(s, hi.w, a[7]);
}

// acc += S chunk rows @ X chunk columns [cw * cb, cw * cb + cw) over this
// k-group's k-vectors; with `col`, ex += S chunk rows @ x_r chunk (own
// multiply-adds, never derived from acc).
template <int RT, int CW>
__device__ __forceinline__ void product(const float* s_sm, const float* x_sm,
                                        const float* xr_sm, int rp, int cb,
                                        bool col, int kg, const Plan& p,
                                        int gp, float (&acc)[RT][CW],
                                        float (&ex)[RT]) {
  const int ld4 = gp >> 2;
  const float4* xc = reinterpret_cast<const float4*>(x_sm) + (CW / 4) * cb;
  const char* sb = reinterpret_cast<const char*>(s_sm);
  const uint32_t mask = (p.kc >> 2) - 1;   // 16-byte chunks of a row - 1
#pragma unroll 2
  for (int k = 4 * kg; k < p.kc; k += 4 * p.groups) {
    float a[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const uint32_t off = 4u * ((rp + i * p.pairs) * p.kc + k);
      const float4 v = *reinterpret_cast<const float4*>(
          sb + (off ^ (((off >> 7) & mask) << 4)));
      a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int b = 0; b < CW / 8; ++b) {
        const float4 lo = xc[(k + kk) * ld4 + 2 * b];
        const float4 hi = xc[(k + kk) * ld4 + 2 * b + 1];
#pragma unroll
        for (int i = 0; i < RT; ++i) fma8(acc[i] + 8 * b, a[i][kk], lo, hi);
      }
    }
    if (col) {
      const float4 e = *reinterpret_cast<const float4*>(xr_sm + k);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        ex[i] = fmaf(a[i][0], e.x, ex[i]);
        ex[i] = fmaf(a[i][1], e.y, ex[i]);
        ex[i] = fmaf(a[i][2], e.z, ex[i]);
        ex[i] = fmaf(a[i][3], e.w, ex[i]);
      }
    }
  }
}

template <int RT, int CW>
__global__ void __launch_bounds__(kMaxThreads)
spmm_ring_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                 const float* __restrict__ x, const float* __restrict__ xr,
                 float* __restrict__ out, float* __restrict__ sums,
                 float* __restrict__ extra, int width, int bm, int bk, int gp,
                 const Plan p, int inj_stripe, int inj_slot,
                 float inj_delta, const __grid_constant__ CUtensorMap smap) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* part_sum = reinterpret_cast<float*>(smem);
  float* warp_part = reinterpret_cast<float*>(smem + 64);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 128);
  const uint32_t base = smem_addr(smem);
  float* ring = reinterpret_cast<float*>(
      smem + ((base + kHeaderBytes + kAlign - 1) / kAlign * kAlign - base));

  cg::cluster_group cluster = cg::this_cluster();
  const int blocks = p.slices * p.parts;      // a stripe's: one cluster
  const int stripe = blockIdx.x / blocks;
  const int rank = blockIdx.x - stripe * blocks;
  const int slice = rank / p.parts;
  const int part = rank - slice * p.parts;
  const int row0 = slice * p.rows;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int kg = t / p.span;
  const int u = t - kg * p.span;              // this thread's unit
  const bool active = kg < p.groups && u < p.units;
  const int cb = u / p.pairs;                 // column block
  const int rp = u - cb * p.pairs;            // first row (of the slice)
  const bool col = cb == 0;                   // carries the check column

  Ring r;
  r.smap = &smap;
  r.bars = bars;
  r.bm = bm;
  r.row_base = stripe * width * bm + row0;
  r.k0 = part * p.kb;
  r.cols = cols + (size_t)stripe * width;
  r.x = x;
  r.xr = xr;
  r.ring = ring;
  r.width = width;
  r.bk = bk;
  r.gp = gp;
  r.rows = p.rows;
  r.kc = p.kc;
  r.chunks = p.chunks;
  r.stage_floats = p.stage_floats;
  r.stages = p.stages;
  ring_init(r);

  // chunks 0 .. stages - 2 in flight; each step refills the stage the step
  // before it read, once the barrier in wait_stage says everyone is past it
  for (int q = 0; q + 1 < p.stages; ++q) refill(r);

  float acc[RT][CW], ex[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
    ex[i] = 0.f;
  }
  const bool inj_here = stripe == inj_stripe && row0 == 0 && part == 0 &&
                        kg == 0 && u == 0;
  int st = 0;
  for (int j = 0; j < width; ++j) {
    for (int h = 0; h < p.chunks; ++h) {
      wait_stage(r);
      refill(r);
      const float* s_sm = ring + (size_t)st * p.stage_floats;
      const float* x_sm = s_sm + p.rows * p.kc;
      if (active)
        product<RT, CW>(s_sm, x_sm, x_sm + p.kc * gp, rp, cb, col, kg, p, gp,
                        acc, ex);
      if (++st == p.stages) st = 0;
    }
    if (inj_here && j == inj_slot) acc[0][0] += inj_delta;
  }

  // every chunk copied was waited on: the ring now holds the k-groups'
  // partials, which the first group adds in group order
  __syncthreads();
  constexpr int rec = (CW + 1) * RT;
  if (active && kg > 0) {
    float* d = ring + ((size_t)(kg - 1) * p.units + u) * rec;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int c = 0; c < CW; ++c) d[i * CW + c] = acc[i][c];
      d[CW * RT + i] = ex[i];
    }
  }
  __syncthreads();
  if (active && kg == 0)
    for (int g = 1; g < p.groups; ++g) {
      const float* s = ring + ((size_t)(g - 1) * p.units + u) * rec;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[i][c] += s[i * CW + c];
        ex[i] += s[CW * RT + i];
      }
    }
  __syncthreads();
  // the block's partial tile [rows, gp + 1] (the check column last)
  const int ld = gp + 1;
  if (active && kg == 0)
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float* d = ring + (rp + i * p.pairs) * ld;
#pragma unroll
      for (int c = 0; c < CW; ++c) d[CW * cb + c] = acc[i][c];
      if (col) d[gp] = ex[i];
    }
  // the slice's k-parts, added in part order from distributed shared
  // memory: each block of the slice finishes its share of the rows
  cluster.sync();
  const int share = (p.rows + p.parts - 1) / p.parts;
  const int r_lo = part * share;
  const int r_hi = r_lo + share < p.rows ? r_lo + share : p.rows;
  float tot = 0.f;
  for (int e = r_lo * ld + t; e < r_hi * ld; e += blockDim.x) {
    float v = 0.f;
    for (int q = 0; q < p.parts; ++q)
      v += cluster.map_shared_rank(ring, slice * p.parts + q)[e];
    const int row = e / ld, c = e - row * ld;
    const size_t grow = (size_t)stripe * bm + row0 + row;
    if (c < gp) {
      out[grow * gp + c] = v;
      tot += v;
    } else {
      extra[grow] = v;
    }
  }
  // the share's sum: warp tree, then the warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    tot += __shfl_down_sync(0xffffffffu, tot, off);
  if (lane == 0) warp_part[warp] = tot;
  __syncthreads();
  if (t == 0) {
    float s = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += warp_part[w];
    part_sum[0] = s;
  }
  // the stripe's sum: rank 0 adds the shares' sums in rank order; the last
  // barrier keeps every block's shared memory alive until it has
  cluster.sync();
  if (rank == 0 && t == 0) {
    float s = 0.f;
    for (int q = 0; q < blocks; ++q)
      s += *cluster.map_shared_rank(part_sum, q);
    sums[stripe] = s;
  }
  cluster.sync();
}

}  // namespace

// The launch plan, as analysis/vmem.py states it (the wrapper asserts that
// the two agree): dynamic shared memory (0: shape not supported), the rows
// of a block, the k-parts a slot is cut into, a block's threads and its
// ring's stages.
extern "C" int spmm_abft_smem_bytes(int bm, int bk, int gp) {
  return make_plan(bm, bk, gp).smem;
}

extern "C" int spmm_abft_slice_rows(int bm, int bk, int gp) {
  const Plan p = make_plan(bm, bk, gp);
  return p.smem ? p.rows : 0;
}

extern "C" int spmm_abft_parts(int bm, int bk, int gp) {
  const Plan p = make_plan(bm, bk, gp);
  return p.smem ? p.parts : 0;
}

extern "C" int spmm_abft_threads(int bm, int bk, int gp) {
  const Plan p = make_plan(bm, bk, gp);
  return p.smem ? p.threads : 0;
}

extern "C" int spmm_abft_stages(int bm, int bk, int gp) {
  const Plan p = make_plan(bm, bk, gp);
  return p.smem ? p.stages : 0;
}

// Launch on `stream`; allocates nothing, does not synchronise, returns a CUDA
// error code (0 on success).  Needs a shape the plan supports (bk % 4 == 0,
// gp % 8 == 0, a stripe cut into at most 8 blocks, the ring within one
// block's shared memory) and 16-byte aligned operands.  The S boxes are
// described by a tensor map made here for `vals` (cuTensorMapEncodeTiled,
// reached through the runtime's driver entry point: no -lcuda).
extern "C" int spmm_abft_launch(const int* cols, const float* vals,
                                const float* x, const float* xr, float* out,
                                float* sums, float* extra, int nbm, int width,
                                int bm, int bk, int gp, int inj_stripe,
                                int inj_slot, float inj_delta, void* stream) {
  const Plan p = make_plan(bm, bk, gp);
  if (p.smem == 0 || nbm < 1 || width < 0) return (int)cudaErrorInvalidValue;
  typedef CUresult (*EncodeTiled)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static EncodeTiled encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult q;
    void* fp = nullptr;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fp,
                                            cudaEnableDefault, &q);
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess || !fp)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fp);
  }
  CUtensorMap smap;
  const cuuint64_t gdim[2] = {(cuuint64_t)bk, (cuuint64_t)nbm * width * bm};
  const cuuint64_t gstride[1] = {(cuuint64_t)bk * 4};
  const cuuint32_t box[2] = {(cuuint32_t)p.kc, (cuuint32_t)p.rows};
  const cuuint32_t estride[2] = {1, 1};
  const CUtensorMapSwizzle sw = p.kc == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : p.kc == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : p.kc == 8 ? CU_TENSOR_MAP_SWIZZLE_32B
                                            : CU_TENSOR_MAP_SWIZZLE_NONE;
  if (encode(&smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(vals), gdim, gstride, box, estride,
             CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  void (*fn)(const int*, const float*, const float*, const float*, float*,
             float*, float*, int, int, int, int, Plan, int, int, float,
             const CUtensorMap) =
      p.cw == 16 ? (p.rt == 4   ? spmm_ring_kernel<4, 16>
                    : p.rt == 2 ? spmm_ring_kernel<2, 16>
                                : spmm_ring_kernel<1, 16>)
                 : (p.rt == 4   ? spmm_ring_kernel<4, 8>
                    : p.rt == 2 ? spmm_ring_kernel<2, 8>
                                : spmm_ring_kernel<1, 8>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fn,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nbm * p.slices * p.parts));
  cfg.blockDim = dim3((unsigned)p.threads);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)(p.slices * p.parts);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, cols, vals, x, xr, out, sums, extra,
                           width, bm, bk, gp, p, inj_stripe, inj_slot,
                           inj_delta, smap);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
