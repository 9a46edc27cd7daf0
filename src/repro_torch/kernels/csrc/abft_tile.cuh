// Building blocks of the fused GCN kernels (gcn_fused.cu, gcn_network.cu):
// a register-tiled f32 product fed by a ring of copies (cp.async from every
// thread for the combination, TMA from one for the sweep), the fold of its
// k-groups, and fixed-order block sums.
//
// Both phases of a fused layer are the same product shape: a tile
// [rows, nc] += L [rows, kc] @ R [kc, nc], with a check column
// e [rows] += L @ c [kc] beside it from its own multiply-adds.  The
// combination is X = H @ W (L an H chunk, R a W chunk, c a w_r chunk); the
// aggregation is acc = S @ X (L an S chunk, R the X rows, c the x_r rows).
//
// A thread owns RT rows x 8 columns of the tile in registers (rows rp,
// rp + rpos, ..., so the 32 threads of a warp walk 32 different rows and
// the same R columns: R's loads are broadcasts).  8 columns, not 16: with
// 16 both phases spilled under the 128 registers that two 256-thread
// blocks an SM allow, and ran slower.
// When the tile has fewer such units than the block has threads, the
// chunk's k-vectors (4 wide) are dealt out to k-groups; the groups'
// partial tiles are added in group order once, at the end
// (`fold_groups`).  Every sum therefore runs in one order fixed by the
// plan, with no atomics: results repeat bit for bit.
//
// A chunk lands in one stage of the ring as L [rows][kc + 4] (4 floats of
// padding a row: 8 lanes reading a 16-byte k-vector of 8 rows hit 32
// different banks) — or, as a TMA box, L [rows][kc] swizzled to the same
// effect — then R [kc][nc], then c [kc].
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace abft {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;            // ring depth: 3 chunks in flight
constexpr int kCw = 8;                // columns a thread holds

// How one product is cut over the block's threads.
struct Tile {
  int rows;    // rows of the tile
  int nc;      // columns of the tile (a multiple of 8)
  int kc;      // k-columns a stage holds (a multiple of 4)
  int rt;      // rows a thread holds (4 or 2)
  int rpos;    // rows / rt: row positions of a column block
  int units;   // rpos * nc / 8: the (row position, column block) units
  int span;    // threads of one k-group: 16, or units rounded up to 32
  int groups;  // k-groups: kc / 4 k-vectors dealt out among them
};

// The cut of a [rows, nc] tile fed kc k-columns a stage; false when the
// units do not fit in one block.  4 rows a thread where that still leaves
// a warp of units, else 2.
__host__ __device__ inline bool make_tile(Tile& t, int rows, int nc, int kc) {
  t.rows = rows;
  t.nc = nc;
  t.kc = kc;
  const int cbs = nc / kCw;
  t.rt = (rows % 4 == 0 && (rows / 4) * cbs >= 32) ? 4 : 2;
  if (rows < 2 || rows % t.rt) return false;
  t.rpos = rows / t.rt;
  t.units = t.rpos * cbs;
  t.span = t.units <= 16 ? 16 : 32 * ((t.units + 31) / 32);
  if (t.span > kThreads) return false;
  t.groups = kThreads / t.span;
  if (t.groups > kc / 4) t.groups = kc / 4;
  return true;
}

// floats of one ring stage: L [rows][kc + 4], R [kc][nc], c [kc]
__host__ __device__ inline int stage_floats(const Tile& t) {
  return t.rows * (t.kc + 4) + t.kc * t.nc + t.kc;
}

// floats the fold of the k-groups writes: groups 1.. each a record of
// RT * 9 floats a unit
__host__ __device__ inline int fold_floats(const Tile& t) {
  return (t.groups - 1) * t.units * t.rt * (kCw + 1);
}

// This thread's place in a tile: k-group, unit, column block, first row.
struct Lane {
  int kg, u, cb, rp;
  bool active;
};

__device__ __forceinline__ Lane lane_of(const Tile& t) {
  Lane l;
  l.kg = threadIdx.x / t.span;
  l.u = threadIdx.x - l.kg * t.span;
  l.active = l.kg < t.groups && l.u < t.units;
  l.cb = l.u / t.rpos;
  l.rp = l.u - l.cb * t.rpos;
  return l;
}

// --- cp.async -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, `bytes` of them read (the rest zero), through L2 only: safe for
// data other blocks wrote earlier in the same launch (after a grid-wide
// barrier).
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes, or 4 zero bytes when `bytes` is 0.
__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// A load from L2, bypassing L1: for data other blocks wrote earlier in the
// same launch.  `volatile` keeps the compiler from moving it across the
// fence or barrier that orders it.
__device__ __forceinline__ float ld_cg(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// --- TMA and mbarriers ---------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// The shared memory the generic proxy wrote (or read) is handed to the
// async proxy (TMA) that writes it next.
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Global memory the generic proxy wrote is handed to the async proxy
// (TMA) that reads it after the next barrier.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// A 2-D box of the tensor `map` at coordinates (c0, c1) into `dst`.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void tma_bulk(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait for phase `parity` of `bar`; a phase that never completes (a copy
// that faulted) traps after 2^26 polls instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1u << 26)) __trap();
  }
}

// Stream chunks 0 .. n - 1 through a cp.async ring.  `issue(q)` copies chunk q
// into stage q % kStages (nothing when q >= n) and must commit one group,
// empty or not; `consume(q)` multiplies it.  One barrier a chunk: it says
// every thread's copies of chunk q have landed and every thread is done
// with chunk q - 1, whose stage the refill then overwrites.  Every thread
// of the block must call this; it ends with a barrier and no copy in
// flight.
template <class Issue, class Consume>
__device__ __forceinline__ void ring_run(int n, Issue&& issue,
                                         Consume&& consume) {
#pragma unroll 1
  for (int q = 0; q < kStages - 1; ++q) issue(q);
#pragma unroll 1
  for (int q = 0; q < n; ++q) {
    cp_wait<kStages - 2>();
    __syncthreads();
    issue(q + kStages - 1);
    consume(q);
  }
  cp_wait<0>();
  __syncthreads();
}

// --- the product ----------------------------------------------------------

__device__ __forceinline__ void fma8(float* a, float s, const float4& lo,
                                     const float4& hi) {
  a[0] = fmaf(s, lo.x, a[0]); a[1] = fmaf(s, lo.y, a[1]);
  a[2] = fmaf(s, lo.z, a[2]); a[3] = fmaf(s, lo.w, a[3]);
  a[4] = fmaf(s, hi.x, a[4]); a[5] = fmaf(s, hi.y, a[5]);
  a[6] = fmaf(s, hi.z, a[6]); a[7] = fmaf(s, hi.w, a[7]);
}

// What the product reads of a Tile, held in registers by the callers.
struct Cut {
  int kc, nc, rpos, groups;
};

__host__ __device__ inline Cut cut_of(const Tile& t) {
  return Cut{t.kc, t.nc, t.rpos, t.groups};
}

// acc += L rows @ R columns [8 cb, 8 cb + 8) over this k-group's
// k-vectors of the staged chunk (L [rows][kc + 4], R [kc][nc], c [kc]);
// with `col`, ex += L rows @ c (its own multiply-adds, never derived from
// acc).
template <int RT, bool kSwizzled = false>
__device__ __forceinline__ void tile_product(const float* l_sm,
                                             const float* r_sm,
                                             const float* c_sm, const Cut& t,
                                             const Lane& l, bool col,
                                             float (&acc)[RT][kCw],
                                             float (&ex)[RT]) {
  const int ldl = kSwizzled ? t.kc : t.kc + 4;
  const int ld4 = t.nc >> 2;
  const float4* rc = reinterpret_cast<const float4*>(r_sm) + 2 * l.cb;
  const float* l0 = l_sm + l.rp * ldl;
  const int rstep = t.rpos * ldl;
  // a swizzled L (a TMA box) moves 16-byte piece c of row r to c ^ (r % 8)
  // (128-byte rows; 64-, 32-byte rows take r / 2 % 4, r / 4 % 2)
  const uint32_t mask = (t.kc >> 2) - 1;
#pragma unroll 1
  for (int k = 4 * l.kg; k < t.kc; k += 4 * t.groups) {
    float a[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float4 v;
      if constexpr (kSwizzled) {
        const uint32_t off = 4u * ((l.rp + i * t.rpos) * t.kc + k);
        v = *reinterpret_cast<const float4*>(
            reinterpret_cast<const char*>(l_sm) +
            (off ^ (((off >> 7) & mask) << 4)));
      } else {
        v = *reinterpret_cast<const float4*>(l0 + i * rstep + k);
      }
      a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 lo = rc[(k + kk) * ld4];
      const float4 hi = rc[(k + kk) * ld4 + 1];
#pragma unroll
      for (int i = 0; i < RT; ++i) fma8(acc[i], a[i][kk], lo, hi);
    }
    if (col) {
      const float4 e = *reinterpret_cast<const float4*>(c_sm + k);
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

template <int RT>
__device__ __forceinline__ void tile_zero(float (&acc)[RT][kCw],
                                          float (&ex)[RT]) {
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int c = 0; c < kCw; ++c) acc[i][c] = 0.f;
    ex[i] = 0.f;
  }
}

// Add the k-groups' partial tiles into group 0's registers, in group order,
// through `scratch` (fold_floats(t) floats; the drained ring).  Every
// thread of the block must call this; it ends with a barrier.
template <int RT>
__device__ __forceinline__ void fold_groups(float* scratch, const Tile& t,
                                            const Lane& l,
                                            float (&acc)[RT][kCw],
                                            float (&ex)[RT]) {
  if (t.groups > 1) {
    constexpr int CW = kCw;
    constexpr int rec = RT * (CW + 1);
    if (l.active && l.kg > 0) {
      float* d = scratch + ((l.kg - 1) * t.units + l.u) * rec;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
#pragma unroll
        for (int c = 0; c < CW; ++c) d[i * CW + c] = acc[i][c];
        d[RT * CW + i] = ex[i];
      }
    }
    __syncthreads();
    if (l.active && l.kg == 0)
      for (int g = 1; g < t.groups; ++g) {
        const float* s = scratch + ((g - 1) * t.units + l.u) * rec;
#pragma unroll
        for (int i = 0; i < RT; ++i) {
#pragma unroll
          for (int c = 0; c < CW; ++c) acc[i][c] += s[i * CW + c];
          ex[i] += s[RT * CW + i];
        }
      }
  }
  __syncthreads();
}

template <int RT>
__device__ __forceinline__ float tile_sum(const float (&acc)[RT][kCw]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int c = 0; c < kCw; ++c) s += acc[i][c];
  }
  return s;
}

// --- block sums -----------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of one value per thread over the block, in thread 0: a warp tree,
// then the warps in order.  `scratch` holds kWarps floats.  Every thread
// must call this; it ends with a barrier.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) t += scratch[w];
  __syncthreads();
  return t;
}

}  // namespace abft
