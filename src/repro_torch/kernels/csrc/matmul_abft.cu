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
// M > 16 (prefill), `wide_kernel`: one block of 256 threads owns one
// 128 x 128 C tile, 8 x 8 outputs a thread, and walks all of K in 32-wide
// chunks through a 3-stage cp.async ring in dynamic shared memory
// (104,832 B in f32; `vmem.matmul_wide_smem_bytes`).  A's and B's slices
// are copied as they lie, in 16-byte pieces that hold no register, and read
// back with 16-byte loads: per 4 k a thread's 8 loads of A and 8 of B feed
// 256 FFMA (the 64 x 128 tile this replaced read 12 scalars for 32 FFMA, so
// shared-memory instructions, not FFMA, set its pace).  One barrier a chunk;
// interior blocks copy from pointers set up once, with no bounds arithmetic.
// B^T (a train step's dA = dC·B^T, the tied LM head) is copied as it lies
// too, [128 n][32 k] in coalesced 16-byte pieces; after the chunk's barrier
// the block turns it into B's k-major [32 k][128 n] layout in one more
// buffer (127,360 B in f32), a second barrier, and the chunk is multiplied
// by B's inner loop — the same values in the same order, so C, the block
// sums and the extra column are bit for bit those of the B path on a
// transposed copy.  (Read as it lies, the [n][k] stage costs 32 scalar
// loads per 4 k, each a 4-way bank conflict: 1.6–1.9x the B path's time.)
// The block's two 64-row halves are two entries of block_sums, so the sum
// tile stays 64 x 128.  What holds it back: registers — acc and the chunk
// partial take 128 of the 255 a thread, so one block of 8 warps runs an SM
// and the compiler cannot load fragments far ahead of their FFMA; the copy
// of each chunk and its barrier (tools/wide_tile_variants.py's `diag_*`
// variants measure both); the products with narrow N (k/v, 256 columns: 16
// blocks) leave most SMs idle, and split-K would change the association;
// bf16 takes the same tile unoptimised (widened at each read); B^T adds a
// transpose of each chunk and its barrier (overlapping it with the previous
// chunk won 1–3 %, tools/bt_variants.py).
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
//
// Grouped launch (`matmul_abft_grouped_launch`): G products of one shape
// over contiguous [G, ...] operands — an MoE layer's experts, up, gate or
// down for all E at once.  The group is blockIdx.z of the wide grid, and
// the outermost axis of the thin path's (group, tile, split) items (and
// blockIdx.y of thin_reduce); each group's pointers are offset, nothing
// else changes, so group g's outputs are bit for bit a single launch's.
// Group g's b_r lies g K floats in, 16-byte aligned only when K % 4 == 0:
// a ragged K reads b_r a float at a time (`fetch_br`), so any K is taken.
// The shared memory, tile and split count are the single product's.
//
// Row counts.  An optional `rows` [G] (int32, on the card; with B as it
// lies) says how many leading rows of each group are live — an MoE capacity
// buffer fills each expert's rows from 0 — and rows at or past rows[g] are
// taken as zero rows of A, whatever A holds there.  A counted launch runs
// its own instances of the kernels (`COUNTED`), so a launch without counts
// runs exactly the code it ran before counts existed.  The kernels read the
// counts on the card (clamped to [0, M]); nothing reaches the host.  Since a
// zero row's products are exactly +0 on finite operands, every output stays
// bit for bit the launch without counts on A with those rows zeroed: rows
// inside a live 16-row step are zero-filled in the stage (cp.async with
// src_bytes 0 reads nothing), 16-row steps past the count are not multiplied
// (their accumulators stay +0), a wide block wholly past the count and every
// item of a group with no live row read neither A nor B.  Such a block
// writes its zeros and the extra column of a zero row, Σ_k 0·b_r[k]: +0, or
// NaN where b_r holds a non-finite value, from one read of b_r.  The thin
// path walks only the live groups' items, dealt round-robin over the
// persistent blocks, so idle experts cost one count of the groups a block.
// A 64-row block tile for counted launches (tools/grouped_variants.py) lost
// up to 13 % to this step skip without one, and won at most 6 % with it.
// What still holds it back: a live row costs its whole 16-row step, and a
// block with fewer steps still copies all of B's chunks and reads them once
// a k, so its time falls slower than its FFMA; the thin path's split sums of
// every live group pass through the workspace: at a decode step's capacity
// of 6–8 rows and 64 splits, 20–25 % of the bytes of the group's B written
// and read back, by a thin_reduce that has only (tiles x live groups)
// blocks of work and takes a third of a counted decode launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
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

// Live rows of group g: rows[g] clamped to [0, M].
__device__ __forceinline__ int live_rows(const int* rows, int g, int M) {
  return min(max(__ldg(rows + g), 0), M);
}

// The extra entry of a zero row of A, Σ_k 0·b_r[k]: +0, or NaN where b_r
// holds a non-finite value (0·±Inf and 0·NaN are NaN, as FFMA makes them).
// The block reads the group's K floats of b_r once; every thread of the
// block calls it.
__device__ float zero_row_extra(const float* br, int K) {
  int bad = 0;
  for (int k = threadIdx.x; k < K; k += blockDim.x) bad |= !isfinite(br[k]);
  return __syncthreads_or(bad) ? __int_as_float(0x7fffffff) : 0.f;
}

// The live groups of a counted launch in order (rows[g] > 0), the rank-th
// by `at(rank)` for ranks that never decrease: a cursor that the whole
// block moves in step, 32 groups a look (a warp ballot), so a block's walk
// over all its items reads each count at most once.
struct LiveGroups {
  const int* rows;
  int groups;
  int g = -1, rank = -1;
  __device__ __forceinline__ LiveGroups(const int* r, int n)
      : rows(r), groups(n) {}
  __device__ __forceinline__ int at(int r) {
    const int lane = threadIdx.x & 31;
    while (rank < r) {
      int next = groups;
      for (int base = g + 1; base < groups; base += 32) {
        const int gg = base + lane;
        const unsigned live =
            __ballot_sync(0xffffffffu, gg < groups && __ldg(rows + gg) > 0);
        if (live) {
          next = base + __ffs(live) - 1;
          break;
        }
      }
      g = next;
      ++rank;
    }
    return g;
  }
};

// Groups with a live row (every thread of the block calls it).
__device__ int count_live(const int* rows, int groups) {
  int n = 0;
  for (int g0 = 0; g0 < groups; g0 += blockDim.x) {
    const int g = g0 + threadIdx.x;
    n += __syncthreads_count(g < groups && __ldg(rows + g) > 0);
  }
  return n;
}

// b_r's 4 values [k, k + 4) of a group's row `row` (zeros past K) into
// shared memory.  Group g's row lies g K floats in, so it starts 16-byte
// aligned only when K % 4 == 0: then one cp.async, else a float at a time
// (the stage is not read before a later barrier).  `base` is any valid
// address for an empty copy.
__device__ __forceinline__ void fetch_br(float* dst, const float* base,
                                         const float* row, int k, int K) {
  const int valid = max(0, min(K - k, 4));
  if (K % 4 == 0) {
    cp_async16(dst, valid ? row + k : base, 4 * valid);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[j] = j < valid ? row[k + j] : 0.f;
  }
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

// Persistent blocks over the (group, tile, split) items of the groups
// (COUNTED: of the live groups): item i is the (i / (tiles S))-th of them
// (a grouped launch's product; 0 for one product), and its rest r is column
// tile r % tiles (256 columns, thread t owns column 256 tile + t, all M
// rows; MT >= M is the compile-time row count) and split r / tiles
// (K [s kc, min((s + 1) kc, K))).  Group g's operands lie g products in:
// A + g M K, B + g K N, b_r + g K, its sums at ws + g S M (N + 1); COUNTED,
// its rows at or past rows[g] are zero-filled in the stage.  A block takes items
// blockIdx.x, + gridDim.x, ..., and walks their chunks as one stream
// through a kStages-deep cp.async ring, so the next item's first chunks
// are in flight while the current item's last one is multiplied.  An
// item's sums go to its group's ws[s, m, n] and, for tile 0 with br,
// A @ b_r's to ws[S M N + s M + m].  Which block runs which item changes no
// sum, so a group's outputs are bit for bit those of a launch of that
// product alone.
template <typename T, int MT, bool TRANS, bool COUNTED>
__global__ void __launch_bounds__(kThreads)
thin_split_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  const float* __restrict__ br, float* __restrict__ ws,
                  const int* __restrict__ rows, int M, int N, int K, int kc,
                  int splits, int groups) {
  using P = Piece<T>;
  using St = ThinStage<T, MT, TRANS>;
  constexpr int V = P::V;
  constexpr int NP = kBK * kThinN / V / kThreads;   // B pieces a thread copies
  constexpr int PR = (TRANS ? kBK : kThinN) / V;    // pieces along a row
  constexpr int AP = MT * kBK / V;                  // A pieces of a chunk
  extern __shared__ __align__(16) unsigned char thin_smem[];

  const int t = threadIdx.x;
  const int tiles = (N + kThinN - 1) / kThinN;
  const int items = tiles * splits;        // of one group
  const int total = items * (COUNTED ? count_live(rows, groups) : groups);
  const size_t ws_group = (size_t)splits * M * (N + 1);
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
    const int k0 = (item % items / tiles) * kc;
    return (min(k0 + kc, K) - k0 + kBK - 1) / kBK;
  };

  // copy chunk `ch` of item rest `r` of group `g` into stage `st` (the
  // scalar tail stores directly: the stage is not read before a later
  // barrier)
  auto fetch = [&](int st, int g, int r, int ch) {
    const int mg = COUNTED ? live_rows(rows, g, M) : M;
    const int n0 = (r % tiles) * kThinN;
    const int k0 = (r / tiles) * kc + ch * kBK;
    const T* Bg = B + (size_t)g * K * N;
    const T* Ag = A + (size_t)g * M * K;
    T* bs = stage_b(st);
#pragma unroll
    for (int e = 0; e < NP; ++e) {
      const int idx = t + e * kThreads;
      const int row = idx / PR, col = (idx % PR) * V;
      const int n = TRANS ? n0 + row : n0 + col;
      const int k = TRANS ? k0 + col : k0 + row;
      T* dst = bs + (TRANS ? row * St::LDT + col : row * kThinN + col);
      const T* src = TRANS ? Bg + (size_t)n * K + k : Bg + (size_t)k * N + n;
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
      const int valid = m < mg ? max(0, min(K - (k0 + col), V)) : 0;
      const T* src = Ag + (size_t)m * K + k0 + col;
      T* dst = as + m * St::LDA + col;
      if (vec_a) {
        cp_async16(dst, valid ? src : A, valid * (int)sizeof(T));
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) dst[j] = j < valid ? src[j] : from_f<T>(0.f);
      }
    }
    if (br != nullptr && n0 == 0 && t < kBK / 4)
      fetch_br(stage_br(st) + 4 * t, br, br + (size_t)g * K, k0 + 4 * t, K);
  };

  // the fetch cursor runs kStages - 1 chunks ahead of the compute cursor;
  // COUNTED, each has its own walk over the live groups
  LiveGroups fetch_groups(rows, groups), groups_of(rows, groups);
  int item_i = blockIdx.x, ch_i = 0;
  auto fetch_next = [&](int st) {
    if (item_i < total) {
      fetch(st, COUNTED ? fetch_groups.at(item_i / items) : item_i / items,
            item_i % items, ch_i);
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
  for (int item = blockIdx.x, ch = 0; item < total;) {
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

    const int tile = item % items % tiles, split = item % items / tiles;
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
      float* wsg = ws + (size_t)(COUNTED ? groups_of.at(item / items)
                                         : item / items) * ws_group;
      const int n = tile * kThinN + t;
      if (n < N) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if (i < M) wsg[((size_t)split * M + i) * N + n] = acc[i];
      }
      if (with_extra && t < M)
        wsg[(size_t)splits * M * N + (size_t)split * M + t] = ex;
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

// Block (ni, g): columns [256 ni, 256 ni + 256) of group g's product (its
// workspace, C, block_sums and extra lie g products in).  C = the S split
// sums added in
// split order, in the operand dtype; block_sums[4 ni + j] = their f32 sum
// over the 64-column tile j (per thread in row order, a warp shuffle tree,
// then the tile's two warps in order); block 0 adds the extra column's split
// sums in order.  Each thread keeps 32 loads in flight across its rows.
// COUNTED, a group with no live row (rows[g] == 0) has no split sums: its C
// and block sums are zeros and its extra column the zero row's
// (`zero_row_extra`).
template <typename T, int MT, bool COUNTED>
__global__ void __launch_bounds__(kThreads)
thin_reduce_kernel(const float* __restrict__ ws, T* __restrict__ C,
                   float* __restrict__ block_sums, float* __restrict__ extra,
                   const float* __restrict__ br, const int* __restrict__ rows,
                   int M, int N, int K, int S) {
  constexpr int kBatch = MT >= 32 ? 1 : 32 / MT;   // splits per round trip
  __shared__ float red[kWarps];
  const int t = threadIdx.x;
  const int n = blockIdx.x * kThinN + t;
  const size_t plane = (size_t)M * N;
  const size_t g = blockIdx.y;
  ws += g * S * (plane + M);
  C += g * plane;
  block_sums += g * ((N + kSumN - 1) / kSumN);
  if (extra != nullptr) extra += g * M;
  if (COUNTED && live_rows(rows, g, M) == 0) {
    if (n < N)
      for (int i = 0; i < M; ++i) C[(size_t)i * N + n] = from_f<T>(0.f);
    const int tile = blockIdx.x * (kThinN / kSumN) + t;
    if (t < kThinN / kSumN && tile * kSumN < N) block_sums[tile] = 0.f;
    if (extra != nullptr && blockIdx.x == 0) {
      const float v = zero_row_extra(br + g * K, K);
      if (t < M) extra[t] = v;
    }
    return;
  }
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
template <typename T, int MT, bool TRANS, bool COUNTED>
int thin_capacity() {
  static const int capacity = [] {
    constexpr int bytes = thin_smem_bytes<T, MT, TRANS>();
    auto* fn = thin_split_kernel<T, MT, TRANS, COUNTED>;
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

template <typename T, int MT, bool TRANS, bool COUNTED>
int launch_thin_split(const T* a, const T* b, const float* br, float* ws,
                      const int* rows, int groups, int m, int n, int k,
                      int kc, int splits, cudaStream_t stream) {
  const int capacity = thin_capacity<T, MT, TRANS, COUNTED>();
  if (capacity <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long items =
      (long long)groups * ((n + kThinN - 1) / kThinN) * splits;
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  const int grid = items < capacity ? (int)items : capacity;
  thin_split_kernel<T, MT, TRANS, COUNTED>
      <<<grid, kThreads, thin_smem_bytes<T, MT, TRANS>(), stream>>>(
          a, b, br, ws, rows, m, n, k, kc, splits, groups);
  return (int)cudaGetLastError();
}

template <typename T, int MT>
int launch_thin(const T* a, const T* b, const float* br, T* c, float* sums,
                float* extra, float* ws, const int* rows, int groups, int m,
                int n, int k, int trans_b, cudaStream_t stream) {
  const int kc = kBK * split_chunks(m, n, k);
  const int splits = (k + kc - 1) / kc;
  // counts are taken with B as it lies only (no transposed caller)
  const int err =
      rows != nullptr
          ? (trans_b ? (int)cudaErrorInvalidValue
                     : launch_thin_split<T, MT, false, true>(
                           a, b, br, ws, rows, groups, m, n, k, kc, splits,
                           stream))
      : trans_b ? launch_thin_split<T, MT, true, false>(
                      a, b, br, ws, rows, groups, m, n, k, kc, splits, stream)
                : launch_thin_split<T, MT, false, false>(
                      a, b, br, ws, rows, groups, m, n, k, kc, splits,
                      stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kThinN - 1) / kThinN, groups);
  if (rows != nullptr)
    thin_reduce_kernel<T, MT, true><<<grid, kThreads, 0, stream>>>(
        ws, c, sums, extra, br, rows, m, n, k, splits);
  else
    thin_reduce_kernel<T, MT, false><<<grid, kThreads, 0, stream>>>(
        ws, c, sums, extra, br, rows, m, n, k, splits);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wide path (M > 16)
// ---------------------------------------------------------------------------

constexpr int kWideM = 128;     // rows of one block's C tile
constexpr int kWideN = 128;     // columns of one block's C tile
constexpr int kWideSumM = 64;   // rows of one block_sums tile (x 128 columns)

// 4 consecutive elements of a shared-memory row as floats: one 16-byte load
// (f32) or one 8-byte load (bf16, widened: element 2i is the low half).
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}
// 4 consecutive elements of C: one 16-byte store (f32), one 8-byte (bf16)
__device__ __forceinline__ void store4(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* f) {
  unsigned h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    h[j] = __bfloat16_as_ushort(__float2bfloat16_rn(f[j]));
  *reinterpret_cast<uint2*>(p) = make_uint2(h[0] | (h[1] << 16),
                                            h[2] | (h[3] << 16));
}

// f(std::integral_constant<int, S>{}) with S = steps (MAX - N < steps <=
// MAX): one uniform branch a step below MAX; N = 1 is f(MAX) alone.
template <int N, int MAX, typename F>
__device__ __forceinline__ void with_steps(int steps, F&& f) {
  if constexpr (N > 1) {
    if (steps < MAX) {
      with_steps<N - 1, MAX - 1>(steps, f);
      return;
    }
  }
  f(std::integral_constant<int, MAX>{});
}

// One ring stage in shared memory, raw operand elements: A's [BM][32] slice
// as it lies in device memory (m-major; rows of 32 + V elements: 16-byte
// aligned, and 4 consecutive rows fall on distinct banks), B's [32][128]
// slice as it lies (B^T: [128][32 + V], as A), and b_r's 32 values (f32).
// B^T adds one k-major buffer after the ring, KM_BYTES: the chunk being
// multiplied, [32 k][128 n] as B's stage (`km_group` places its columns).
template <typename T, int BM, bool TRANS> struct WideStage {
  static constexpr int V = Piece<T>::V;
  static constexpr int LDK = kBK + V;       // a k-contiguous row
  static constexpr int A_ELEMS = BM * LDK;
  static constexpr int B_ELEMS = TRANS ? kWideN * LDK : kBK * kWideN;
  static constexpr int BYTES = (A_ELEMS + B_ELEMS) * (int)sizeof(T) +
                               kBK * (int)sizeof(float);
  static constexpr int KM_BYTES = TRANS ? kBK * kWideN * (int)sizeof(T) : 0;
};

template <typename T, int BM, bool TRANS>
constexpr int wide_smem_bytes() {
  return kStages * WideStage<T, BM, TRANS>::BYTES +
         WideStage<T, BM, TRANS>::KM_BYTES;
}

// Where the k-major buffer keeps columns 4 g .. 4 g + 3 of row k: 4-column
// group g ^ ((k / 4) % 8 · V / 4), a swizzle inside each aligned 8 (f32) or
// 16 (bf16) groups, so that the 16-byte (f32) or 8-byte (bf16) pieces a
// quarter- or half-warp stores in the transpose (8 rows 4 apart, one or two
// column groups) fall on distinct banks, as do the 8 groups of one row
// that a warp reads in the inner loop.
template <int V>
__device__ __forceinline__ int km_group(int k, int g) {
  return g ^ ((k >> 2) & 7) * (V / 4);
}

// A 4 x 4 block of raw elements — 4 rows of `src` (stride ld), 4
// consecutive elements each — stored transposed: element (r, c) to
// dst[c ldd + r].  Raw bits, no conversion.
__device__ __forceinline__ void transpose4x4(const float* src, int ld,
                                             float* dst, int ldd) {
  float4 r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = *reinterpret_cast<const float4*>(src + i * ld);
  *reinterpret_cast<float4*>(dst) = make_float4(r[0].x, r[1].x, r[2].x,
                                                r[3].x);
  *reinterpret_cast<float4*>(dst + ldd) = make_float4(r[0].y, r[1].y, r[2].y,
                                                      r[3].y);
  *reinterpret_cast<float4*>(dst + 2 * ldd) = make_float4(r[0].z, r[1].z,
                                                          r[2].z, r[3].z);
  *reinterpret_cast<float4*>(dst + 3 * ldd) = make_float4(r[0].w, r[1].w,
                                                          r[2].w, r[3].w);
}
__device__ __forceinline__ void transpose4x4(const __nv_bfloat16* src,
                                             int ld, __nv_bfloat16* dst,
                                             int ldd) {
  uint2 r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = *reinterpret_cast<const uint2*>(src + i * ld);
  // element 2i of a word is its low half: 0x5410 joins two low halves,
  // 0x7632 two high ones
  const unsigned lo = 0x5410u, hi = 0x7632u;
  *reinterpret_cast<uint2*>(dst) = make_uint2(
      __byte_perm(r[0].x, r[1].x, lo), __byte_perm(r[2].x, r[3].x, lo));
  *reinterpret_cast<uint2*>(dst + ldd) = make_uint2(
      __byte_perm(r[0].x, r[1].x, hi), __byte_perm(r[2].x, r[3].x, hi));
  *reinterpret_cast<uint2*>(dst + 2 * ldd) = make_uint2(
      __byte_perm(r[0].y, r[1].y, lo), __byte_perm(r[2].y, r[3].y, lo));
  *reinterpret_cast<uint2*>(dst + 3 * ldd) = make_uint2(
      __byte_perm(r[0].y, r[1].y, hi), __byte_perm(r[2].y, r[3].y, hi));
}

// One block per BM x 128 tile of C (blockIdx.y, blockIdx.x), walking all of
// K in 32-wide chunks through a kStages-deep cp.async ring (the thin
// path's depth: a fourth stage measured no faster), one
// __syncthreads a chunk.  Thread t of warp w, lane l owns rows ty + 16 i
// (i < BM / 16; ty = 4 (w / 2) + l / 8) and columns 4 tx + j, 64 + 4 tx + j
// (j < 4; tx = 8 (w % 2) + l % 8): per 4 k it reads each of its rows' 4 A
// values with one 16-byte load — the 8 lanes of a row share the address, the
// warp's 4 rows fall on distinct banks — and per k its 8 B values with two,
// the warp's 8 column groups one contiguous 128-byte line; then BM / 2 FFMA
// per k per 16-byte load.  Each chunk is summed apart in `part`, k in
// order, and added to `acc` in chunk order.  B^T: after the barrier,
// thread t turns the 4 x 4 block (n 4 (t / 8), k 4 (t % 8)) of the chunk's
// [128 n][32 k] stage into the k-major buffer (`km_group`); after a second
// barrier the loop reads that buffer as B's stage, its column groups
// swizzled.  Rows i < 4 are C rows 0-63 of the
// tile, rows i >= 4 rows 64-127: each half's f32 sum is one block_sums
// entry (per thread i then j, a warp shuffle tree, then warp by warp).  The
// ni == 0 blocks also sum A @ b_r, one row a thread, in the same chunks.
// blockIdx.z is the group of a grouped launch (0 for one product): its
// operands and outputs lie g products in, and nothing else changes, so a
// group's outputs are bit for bit those of a launch of that product alone.
// COUNTED, the group's rows at or past its count are zero-filled in the
// stage; a thread's 16-row steps i with 16 i at or past the tile's live
// rows are not multiplied (`steps`, uniform in the block: their
// accumulators stay +0, as a zero row's products are), and a block with no
// live row copies nothing: it writes zeros and the zero row's extra column.
template <typename T, int BM, bool TRANS, bool COUNTED>
__global__ void __launch_bounds__(kThreads, 1)
wide_kernel(const T* __restrict__ A, const T* __restrict__ B,
            const float* __restrict__ br, T* __restrict__ C,
            float* __restrict__ block_sums, float* __restrict__ extra,
            const int* __restrict__ rows, int M, int N, int K) {
  using St = WideStage<T, BM, TRANS>;
  constexpr int V = St::V;
  constexpr int LDK = St::LDK;
  constexpr int TM = BM / 16;                       // rows a thread
  constexpr int HALVES = BM / kWideSumM;            // block_sums rows a block
  constexpr int AP = BM * (kBK / V) / kThreads;     // A pieces a thread copies
  constexpr int BP = kBK * kWideN / V / kThreads;   // B pieces a thread copies
  static_assert(BM % kWideSumM == 0 && TM % HALVES == 0, "tile vs sum tile");
  static_assert(AP * kThreads == BM * (kBK / V), "A slice vs block");
  static_assert(BP * kThreads == kBK * kWideN / V, "B slice vs block");
  extern __shared__ __align__(16) unsigned char wide_smem[];
  __shared__ float red[HALVES][kWarps];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tx = (warp & 1) * 8 + (lane & 7);
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int ni = blockIdx.x, mi = blockIdx.y;
  const int m0 = mi * BM, n0 = ni * kWideN;
  // the group's live rows
  const int mg = COUNTED ? live_rows(rows, blockIdx.z, M) : M;
  {
    const size_t g = blockIdx.z;
    A += g * M * K;
    B += g * K * N;
    C += g * M * N;
    block_sums += g * ((M + kWideSumM - 1) / kWideSumM) * gridDim.x;
    if (br != nullptr) br += g * K;
    if (extra != nullptr) extra += g * M;
  }
  const bool with_extra = br != nullptr && ni == 0;
  if (COUNTED && m0 >= mg) {           // no live row: zeros, read no A or B
    for (int idx = t; idx < BM * kWideN; idx += kThreads) {
      const int m = m0 + idx / kWideN, n = n0 + idx % kWideN;
      if (m < M && n < N) C[(size_t)m * N + n] = from_f<T>(0.f);
    }
    if (t < HALVES && (mi * HALVES + t) * kWideSumM < M)
      block_sums[(size_t)(mi * HALVES + t) * gridDim.x + ni] = 0.f;
    if (with_extra) {
      const float v = zero_row_extra(br, K);
      if (t < BM && m0 + t < M) extra[m0 + t] = v;
    }
    return;
  }
  // 16-row steps with a live row (a thread's rows ty + 16 i, i < steps)
  const int steps = COUNTED ? min(TM, (mg - m0 + 15) / 16) : TM;
  // every row of the operand starts 16-byte aligned (the bases are: the
  // wrapper checks it), so pieces are whole or wholly outside
  const bool vec_a = K % V == 0;
  const bool vec_b = TRANS ? vec_a : (N % V == 0);

  auto stage_a = [&](int st) {
    return reinterpret_cast<T*>(wide_smem + st * St::BYTES);
  };
  auto stage_b = [&](int st) { return stage_a(st) + St::A_ELEMS; };
  auto stage_br = [&](int st) {
    return reinterpret_cast<float*>(stage_b(st) + St::B_ELEMS);
  };
  // one 16-byte piece: cp.async when rows are aligned, else element by
  // element (the stage is not read before a later barrier)
  auto piece = [&](T* dst, const T* base, const T* src, int valid, bool vec) {
    if (vec) {
      cp_async16(dst, valid ? src : base, valid * (int)sizeof(T));
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) dst[j] = j < valid ? src[j] : from_f<T>(0.f);
    }
  };
  // A block with every row and column inside the operands (and rows that
  // start 16-byte aligned) copies its whole chunks from pointers set up
  // here, with no bounds arithmetic per piece: thread t copies piece
  // t % (32 / V) of A's rows t / (32 / V) + AR e and piece t % (128 / V)
  // of B's rows t / (128 / V) + BR e (B^T's as A's)
  const bool interior = vec_a && vec_b && m0 + BM <= M &&
                        n0 + kWideN <= N;
  constexpr int AR = kThreads / (kBK / V);
  // B^T's [128 n][32 k] slice is copied as A's slice is
  constexpr int BR = TRANS ? AR : kThreads / (kWideN / V);
  constexpr int LDB = TRANS ? LDK : kWideN;   // a stage row of B's slice
  const T* ga = A + (size_t)(m0 + t / (kBK / V)) * K + (t % (kBK / V)) * V;
  // the interior A pieces this thread copies that lie before the count
  // (bit e; the others are zero-filled)
  unsigned a_live = ~0u;
  if constexpr (COUNTED) {
    a_live = 0;
#pragma unroll
    for (int e = 0; e < AP; ++e)
      a_live |= (m0 + t / (kBK / V) + e * AR < mg ? 1u : 0u) << e;
  }
  const T* gb = TRANS ? B + (size_t)(n0 + t / (kBK / V)) * K +
                            (t % (kBK / V)) * V
                      : B + (size_t)(t / (kWideN / V)) * N + n0 +
                            (t % (kWideN / V)) * V;
  const int sa = (t / (kBK / V)) * LDK + (t % (kBK / V)) * V;
  const int sb = TRANS ? sa
                       : (t / (kWideN / V)) * kWideN + (t % (kWideN / V)) * V;
  // copy chunk [k0, k0 + 32) into stage st
  auto fetch = [&](int st, int k0) {
    if (interior && k0 + kBK <= K) {
#pragma unroll
      for (int e = 0; e < AP; ++e)
        cp_async16(stage_a(st) + sa + e * AR * LDK,
                   ga + (size_t)e * AR * K + k0, (a_live >> e & 1u) * 16);
#pragma unroll
      for (int e = 0; e < BP; ++e)
        cp_async16(stage_b(st) + sb + e * BR * LDB,
                   TRANS ? gb + (size_t)e * BR * K + k0
                         : gb + (size_t)(k0 + e * BR) * N,
                   16);
      if (with_extra && t < kBK / 4)   // interior: K % V == 0, b_r aligned
        cp_async16(stage_br(st) + 4 * t, br + k0 + 4 * t, 16);
      return;
    }
    T* as = stage_a(st);
#pragma unroll
    for (int e = 0; e < AP; ++e) {
      const int idx = t + e * kThreads;
      const int r = idx / (kBK / V), col = (idx % (kBK / V)) * V;
      const int valid = m0 + r < mg ? max(0, min(K - (k0 + col), V)) : 0;
      piece(as + r * LDK + col, A, A + (size_t)(m0 + r) * K + k0 + col, valid,
            vec_a);
    }
    T* bs = stage_b(st);
#pragma unroll
    for (int e = 0; e < BP; ++e) {
      const int idx = t + e * kThreads;
      if constexpr (TRANS) {
        const int r = idx / (kBK / V), col = (idx % (kBK / V)) * V;
        const int valid = n0 + r < N ? max(0, min(K - (k0 + col), V)) : 0;
        piece(bs + r * LDK + col, B, B + (size_t)(n0 + r) * K + k0 + col,
              valid, vec_b);
      } else {
        const int r = idx / (kWideN / V), col = (idx % (kWideN / V)) * V;
        const int valid = k0 + r < K ? max(0, min(N - (n0 + col), V)) : 0;
        piece(bs + r * kWideN + col, B, B + (size_t)(k0 + r) * N + n0 + col,
              valid, vec_b);
      }
    }
    if (with_extra && t < kBK / 4)
      fetch_br(stage_br(st) + 4 * t, br, br, k0 + 4 * t, K);
  };

  // B^T: the k-major buffer after the ring
  T* const km = reinterpret_cast<T*>(wide_smem + kStages * St::BYTES);

  const int chunks = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) fetch(s, s * kBK);
    cp_async_commit();               // one group per chunk, empty or not
  }

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float ex = 0.f;

  for (int c = 0; c < chunks; ++c) {
    const int st = c % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk c
    __syncthreads();                   // everyone's; chunk c - 1 is read
    const int next = c + kStages - 1;
    if (next < chunks) fetch(next % kStages, next * kBK);
    cp_async_commit();
    if constexpr (TRANS) {   // the barrier above: chunk c - 1 read km
      const int tk = 4 * (t % 8), tn = 4 * (t / 8);   // this thread's block
      transpose4x4(stage_b(st) + tn * LDK + tk, LDK,
                   km + tk * kWideN + 4 * km_group<V>(tk, tn / 4), kWideN);
      __syncthreads();
    }

    const T* as = stage_a(st);
    const T* bs = TRANS ? km : stage_b(st);
    // the chunk for the first S steps, S = steps a compile-time count
    with_steps<COUNTED ? TM : 1, TM>(steps, [&](auto s_) {
      constexpr int S = decltype(s_)::value;
      float part[S][8];
#pragma unroll
      for (int i = 0; i < S; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
#pragma unroll
      for (int kq = 0; kq < kBK; kq += 4) {
        float a[S][4];
#pragma unroll
        for (int i = 0; i < S; ++i) load4(as + (ty + 16 * i) * LDK + kq, a[i]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float b[8];
          if constexpr (TRANS) {
            const int q = 4 * km_group<V>(kq, tx);
            load4(bs + (kq + kk) * kWideN + q, b);
            load4(bs + (kq + kk) * kWideN + 64 + q, b + 4);
          } else {
            load4(bs + (kq + kk) * kWideN + 4 * tx, b);
            load4(bs + (kq + kk) * kWideN + 64 + 4 * tx, b + 4);
          }
#pragma unroll
          for (int i = 0; i < S; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              part[i][j] = fmaf(a[i][kk], b[j], part[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < S; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
    });

    if (with_extra && t < BM) {
      const float* brs = stage_br(st);
      float p = 0.f;
#pragma unroll
      for (int kq = 0; kq < kBK; kq += 4) {
        float a4[4];
        load4(as + t * LDK + kq, a4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) p = fmaf(a4[kk], brs[kq + kk], p);
      }
      ex = __fadd_rn(ex, p);
    }
  }
  cp_async_wait<0>();                // no copy outlives the block

  // C in the operand dtype, 4 elements a store where every row of C starts
  // aligned (N a multiple of 4); the tile's edge element by element
  const bool vec_c = N % 4 == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * h + 4 * tx;
      T* dst = C + (size_t)m * N + n;
      if (vec_c && n + 4 <= N) {
        store4(dst, &acc[i][4 * h]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) dst[j] = from_f<T>(acc[i][4 * h + j]);
      }
    }
  }
  // the f32 sum of each 64-row half (out-of-range entries are exactly 0)
#pragma unroll
  for (int hf = 0; hf < HALVES; ++hf) {
    float s = 0.f;
#pragma unroll
    for (int i = hf * (TM / HALVES); i < (hf + 1) * (TM / HALVES); ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s += acc[i][j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[hf][warp] = s;
  }
  __syncthreads();
  if (t < HALVES && (mi * HALVES + t) * kWideSumM < M) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tot += red[t][w];
    block_sums[(size_t)(mi * HALVES + t) * gridDim.x + ni] = tot;
  }
  if (with_extra && t < BM && m0 + t < M) extra[m0 + t] = ex;
}

// Launch one wide_kernel instantiation; its dynamic shared memory limit is
// raised once, at the first launch, and a refusal is returned (then, and
// at every later launch).
template <typename T, int BM, bool TRANS, bool COUNTED>
int launch_wide(const T* a, const T* b, const float* br, T* c, float* sums,
                float* extra, const int* rows, int groups, int m, int n, int k,
                cudaStream_t stream) {
  constexpr int bytes = wide_smem_bytes<T, BM, TRANS>();
  static const cudaError_t attr = [] {
    auto* fn = wide_kernel<T, BM, TRANS, COUNTED>;
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        wide_smem_bytes<T, BM, TRANS>());
    if (err != cudaSuccess) cudaGetLastError();   // not left for a later call
    return err;
  }();
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((n + kWideN - 1) / kWideN, (m + BM - 1) / BM, groups);
  wide_kernel<T, BM, TRANS, COUNTED><<<grid, kThreads, bytes, stream>>>(
      a, b, br, c, sums, extra, rows, m, n, k);
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
                 float* sums, float* extra, float* ws, const int* rows,
                 int groups, int m, int n, int k, int trans_b,
                 cudaStream_t stream) {
  if (m <= kSmallM) {
    if (ws == nullptr) return (int)cudaErrorInvalidValue;
    return with_rows(m, [&](auto mt) {
      return launch_thin<T, decltype(mt)::value>(
          static_cast<const T*>(a), static_cast<const T*>(b), br,
          static_cast<T*>(c), sums, extra, ws, rows, groups, m, n, k, trans_b,
          stream);
    });
  }
  auto ta = static_cast<const T*>(a);
  auto tb = static_cast<const T*>(b);
  auto tc = static_cast<T*>(c);
  if (rows != nullptr)       // counts with B as it lies only
    return trans_b ? (int)cudaErrorInvalidValue
                   : launch_wide<T, kWideM, false, true>(
                         ta, tb, br, tc, sums, extra, rows, groups, m, n, k,
                         stream);
  return trans_b ? launch_wide<T, kWideM, true, false>(
                       ta, tb, br, tc, sums, extra, rows, groups, m, n, k,
                       stream)
                 : launch_wide<T, kWideM, false, false>(
                       ta, tb, br, tc, sums, extra, rows, groups, m, n, k,
                       stream);
}

int launch_any(const void* a, const void* b, const float* br, void* c,
               float* sums, float* extra, float* ws, const int* rows,
               int groups, int m, int n, int k, int trans_b, int dtype,
               void* stream) {
  if (groups <= 0 || groups > 65535 || m <= 0 || n <= 0 || k <= 0 ||
      (br == nullptr) != (extra == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_typed<float>(a, b, br, c, sums, extra, ws, rows, groups, m,
                               n, k, trans_b, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(a, b, br, c, sums, extra, ws, rows,
                                       groups, m, n, k, trans_b, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T> int thin_smem_typed(int m, int trans_b) {
  return with_rows(m, [&](auto mt) {
    constexpr int MT = decltype(mt)::value;
    return trans_b ? thin_smem_bytes<T, MT, true>()
                   : thin_smem_bytes<T, MT, false>();
  });
}

}  // namespace

// The C tile `block_sums` is taken over for an M-row product (rows, then
// columns): 64 x 128 when M > 16 (each half of a block's 128 x 128 tile),
// 64 columns over all 16 rows otherwise; analysis/vmem.py `matmul_tile`
// states the same and the wrapper checks it.
extern "C" int matmul_abft_tile_m(int m) {
  return m <= kSmallM ? kSmallM : kWideSumM;
}
extern "C" int matmul_abft_tile_n(int m) {
  return m <= kSmallM ? kSumN : kWideN;
}

// The C tile one block of the wide path owns (0 when M <= 16, which takes
// the thin path); analysis/vmem.py `MATMUL_WIDE_TILE` states the same and
// the wrapper checks it.
extern "C" int matmul_abft_wide_tile_m(int m) {
  return m <= kSmallM ? 0 : kWideM;
}
extern "C" int matmul_abft_wide_tile_n(int m) {
  return m <= kSmallM ? 0 : kWideN;
}

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

// Dynamic shared memory of one wide-path block for an M-row product (M > 16,
// else 0; dtype as for the launch): the cp.async ring; analysis/vmem.py
// `matmul_wide_smem_bytes` states the same and the wrapper checks it.
extern "C" int matmul_abft_wide_smem_bytes(int m, int dtype, int trans_b) {
  if (m <= kSmallM) return 0;
  if (dtype == 0)
    return trans_b ? wide_smem_bytes<float, kWideM, true>()
                   : wide_smem_bytes<float, kWideM, false>();
  return trans_b ? wide_smem_bytes<__nv_bfloat16, kWideM, true>()
                 : wide_smem_bytes<__nv_bfloat16, kWideM, false>();
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
  return launch_any(a, b, br, c, sums, extra, ws, nullptr, 1, m, n, k, trans_b,
                    dtype, stream);
}

// `groups` independent products A_g [M, K] @ B_g [K, N] (B_g^T [N, K] with
// trans_b) in one launch, over contiguous [groups, ...] operands: b_r
// [groups, K], C [groups, M, N], sums [groups, ceil(M/tm), ceil(N/tn)],
// extra [groups, M] and, when M <= 16, ws of groups * S * M * (N + 1)
// floats.  The group is one more grid axis (wide path) or the outermost
// item axis (thin path); the per-tile code and every association are the
// single launch's, so group g's outputs are bit for bit those of
// matmul_abft_launch on product g.  `rows`, null or [groups] int32 on the
// device (with B as it lies, not trans_b): group g's rows at or past
// rows[g] (clamped to [0, M]) are taken as zero rows of A — its outputs
// are bit for bit those of the launch without counts on A with those rows
// zeroed (on finite operands; the extra column of a zero row is NaN exactly
// where b_r is not finite).
// 1 <= groups <= 65535.  The Python wrappers launch a single product
// through this entry too (groups = 1, rows null, which is
// matmul_abft_launch exactly).
extern "C" int matmul_abft_grouped_launch(const void* a, const void* b,
                                          const float* br, void* c,
                                          float* sums, float* extra,
                                          float* ws, const int* rows,
                                          int groups, int m, int n, int k,
                                          int trans_b, int dtype,
                                          void* stream) {
  return launch_any(a, b, br, c, sums, extra, ws, rows, groups, m, n, k,
                    trans_b, dtype, stream);
}
