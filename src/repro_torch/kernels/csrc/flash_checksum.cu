// Causal online-softmax (flash) attention carrying the fused ABFT chain
// column, for NVIDIA Hopper.
//
// Replaces the TPU kernel `flash_checksum_kernel` (`_kernel`) of
// src/repro/kernels/flash_checksum/kernel.py:
//
//   o       = softmax(q kᵀ · dh^-0.5, causal) v     [B, T, H, dh] (q's dtype)
//   o_extra = softmax(q kᵀ · dh^-0.5, causal) vr    [B, T, H]     (f32)
//
// with the key/value head of query head h at h / (H / Kh) (GQA / MQA: the
// wrapper never repeats K and V per query head), and vr = V·w_or the carried
// check column, so Σ o_extra = eᵀ(A V W_o)e.  The causal mask compares
// query and key *indices*, as the TPU kernel does; the LM calls it only for
// self-attention over positions 0..T-1, where indices and positions agree.
// vr may be null: then o_extra is not computed and o is unchanged — the
// output accumulator runs the same code either way, so a guarded step's
// attention output equals the unguarded one's bit for bit.
//
// What bounds it on this card: operations.  At gemma-2b's prefill (T = 512,
// dh = 256, 16 (batch, head) pairs) the two products are ~1.1 GFLOP each of
// causal work against ~20 MB of q/k/v/o.
//
// Design.  One thread block per (64-query block, batch x head); it walks the
// key blocks of 32 in order and skips those strictly above the diagonal.
// The running max m, sum l and carried column ex of each query row live in
// the registers of the row's owner thread (threads 0..63); the [64, dh]
// output accumulator lives in registers, an 8-row x (dh/32)-column slab per
// thread (lanes on consecutive columns).  The TPU's 128 x 128 blocks do not
// fit a Hopper block at dh = 256 in f32 (a 128 x 256 q tile alone is 128 KB
// of the 227 KB): the q tile [64, dh + 1], the k tile [32, dh + 1], the v
// tile [32, dh] and the probabilities [64, 33] take 140,288 B at dh = 256
// (analysis/vmem.py `flash_smem_bytes`).  Per key block: scores (8 per
// thread), then each row's owner updates m, l, ex in column order and writes
// p (rounded to v's dtype, as the TPU kernel casts p before both products),
// then every thread rescales its accumulator slab and adds p·v, summed into
// a separate partial as `acc * corr + p @ v` associates.  No atomics; every
// sum has one fixed order.
//
// What holds it back: both products run on the f32 FMA pipes out of shared
// memory (about one shared load per FMA), no tensor cores, no pipelining of
// the next key block's loads, one block per SM (the accumulator and the
// partial take ~150 registers a thread).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows of one block
constexpr int kBKey = 32;      // keys of one step
constexpr int kThreads = 256;
constexpr int kMaxDH = 256;
constexpr int kSlab = kMaxDH / 32;   // accumulator columns per thread
constexpr int kRowsPerWarp = kBQ / (kThreads / 32);
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

__host__ __device__ inline int flash_smem_floats(int dh) {
  return kBQ * (dh + 1) + kBKey * (dh + 1) + kBKey * dh + kBQ * (kBKey + 1) +
         kBKey + kBQ;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_checksum_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ vr,
                      T* __restrict__ o, float* __restrict__ o_extra,
                      int n_t, int n_s, int n_h, int n_kh, int dh,
                      float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);     // [kBQ][dh + 1]
  float* ks = qs + kBQ * (dh + 1);                 // [kBKey][dh + 1]
  float* vs = ks + kBKey * (dh + 1);               // [kBKey][dh]
  float* ps = vs + kBKey * dh;                     // [kBQ][kBKey + 1]
  float* vrs = ps + kBQ * (kBKey + 1);             // [kBKey]
  float* rowc = vrs + kBKey;                       // [kBQ]

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / n_h, h = bh % n_h;
  const int kh = h / (n_h / n_kh);
  const bool with_extra = vr != nullptr;

  // the query tile, rows past T as zeros
  for (int idx = t; idx < kBQ * dh; idx += kThreads) {
    const int r = idx / dh, d = idx % dh;
    float val = 0.f;
    if (q0 + r < n_t) val = to_f(q[((size_t)(b * n_t + q0 + r) * n_h + h) * dh + d]);
    qs[r * (dh + 1) + d] = val;
  }

  // row state, owned by thread r < kBQ
  float m_i = kNeg, l_i = 0.f, ex_i = 0.f;
  // accumulator slab: rows warp * 8 + i, columns lane + 32 * j
  float acc[kRowsPerWarp][kSlab];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kSlab; ++j) acc[i][j] = 0.f;

  // score mapping: row t / 4, columns (t % 4) + 4 * j
  const int sr = t >> 2, sc = t & 3;
  const int last = causal ? min(n_s, q0 + kBQ) : n_s;
  for (int k0 = 0; k0 < last; k0 += kBKey) {
    __syncthreads();                 // the previous step's tiles are read
    for (int idx = t; idx < kBKey * dh; idx += kThreads) {
      const int j = idx / dh, d = idx % dh;
      float kv = 0.f, vv = 0.f;
      if (k0 + j < n_s) {
        const size_t off = ((size_t)(b * n_s + k0 + j) * n_kh + kh) * dh + d;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      ks[j * (dh + 1) + d] = kv;
      vs[j * dh + d] = vv;
    }
    if (t < kBKey) {
      float x = 0.f;
      if (with_extra && k0 + t < n_s)
        x = to_f(vr[(size_t)(b * n_s + k0 + t) * n_h + h]);
      vrs[t] = x;
    }
    __syncthreads();

    // scores, scaled and masked (masked entries hold kNeg)
    {
      float s[kBKey / 4];
#pragma unroll
      for (int j = 0; j < kBKey / 4; ++j) s[j] = 0.f;
      const float* qrow = qs + sr * (dh + 1);
      for (int d = 0; d < dh; ++d) {
        const float qv = qrow[d];
#pragma unroll
        for (int j = 0; j < kBKey / 4; ++j)
          s[j] = fmaf(qv, ks[(sc + 4 * j) * (dh + 1) + d], s[j]);
      }
#pragma unroll
      for (int j = 0; j < kBKey / 4; ++j) {
        const int c = sc + 4 * j, kpos = k0 + c, qpos = q0 + sr;
        const bool valid = kpos < n_s && (!causal || kpos <= qpos);
        ps[sr * (kBKey + 1) + c] = valid ? s[j] * scale : kNeg;
      }
    }
    __syncthreads();

    // each row's owner: online-softmax update, p in v's dtype, the column
    if (t < kBQ) {
      float* prow = ps + t * (kBKey + 1);
      float mx = kNeg;
      for (int c = 0; c < kBKey; ++c) mx = fmaxf(mx, prow[c]);
      const float m_new = fmaxf(m_i, mx);
      const float corr = expf(m_i - m_new);
      float psum = 0.f, pex = 0.f;
      for (int c = 0; c < kBKey; ++c) {
        const int kpos = k0 + c;
        const bool valid = kpos < n_s && (!causal || kpos <= q0 + t);
        const float p = valid ? expf(prow[c] - m_new) : 0.f;
        const float pr = to_f(from_f<T>(p));
        psum += p;
        pex = fmaf(pr, vrs[c], pex);
        prow[c] = pr;
      }
      l_i = __fadd_rn(__fmul_rn(l_i, corr), psum);
      ex_i = __fadd_rn(__fmul_rn(ex_i, corr), pex);
      m_i = m_new;
      rowc[t] = corr;
    }
    __syncthreads();

    // acc = acc * corr + p @ v on this thread's slab
    {
      float pv[kRowsPerWarp][kSlab];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
        for (int j = 0; j < kSlab; ++j) pv[i][j] = 0.f;
      for (int c = 0; c < kBKey; ++c) {
        float vv[kSlab];
#pragma unroll
        for (int j = 0; j < kSlab; ++j) {
          const int d = lane + 32 * j;
          vv[j] = d < dh ? vs[c * dh + d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float p = ps[(warp * kRowsPerWarp + i) * (kBKey + 1) + c];
#pragma unroll
          for (int j = 0; j < kSlab; ++j) pv[i][j] = fmaf(p, vv[j], pv[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float corr = rowc[warp * kRowsPerWarp + i];
#pragma unroll
        for (int j = 0; j < kSlab; ++j)
          acc[i][j] = __fadd_rn(__fmul_rn(acc[i][j], corr), pv[i][j]);
      }
    }
  }

  // epilogue: divide by l (floored at 1e-30), write o and o_extra
  __syncthreads();
  if (t < kBQ) {
    const float lsafe = fmaxf(l_i, 1e-30f);
    rowc[t] = lsafe;
    if (with_extra && q0 + t < n_t)
      o_extra[(size_t)(b * n_t + q0 + t) * n_h + h] = __fdiv_rn(ex_i, lsafe);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    if (q0 + r >= n_t) continue;
    const float lsafe = rowc[r];
    T* orow = o + ((size_t)(b * n_t + q0 + r) * n_h + h) * dh;
#pragma unroll
    for (int j = 0; j < kSlab; ++j) {
      const int d = lane + 32 * j;
      if (d < dh) orow[d] = from_f<T>(__fdiv_rn(acc[i][j], lsafe));
    }
  }
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, const void* vr,
                 void* o, float* o_extra, int n_b, int n_t, int n_s, int n_h,
                 int n_kh, int dh, float scale, int causal,
                 cudaStream_t stream) {
  const int smem = flash_smem_floats(dh) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_checksum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_t + kBQ - 1) / kBQ, n_b * n_h);
  flash_checksum_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(vr), static_cast<T*>(o),
      o_extra, n_t, n_s, n_h, n_kh, dh, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_checksum_smem_bytes(int dh) {
  return flash_smem_floats(dh) * (int)sizeof(float);
}

extern "C" int flash_checksum_max_dh() { return kMaxDH; }

// Launch on `stream`; allocates nothing, does not synchronise, returns
// cudaGetLastError() (0 on success).  q [B, T, H, dh], k and v [B, S, Kh, dh],
// vr [B, S, H] or null, o [B, T, H, dh], o_extra [B, T, H] f32 or null (with
// vr); dtype 0 = float32, 1 = bfloat16 (q, k, v, vr, o).
extern "C" int flash_checksum_launch(const void* q, const void* k,
                                     const void* v, const void* vr, void* o,
                                     float* o_extra, int n_b, int n_t,
                                     int n_s, int n_h, int n_kh, int dh,
                                     float scale, int causal, int dtype,
                                     void* stream) {
  if (n_b <= 0 || n_t <= 0 || n_s <= 0 || n_kh <= 0 || n_h % n_kh ||
      dh <= 0 || dh > kMaxDH || (vr == nullptr) != (o_extra == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_typed<float>(q, k, v, vr, o, o_extra, n_b, n_t, n_s, n_h,
                               n_kh, dh, scale, causal, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k, v, vr, o, o_extra, n_b, n_t,
                                       n_s, n_h, n_kh, dh, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
