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
// multiplied like any other tile, no mask.
//
// What bounds it on this card: bytes.  With G = 16 a [128, 128] tile costs
// 64 KB of device-memory traffic for 0.56 MFLOP, about 8 FLOP per byte,
// under the card's f32 balance of roughly 20.
//
// Design.  The TPU grid is (stripe, slot) with the accumulator carried in
// scratch from one slot to the next; thread blocks run in no order, so here
// ONE BLOCK OWNS ONE ROW-STRIPE and walks its slots in a loop, reading
// block_cols[i, j] itself.  The S tile is staged through shared memory with
// coalesced 16-byte reads, the gathered X tile and the x_r tile beside it;
// while a tile is multiplied the next one (and its X tile) is prefetched into
// L2.  The product is register-tiled (abft_tile.cuh).  The stripe accumulator
// [bm, G] and the check column [bm] stay in shared memory across the whole
// sweep and reach device memory once.  The inject hook adds `delta` to
// acc[0, 0] after slot `inj_slot` of stripe `inj_stripe` (stripe -1: none).
// No atomics, fixed-order reductions.
//
// What holds it back: one block per stripe gives nbm blocks (about 144-176
// for a served batch at Cora's size, 22 for one Cora graph) on 132 SMs, the
// tile goes through shared memory without double buffering, the products run
// on the f32 pipes, and padding tiles cost what real ones do.
#include "abft_tile.cuh"

using namespace abft;

namespace {

__host__ __device__ inline int spmm_smem_floats(int bm, int bk, int gp) {
  return bm * gp + bk * gp + bm + bk + kReduceScratch + bm * (bk + 1);
}

__global__ void __launch_bounds__(kThreads, 2)
spmm_abft_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                 const float* __restrict__ x, const float* __restrict__ xr,
                 float* __restrict__ out, float* __restrict__ sums,
                 float* __restrict__ extra, int width, int bm, int bk, int gp,
                 int inj_stripe, int inj_slot, float inj_delta) {
  extern __shared__ float4 smem4[];
  float* acc_sm = reinterpret_cast<float*>(smem4);
  float* x_sm = acc_sm + bm * gp;
  float* ex_sm = x_sm + bk * gp;
  float* xr_sm = ex_sm + bm;
  float* red = xr_sm + bk;
  float* s_sm = red + kReduceScratch;

  const int i = blockIdx.x;
  for (int t = threadIdx.x; t < bm * gp; t += kThreads) acc_sm[t] = 0.f;
  for (int t = threadIdx.x; t < bm; t += kThreads) ex_sm[t] = 0.f;
  __syncthreads();

  const int xt4 = (bk * gp) >> 2;
  const size_t tile_floats = (size_t)bm * bk;
  for (int j = 0; j < width; ++j) {
    const int c = cols[i * width + j];
    const float* tile = vals + ((size_t)i * width + j) * tile_floats;
    load_s_tile(tile, s_sm, bm, bk);
    const float4* xs = reinterpret_cast<const float4*>(x + (size_t)c * bk * gp);
    float4* xd = reinterpret_cast<float4*>(x_sm);
    for (int t = threadIdx.x; t < xt4; t += kThreads) xd[t] = __ldg(xs + t);
    for (int t = threadIdx.x; t < bk; t += kThreads)
      xr_sm[t] = __ldg(xr + (size_t)c * bk + t);
    if (j + 1 < width) {
      prefetch_l2(tile + tile_floats, (int)(tile_floats * sizeof(float)));
      prefetch_l2(x + (size_t)cols[i * width + j + 1] * bk * gp,
                  bk * gp * (int)sizeof(float));
    }
    __syncthreads();

    aggregate_tile(s_sm, x_sm, xr_sm, acc_sm, ex_sm, bm, bk, gp, true);

    if (i == inj_stripe && j == inj_slot && threadIdx.x == 0)
      acc_sm[0] += inj_delta;
  }
  __syncthreads();
  stripe_epilogue(acc_sm, ex_sm, red, out, sums, extra, i, bm, gp);
}

}  // namespace

extern "C" int spmm_abft_smem_bytes(int bm, int bk, int gp) {
  return spmm_smem_floats(bm, bk, gp) * (int)sizeof(float);
}

extern "C" int abft_block_threads() { return kThreads; }

// Launch on `stream`; allocates nothing, does not synchronise, returns
// cudaGetLastError() (0 on success).  Needs bm even, bk % 4 == 0, gp % 8 == 0.
extern "C" int spmm_abft_launch(const int* cols, const float* vals,
                                const float* x, const float* xr, float* out,
                                float* sums, float* extra, int nbm, int width,
                                int bm, int bk, int gp, int inj_stripe,
                                int inj_slot, float inj_delta, void* stream) {
  if ((bm & 1) || (bk & 3) || (gp & 7)) return (int)cudaErrorInvalidValue;
  const int smem = spmm_abft_smem_bytes(bm, bk, gp);
  cudaError_t err = cudaFuncSetAttribute(
      spmm_abft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  spmm_abft_kernel<<<nbm, kThreads, smem, (cudaStream_t)stream>>>(
      cols, vals, x, xr, out, sums, extra, width, bm, bk, gp, inj_stripe,
      inj_slot, inj_delta);
  return (int)cudaGetLastError();
}
