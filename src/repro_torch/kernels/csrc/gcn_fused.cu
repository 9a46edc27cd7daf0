// One GCN-ABFT layer out = S (H W) in a single sweep, for NVIDIA Hopper.
//
// Replaces the TPU kernel `gcn_fused_kernel` (`_make_kernel`) of
// src/repro/kernels/gcn_fused/kernel.py.  The per-tile arithmetic (the
// on-the-fly combination x = h @ W, x_r = h @ w_r and the aggregation
// acc += S_tile @ x, ex += S_tile @ x_r) is `fused_stripe_sweep` in
// fused_tile.cuh, shared with the whole-network kernel.  This kernel emits
// the same three outputs as spmm_abft (out, stripe_sums, extra), plus, with
// `with_slots`, the telescoped running sums Σ acc and Σ ex recorded after
// every slot (after the inject hook), from which slot-granular check corners
// are differenced.  `with_check == 0` does none of the check products and
// leaves `extra` all zero.
//
// What bounds it on this card: at narrow F, bytes (the S tiles, as in
// spmm_abft).  At Cora's F = 1433 the recomputed combination is 5.9 MFLOP
// per stored tile against 0.56 for the aggregation, and the sweep is bound
// by f32 operations and by re-reading H tiles.
//
// Design.  One block owns one row-stripe and walks its slots in order, as in
// spmm_abft.  The TPU kernel held a whole [bk, F] H tile and all of W in
// on-chip memory; this one walks F in chunks (fused_tile.cuh), so the
// shared-memory footprint does not depend on F; analysis/vmem.py states the
// same footprint, and the condition that a [bk, G] tile has at most one
// register tile per thread, and the engine's fallback predicate reads both
// there.
//
// What holds it back: one block per stripe (few blocks), scalar f32 FMAs for
// a product that wgmma could carry in TF32 only by giving up the check's f32
// noise floor, and the recomputation per stored tile itself, padding tiles
// included.
#include "fused_tile.cuh"

using namespace abft;

namespace {

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
  const FusedSmem sm =
      carve_fused_smem(reinterpret_cast<float*>(smem4), bm, bk, gp);
  const int i = blockIdx.x;
  fused_stripe_sweep<false>(cols, vals, h, w, wr, i, width, bm, bk, f, gp,
                            with_check, with_slots,
                            i == inj_stripe ? inj_slot : -1, inj_delta,
                            slot_acts, slot_preds, sm);
  stripe_epilogue(sm.acc, sm.ex, sm.red, out, sums, extra, i, bm, gp);
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
