// One GCN-ABFT layer out = S (H W), for NVIDIA Hopper.
//
// Replaces the TPU kernel `gcn_fused_kernel` (`_make_kernel`) of
// src/repro/kernels/gcn_fused/kernel.py.  It emits the same three outputs
// as spmm_abft (out, stripe_sums, extra), plus, with `with_slots`, the
// telescoped running sums Σ acc and Σ ex recorded after every slot (after
// the inject hook), from which slot-granular check corners are differenced.
// `with_check == 0` does none of the check products and leaves `extra` all
// zero.
//
// What bounds it on this card: bytes.  At Cora's served batch (F = 1433,
// G = 16, 144 stripes x 24 slots of 128 x 128 tiles) the layer reads H
// once (105.6 MB) and the S tiles once (229 MB): 0.100 ms at 3.35 TB/s.  Its
// least work, the combination once (0.90 GFLOP) and the aggregation per
// stored tile (1.9 GFLOP), is 0.042 ms of f32 FMA.
//
// Design.  The TPU kernel recomputed x = H[c] @ W per stored tile inside
// the aggregation, with a whole H tile and W resident in VMEM; on this card
// that recompute read 2.5 GB of H a launch and did 24 times the needed
// FMAs.  Here the layer is two phases (fused_tile.cuh), two kernels in
// stream order behind one C call:
//   * `combine_kernel`: X = H W and x_r = H w_r, once per row, into a
//     workspace the wrapper allocates ([K, gp] + [K] f32, 1.2 MB at Cora,
//     which stays in L2); one block per 64 rows x up to 64 columns, F
//     streamed through a 4-stage cp.async ring;
//   * `sweep_kernel`: one block per stripe (up to 128 rows) walks its slots
//     in order, S in chunks through a 4-stage TMA ring (one thread copies
//     a chunk's S box and its X and x_r rows; every thread waits on the
//     stage's mbarrier), 4 x 8 register tiles, one barrier a chunk; the
//     slot telescopes from warp sums, no barrier of their own.
// Both are 256-thread blocks at 2 an SM, with no spill.  Only the contract
// that X never reaches device memory is given up; what the TPU kernel
// bought with it, one traversal of H, holds: H is read once either way.
//
// What holds it back (tools/fused_ab.py, tools/fused_variants.py; NVIDIA
// H100 80GB HBM3, 700.00 W; Cora's served batch): the combination takes
// 0.075 ms against the 0.032 of reading H once — each thread copies H 4
// bytes at a time, since its rows are not 16-byte aligned; the sweep,
// one block a stripe, leaves 12 of 132 SMs two stripes.  Padding tiles cost
// what real ones do.
#include "fused_tile.cuh"

using namespace abft;

namespace {

__global__ void __launch_bounds__(kThreads, 2)
combine_kernel(const __grid_constant__ CombineArgs g,
               const __grid_constant__ Plan p) {
  extern __shared__ float4 smem4[];
  combine_any<false>(g, p, blockIdx.x, gridDim.x,
                     reinterpret_cast<float*>(smem4));
}

__global__ void __launch_bounds__(kThreads, 2)
sweep_kernel(const __grid_constant__ SweepArgs a,
             const __grid_constant__ Plan p,
             const __grid_constant__ CUtensorMap smap) {
  extern __shared__ float4 smem4[];
  sweep_any(a, p, &smap, blockIdx.x, gridDim.x,
            reinterpret_cast<float*>(smem4));
}

}  // namespace

extern "C" int gcn_fused_smem_bytes(int bm, int bk, int gp) {
  return make_plan(bm, bk, gp).smem;
}

// The plan as analysis/vmem.py `fused_plan` states it (the wrapper asserts
// that the two agree): ct, col_tiles, the combine tile's rt, units,
// groups, the sweep tile's rows, kc, rt, units, groups, the slices and the
// shared memory, into `out[12]`.
extern "C" int gcn_fused_plan(int bm, int bk, int gp, int* out) {
  const Plan p = make_plan(bm, bk, gp);
  const int v[12] = {p.ct,       p.col_tiles, p.a.rt,   p.a.units,
                     p.a.groups, p.b.rows,    p.b.kc,   p.b.rt,
                     p.b.units,  p.b.groups,  p.slices, p.smem};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return p.smem > 0 ? 1 : 0;
}

// Launch on `stream`; allocates nothing, does not synchronise, returns
// cudaGetLastError() (0 on success).  `ws` is the workspace, k_rows * (gp +
// 1) floats; `part` the slices' sums, nbm * slices * (2 width + 1) floats;
// `count` nbm zeroed words (left zeroed); `slot_acts`/`slot_preds` are
// written only when `with_slots` is set.  Two kernels in stream order: the
// combination, then the sweep.
extern "C" int gcn_fused_launch(const int* cols, const float* vals,
                                const float* h, const float* w,
                                const float* wr, float* ws, float* part,
                                unsigned int* count, float* out,
                                float* sums, float* extra, float* slot_acts,
                                float* slot_preds, int nbm, int width, int bm,
                                int bk, int k_rows, int f, int gp,
                                int with_check, int with_slots,
                                int inj_stripe, int inj_slot, float inj_delta,
                                void* stream) {
  const Plan p = make_plan(bm, bk, gp);
  if (p.smem == 0 || nbm < 1 || width < 0 || k_rows < 1 || f < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  const CombineArgs g{h, w, wr, ws, ws + (size_t)k_rows * gp, k_rows, f, gp,
                      with_check};
  combine_kernel<<<combine_items(p, k_rows), kThreads, p.smem,
                   (cudaStream_t)stream>>>(g, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  SweepArgs a{};
  a.cols = cols;
  a.vals = vals;
  a.x = g.x;
  a.xr = g.xr;
  a.out = out;
  a.sums = sums;
  a.extra = extra;
  a.slot_acts = slot_acts;
  a.slot_preds = slot_preds;
  a.part = part;
  a.count = count;
  a.nbm = nbm;
  a.width = width;
  a.bm = bm;
  a.bk = bk;
  a.gp = gp;
  a.g = gp;
  a.with_check = with_check;
  a.with_slots = with_slots;
  a.epilogue = kEpiLayer;
  a.inj_stripe = inj_stripe;
  a.inj_slot = inj_slot;
  a.inj_delta = inj_delta;
  CUtensorMap smap;
  if ((err = encode_vals_map(&smap, vals, (long long)nbm * width * bm, bk,
                             p.b)) != cudaSuccess)
    return (int)err;
  sweep_kernel<<<sweep_items(p, nbm), kThreads, p.smem,
                 (cudaStream_t)stream>>>(a, p, smap);
  return (int)cudaGetLastError();
}

// The combination alone (phase A of gcn_fused_launch, the same kernel and
// plan): X and x_r into `ws`.  For measuring the phase and checking it;
// the layer itself is gcn_fused_launch.
extern "C" int gcn_fused_combine_launch(const float* h, const float* w,
                                        const float* wr, float* ws, int bm,
                                        int bk, int k_rows, int f, int gp,
                                        int with_check, void* stream) {
  const Plan p = make_plan(bm, bk, gp);
  if (p.smem == 0 || k_rows < 1 || f < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  const CombineArgs g{h, w, wr, ws, ws + (size_t)k_rows * gp, k_rows, f, gp,
                      with_check};
  combine_kernel<<<combine_items(p, k_rows), kThreads, p.smem,
                   (cudaStream_t)stream>>>(g, p);
  return (int)cudaGetLastError();
}
