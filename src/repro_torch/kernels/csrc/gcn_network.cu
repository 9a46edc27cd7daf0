// A whole L-layer GCN  H_{l+1} = relu(S (H_l W_l))  in ONE launch, for
// NVIDIA Hopper.
//
// Replaces the TPU kernel `gcn_network_kernel` (`_make_network_kernel`) of
// src/repro/kernels/gcn_fused/kernel.py.  Per layer l it computes what a
// gcn_fused launch computes (fused_tile.cuh: X_l = H_l W_l and x_r = H_l
// w_r,l once per row, then acc = Σ_j S[i,j] X_l[cols[i,j]] and ex = Σ_j
// S[i,j] x_r[cols[i,j]] from separate products), records the telescoped
// Σ acc / Σ ex after every slot (after the inject hook) into tele_acts /
// tele_preds [L, nbm, width], applies ReLU between layers, and writes the
// final logits once.  `with_check == 0` elides the eq.-5 products (the pred
// telescopes stay 0).
//
// What bounds it on this card: bytes.  At Cora's served batch, h0 (105.6
// MB) once and the S tiles (229 MB) once per layer; the activations
// between layers (1.2 MB at hidden width 16) and the X workspace stay in
// the 50 MB L2.
//
// Design.  The TPU kernel kept two [K, P] activation buffers in one core's
// VMEM for the whole grid and folded the next layer's combination into the
// aggregation epilogue; no memory of a Hopper card is both on chip and
// shared by all blocks, so here:
//   * TWO PHASES A LAYER, the same code as gcn_fused (`combine_items_from`,
//     then `sweep_slices_from`), with a grid-wide barrier after each phase:
//     the combination writes X_l and x_r into the workspace, the sweep
//     reads them after the barrier, and the next layer's combination reads
//     act[l] after the next one (2L - 1 barriers).  One workspace serves every
//     layer: a layer's sweep is done with it before the next combination
//     overwrites it.
//   * ONE ACTIVATION BUFFER PER LAYER, not a ping-pong pair.  Layer l writes
//     act[l] [K, G_l] (post-ReLU, the unpadded width the next layer reads)
//     and only layer l + 1 reads it; the wrapper returns these buffers as
//     the surgical tiers' activation stash at no extra cost.
//   * PER-LAYER WIDTHS AND PLANS.  Each layer has its own W_l [F_l, gp_l],
//     w_r,l [F_l, 1], cut and arguments, built by the launcher into one
//     parameter struct of at most kMaxLayers layers; the shared memory is
//     the largest layer's.
//   * ONE COOPERATIVE, PERSISTENT LAUNCH.  The grid is at most the number of
//     blocks that can be resident at once (occupancy x SMs: two an SM),
//     computed by the launcher, never taken from the caller;
//     cudaLaunchCooperativeKernel refuses a grid that could not be
//     co-resident instead of deadlocking.
//     Block b takes items b, b + grid, ... of every phase.  The barrier is
//     hand-rolled (an arrival counter and a generation word in device
//     memory, a fence before arriving) so the build needs no relocatable
//     device code.
//   * COHERENCE.  Data written in this launch is read only through L2: the
//     workspace by the sweep's TMA copies (the combination fences its
//     writes to the async proxy before the barrier), the activations by
//     the next combination's ld.global.cg loads, the slices' sums by
//     ld.global.cg; h0, the S tiles and W are read-only.
//   * BITWISE CONTRACT.  Each combine item and each stripe slice runs the
//     code of a gcn_fused launch (fused_tile.cuh) with the same plan; every
//     product is an explicit fmaf and every other sum a plain addition in a
//     fixed order, which the compiler may neither reassociate nor contract
//     wherever it inlines them.  So logits, telescopes and activations
//     equal a chain of gcn_fused launches with ReLU between.
//
// What holds it back: what holds gcn_fused back, and the grid barriers,
// which make every phase wait for its slowest block.
#include "fused_tile.cuh"

using namespace abft;

namespace {

constexpr int kMaxLayers = 8;
constexpr int kGQuantum = 8;

// One layer's two phases, their arguments built by the launcher.
struct NetLayer {
  CUtensorMap smap;    // the S tiles in the boxes of this layer's sweep
  CombineArgs comb;    // H_l (h0, or act[l - 1]), W_l, w_r,l -> workspace
  SweepArgs sweep;     // the workspace -> act[l] (relu) or the logits
  Plan plan;
};

// Everything a launch needs, in one __grid_constant__ parameter: the phases
// read their arguments from parameter memory where they use them.
struct NetArgs {
  unsigned int* barrier;   // 2 words: the grid barrier's
  int n_layers;
  NetLayer layer[kMaxLayers];
};

static_assert(sizeof(NetArgs) <= 4096, "NetArgs outgrows a kernel's parameters");

inline int lanes(int g) { return (g + kGQuantum - 1) / kGQuantum * kGQuantum; }

// Every block of the grid waits here until all have arrived.  `count` and
// `gen` start at 0 for the launch.  Each thread fences its own writes; thread
// 0 reads the generation BEFORE arriving (it cannot change until every block
// has arrived), arrives, and the last arriver resets the counter and bumps
// the generation; the others spin until it moves.
__device__ __forceinline__ void grid_barrier(unsigned int* count,
                                             unsigned int* gen,
                                             unsigned int nblocks) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* vgen = gen;
    const unsigned int g0 = *vgen;
    __threadfence();
    if (atomicAdd(count, 1u) == nblocks - 1) {
      atomicExch(count, 0u);
      __threadfence();
      atomicAdd(gen, 1u);
    } else {
      while (*vgen == g0) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// Per layer: the combination of this block's row tiles into the
// workspace, a grid barrier (the sweep reads X_l), the sweep of its stripe
// slices, and a grid barrier before the next layer reads act[l]: 2L - 1
// barriers.  The phases are inlined and read their arguments from the
// kernel's parameter memory where they use them.  Layer 0 reads h0 through
// the read-only path; later layers read the activations written in this
// launch from L2.  Two blocks an SM: the phases of every layer in one
// function fit the 128 registers that leaves (with the sweep's copies
// issued from every thread they did not, and no layout of the layer loop
// helped).
__global__ void __launch_bounds__(kThreads, 2)
gcn_network_kernel(const __grid_constant__ NetArgs net) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
#pragma unroll 1
  for (int l = 0; l < net.n_layers; ++l) {
    const NetLayer& ly = net.layer[l];
    if (l == 0) combine_any<false>(ly.comb, ly.plan, blockIdx.x, gridDim.x,
                                   smem);
    else combine_any<true>(ly.comb, ly.plan, blockIdx.x, gridDim.x, smem);
    grid_barrier(net.barrier, net.barrier + 1, gridDim.x);
    sweep_any(ly.sweep, ly.plan, &ly.smap, blockIdx.x, gridDim.x, smem);
    if (l + 1 < net.n_layers)
      grid_barrier(net.barrier, net.barrier + 1, gridDim.x);
  }
}

bool network_plans(const int* dims, int n_layers, int bm, int bk,
                   Plan* plans) {
  if (bm != bk || n_layers < 1 || n_layers > kMaxLayers) return false;
  for (int l = 0; l < n_layers; ++l) {
    if (dims[l] < 1 || dims[l + 1] < 1) return false;
    plans[l] = make_plan(bm, bk, lanes(dims[l + 1]));
    if (plans[l].smem == 0) return false;
  }
  return true;
}

int network_smem_bytes(const Plan* plans, int n_layers) {
  int most = 0;
  for (int l = 0; l < n_layers; ++l)
    if (plans[l].smem > most) most = plans[l].smem;
  return most;
}

// Blocks of the persistent grid: at most the blocks that can be resident at
// once on the current device, and no more than the largest phase has items.
cudaError_t network_grid(int items, int smem, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      gcn_network_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gcn_network_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gcn_network_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = items < per_sm * sms ? items : per_sm * sms;
  return cudaSuccess;
}

}  // namespace

extern "C" int gcn_network_max_layers() { return kMaxLayers; }

extern "C" int gcn_network_supported(const int* dims, int n_layers, int bm,
                                     int bk) {
  Plan plans[kMaxLayers];
  return network_plans(dims, n_layers, bm, bk, plans) ? 1 : 0;
}

extern "C" int gcn_network_smem_bytes(const int* dims, int n_layers, int bm) {
  Plan plans[kMaxLayers];
  if (!network_plans(dims, n_layers, bm, bm, plans)) return 0;
  return network_smem_bytes(plans, n_layers);
}

// Launch on `stream`; allocates nothing, does not synchronise, returns a CUDA
// error code (0 on success).  `dims` [n_layers + 1] are the unpadded layer
// widths; `ws`/`wrs` [n_layers] point at each W_l [dims[l], lanes(dims[l+1])]
// and w_r,l [dims[l], 1]; `acts` [n_layers - 1] at each [nbm * bm, dims[l+1]]
// activation buffer; `work` at the workspace, nbm * bm * (the widest
// lanes(dims[l+1]) + 1) floats; `part` at nbm * (the most slices) *
// (2 width + 1) floats; `barrier` at 2 + nbm zeroed words (the grid
// barrier's, then each stripe's slice count).  The grid it chose is written
// to `*grid_out`.
extern "C" int gcn_network_launch(const int* cols, const float* vals,
                                  const float* h0, const void* const* ws,
                                  const void* const* wrs, void* const* acts,
                                  const int* dims, float* out,
                                  float* tele_acts, float* tele_preds,
                                  float* work, float* part,
                                  unsigned int* barrier,
                                  int n_layers, int nbm, int width, int bm,
                                  int bk, int with_check, int inj_layer,
                                  int inj_stripe, int inj_slot,
                                  float inj_delta, void* stream,
                                  int* grid_out) {
  Plan plans[kMaxLayers];
  if (!network_plans(dims, n_layers, bm, bk, plans) || nbm < 1)
    return (int)cudaErrorInvalidValue;
  NetArgs net{};
  net.barrier = barrier;
  net.n_layers = n_layers;
  const int k_rows = nbm * bm;
  int items = nbm;
  for (int l = 0; l < n_layers; ++l) {
    NetLayer& ly = net.layer[l];
    const int gp = lanes(dims[l + 1]);
    float* act = l + 1 < n_layers ? static_cast<float*>(acts[l]) : nullptr;
    ly.plan = plans[l];
    const cudaError_t e = encode_vals_map(
        &ly.smap, vals, (long long)nbm * width * bm, bk, plans[l].b);
    if (e != cudaSuccess) return (int)e;
    ly.comb = CombineArgs{
        l == 0 ? h0 : static_cast<const float*>(acts[l - 1]),
        static_cast<const float*>(ws[l]), static_cast<const float*>(wrs[l]),
        work, work + (size_t)k_rows * gp, k_rows, dims[l], gp, with_check};
    SweepArgs& a = ly.sweep;
    a.cols = cols;
    a.vals = vals;
    a.x = ly.comb.x;
    a.xr = ly.comb.xr;
    a.out = act ? act : out;
    a.slot_acts = tele_acts + (size_t)l * nbm * width;
    a.slot_preds = tele_preds + (size_t)l * nbm * width;
    a.part = part;
    a.count = barrier + 2;
    a.nbm = nbm;
    a.width = width;
    a.bm = bm;
    a.bk = bk;
    a.gp = gp;
    a.g = dims[l + 1];
    a.with_check = with_check;
    a.with_slots = 1;
    a.epilogue = act ? kEpiAct : kEpiLogits;
    a.inj_stripe = l == inj_layer ? inj_stripe : -1;
    a.inj_slot = inj_slot;
    a.inj_delta = inj_delta;
    const int ia = combine_items(plans[l], k_rows);
    const int ib = sweep_items(plans[l], nbm);
    if (ia > items) items = ia;
    if (ib > items) items = ib;
  }
  const int smem = network_smem_bytes(plans, n_layers);
  int grid = 0;
  cudaError_t err = network_grid(items, smem, &grid);
  if (err != cudaSuccess) return (int)err;
  *grid_out = grid;
  void* args[] = {&net};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(gcn_network_kernel), dim3(grid),
      dim3(kThreads), args, (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
