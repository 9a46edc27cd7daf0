// A whole L-layer GCN  H_{l+1} = relu(S (H_l W_l))  in ONE launch, for
// NVIDIA Hopper.
//
// Replaces the TPU kernel `gcn_network_kernel` (`_make_network_kernel`) of
// src/repro/kernels/gcn_fused/kernel.py.  Per layer l it computes what a
// gcn_fused launch computes (fused_tile.cuh: acc = Σ_j S[i,j] (H_l[cols[i,j]]
// W_l) and ex = Σ_j S[i,j] (H_l[cols[i,j]] w_r,l) from separate products),
// records the telescoped Σ acc / Σ ex after every slot (after the inject
// hook) into tele_acts / tele_preds [L, nbm, width], applies ReLU between
// layers, and writes the final logits once.  `with_check == 0` elides the
// eq.-5 products (the pred telescopes stay 0).
//
// What bounds it on this card: at Cora's widths, the f32 operations of the
// recomputed layer-0 combination (as in gcn_fused); by bytes, the S tiles,
// read once per layer.  The activations between layers are 1.2 MB at Cora's
// hidden width 16 and stay in the 50 MB L2.
//
// Design.  The TPU kernel kept two [K, P] activation buffers in one core's
// VMEM for the whole grid; no memory of a Hopper card is both on chip and
// shared by all blocks, so here the activations live in device memory:
//   * ONE BUFFER PER LAYER, not a ping-pong pair.  Layer l writes act[l]
//     [K, G_l] (post-ReLU, the unpadded width the next layer reads) and only
//     layer l + 1 reads it, so no buffer is written while it is read and no
//     block can hold a stale line of it; the wrapper returns these buffers
//     as the surgical tiers' activation stash at no extra cost.
//   * PER-LAYER WIDTHS.  Each layer has its own W_l [F_l, gp_l] and
//     w_r,l [F_l, 1] (a parameter struct of at most kMaxLayers entries), not
//     one shared padded P: at Cora one P = 1440 would break the one-register-
//     tile-per-thread condition of the fused sweep.
//   * ONE COOPERATIVE, PERSISTENT LAUNCH.  The grid is at most the number of
//     blocks that can be resident at once (occupancy x SMs), computed by the
//     launcher, never taken from the caller; cudaLaunchCooperativeKernel
//     refuses a grid that could not be co-resident instead of deadlocking.
//     Block b takes stripes b, b + grid, ... of every layer, and a grid-wide
//     barrier separates the layers.  The barrier is hand-rolled (an arrival
//     counter and a generation word in device memory, a fence before
//     arriving) so the build needs no relocatable device code.  A thread-
//     block cluster with distributed shared memory would keep activations
//     on chip, but a cluster has at most 16 blocks against 144 stripes at
//     Cora.
//   * COHERENCE.  Layer l >= 1 reads activations other blocks wrote in this
//     launch: those loads go to L2 (ld.global.cg), never through the
//     read-only path or L1; h0, the S tiles and W are read-only and keep
//     __ldg.
//   * BITWISE CONTRACT.  Each stripe of each layer runs fused_stripe_sweep,
//     the same code as a gcn_fused launch, so logits, telescopes and
//     activations equal a chain of gcn_fused launches with ReLU between.
//
// What holds it back: everything that holds gcn_fused back (one block per
// stripe, scalar f32 FMAs, the per-tile recomputation), and the grid
// barrier, which makes every layer wait for its slowest stripe.
#include "fused_tile.cuh"

using namespace abft;

namespace {

constexpr int kMaxLayers = 8;
constexpr int kGQuantum = 8;

struct NetLayer {
  const float* w;   // [f, gp]
  const float* wr;  // [f, 1]
  float* act;       // [K, g] post-ReLU output (layers < L - 1)
  int f, g, gp;
};

struct NetArgs {
  NetLayer layer[kMaxLayers];
};

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

// One layer over this block's stripes: sweep each stripe (fused_tile.cuh),
// then write its post-ReLU activations (one [K, g] buffer per layer) or, at
// the last layer, its logits.  Never inlined: its registers are allocated
// as in a gcn_fused launch, and only the few values live across the layer
// loop are saved around the call (inlined into that loop, the sweep spilled
// several times more).  Layer 0 reads h0 through the read-only path
// (`kL2 == false`); later layers read the previous layer's activations,
// written in this launch, from L2.
template <bool kL2>
__device__ __noinline__ void network_layer(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const float* h, const NetLayer ly, float* __restrict__ out, float* ta,
    float* tp, bool last, int nbm, int width, int bm, int with_check,
    int inj_stripe, int inj_slot, float inj_delta) {
  extern __shared__ float4 smem4[];
  const FusedSmem sm =
      carve_fused_smem(reinterpret_cast<float*>(smem4), bm, bm, ly.gp);
  for (int i = blockIdx.x; i < nbm; i += gridDim.x) {
    fused_stripe_sweep<kL2>(cols, vals, h, ly.w, ly.wr, i, width, bm, bm,
                            ly.f, ly.gp, with_check, 1,
                            i == inj_stripe ? inj_slot : -1, inj_delta, ta,
                            tp, sm);
    if (last) {
      float* o = out + (size_t)i * bm * ly.gp;
      for (int t = threadIdx.x; t < bm * ly.gp; t += kThreads)
        o[t] = sm.acc[t];
    } else {
      float* a = ly.act + (size_t)i * bm * ly.g;
      for (int t = threadIdx.x; t < bm * ly.g; t += kThreads) {
        const int r = t / ly.g, c = t - r * ly.g;
        const float v = sm.acc[r * ly.gp + c];
        a[t] = v < 0.f ? 0.f : v;   // ReLU; NaN stays NaN
      }
    }
    __syncthreads();   // the epilogue read acc; the next stripe zeroes it
  }
}

// `net` is a __grid_constant__ parameter: the per-layer table is indexed
// by the runtime layer number straight from parameter memory, with no
// local copy.
__global__ void __launch_bounds__(kThreads, 2)
gcn_network_kernel(const int* __restrict__ cols,
                   const float* __restrict__ vals,
                   const float* __restrict__ h0,
                   const __grid_constant__ NetArgs net,
                   float* __restrict__ out, float* __restrict__ tele_acts,
                   float* __restrict__ tele_preds, unsigned int* barrier,
                   int n_layers, int nbm, int width, int bm, int with_check,
                   int inj_layer, int inj_stripe, int inj_slot,
                   float inj_delta) {
  for (int l = 0; l < n_layers; ++l) {
    const bool last = l == n_layers - 1;
    float* ta = tele_acts + (size_t)l * nbm * width;
    float* tp = tele_preds + (size_t)l * nbm * width;
    const int inj = l == inj_layer ? inj_stripe : -1;
    if (l == 0)
      network_layer<false>(cols, vals, h0, net.layer[0], out, ta, tp, last,
                           nbm, width, bm, with_check, inj, inj_slot,
                           inj_delta);
    else
      network_layer<true>(cols, vals, net.layer[l - 1].act, net.layer[l],
                          out, ta, tp, last, nbm, width, bm, with_check, inj,
                          inj_slot, inj_delta);
    if (!last) grid_barrier(barrier, barrier + 1, gridDim.x);
  }
}

bool network_supported(const int* dims, int n_layers, int bm, int bk) {
  if (bm != bk || n_layers < 1 || n_layers > kMaxLayers) return false;
  for (int l = 0; l < n_layers; ++l)
    if (dims[l] < 1 || dims[l + 1] < 1 ||
        !fused_supported(bm, bk, lanes(dims[l + 1])))
      return false;
  return true;
}

int network_smem_bytes(const int* dims, int n_layers, int bm) {
  int most = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int need = fused_smem_floats(bm, bm, lanes(dims[l + 1]));
    if (need > most) most = need;
  }
  return most * (int)sizeof(float);
}

// Blocks of the persistent grid: at most the blocks that can be resident at
// once on the current device, and no more than the stripes.
cudaError_t network_grid(int nbm, int smem, int* grid) {
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
  *grid = nbm < per_sm * sms ? nbm : per_sm * sms;
  return cudaSuccess;
}

}  // namespace

extern "C" int gcn_network_max_layers() { return kMaxLayers; }

extern "C" int gcn_network_supported(const int* dims, int n_layers, int bm,
                                     int bk) {
  return network_supported(dims, n_layers, bm, bk) ? 1 : 0;
}

extern "C" int gcn_network_smem_bytes(const int* dims, int n_layers, int bm) {
  return network_smem_bytes(dims, n_layers, bm);
}

// Launch on `stream`; allocates nothing, does not synchronise, returns a CUDA
// error code (0 on success).  `dims` [n_layers + 1] are the unpadded layer
// widths; `ws`/`wrs` [n_layers] point at each W_l [dims[l], lanes(dims[l+1])]
// and w_r,l [dims[l], 1]; `acts` [n_layers - 1] at each [nbm * bm, dims[l+1]]
// activation buffer; `barrier` at two zeroed words.  The grid it chose is
// written to `*grid_out`.
extern "C" int gcn_network_launch(const int* cols, const float* vals,
                                  const float* h0, const void* const* ws,
                                  const void* const* wrs, void* const* acts,
                                  const int* dims, float* out,
                                  float* tele_acts, float* tele_preds,
                                  unsigned int* barrier, int n_layers,
                                  int nbm, int width, int bm, int bk,
                                  int with_check, int inj_layer,
                                  int inj_stripe, int inj_slot,
                                  float inj_delta, void* stream,
                                  int* grid_out) {
  if (!network_supported(dims, n_layers, bm, bk))
    return (int)cudaErrorInvalidValue;
  NetArgs net{};
  for (int l = 0; l < n_layers; ++l) {
    NetLayer& ly = net.layer[l];
    ly.w = static_cast<const float*>(ws[l]);
    ly.wr = static_cast<const float*>(wrs[l]);
    ly.act = l + 1 < n_layers ? static_cast<float*>(acts[l]) : nullptr;
    ly.f = dims[l];
    ly.g = dims[l + 1];
    ly.gp = lanes(dims[l + 1]);
  }
  const int smem = network_smem_bytes(dims, n_layers, bm);
  int grid = 0;
  cudaError_t err = network_grid(nbm, smem, &grid);
  if (err != cudaSuccess) return (int)err;
  *grid_out = grid;
  void* args[] = {&cols,     &vals,      &h0,         &net,
                  &out,      &tele_acts, &tele_preds, &barrier,
                  &n_layers, &nbm,       &width,      &bm,
                  &with_check, &inj_layer, &inj_stripe, &inj_slot,
                  &inj_delta};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(gcn_network_kernel), dim3(grid),
      dim3(kThreads), args, (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
