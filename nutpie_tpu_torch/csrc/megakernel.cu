// NUTS chunk kernel for Hopper (sm_90a): a whole chunk of draws per launch.
//
// Replaces nutpie_tpu/sampler/megakernel.py:make_megakernel_chunk_runner
// (the Pallas machine-step megakernel, pl.pallas_call at :368).  One launch
// runs start_draw and then machine_step until each chain has produced
// `limit` draws; the radon log density and its gradient are evaluated in
// place (radon.cuh), the three per-leapfrog uniforms come from the
// in-kernel Threefry (threefry.cuh), and while tuning each finished draw
// also runs the diagonal adaptation (adapt.cuh).  Pooling, the
// trapped-chain rescue and the per-draw momentum randoms stay in torch at
// chunk boundaries, as they stayed in XLA around pallas_call.
//
// What bounds it on this card: operations.  One leapfrog costs one radon
// gradient (6.99e4 operations, radon.cuh) and 12 operations per coordinate
// (the two leapfrog halves, the kinetic energy, two momentum sums); each
// checkpoint slot a subtree U-turn check reads costs 6 per coordinate
// (about 0.73 slots per leapfrog on a posterior chunk), each merged
// subtree 17 and each draw's momentum 5: 7.34e4 operations per leapfrog
// in all, in float32 outside the tensor cores (67 TFLOP/s on an H100 SXM).
// The bytes a chunk must move are the state in and out once (~50 KB per
// chain in float32), the momentum randoms in and the draws out (2 x L x
// 173 values per chain): at the main path's shapes (2048 chains, L = 128,
// ~15 leapfrogs per draw after warmup) that is 3.93e6 leapfrogs, 2.88e11
// operations (4.31 ms) against 0.50 GB (0.15 ms at 3.35 TB/s).
// chip_smoke.py counts both from each run's trees (chunk_ops).
//
// A chain's leapfrog is a long chain of dependent steps (gradient, energy,
// tree decisions), so the card is filled with many chains at once and each
// chain's work is spread over just enough lanes to keep its own path short.
// The design:
//  - one warp per chain, lane l owning coordinates l, l + 32, ...; the
//    scalar bookkeeping is lane-uniform and reductions are butterflies, so
//    a leapfrog has no block barrier and only the __syncwarp calls of the
//    radon exchanges (machine_step.cuh);
//  - persistent blocks of up to MaxWarps chains: the grid is the SM count
//    times the resident blocks per SM, and each warp takes its next chain
//    from a global counter (`queue`, zeroed by the wrapper per launch), so
//    no SM idles through a last partial round.  A chain's result does not
//    depend on the warp that ran it;
//  - the radon data in shared memory once per block, read by every chain
//    of the block; the observations split into 32 lane runs (radon.cuh);
//  - the leapfrog's new point in registers (NPL coordinates per lane, a
//    template parameter taken from dim at launch); the chain's state rows,
//    inverse mass and radon scratch in the warp's slice of shared memory;
//    the checkpoint stack (read only by the U-turn checks) and the nine
//    adaptation rows (touched once per tuning draw) in the chain's global
//    rows, which stay in L2.  Keeping the state rows in registers too
//    took 168 registers a thread with spills and 10 chains per SM.
// The block's only __syncthreads follows its load of the model data.
//
// At radon's sizes a float32 block holds 16 chains in 128 registers a
// thread and 222,320 bytes of shared memory (40,304 of model data, 11,376
// per chain), one block per SM; float64 holds 6.  chip_smoke.py's build
// phase prints this geometry (nutpie_megakernel_geometry_*).
//
// What is left: the two basis products of the radon gradient are 78% of
// a leapfrog's operations and run as scalar multiply-adds fed from shared
// memory, one chain at a time; the residual pass's critical path is a
// lane's ~29 observations; the scalar phases run their transcendental
// chains once per leapfrog in every lane.  The chains of a block do not
// step together, so the basis products do not yet batch onto the tensor
// cores.
#include <cuda_runtime.h>

#include "machine_step.cuh"

namespace nutpie {

template <typename T, int NPL, bool ADAM>
__global__ void __launch_bounds__(MaxWarps<T>::value * kLanes, 1)
    megakernel_chunk(MkArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  megakernel_chunk_body<T, NPL, ADAM>(a, smem);
}

// The kernel compiled for the smallest coordinates-per-lane count (NPL in
// 2, 4, 6, 8) that covers dim, or null above 256 coordinates.
template <typename T, bool ADAM>
const void* pick_npl(int dim, int* npl) {
  if (dim <= 2 * kLanes) { *npl = 2; return reinterpret_cast<const void*>(megakernel_chunk<T, 2, ADAM>); }
  if (dim <= 4 * kLanes) { *npl = 4; return reinterpret_cast<const void*>(megakernel_chunk<T, 4, ADAM>); }
  if (dim <= 6 * kLanes) { *npl = 6; return reinterpret_cast<const void*>(megakernel_chunk<T, 6, ADAM>); }
  if (dim <= 8 * kLanes) { *npl = 8; return reinterpret_cast<const void*>(megakernel_chunk<T, 8, ADAM>); }
  *npl = 0;
  return nullptr;
}

// ... and for the step-size method: Adam has instantiations of its own
// (adapt.cuh: step_size_update).
template <typename T>
const void* pick_kernel(const MkConfig& cfg, int* npl) {
  return cfg.step_method == STEP_ADAM ? pick_npl<T, true>(cfg.dim, npl)
                                      : pick_npl<T, false>(cfg.dim, npl);
}

struct LaunchPlan {
  const void* fn;
  int npl;
  int warps;      // chains per block
  size_t smem;    // dynamic shared memory per block
  size_t data_bytes, warp_bytes;
};

// Chains per block: MaxWarps<T>, or fewer where the shared memory of the
// card cannot hold that many slices beside the model data.
template <typename T>
int plan_launch(const MkConfig& cfg, LaunchPlan* p) {
  p->fn = pick_kernel<T>(cfg, &p->npl);
  if (p->fn == nullptr || cfg.dim != 2 * cfg.n_counties + 3) {
    return int(cudaErrorInvalidValue);
  }
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return int(err);
  const SmemPlan<T> sp(cfg);
  p->data_bytes = sp.data_bytes;
  p->warp_bytes = sp.warp_bytes;
  const long fit = (long(optin) - long(sp.data_bytes)) / long(sp.warp_bytes);
  p->warps = fit < MaxWarps<T>::value ? int(fit) : MaxWarps<T>::value;
  if (p->warps < 1) return int(cudaErrorInvalidValue);
  p->smem = sp.block_bytes(p->warps);
  return int(cudaFuncSetAttribute(p->fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(p->smem)));
}

// What was compiled and how it fits on the card; out[0..9] = npl, chains
// per block, shared bytes per block, resident blocks per SM, SM count,
// registers per thread, local (spill) bytes per thread, model-data bytes,
// bytes per chain slice, max threads per block.
template <typename T>
int geometry(const MkConfig* cfg, int32_t* out) {
  LaunchPlan p;
  int code = plan_launch<T>(*cfg, &p);
  if (code != 0) return code;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, p.fn);
  if (err != cudaSuccess) return int(err);
  int blocks = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, p.fn, p.warps * kLanes, p.smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  out[0] = p.npl;
  out[1] = p.warps;
  out[2] = int32_t(p.smem);
  out[3] = blocks;
  out[4] = sms;
  out[5] = attr.numRegs;
  out[6] = int32_t(attr.localSizeBytes);
  out[7] = int32_t(p.data_bytes);
  out[8] = int32_t(p.warp_bytes);
  out[9] = attr.maxThreadsPerBlock;
  return 0;
}

template <typename T>
int launch_chunk(const MkConfig* cfg, void* scal, void* key, void* vecs,
                 void* ckpt_p, void* ckpt_s, void* flts, void* ints,
                 void* adapt_vecs, void* adapt_flts, void* mom, void* jit,
                 void* pos_out, void* scal_out, void* obs, void* basis,
                 void* part, void* queue, int grid, void* stream) {
  LaunchPlan p;
  int code = plan_launch<T>(*cfg, &p);
  if (code != 0) return code;
  if (grid < 1) return int(cudaErrorInvalidConfiguration);
  MkArgs<T> a;
  a.cfg = *cfg;
  a.scal = static_cast<const int32_t*>(scal);
  a.key = static_cast<const int64_t*>(key);
  a.vecs = static_cast<T*>(vecs);
  a.ckpt_p = static_cast<T*>(ckpt_p);
  a.ckpt_s = static_cast<T*>(ckpt_s);
  a.flts = static_cast<T*>(flts);
  a.ints = static_cast<int32_t*>(ints);
  a.adapt_vecs = static_cast<T*>(adapt_vecs);
  a.adapt_flts = static_cast<T*>(adapt_flts);
  a.mom = static_cast<const T*>(mom);
  a.jit = static_cast<const T*>(jit);
  a.pos_out = static_cast<T*>(pos_out);
  a.scal_out = static_cast<T*>(scal_out);
  a.obs = static_cast<const T*>(obs);
  a.basis = static_cast<const T*>(basis);
  a.part = static_cast<const int32_t*>(part);
  a.queue = static_cast<int32_t*>(queue);
  void* args[] = {&a};
  cudaError_t err = cudaLaunchKernel(p.fn, dim3(grid), dim3(p.warps * kLanes), args,
                                     p.smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace nutpie

extern "C" {

// Launch one chunk on `grid` persistent blocks; returns the CUDA error code
// of the launch (0 = queued).  `queue` is one int32, zero at the launch.
int nutpie_megakernel_chunk_f32(const nutpie::MkConfig* cfg, void* scal,
                                void* key, void* vecs, void* ckpt_p,
                                void* ckpt_s, void* flts, void* ints,
                                void* adapt_vecs, void* adapt_flts, void* mom,
                                void* jit, void* pos_out, void* scal_out,
                                void* obs, void* basis, void* part,
                                void* queue, int grid, void* stream) {
  return nutpie::launch_chunk<float>(cfg, scal, key, vecs, ckpt_p, ckpt_s,
                                     flts, ints, adapt_vecs, adapt_flts, mom,
                                     jit, pos_out, scal_out, obs, basis, part,
                                     queue, grid, stream);
}

int nutpie_megakernel_chunk_f64(const nutpie::MkConfig* cfg, void* scal,
                                void* key, void* vecs, void* ckpt_p,
                                void* ckpt_s, void* flts, void* ints,
                                void* adapt_vecs, void* adapt_flts, void* mom,
                                void* jit, void* pos_out, void* scal_out,
                                void* obs, void* basis, void* part,
                                void* queue, int grid, void* stream) {
  return nutpie::launch_chunk<double>(cfg, scal, key, vecs, ckpt_p, ckpt_s,
                                      flts, ints, adapt_vecs, adapt_flts, mom,
                                      jit, pos_out, scal_out, obs, basis, part,
                                      queue, grid, stream);
}

// The compiled kernel's geometry for this configuration (see geometry()).
int nutpie_megakernel_geometry_f32(const nutpie::MkConfig* cfg, int32_t* out) {
  return nutpie::geometry<float>(cfg, out);
}

int nutpie_megakernel_geometry_f64(const nutpie::MkConfig* cfg, int32_t* out) {
  return nutpie::geometry<double>(cfg, out);
}

const char* nutpie_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
