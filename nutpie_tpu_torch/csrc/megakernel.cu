// NUTS chunk kernel for Hopper (sm_90a): a whole chunk of draws per launch.
//
// Replaces nutpie_tpu/sampler/megakernel.py:make_megakernel_chunk_runner
// (the Pallas machine-step megakernel, pl.pallas_call at :368).  One launch
// runs start_draw and then machine_step until the chain has produced
// `limit` draws, for every chain at once; the radon log density and its
// gradient are evaluated in place (radon.cuh), the three per-leapfrog
// uniforms come from the in-kernel Threefry (threefry.cuh), and while tuning
// each finished draw also runs the diagonal adaptation (adapt.cuh).
// Pooling, the trapped-chain rescue and the per-draw momentum randoms stay
// in torch at chunk boundaries, as they stayed in XLA around pallas_call.
//
// Design: one thread block per chain, kThreads (128) threads; each thread
// owns coordinates i, i + 128, ... of every [dim] row.  The chain's whole
// state -- (14 + 2 x 10 + 9) x 173 values plus five scratch rows, 66 KB in
// float64 and 33 KB in float32 at radon's 173 dimensions -- is loaded into
// dynamic shared memory once, stays there for the whole chunk and is written
// back once (opting in above 48 KB with cudaFuncSetAttribute).  Scalar
// bookkeeping runs in thread 0 between barriers; dot products and the
// stagnation/finiteness tests are block reductions.  A chain whose block has
// finished exits; a finished chain's steps would change nothing (every
// write is gated on active/draw_done), so a per-chain exit gives the same
// state as the TPU kernel's per-tile exit.
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
// What the design does about it: the state stays in shared memory, so the
// bytes stay at that floor, and the arithmetic runs on the plain FMA pipes.
// This first version is far from the operations bound: each leapfrog is a
// chain of ~15 block barriers, the radon residuals walk each county's
// segment in one thread, and one chain per block leaves most lanes idle on
// the scalar phases.  Several chains per block (or one warp per chain) and
// an observation-parallel residual pass are the next steps.
#include <cuda_runtime.h>

#include "machine_step.cuh"

namespace nutpie {

template <typename T>
__global__ void __launch_bounds__(kThreads) megakernel_chunk(MkArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  megakernel_chunk_body<T>(a, smem);
}

template <typename T>
int launch_chunk(const MkConfig* cfg, void* scal, void* key, void* vecs,
                 void* ckpt_p, void* ckpt_s, void* flts, void* ints,
                 void* adapt_vecs, void* adapt_flts, void* mom, void* jit,
                 void* pos_out, void* scal_out, void* y, void* floor,
                 void* basis, void* offsets, void* stream) {
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
  a.y = static_cast<const T*>(y);
  a.floor = static_cast<const T*>(floor);
  a.basis = static_cast<const T*>(basis);
  a.offsets = static_cast<const int32_t*>(offsets);
  const size_t smem = block_smem_bytes<T>(cfg->dim, cfg->depth_slots,
                                          cfg->n_counties);
  cudaError_t err = cudaFuncSetAttribute(
      megakernel_chunk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  megakernel_chunk<T><<<cfg->n_chains, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

}  // namespace nutpie

extern "C" {

// Launch one chunk; returns the CUDA error code of the launch (0 = queued).
int nutpie_megakernel_chunk_f32(const nutpie::MkConfig* cfg, void* scal,
                                void* key, void* vecs, void* ckpt_p,
                                void* ckpt_s, void* flts, void* ints,
                                void* adapt_vecs, void* adapt_flts, void* mom,
                                void* jit, void* pos_out, void* scal_out,
                                void* y, void* floor, void* basis,
                                void* offsets, void* stream) {
  return nutpie::launch_chunk<float>(cfg, scal, key, vecs, ckpt_p, ckpt_s,
                                     flts, ints, adapt_vecs, adapt_flts, mom,
                                     jit, pos_out, scal_out, y, floor, basis,
                                     offsets, stream);
}

int nutpie_megakernel_chunk_f64(const nutpie::MkConfig* cfg, void* scal,
                                void* key, void* vecs, void* ckpt_p,
                                void* ckpt_s, void* flts, void* ints,
                                void* adapt_vecs, void* adapt_flts, void* mom,
                                void* jit, void* pos_out, void* scal_out,
                                void* y, void* floor, void* basis,
                                void* offsets, void* stream) {
  return nutpie::launch_chunk<double>(cfg, scal, key, vecs, ckpt_p, ckpt_s,
                                      flts, ints, adapt_vecs, adapt_flts, mom,
                                      jit, pos_out, scal_out, y, floor, basis,
                                      offsets, stream);
}

const char* nutpie_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
