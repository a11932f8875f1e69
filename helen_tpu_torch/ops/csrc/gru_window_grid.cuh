// What the grid-wide recurrences share (gru_window_xp_bwd_grid.cu, the
// backward's pass 1; gru_window_xp_grid.cu, the forward): one persistent
// cooperative grid per launch, one block per SM, each block holding its
// hidden units' slice of W_hh in shared memory for all T steps, and one
// barrier per direction and step through a zeroed counter the wrapper passes.
//
// The barrier: each block releases its writes (__threadfence, then an atomic
// arrival on its direction's counter) and waits with acquire loads until all
// C blocks of the direction have arrived s + 1 times. A wait past
// GRID_SPIN_NS traps, so a fault fails the launch instead of hanging the
// card. Rows that other blocks wrote in the same launch are read through L2
// only (cp.async.cg, __ldcg): L1 is not coherent within a launch.

#pragma once

#include "gru_window_smem.cuh"

namespace {

constexpr long long GRID_SPIN_NS = 10000000000LL;  // a barrier wait past 10 s traps
constexpr int GRID_CTR_STRIDE = 32;  // the directions' counters 128 bytes apart

// 16 bytes of any type from device memory (through L2 only) to shared memory
__device__ __forceinline__ void cp_async16_cg(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Every block of the direction has done its part of the step: the block's
// threads meet, thread 0 releases the block's writes, arrives and waits for
// `target` arrivals in all, and the block's threads meet again.
__device__ __forceinline__ void grid_barrier(unsigned* ctr, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctr, 1u);
    const long long t0 = globaltimer();
    while (ld_acquire(ctr) < target) {
      if (globaltimer() - t0 > GRID_SPIN_NS) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// the current device's streaming multiprocessors
inline int device_sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// A cooperative launch of `blocks` blocks of `threads`, all co-resident: a
// grid the card cannot hold at once is refused
// (cudaErrorCooperativeLaunchTooLarge) before anything runs.
template <typename Kernel>
int launch_cooperative(Kernel kernel, int blocks, int threads, size_t smem, void** args,
                       void* stream) {
  if (int e = allow_smem(kernel, smem)) return e;
  int per_sm = 0;
  if (cudaError_t e =
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) {
    return (int)e;
  }
  if ((long long)per_sm * device_sm_count() < blocks) {
    return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  if (cudaError_t e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                                  dim3(threads), args, smem,
                                                  (cudaStream_t)stream)) {
    return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace
