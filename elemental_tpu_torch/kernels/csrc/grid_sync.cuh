// Grid-wide barriers for a cooperative launch (every CTA resident), shared
// by the port's persistent kernels.  grid_barrier: a waiting CTA polls one
// generation word with an acquire load and backs off with __nanosleep
// between polls, so the CTAs that wait do not flood L2 with polls while
// the others still work (cooperative_groups' grid.sync() spins without
// backing off).  Its two words (arrivals, generation) are zero at launch;
// the wrapper passes them.  grid_count_arrive / grid_count_wait, at the
// end, are a split barrier on one counter.  Data written before a barrier
// is read after it through L2 (ld.cg): L1 is not coherent across SMs.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// bar[0] counts arrivals, bar[1] is the generation.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned n = gridDim.x * gridDim.y * gridDim.z;
    const unsigned gen = ld_acquire_gpu(bar + 1);
    __threadfence();                              // release this CTA's writes
    if (atomicAdd(bar, 1u) == n - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);                     // open the barrier
    } else {
      while (ld_acquire_gpu(bar + 1) == gen) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// Arrive at the barrier without waiting for it (the caller does no work
// that needs the others' writes before its next grid_barrier).  Returns,
// in thread 0, the generation the arrival belongs to; grid_wait_past then
// waits until that barrier has opened, which must happen before the
// caller's next grid_barrier (its count is reset only on opening).
__device__ __forceinline__ unsigned grid_arrive(unsigned* bar) {
  __syncthreads();
  unsigned gen = 0;
  if (threadIdx.x == 0) {
    const unsigned n = gridDim.x * gridDim.y * gridDim.z;
    gen = ld_acquire_gpu(bar + 1);
    __threadfence();
    if (atomicAdd(bar, 1u) == n - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    }
  }
  return gen;
}

__device__ __forceinline__ void grid_wait_past(unsigned* bar, unsigned gen) {
  if (threadIdx.x == 0)
    while (ld_acquire_gpu(bar + 1) == gen) __nanosleep(64);
  __syncthreads();
}

// A counting barrier, split in two.  grid_count_arrive adds this CTA's
// arrival to one word that only grows (zero when the wrapper allocates it,
// never reset); grid_count_wait waits until the word reaches `target`, the
// arrivals of every barrier so far (the caller keeps the count: target +=
// CTAs at each arrival, across launches too).  An arrival is one release
// (fence.acq_rel, then a relaxed reduction: no sequentially consistent
// fence), the wait one acquire load in a spin, and the poll that waits is
// the one that sees the barrier open (no generation word to flip).  Work
// placed between the two overlaps the others' arrivals.
__device__ __forceinline__ void grid_count_arrive(unsigned* ctr) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("fence.acq_rel.gpu;\n\t"
                 "red.relaxed.gpu.global.add.u32 [%0], 1;"
                 :: "l"(ctr) : "memory");
}

__device__ __forceinline__ void grid_count_wait(const unsigned* ctr,
                                                unsigned target) {
  if (threadIdx.x == 0)
    while (ld_acquire_gpu(ctr) < target) {
    }
  __syncthreads();
}

}  // namespace
