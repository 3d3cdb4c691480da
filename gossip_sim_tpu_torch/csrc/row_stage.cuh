// row_stage.cuh — move a block's rows between device memory and shared
// memory, for the kernels that give one thread to each (origin, node) row.
//
// Neighbouring rows of an [O, N, S] plane lie S elements apart (48 bytes
// for S = 12 int32 slots), so a thread reading its own row from device
// memory would touch a new 32-byte sector on almost every load.  A block's
// rows are one contiguous span instead: the block copies it with 16-byte
// vectors, neighbouring threads on neighbouring addresses, and each thread
// then works on its row in shared memory.  Where either side is not
// 16-byte aligned (a tail block, or a row count that leaves an odd
// offset), the copy goes byte by byte; the result is the same.

#pragma once

#include <stdint.h>

__device__ __forceinline__ void stage_in(uint8_t* dst,
                                         const uint8_t* __restrict__ src,
                                         int nbytes) {
  int nvec = 0;
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    nvec = nbytes >> 4;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) d4[i] = __ldg(s4 + i);
  }
  for (int i = (nvec << 4) + threadIdx.x; i < nbytes; i += blockDim.x)
    dst[i] = src[i];
}

__device__ __forceinline__ void stage_out(uint8_t* __restrict__ dst,
                                          const uint8_t* src, int nbytes) {
  int nvec = 0;
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    nvec = nbytes >> 4;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) d4[i] = s4[i];
  }
  for (int i = (nvec << 4) + threadIdx.x; i < nbytes; i += blockDim.x)
    dst[i] = src[i];
}

// Asynchronous staging, for a kernel that loads its next rows while it
// works on the current ones (cp.async, sm_80 and later).  The 16-byte part
// of an aligned span is copied by cp.async.cg, neighbouring threads on
// neighbouring addresses, and lands in shared memory without passing
// through registers; an unaligned span, and the bytes past its last 16,
// are copied byte by byte at once, as stage_in does.  The copies a thread
// issued before stage_commit() form one group; stage_wait<k>() waits until
// at most k of the thread's groups are still in flight, and a
// __syncthreads() after it makes every thread's copies visible to all.
__device__ __forceinline__ void stage_in_async(uint8_t* dst,
                                               const uint8_t* __restrict__ src,
                                               int nbytes) {
  int nvec = 0;
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    nvec = nbytes >> 4;
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + 16 * i);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(d), "l"(src + 16 * i) : "memory");
    }
  }
  for (int i = (nvec << 4) + threadIdx.x; i < nbytes; i += blockDim.x)
    dst[i] = src[i];
}

__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kInFlight>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kInFlight) : "memory");
}
