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
