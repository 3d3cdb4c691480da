// faults.cuh — the stateless counter hashes of faults.py, on the device.
//
// Every impairment and pull decision is a hash of (seed, iteration, node
// ids), computed bit for bit as faults.py computes it (fmix32, edge_u32,
// node_u32; all arithmetic mod 2^32).  The round's per-(seed, iteration,
// salt) basis comes from the host (faults.py round_basis).
#pragma once

#include <stdint.h>

// murmur3's 32-bit finalizer
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// faults.py edge_u32: fmix32(basis ^ src * C1 ^ dst * C2)
__device__ __forceinline__ uint32_t edge_u32(uint32_t basis, uint32_t src,
                                             uint32_t dst) {
  return fmix32(basis ^ (src * 0x85EBCA6Bu) ^ (dst * 0xC2B2AE35u));
}

// faults.py node_u32: fmix32(basis ^ node * C1)
__device__ __forceinline__ uint32_t node_u32(uint32_t basis, uint32_t node) {
  return fmix32(basis ^ (node * 0x85EBCA6Bu));
}
