// threefry.cuh — the threefry-2x32 block and the words of a jax.random
// draw, for the kernels that hash on the card (threefry.cu, rotate.cu).
//
// The layouts are described in kernels/threefry.py; its word_at and
// split_word are the plain mirrors of tf_word and tf_split_word below, held
// against jax.random on the CPU.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t tf_rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define TF_ROUND(r)    \
  x0 += x1;            \
  x1 = tf_rotl(x1, r) ^ x0;

// One threefry-2x32 block (20 rounds) of the counter pair (x0, x1) under
// key (k0, k1), in place.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

#undef TF_ROUND

// A 32-bit word -> float32 in [0, 1), as jax.random.uniform maps it.
__device__ __forceinline__ float to_uniform(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// jax.random.fold_in: the key of the counter pair (0, data).
__device__ __forceinline__ void tf_fold_in(uint32_t k0, uint32_t k1,
                                           uint32_t data, uint32_t& o0,
                                           uint32_t& o1) {
  o0 = 0;
  o1 = data;
  threefry2x32(k0, k1, o0, o1);
}

// The 32-bit word at flat index f of an n-word draw under key (k0, k1):
// one threefry block.  Partitionable: (0, f) hashed, y0 ^ y1.  Original:
// pair p = f mod h (h = ceil(n / 2)) hashes (p, p + h), the last pair of an
// odd n (p, 0); y0 for the first half, y1 for the second.
__device__ __forceinline__ uint32_t tf_word(uint32_t k0, uint32_t k1,
                                            uint32_t f, uint32_t n,
                                            bool part) {
  uint32_t x0, x1;
  if (part) {
    x0 = 0;
    x1 = f;
    threefry2x32(k0, k1, x0, x1);
    return x0 ^ x1;
  }
  const uint32_t h = n - (n >> 1);
  const bool hi = f >= h;
  const uint32_t p = hi ? f - h : f;
  x0 = p;
  x1 = ((n & 1u) && p == h - 1) ? 0u : p + h;
  threefry2x32(k0, k1, x0, x1);
  return hi ? x1 : x0;
}

// Word w (0 or 1) of key i of jax.random.split(key, m): one threefry block.
// Partitionable: (0, i) hashed, word w of the pair.  Original: flat word
// g = 2i + w of the concatenated halves, where pair j hashes (j, j + m):
// y0 of pair g if g < m, else y1 of pair g - m.
__device__ __forceinline__ uint32_t tf_split_word(uint32_t k0, uint32_t k1,
                                                  uint32_t i, int w,
                                                  uint32_t m, bool part) {
  uint32_t x0, x1;
  if (part) {
    x0 = 0;
    x1 = i;
    threefry2x32(k0, k1, x0, x1);
    return w ? x1 : x0;
  }
  const uint32_t g = 2 * i + (uint32_t)w;
  const bool hi = g >= m;
  x0 = hi ? g - m : g;
  x1 = x0 + m;
  threefry2x32(k0, k1, x0, x1);
  return hi ? x1 : x0;
}

// Key i of jax.random.split(key, m): one threefry block in the
// partitionable layout, two in the original one (a block per word).
__device__ __forceinline__ uint2 tf_split_key(uint32_t k0, uint32_t k1,
                                              uint32_t i, uint32_t m,
                                              bool part) {
  if (part) {
    uint32_t x0 = 0, x1 = i;
    threefry2x32(k0, k1, x0, x1);
    return make_uint2(x0, x1);
  }
  return make_uint2(tf_split_word(k0, k1, i, 0, m, false),
                    tf_split_word(k0, k1, i, 1, m, false));
}
