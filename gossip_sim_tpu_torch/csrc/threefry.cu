// threefry — threefry-2x32 draws, bit for bit as jax.random.
//
// Replaces the reference engine's key derivation and uniforms that are not
// drawn inside a kernel (gossip_sim_tpu/engine/core.py:328-339 in
// init_state, :507-509 fold_in and split and :522 the draw of the fail
// round), which jax.random lowers to elementwise u32 arithmetic; verb 5's
// draws (:952-958) are made inside rotate.cu.  The block and the word maps
// are in threefry.cuh, shared with rotate.cu.  The plain PyTorch version is
// kernels/threefry.py threefry_plain; the layouts are described there.
//
// Input:  keys [b0, b1, 2] i64 holding u32 words, at element strides
//         (s0, s1, sw), so a key slice such as subs[:, 2:2+T] is read in
//         place; for fold_in, a per-key counter (data, strides ds0, ds1;
//         null = the scalar counter).
// Output: mode 0 fold_in [B, 2] i64, 1 split [B, count, 2] i64,
//         2 bits [B, count] i64, 3 uniform [B, count] f32.
//
// One thread per threefry block (counter pair) and key: blockIdx.z and .y
// walk the two key axes, blockIdx.x and threadIdx.x the pairs of one key
// (fold_in, one pair per key: a thread per key).  Everything is u32 in registers,
// rotations are one funnel shift, and the only memory traffic is the
// (broadcast) key load and the output store.
// Bound on the H100: integer issue, not memory.  A block is 20 rounds of
// add, rotate, xor plus 5 key injections, about 80 32-bit instructions per
// pair against 4 or 8 bytes stored (PERF.md recounts them from the SASS).

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxGridYZ = 65535;

__device__ __forceinline__ uint32_t ld_word(const int64_t* p) {
  return (uint32_t)__ldg(reinterpret_cast<const long long*>(p));
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(const int64_t* __restrict__ keys, int b0, int b1,
                long long s0, long long s1, long long sw, int part,
                uint32_t count, uint32_t pairs,
                const int64_t* __restrict__ data, long long ds0,
                long long ds1, uint32_t scalar, void* __restrict__ out) {
  if constexpr (kMode == 0) {  // fold_in, one thread per key: (0, data)
    const long long b = blockIdx.x * (long long)kThreads + threadIdx.x;
    if (b >= (long long)b0 * b1) return;
    const int i0 = (int)(b / b1);
    const int i1 = (int)(b - (long long)i0 * b1);
    const int64_t* kp = keys + i0 * s0 + i1 * s1;
    uint32_t x0, x1;
    tf_fold_in(ld_word(kp), ld_word(kp + sw),
               data ? ld_word(data + i0 * ds0 + i1 * ds1) : scalar, x0, x1);
    reinterpret_cast<longlong2*>(out)[b] =
        make_longlong2((long long)x0, (long long)x1);
    return;
  }
  const uint32_t j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= pairs) return;
  for (int i0 = blockIdx.z; i0 < b0; i0 += gridDim.z)
  for (int i1 = blockIdx.y; i1 < b1; i1 += gridDim.y) {
    const long long b = (long long)i0 * b1 + i1;
    const int64_t* kp = keys + i0 * s0 + i1 * s1;
    const uint32_t k0 = ld_word(kp);
    const uint32_t k1 = ld_word(kp + sw);
    if constexpr (kMode == 1) {  // split
      int64_t* o = reinterpret_cast<int64_t*>(out) + b * 2 * count;
      if (part) {
        uint32_t x0 = 0, x1 = j;
        threefry2x32(k0, k1, x0, x1);
        reinterpret_cast<longlong2*>(o)[j] =
            make_longlong2((long long)x0, (long long)x1);
      } else {  // words j and count + j of the concatenated halves
        uint32_t x0 = j, x1 = j + count;
        threefry2x32(k0, k1, x0, x1);
        o[j] = x0;
        o[count + j] = x1;
      }
    } else {  // bits (2) or uniform (3): count words per key
      uint32_t x0, x1;
      if (part) {
        x0 = 0;
        x1 = j;
      } else {  // the odd tail's second counter is the zero pad
        x0 = j;
        x1 = ((count & 1u) && j == pairs - 1) ? 0u : j + pairs;
      }
      threefry2x32(k0, k1, x0, x1);
      const long long base = b * (long long)count;
      if constexpr (kMode == 2) {
        int64_t* o = reinterpret_cast<int64_t*>(out) + base;
        if (part) {
          o[j] = x0 ^ x1;
        } else {
          o[j] = x0;
          if (pairs + j < count) o[pairs + j] = x1;
        }
      } else {
        float* o = reinterpret_cast<float*>(out) + base;
        if (part) {
          o[j] = to_uniform(x0 ^ x1);
        } else {
          o[j] = to_uniform(x0);
          if (pairs + j < count) o[pairs + j] = to_uniform(x1);
        }
      }
    }
  }
}

}  // namespace

// mode 0 fold_in, 1 split, 2 bits, 3 uniform (kernels/threefry.py OPS).
extern "C" int threefry_launch(const int64_t* keys, int b0, int b1,
                               long long s0, long long s1, long long sw,
                               int mode, int part, long long count,
                               const int64_t* data, long long ds0,
                               long long ds1, long long scalar, void* out,
                               cudaStream_t stream) {
  if (b0 < 1 || b1 < 1 || mode < 0 || mode > 3 || count < 1 ||
      count > 0xFFFFFFFFLL || (mode == 0 && count != 1))
    return (int)cudaErrorInvalidValue;
  const long long nkeys = (long long)b0 * b1;
  const long long pairs = (mode == 1 || part) ? count : (count + 1) / 2;
  // fold_in: a thread per key; else a thread per pair, blockIdx.z and .y
  // per key
  const dim3 grid =
      mode == 0 ? dim3((unsigned)((nkeys + kThreads - 1) / kThreads))
                : dim3((unsigned)((pairs + kThreads - 1) / kThreads),
                       (unsigned)(b1 < (int)kMaxGridYZ ? b1 : kMaxGridYZ),
                       (unsigned)(b0 < (int)kMaxGridYZ ? b0 : kMaxGridYZ));
  const uint32_t c = (uint32_t)count, p = (uint32_t)pairs,
                 sc = (uint32_t)scalar;
  switch (mode) {
    case 0:
      threefry_kernel<0><<<grid, kThreads, 0, stream>>>(
          keys, b0, b1, s0, s1, sw, part, c, p, data, ds0, ds1, sc, out);
      break;
    case 1:
      threefry_kernel<1><<<grid, kThreads, 0, stream>>>(
          keys, b0, b1, s0, s1, sw, part, c, p, data, ds0, ds1, sc, out);
      break;
    case 2:
      threefry_kernel<2><<<grid, kThreads, 0, stream>>>(
          keys, b0, b1, s0, s1, sw, part, c, p, data, ds0, ds1, sc, out);
      break;
    default:
      threefry_kernel<3><<<grid, kThreads, 0, stream>>>(
          keys, b0, b1, s0, s1, sw, part, c, p, data, ds0, ds1, sc, out);
  }
  return (int)cudaGetLastError();
}
