// rotate — verb 5: rotate one stake-weighted new peer into each active set.
//
// Replaces the reference engine's `round/verb5_rotate` block
// (gossip_sim_tpu/engine/core.py:950-1011) with its sampler `_sample_fast`
// (core.py:274-305).  The plain PyTorch version is kernels/rotate.py
// rotate_plain (and sample_members_plain for the sampler).
//
// Input:  active [O, N, S] i32, pruned (this round's bits after verb 4) and
//         tfail [O, N, S] u8, failed [O, N] u8, rot_u [O, N] f32, u_all
//         [O, T, N, 2] f32 as the threefry kernel writes it (class and
//         member uniform of each try), origins [O], buckets [N], perm [N]
//         i32, class_start and class_count [25] i32, class_cdf [25, 25] f32.
// Output: new_active, new_pruned, new_tfail [O, N, S]; rot_failed [O] i32,
//         the rows that wanted to rotate and found no new peer in T tries.
//
// Per row: rotate iff rot_u < p (one f32 compare).  Try t draws a class as
// #{j < 24 : u_class >= class_cdf[min(b_n, b_o)][j]} and a member
// start + floor(u_member * count) (one f32 multiply, written __fmul_rn so
// it is never contracted, then floor, then the cast), capped at the class's
// last member; the candidate perm[member] is taken if it is neither the
// node nor in the row's active set.  A row that rotates shifts the new peer
// in at the end when it is full (its oldest slot goes) and appends it after
// the last member otherwise; the new slot's tfail bit is the peer's failed
// bit.  Every float operation is the one the reference does, so the result
// is exact.
//
// One thread per (origin, node) row, the block's rows staged through shared
// memory (row_stage.cuh) and updated there in place; the class tables sit
// in shared memory, perm is read through the read-only path.  Only the
// rows that rotate (a share p of them) read their uniforms, perm, buckets
// and failed, and they stop at the first new peer.  rot_failed is an
// integer sum: the launcher zeroes it (a memset on the stream) and rows add
// to it atomically, exact in any order.  Bound on the H100: memory, the
// three [O, N, S] planes read and written once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_stage.cuh"

namespace {

constexpr int kNB = 25;   // stake buckets: NUM_PUSH_ACTIVE_SET_ENTRIES
constexpr int kDefaultSmem = 48 * 1024;

__global__ void rotate_kernel(
    const int32_t* __restrict__ active, const uint8_t* __restrict__ pruned,
    const uint8_t* __restrict__ tfail, const uint8_t* __restrict__ failed,
    const float* __restrict__ rot_u, const float2* __restrict__ u_all,
    const int32_t* __restrict__ origins, const int32_t* __restrict__ buckets,
    const int32_t* __restrict__ perm, const int32_t* __restrict__ class_start,
    const int32_t* __restrict__ class_count,
    const float* __restrict__ class_cdf, int32_t* __restrict__ new_active,
    uint8_t* __restrict__ new_pruned, uint8_t* __restrict__ new_tfail,
    int32_t* __restrict__ rot_failed, long long rows, int n, int s,
    int tries, float prob) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float s_cdf[kNB * kNB];
  __shared__ int s_start[kNB], s_count[kNB];
  const int rpb = blockDim.x;
  const long long r0 = (long long)blockIdx.x * rpb;
  const int nr = (int)min((long long)rpb, rows - r0);
  int32_t* s_act = reinterpret_cast<int32_t*>(smem);
  uint8_t* s_prn = reinterpret_cast<uint8_t*>(s_act + rpb * s);
  uint8_t* s_tf = s_prn + rpb * s;
  for (int j = threadIdx.x; j < kNB * kNB; j += rpb) s_cdf[j] = class_cdf[j];
  for (int j = threadIdx.x; j < kNB; j += rpb) {
    s_start[j] = class_start[j];
    s_count[j] = class_count[j];
  }
  stage_in(reinterpret_cast<uint8_t*>(s_act),
           reinterpret_cast<const uint8_t*>(active + r0 * s), nr * s * 4);
  stage_in(s_prn, pruned + r0 * s, nr * s);
  stage_in(s_tf, tfail + r0 * s, nr * s);
  __syncthreads();

  const int i = threadIdx.x;
  if (i < nr) {
    const long long row = r0 + i;
    if (__ldg(rot_u + row) < prob) {
      const int o = (int)(row / n);
      const int node = (int)(row - (long long)o * n);
      int32_t* a = s_act + i * s;
      uint8_t* pr = s_prn + i * s;
      uint8_t* tf = s_tf + i * s;
      const int k = min(__ldg(buckets + node), __ldg(buckets + __ldg(origins + o)));
      const float* cdf = s_cdf + k * kNB;
      int chosen = n;
      bool found = false;
      for (int t = 0; t < tries && !found; ++t) {
        const float2 u = __ldg(u_all + ((long long)o * tries + t) * n + node);
        int cls = 0;
#pragma unroll
        for (int j = 0; j < kNB - 1; ++j) cls += u.x >= cdf[j];
        const int start = s_start[cls], count = s_count[cls];
        int member =
            start + (int)floorf(__fmul_rn(u.y, (float)count));
        member = min(member, start + max(count - 1, 0));
        const int cand = __ldg(perm + min(member, n - 1));
        bool fresh = cand != node;
        for (int j = 0; j < s; ++j) fresh &= a[j] != cand;
        if (fresh) {
          chosen = cand;
          found = true;
        }
      }
      if (!found) {
        atomicAdd(rot_failed + o, 1);
      } else {
        const uint8_t cf = __ldg(failed + (long long)o * n + min(chosen, n - 1));
        int members = 0;
        for (int j = 0; j < s; ++j) members += a[j] < n;
        if (members >= s) {           // full: the oldest slot goes
          for (int j = 0; j + 1 < s; ++j) {
            a[j] = a[j + 1];
            pr[j] = pr[j + 1];
            tf[j] = tf[j + 1];
          }
          a[s - 1] = chosen;
          pr[s - 1] = 0;
          tf[s - 1] = cf;
        } else {                      // append after the last member
          a[members] = chosen;
          tf[members] = cf;
        }
      }
    }
  }
  __syncthreads();
  stage_out(reinterpret_cast<uint8_t*>(new_active + r0 * s),
            reinterpret_cast<const uint8_t*>(s_act), nr * s * 4);
  stage_out(new_pruned + r0 * s, s_prn, nr * s);
  stage_out(new_tfail + r0 * s, s_tf, nr * s);
}

}  // namespace

// rows = O * N, o = O; rows_per_block and smem (the staged rows; the class
// tables are static shared memory) come from kernels/rotate.py
// launch_geometry.
extern "C" int rotate_launch(
    const int32_t* active, const uint8_t* pruned, const uint8_t* tfail,
    const uint8_t* failed, const float* rot_u, const float* u_all,
    const int32_t* origins, const int32_t* buckets, const int32_t* perm,
    const int32_t* class_start, const int32_t* class_count,
    const float* class_cdf, int32_t* new_active, uint8_t* new_pruned,
    uint8_t* new_tfail, int32_t* rot_failed, int o, long long rows, int n,
    int s, int tries, float prob, int rows_per_block, int smem,
    cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(rot_failed, 0, sizeof(int32_t) * o,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(rotate_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  rotate_kernel<<<(unsigned)blocks, rows_per_block, smem, stream>>>(
      active, pruned, tfail, failed, rot_u,
      reinterpret_cast<const float2*>(u_all), origins, buckets, perm,
      class_start, class_count, class_cdf, new_active, new_pruned, new_tfail,
      rot_failed, rows, n, s, tries, prob);
  return (int)cudaGetLastError();
}
