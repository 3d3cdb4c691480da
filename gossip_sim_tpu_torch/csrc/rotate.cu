// rotate — verb 5: rotate one stake-weighted new peer into each active set.
//
// Replaces the reference engine's `round/verb5_rotate` block
// (gossip_sim_tpu/engine/core.py:950-1011) with its sampler `_sample_fast`
// (core.py:274-305) and the block's draws: the round key fold_in(key, it)
// and its split into T + 2 sub keys (core.py:507-509), the rotation
// uniforms and the tries' uniforms (core.py:952-958).  The plain PyTorch
// version is kernels/rotate.py rotate_plain (and sample_members_plain for
// the sampler).
//
// Input:  active [O, N, S] i32, pruned (this round's bits after verb 4) and
//         tfail [O, N, S] u8, failed [O, N] u8, key [O, 2] i64 (each
//         origin's threefry key, u32 words), per lane (lanes.cuh: origin
//         row o is lane o / opl) the iteration `it` (mod 2^32) and the
//         rotation probability, the layout flag, origins [O], buckets [N],
//         perm [N] i32,
//         class_start and class_count [25] i32, class_cdf [25, 25] f32.
// Output: new_active, new_pruned, new_tfail [O, N, S]; rot_failed [O] i32,
//         the rows that wanted to rotate and found no new peer in T tries;
//         the flight recorder's rot [O, N] i32 where set (core.py:1371):
//         the rotated-in peer, or -1 where the row did not rotate.  The
//         kernel is instantiated for the trace, so without it (rot null)
//         the trace-free instantiation runs.
//
// Draws (csrc/threefry.cuh, bit for bit as jax.random): the round key is
// kr = fold_in(key[o], it); sub key 1 of split(kr, T + 2) draws the
// rotation uniforms (word `node` of an N-word draw) and sub key 2 + t the
// class and member uniform of try t (words 2 node and 2 node + 1 of a
// 2N-word draw).  A block derives kr once for each origin its rows span,
// then that origin's sub keys 1 .. T + 1 a thread per key, into T + 2
// slots of shared memory per origin (kr in slot 0, sub key q in slot q; a
// barrier between the two); every row hashes its own rotation uniform, and
// only a row that rotates hashes its tries, up to the first that finds a
// new peer.  Sub key 0 draws the fail round's uniforms, which the engine
// draws with the threefry kernel.
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
// memory (row_stage.cuh) and updated there in place; the class tables and
// the sub keys sit in shared memory, perm is read through the read-only
// path.  rot_failed is an integer sum: the launcher zeroes it (a memset on
// the stream) and rows add to it atomically, exact in any order.  Bound on
// the H100: memory, the three [O, N, S] planes read and written once; the
// hashes (one threefry block per rotation uniform, two per try taken, and
// the keys) are the integer work beside it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"
#include "row_stage.cuh"
#include "threefry.cuh"

namespace {

constexpr int kNB = 25;   // stake buckets: NUM_PUSH_ACTIVE_SET_ENTRIES
constexpr int kDefaultSmem = 48 * 1024;

// one lane's knobs (kernels/rotate.py LANE_DTYPE)
struct RotateLane {
  float prob;   // rotation probability (f32)
  uint32_t it;  // the iteration the round key folds in
};
using RotateLanes = LaneArray<RotateLane>;

template <bool kTrace>
__global__ void rotate_kernel(
    const int32_t* __restrict__ active, const uint8_t* __restrict__ pruned,
    const uint8_t* __restrict__ tfail, const uint8_t* __restrict__ failed,
    const int64_t* __restrict__ key, const int32_t* __restrict__ origins,
    const int32_t* __restrict__ buckets, const int32_t* __restrict__ perm,
    const int32_t* __restrict__ class_start,
    const int32_t* __restrict__ class_count,
    const float* __restrict__ class_cdf, int32_t* __restrict__ new_active,
    uint8_t* __restrict__ new_pruned, uint8_t* __restrict__ new_tfail,
    int32_t* __restrict__ rot_failed, int32_t* __restrict__ rot,
    long long rows, int n, int s,
    int tries, const __grid_constant__ RotateLanes lanes, int opl, int part,
    int key_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float s_cdf[kNB * kNB];
  __shared__ int s_start[kNB], s_count[kNB];
  const int rpb = blockDim.x;
  const long long r0 = (long long)blockIdx.x * rpb;
  const int nr = (int)min((long long)rpb, rows - r0);
  uint2* s_key = reinterpret_cast<uint2*>(smem);
  int32_t* s_act = reinterpret_cast<int32_t*>(smem + key_bytes);
  uint8_t* s_prn = reinterpret_cast<uint8_t*>(s_act + rpb * s);
  uint8_t* s_tf = s_prn + rpb * s;
  for (int j = threadIdx.x; j < kNB * kNB; j += rpb) s_cdf[j] = class_cdf[j];
  for (int j = threadIdx.x; j < kNB; j += rpb) {
    s_start[j] = class_start[j];
    s_count[j] = class_count[j];
  }
  // the round key of each origin the block's rows span, once per origin,
  // into slot 0 of the origin's T + 2 slots; then its sub keys 1 .. T + 1
  // into slots 1 .. T + 1, a thread per key
  const bool pt = part != 0;
  const int o_first = (int)(r0 / n);
  const int n_org = (int)((r0 + nr - 1) / n) - o_first + 1;
  const int nk = tries + 2;
  for (int j = threadIdx.x; j < n_org; j += rpb) {
    const long long* kp =
        reinterpret_cast<const long long*>(key) + 2LL * (o_first + j);
    uint32_t kr0, kr1;
    tf_fold_in((uint32_t)__ldg(kp), (uint32_t)__ldg(kp + 1),
               lanes.l[(o_first + j) / opl].it, kr0, kr1);
    s_key[j * nk] = make_uint2(kr0, kr1);
  }
  stage_in(reinterpret_cast<uint8_t*>(s_act),
           reinterpret_cast<const uint8_t*>(active + r0 * s), nr * s * 4);
  stage_in(s_prn, pruned + r0 * s, nr * s);
  stage_in(s_tf, tfail + r0 * s, nr * s);
  __syncthreads();
  for (int j = threadIdx.x; j < n_org * (tries + 1); j += rpb) {
    const int oj = j / (tries + 1);
    const int q = j - oj * (tries + 1) + 1;
    const uint2 kr = s_key[oj * nk];
    s_key[oj * nk + q] =
        tf_split_key(kr.x, kr.y, (uint32_t)q, (uint32_t)nk, pt);
  }
  __syncthreads();

  const int i = threadIdx.x;
  if constexpr (kTrace) {
    if (i < nr) rot[r0 + i] = -1;   // a row that rotates overwrites it
  }
  if (i < nr) {
    // the row's origin and node from the block's first row (a 32-bit
    // division only where the block passes an origin)
    int o = o_first;
    int node = (int)(r0 - (long long)o_first * n) + i;
    if (node >= n) {
      const int q = node / n;
      o += q;
      node -= q * n;
    }
    const uint2* ko = s_key + (o - o_first) * nk;   // ko[q]: sub key q
    if (to_uniform(tf_word(ko[1].x, ko[1].y, (uint32_t)node, (uint32_t)n,
                           pt)) < lanes.l[o / opl].prob) {
      int32_t* a = s_act + i * s;
      uint8_t* pr = s_prn + i * s;
      uint8_t* tf = s_tf + i * s;
      const int k = min(__ldg(buckets + node), __ldg(buckets + __ldg(origins + o)));
      const float* cdf = s_cdf + k * kNB;
      const uint32_t two_n = 2u * (uint32_t)n;
      int chosen = n;
      bool found = false;
      for (int t = 0; t < tries && !found; ++t) {
        const uint2 kt = ko[2 + t];
        const float ux =
            to_uniform(tf_word(kt.x, kt.y, 2u * node, two_n, pt));
        const float uy =
            to_uniform(tf_word(kt.x, kt.y, 2u * node + 1u, two_n, pt));
        int cls = 0;
#pragma unroll
        for (int j = 0; j < kNB - 1; ++j) cls += ux >= cdf[j];
        const int start = s_start[cls], count = s_count[cls];
        int member =
            start + (int)floorf(__fmul_rn(uy, (float)count));
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
        if constexpr (kTrace) rot[r0 + i] = chosen;
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

// rows = O * N, o = O; rows_per_block, key_bytes (the round keys and sub
// keys, 16-byte padded, ahead of the staged rows) and smem (both; the class
// tables are static shared memory) come from kernels/rotate.py
// launch_geometry.  `lanes` points at k RotateLane records in host memory,
// one per lane of opl origin rows (k * opl = o).  rot null: the
// trace-free instantiation.
extern "C" int rotate_launch(
    const int32_t* active, const uint8_t* pruned, const uint8_t* tfail,
    const uint8_t* failed, const int64_t* key, const int32_t* origins,
    const int32_t* buckets, const int32_t* perm, const int32_t* class_start,
    const int32_t* class_count, const float* class_cdf, int32_t* new_active,
    uint8_t* new_pruned, uint8_t* new_tfail, int32_t* rot_failed,
    int32_t* rot, int o,
    long long rows, int n, int s, int tries, const void* lanes, int k,
    int opl, int part, int rows_per_block, int key_bytes, int smem,
    cudaStream_t stream) {
  RotateLanes lane_args;
  if (!lanes_from_host(&lane_args, static_cast<const RotateLane*>(lanes), k, o, opl))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(rot_failed, 0, sizeof(int32_t) * o,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  const auto kernel = rot != nullptr ? rotate_kernel<true>
                                     : rotate_kernel<false>;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  kernel<<<(unsigned)blocks, rows_per_block, smem, stream>>>(
      active, pruned, tfail, failed, key, origins, buckets, perm,
      class_start, class_count, class_cdf, new_active, new_pruned, new_tfail,
      rot_failed, rot, rows, n, s, tries, lane_args, opl, part, key_bytes);
  return (int)cudaGetLastError();
}
