// prune_apply — apply this round's (pruner, prunee) pairs to the active sets.
//
// Replaces the reference engine's `round/verb4_prune_apply` join
// (gossip_sim_tpu/engine/core.py:894-941: pairs and active-set edges meet
// in one full-width sort keyed by peer * pack + owner, with a pa_slots
// budgeted fast path and a lax.cond fallback to the full-width sort), and
// the traffic round's `traffic/prune_apply` (gossip_sim_tpu/engine/
// traffic.py:711-755), the same join on the value axis with one shared
// active set.
//
// Input:  pruned_in [O, N, S] u8 carried pruned bits, active [O / G, N,
//         S] i32: a plane per G rows (G = 1: the push round's, a set per
//         origin row; G = O: one [N, S] set shared by every o, the traffic
//         round's; G = V: a batch of traffic lanes, one set per lane of V
//         value rows),
//         src_sorted [O, N, C] i32 and pruned_slot [O, N, C] u8 from the
//         prune decision (row = pruner t, entry = prunee u).
// Output: pruned_out [O, N, S] u8 = pruned_in | hit, where hit[o, u, s] is
//         set iff active[o, u, s] == t for a live pair (t, u).
//
// Design: one cooperative launch of one wave of blocks (the grid the card
// holds at once, kernels/prune_apply.py grid_blocks), grid-stride, in
// two phases split by a grid barrier:
//   1. copy pruned_in to pruned_out in 16-byte vectors;
//   2. read pruned_slot in 16-byte vectors, a lane one a step (a 16-bit
//      mask of its nonzero bytes: the live pairs); a warp scan numbers the
//      step's pairs and the lanes take them in turn, so a vector dense with
//      pairs (a row whose upsert counter fires) spreads over the warp.  A
//      pair finds its pruner row from the flat index (32-bit index math
//      where O * N * C and O * N * S fit in 31 bits, else 64-bit), scans
//      the prunee's S slots for the pruner and stores 1 there.
// The scatter lands on rows that phase 1 has copied (the barrier).  The
// bit is idempotent (concurrent stores write the same value), so the order
// of the scatter does not matter and no sort, budget or fallback is
// needed; the result equals both arms of the reference join.
//
// Chosen from timings on the H100 of variants on round-19 inputs (O = 1,
// 32 and 64, and the traffic round at M = 256) and on a steady round at
// O = 1 and 32: the barrier and the same phases as two plain launches time
// alike, and one launch is kept; one vector a lane a step edges out two; a
// list of the live pairs (one atomic a warp and step on one count, then a
// scatter over the whole grid) is slower, as the atomics on the one count
// serialise; loading vectors ahead (the next step's, or the first step's
// and its pairs' before the barrier) is slower too; so is a wider grid
// with fewer vectors a warp a step at O = 1 (one turn of pairs in round
// 19, but the wider barrier costs more in every steady round).  A firing
// round's pairs are bound by their random prunee-row reads and byte
// stores, not by the scan.
//
// Bound on the H100: memory.  The copy of pruned_in plus one read of the
// pruned_slot plane dominate; the live pairs' prunee and active-row reads
// are sparse outside the rounds in which the upsert counters fire.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;     // 16-byte vectors a thread copies at once

template <typename I>
struct Pairs {
  const int32_t* __restrict__ active;
  const int32_t* __restrict__ src_sorted;
  uint8_t* __restrict__ out;
  I n, c, group;  // group: origin rows per plane of active
  int s;

  // pair i (a flat pruned_slot index) with its prunee u read
  __device__ __forceinline__ void apply(I i, int u) const {
    if (u < 0 || (I)u >= n) return;
    const I row = i / c;                 // o * n + t
    const I o_n = row - row % n;         // o * n
    const int t = (int)(row - o_n);
    const I prow = (o_n + (I)u) * (I)s;  // (o * n + u) * s
    // the prunee's row of active plane o / group
    const int32_t* arow =
        active + (group == 1 ? prow : ((o_n / n / group) * n + (I)u) * (I)s);
    for (int j = 0; j < s; ++j)
      if (__ldg(arow + j) == t) out[prow + j] = 1;
  }

  __device__ __forceinline__ void apply(I i) const {
    apply(i, __ldg(src_sorted + i));
  }
};

// bit b set iff byte b of w is nonzero
__device__ __forceinline__ unsigned nonzero_bytes(uint32_t w) {
  const uint32_t hi = (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
  return ((hi >> 7) & 1u) | ((hi >> 14) & 2u) | ((hi >> 21) & 4u) |
         ((hi >> 28) & 8u);
}

// bit b set iff byte b of the 16-byte vector r is nonzero
__device__ __forceinline__ unsigned vector_mask(uint4 r) {
  return nonzero_bytes(r.x) | (nonzero_bytes(r.y) << 4) |
         (nonzero_bytes(r.z) << 8) | (nonzero_bytes(r.w) << 12);
}

// the position of the j-th (from 0) set bit of the 16-bit mask m
// (j < popc(m))
__device__ __forceinline__ int select_bit(unsigned m, int j) {
  int pos = 0;
#pragma unroll
  for (int b = 8; b; b >>= 1) {
    const unsigned low = m & ((1u << b) - 1u);
    const int c = __popc(low);
    if (c <= j) {
      j -= c;
      m >>= b;
      pos += b;
    } else {
      m = low;
    }
  }
  return pos;
}

__device__ __forceinline__ int warp_inclusive_scan(int x, unsigned lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= (unsigned)d) x += y;
  }
  return x;
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
prune_apply_kernel(const uint8_t* __restrict__ pruned_in,
                   const int32_t* __restrict__ active,
                   const int32_t* __restrict__ src_sorted,
                   const uint8_t* __restrict__ pruned_slot,
                   uint8_t* __restrict__ pruned_out, I plane, I slots, I n,
                   int s, I c, I group) {
  cg::grid_group grid = cg::this_grid();
  const I tid = (I)blockIdx.x * kThreads + threadIdx.x;
  const I stride = (I)gridDim.x * kThreads;
  const unsigned lane = threadIdx.x & 31u;
  const Pairs<I> pairs{active, src_sorted, pruned_out, n, c, group, s};

  // 1. the copy, in 16-byte vectors where both planes are aligned
  const bool copy16 = ((reinterpret_cast<uintptr_t>(pruned_in) |
                        reinterpret_cast<uintptr_t>(pruned_out)) & 15u) == 0;
  const I cvecs = copy16 ? plane / 16 : 0;
  const uint4* in4 = reinterpret_cast<const uint4*>(pruned_in);
  uint4* out4 = reinterpret_cast<uint4*>(pruned_out);
  I i = tid;
  for (; i + (kUnroll - 1) * stride < cvecs; i += kUnroll * stride) {
    uint4 r[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) r[k] = __ldg(in4 + i + k * stride);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) out4[i + k * stride] = r[k];
  }
  for (; i < cvecs; i += stride) out4[i] = __ldg(in4 + i);
  for (I j = cvecs * 16 + tid; j < plane; j += stride)
    pruned_out[j] = pruned_in[j];
  grid.sync();

  // 2. the live pairs: a lane reads a 16-byte vector of pruned_slot a
  // step (a 16-bit mask of its nonzero bytes), a warp scan numbers the
  // step's set bytes, and the lanes take them in turn (owner lane by a
  // binary search of the scan, the byte by its rank in the owner's mask),
  // so a vector dense with pairs spreads over the warp
  const I svecs =
      (reinterpret_cast<uintptr_t>(pruned_slot) & 15u) == 0 ? slots / 16 : 0;
  const uint4* slot4 = reinterpret_cast<const uint4*>(pruned_slot);
  for (I w0 = tid - lane; w0 < svecs; w0 += stride) {
    const unsigned mask =
        w0 + lane < svecs ? vector_mask(__ldg(slot4 + w0 + lane)) : 0u;
    const int cnt = __popc(mask);
    const int incl = warp_inclusive_scan(cnt, lane);
    const int total = __shfl_sync(kFull, incl, 31);
    for (int k0 = 0; k0 < total; k0 += 32) {
      const int k = k0 + (int)lane;
      int owner = 0;
#pragma unroll
      for (int b = 16; b; b >>= 1)
        if (__shfl_sync(kFull, incl, owner + b - 1) <= k) owner += b;
      const unsigned m = __shfl_sync(kFull, mask, owner);
      const int before = __shfl_sync(kFull, incl - cnt, owner);
      if (k < total)
        pairs.apply((w0 + (I)owner) * 16 + select_bit(m, k - before));
    }
  }
  for (I j = svecs * 16 + tid; j < slots; j += stride)
    if (pruned_slot[j]) pairs.apply(j);
}

template <typename I>
cudaError_t launch(const uint8_t* pruned_in, const int32_t* active,
                   const int32_t* src_sorted, const uint8_t* pruned_slot,
                   uint8_t* pruned_out, long long plane, long long slots,
                   int n, int s, int c, int group, int grid,
                   cudaStream_t stream) {
  I plane_i = (I)plane, slots_i = (I)slots, n_i = (I)n, c_i = (I)c,
    group_i = (I)group;
  void* args[] = {&pruned_in, &active,  &src_sorted, &pruned_slot,
                  &pruned_out, &plane_i, &slots_i,   &n_i,
                  &s,          &c_i,     &group_i};
  return cudaLaunchCooperativeKernel((const void*)prune_apply_kernel<I>,
                                     dim3((unsigned)grid), dim3(kThreads),
                                     args, 0, stream);
}

// 32-bit index math where every flat index of the two planes fits
bool narrow(long long plane, long long slots) {
  return plane < (1LL << 31) && slots < (1LL << 31);
}

}  // namespace

// group: origin rows per plane of active (G above).
// grid: kernels/prune_apply.py grid_blocks (at most the blocks the card
// holds at once, prune_apply_blocks_per_sm x SMs: a cooperative launch).
extern "C" int prune_apply_launch(const uint8_t* pruned_in,
                                  const int32_t* active,
                                  const int32_t* src_sorted,
                                  const uint8_t* pruned_slot,
                                  uint8_t* pruned_out, int o, int n, int s,
                                  int c, int group, int grid,
                                  cudaStream_t stream) {
  if (o < 0 || n < 1 || s < 1 || c < 0 || grid < 1 || group < 1 ||
      (o > 0 && o % group != 0))
    return (int)cudaErrorInvalidValue;
  const long long plane = (long long)o * n * s;
  const long long slots = (long long)o * n * c;
  if (plane == 0) return (int)cudaSuccess;
  const cudaError_t err =
      narrow(plane, slots)
          ? launch<uint32_t>(pruned_in, active, src_sorted, pruned_slot,
                             pruned_out, plane, slots, n, s, c, group, grid,
                             stream)
          : launch<unsigned long long>(pruned_in, active, src_sorted,
                                       pruned_slot, pruned_out, plane, slots,
                                       n, s, c, group, grid, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Blocks of the 32-bit (wide = 0) or 64-bit (wide = 1) instantiation that
// one SM holds at once, into *blocks; returns the CUDA error.
extern "C" int prune_apply_blocks_per_sm(int wide, int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks,
      wide ? (const void*)prune_apply_kernel<unsigned long long>
           : (const void*)prune_apply_kernel<uint32_t>,
      kThreads, 0);
}
