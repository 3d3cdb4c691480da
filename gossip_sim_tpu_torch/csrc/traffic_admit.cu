// traffic_admit — the traffic round's ingress budget: the cross-value
// contention point.
//
// Replaces the reference engine's `traffic/ingress_cap` block
// (gossip_sim_tpu/engine/traffic.py:316-342: one flat sort of every
// arrival of the round by (target, value-major arrival order) with pseudo
// entries for the per-target counts, and a sort back).
//
// Input:  row_ptr [N + 1], col [N * S] i32: the reverse CSR of the shared
//         active set (each target's in-neighbours as src * S + slot, in
//         ascending source order; kernels/traffic_admit.py in_neighbours);
//         cand_bits / arr_bits [N, V] i32 from traffic_send (sender-major).
// Output: accepted [V, N, F] u8 (zeroed here first), arrived_node and
//         accepted_node [N] i32.
//
// An arrival's rank at its target is its position among the target's
// arrivals in flat (value, source, fanout slot) order; with the ingress cap
// on, the ranks below the cap are accepted.  The active set is shared and
// each row's peers are distinct, so a source sends a target at most one
// message per value, through the one slot that holds the target: in flat
// order the arrivals at a target come value by value, source by source.
//
// Design: a warp per target walks the values in order and, for each, the
// target's in-neighbours 32 at a time (a lane each: one word of arr_bits
// says whether that source's message through that slot arrived); a ballot
// and a prefix popcount rank the chunk's arrivals behind the running count.
// The arrival's fanout slot is the candidates below its slot in cand_bits.
// No atomics and no sort, deterministic.  In-degrees of the 10,000-node
// set stay under 32, so a target's in-neighbours are read once and kept in
// registers; a longer row is re-read per value.  The slot words are
// sender-major, so a lane's words of consecutive values are adjacent: it
// loads 8 values' words (one 32-byte sector) before ranking them.
//
// Bound on the H100: memory.  It reads the two [N, V] words per (source,
// value), each in-neighbour's row once a target (from L2: the planes are
// 8 bytes a (value, source)), and writes the [V, N, F] acceptance bytes,
// one scattered byte per arrival.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8;   // targets per block
constexpr int kUnroll = 8;  // values whose words (a sector) a lane loads

__device__ __forceinline__ void admit_chunk(
    bool arr, uint32_t cb_word, int slot, long long row, int f, int cap,
    unsigned below, int& running, uint8_t* __restrict__ accepted) {
  const unsigned mask = __ballot_sync(kFull, arr);
  if (arr) {
    const int rank = running + __popc(mask & below);
    if (cap <= 0 || rank < cap) {
      const int fo = __popc(cb_word & ((1u << slot) - 1u));
      accepted[row * f + fo] = 1;
    }
  }
  running += __popc(mask);
}

__global__ void __launch_bounds__(32 * kWarps)
traffic_admit_kernel(const int32_t* __restrict__ row_ptr,
                     const int32_t* __restrict__ col,
                     const int32_t* __restrict__ cand_bits,
                     const int32_t* __restrict__ arr_bits,
                     uint8_t* __restrict__ accepted,
                     int32_t* __restrict__ arrived_node,
                     int32_t* __restrict__ accepted_node, int v_count, int n,
                     int s, int f, int cap) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= n) return;  // whole warp
  const unsigned below = (1u << lane) - 1u;
  const int beg = __ldg(row_ptr + t), end = __ldg(row_ptr + t + 1);
  int running = 0;
  if (end - beg <= 32) {
    // one chunk: the lane's in-neighbour stays in registers
    const bool has = beg + lane < end;
    int src = 0, slot = 0;
    if (has) {
      const int e = __ldg(col + beg + lane);
      src = e / s;
      slot = e - src * s;
    }
    for (int v0 = 0; v0 < v_count; v0 += kUnroll) {
      uint32_t aw[kUnroll], cw[kUnroll];
      const long long words = (long long)src * v_count + v0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool load = has && v0 + u < v_count;
        aw[u] = load ? (uint32_t)__ldg(arr_bits + words + u) : 0u;
        cw[u] = load ? (uint32_t)__ldg(cand_bits + words + u) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        admit_chunk((aw[u] >> slot) & 1u, cw[u], slot,
                    (long long)(v0 + u) * n + src, f, cap, below, running,
                    accepted);
    }
  } else {
    for (int v = 0; v < v_count; ++v) {
      for (int c0 = beg; c0 < end; c0 += 32) {
        const int c = c0 + lane;
        int src = 0, slot = 0;
        bool arr = false;
        if (c < end) {
          const int e = __ldg(col + c);
          src = e / s;
          slot = e - src * s;
          arr = ((uint32_t)__ldg(arr_bits + (long long)src * v_count + v) >>
                 slot) & 1u;
        }
        admit_chunk(arr,
                    arr ? (uint32_t)__ldg(cand_bits +
                                          (long long)src * v_count + v)
                        : 0u,
                    slot, (long long)v * n + src, f, cap, below, running,
                    accepted);
      }
    }
  }
  if (lane == 0) {
    arrived_node[t] = running;
    accepted_node[t] = (cap > 0 && running > cap) ? cap : running;
  }
}

}  // namespace

extern "C" int traffic_admit_launch(const int32_t* row_ptr,
                                    const int32_t* col,
                                    const int32_t* cand_bits,
                                    const int32_t* arr_bits,
                                    uint8_t* accepted, int32_t* arrived_node,
                                    int32_t* accepted_node, int v_count,
                                    int n, int s, int f, int cap,
                                    cudaStream_t stream) {
  if (v_count < 0 || n < 1 || s < 1 || s > 32 || f < 1 || f > s)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      accepted, 0, (size_t)v_count * n * f, stream);
  if (err != cudaSuccess) return (int)err;
  traffic_admit_kernel<<<(unsigned)((n + kWarps - 1) / kWarps),
                         32 * kWarps, 0, stream>>>(
      row_ptr, col, cand_bits, arr_bits, accepted, arrived_node,
      accepted_node, v_count, n, s, f, cap);
  return (int)cudaGetLastError();
}
