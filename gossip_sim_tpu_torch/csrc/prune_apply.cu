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
// Input:  pruned_in [O, N, S] u8 carried pruned bits, active [O, N, S] i32
//         (or [N, S], shared by every o: the traffic round's),
//         src_sorted [O, N, C] i32 and pruned_slot [O, N, C] u8 from the
//         prune decision (row = pruner t, entry = prunee u).
// Output: pruned_out [O, N, S] u8 = pruned_in | hit, where hit[o, u, s] is
//         set iff active[o, u, s] == t for a live pair (t, u).
//
// One thread per (o, t, c) slot: a live pair scans the prunee's S slots
// for the pruner and stores 1 into that slot's bit.  The bit is
// idempotent (concurrent stores write the same value), so no sort, no
// budget and no fallback are needed, and the result equals both arms of
// the reference join.
//
// Bound on the H100: memory.  The copy of pruned_in plus one read of the
// pruned_slot plane dominate; live pairs are sparse (rows prune only in the
// round their upsert counter fires), so the S-slot scans are few.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void prune_apply_kernel(const int32_t* __restrict__ active,
                                   const int32_t* __restrict__ src_sorted,
                                   const uint8_t* __restrict__ pruned_slot,
                                   uint8_t* __restrict__ pruned_out,
                                   long long slots, int n, int s, int c,
                                   int shared) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= slots || !pruned_slot[i]) return;
  const long long row = i / c;                 // o * n + t
  const int t = (int)(row % n);
  const int u = src_sorted[i];
  if (u < 0 || u >= n) return;
  const long long prow = (row - t + u) * s;    // (o * n + u) * s
  const int32_t* arow = active + (shared ? (long long)u * s : prow);
  for (int j = 0; j < s; ++j)
    if (arow[j] == t) pruned_out[prow + j] = 1;
}

}  // namespace

extern "C" int prune_apply_launch(const uint8_t* pruned_in,
                                  const int32_t* active,
                                  const int32_t* src_sorted,
                                  const uint8_t* pruned_slot,
                                  uint8_t* pruned_out, int o, int n, int s,
                                  int c, int shared, cudaStream_t stream) {
  const size_t plane = (size_t)o * n * s;
  cudaMemcpyAsync(pruned_out, pruned_in, plane, cudaMemcpyDeviceToDevice,
                  stream);
  const long long slots = (long long)o * n * c;
  if (slots > 0)
    prune_apply_kernel<<<(unsigned)((slots + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(active, src_sorted,
                                                pruned_slot, pruned_out,
                                                slots, n, s, c, shared);
  return (int)cudaGetLastError();
}
