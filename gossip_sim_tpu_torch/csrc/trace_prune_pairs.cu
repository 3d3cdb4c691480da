// trace_prune_pairs — the flight recorder's prune pairs of one round.
//
// Replaces the reference engine's prune-pair capture
// (gossip_sim_tpu/engine/core.py:864-892: the flat keys n * C + slot of the
// pruned slots sorted over the whole row, the first PC kept, behind a
// lax.cond on any prune firing).  The plain PyTorch version is
// kernels/trace_prune_pairs.py trace_prune_pairs_plain.
//
// Input:  n_pruned [R, N] i32 (each pruner's pruned slots, as
//         rc_merge_prune counts them), pruned_slot [R, N, C] u8 and
//         src_sorted [R, N, C] i32 (the prune decision and each slot's
//         peer).
// Output: src and dst [R, PC] i32: the first PC (pruner, prunee) pairs of
//         each row in flat n * C + slot order, -1 past the row's pairs.
//
// The flat order is pruner-major, so pruner n's pairs start at the sum of
// n_pruned over the pruners before it.  One CTA per row walks the row in
// chunks of kThreads pruners: an exclusive scan of the chunk's counts in
// shared memory (warp shuffles, then the warp totals) plus the running
// total of the chunks before gives each pruner its offset; a pruner that
// fires, with its offset below PC, writes its pruned slots in slot order
// at offset + local rank while that stays below PC.  The walk stops at
// the chunk where the total reaches PC, and the CTA then writes -1 over
// the rest of the row's PC slots.  So only the firing pruners' planes are
// read (C bytes and the pruned slots' peers each), a round where nothing
// fires reads n_pruned and writes the fill, and no host sync is needed:
// the reference's lax.cond skips the sort in such a round, and the values
// are the same either way.  R is any row count (O origins in the push
// round, V value rows in a traffic round).  Bound on the H100: memory,
// the n_pruned plane read and the 8 PC bytes of each row written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;   // kernels/trace_prune_pairs.py THREADS
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads) trace_prune_pairs_kernel(
    const int32_t* __restrict__ n_pruned,
    const uint8_t* __restrict__ pruned_slot,
    const int32_t* __restrict__ src_sorted, int32_t* __restrict__ src,
    int32_t* __restrict__ dst, int n, int c, int cap) {
  __shared__ int s_warp[kWarps];
  const long long row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t* np_row = n_pruned + row * n;
  int32_t* src_row = src + row * cap;
  int32_t* dst_row = dst + row * cap;
  long long total = 0;   // pairs of the chunks before, the same in every
                         // thread
  for (int base = 0; base < n && total < cap; base += kThreads) {
    const int i = base + tid;
    const int v = i < n ? __ldg(np_row + i) : 0;
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += u;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = s_warp[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kFull, w, d);
        if (lane >= d) w += u;
      }
      s_warp[lane] = w;   // inclusive warp totals
    }
    __syncthreads();
    const long long off =
        total + (warp > 0 ? s_warp[warp - 1] : 0) + incl - v;
    if (v > 0 && off < cap) {
      const size_t at = ((size_t)row * n + i) * c;
      const uint8_t* ps = pruned_slot + at;
      const int32_t* ss = src_sorted + at;
      long long k = off;
      for (int j = 0; j < c && k < cap; ++j) {
        if (ps[j]) {
          src_row[k] = i;
          dst_row[k] = __ldg(ss + j);
          ++k;
        }
      }
    }
    total += s_warp[kWarps - 1];
    __syncthreads();   // s_warp is written again by the next chunk
  }
  const int filled = (int)min(total, (long long)cap);
  for (int k = filled + tid; k < cap; k += kThreads) {
    src_row[k] = -1;
    dst_row[k] = -1;
  }
}

}  // namespace

// One CTA of kThreads threads per row; r rows, n pruners of c slots each,
// cap pairs a row.
extern "C" int trace_prune_pairs_launch(const int32_t* n_pruned,
                                        const uint8_t* pruned_slot,
                                        const int32_t* src_sorted,
                                        int32_t* src, int32_t* dst, int r,
                                        int n, int c, int cap,
                                        cudaStream_t stream) {
  if (r < 1 || n < 0 || c < 0 || cap < 1) return (int)cudaErrorInvalidValue;
  trace_prune_pairs_kernel<<<(unsigned)r, kThreads, 0, stream>>>(
      n_pruned, pruned_slot, src_sorted, src, dst, n, c, cap);
  return (int)cudaGetLastError();
}
