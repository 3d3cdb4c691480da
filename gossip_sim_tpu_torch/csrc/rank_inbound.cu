// rank_inbound — ingress counts and the K best inbound edges per target.
//
// Replaces the reference engine's `round/verb2_consume` block
// (gossip_sim_tpu/engine/core.py:663-741: a 4-operand 2-key sort of the
// N*F + N delivered-edge/pseudo-edge list, then a slot-aligned two-sort
// compaction over N*F + N*K elements; twin engine/sparse.py:98-149).
//
// Input:  tgt [O, N, F] i32, delivered [O, N, F] u8, hop1 [O, N] i32.
// Output: ingress [O, N] i32 (delivered edges into each target),
//         inb [O, N, K] i32: per target the K smallest delivered inbound
//         edges by key hop1[src] << pb | src, ascending, N = empty;
//         dropped [O] i32 = sum over targets of max(ingress - K, 0).
// Scratch: offsets/cursor [O*N] i32 and the CSR key array [O*N*F] i32.
//
// Keys are unique within a target (a source pushes to distinct peers), so
// the K smallest are one set and the result does not depend on the order
// in which atomics hand out CSR positions.
//
// Three steps, two C entry points (an exclusive scan in PyTorch between):
//   1. count:  one thread per edge, atomicAdd into ingress[o, t];
//   2. place:  one thread per edge, atomicAdd on a per-target cursor gives
//              the edge a CSR position at offsets[o, t] + cursor;
//   3. select: one thread per target keeps the K smallest keys of its
//              segment by insertion into a sorted register array.
// Bound on the H100: memory (read tgt/delivered/hop1 once, write
// inb/ingress once, plus the CSR round trip).  Step 3 is per-thread serial
// over the segment; segments average F entries, and a high-stake target's
// long segment is one slow thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 64;

__global__ void count_kernel(const int32_t* __restrict__ tgt,
                             const uint8_t* __restrict__ delivered,
                             int32_t* __restrict__ ingress, long long edges,
                             int n, int nf) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= edges || !delivered[e]) return;
  const long long o = e / nf;
  atomicAdd(&ingress[o * n + tgt[e]], 1);
}

__global__ void place_kernel(const int32_t* __restrict__ tgt,
                             const uint8_t* __restrict__ delivered,
                             const int32_t* __restrict__ hop1,
                             const int32_t* __restrict__ offsets,
                             int32_t* __restrict__ cursor,
                             int32_t* __restrict__ csr, long long edges,
                             int n, int f, int pb) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= edges || !delivered[e]) return;
  const long long src_row = e / f;             // o * n + src
  const int src = (int)(src_row % n);
  const long long seg = (src_row / n) * n + tgt[e];
  const int pos = atomicAdd(&cursor[seg], 1);
  csr[offsets[seg] + pos] = (hop1[src_row] << pb) | src;
}

__global__ void select_kernel(const int32_t* __restrict__ csr,
                              const int32_t* __restrict__ offsets,
                              const int32_t* __restrict__ ingress,
                              int32_t* __restrict__ inb,
                              int32_t* __restrict__ dropped, long long rows,
                              int n, int k, int pb) {
  const long long row = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int len = ingress[row];
  const int32_t* seg = csr + offsets[row];
  int32_t best[kMaxK];
  int m = 0;
  for (int i = 0; i < len; ++i) {
    const int32_t key = seg[i];
    if (m == k && key >= best[k - 1]) continue;
    int j = (m < k) ? m++ : k - 1;
    while (j > 0 && best[j - 1] > key) {
      best[j] = best[j - 1];
      --j;
    }
    best[j] = key;
  }
  const int32_t mask = (1 << pb) - 1;
  int32_t* out = inb + row * k;
  for (int r = 0; r < k; ++r) out[r] = (r < m) ? (best[r] & mask) : n;
  if (len > k) atomicAdd(&dropped[row / n], len - k);
}

inline unsigned blocks_for(long long items) {
  return (unsigned)((items + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int rank_inbound_count(const int32_t* tgt, const uint8_t* delivered,
                                  int32_t* ingress, int o, int n, int f,
                                  cudaStream_t stream) {
  const long long edges = (long long)o * n * f;
  cudaMemsetAsync(ingress, 0, sizeof(int32_t) * (size_t)o * n, stream);
  if (edges > 0)
    count_kernel<<<blocks_for(edges), kThreads, 0, stream>>>(
        tgt, delivered, ingress, edges, n, n * f);
  return (int)cudaGetLastError();
}

extern "C" int rank_inbound_place(const int32_t* tgt, const uint8_t* delivered,
                                  const int32_t* hop1, const int32_t* ingress,
                                  const int32_t* offsets, int32_t* cursor,
                                  int32_t* csr, int32_t* inb, int32_t* dropped,
                                  int o, int n, int f, int k, int pb,
                                  cudaStream_t stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  const long long edges = (long long)o * n * f;
  const long long rows = (long long)o * n;
  cudaMemsetAsync(cursor, 0, sizeof(int32_t) * (size_t)rows, stream);
  cudaMemsetAsync(dropped, 0, sizeof(int32_t) * (size_t)o, stream);
  if (edges > 0)
    place_kernel<<<blocks_for(edges), kThreads, 0, stream>>>(
        tgt, delivered, hop1, offsets, cursor, csr, edges, n, f, pb);
  if (rows > 0)
    select_kernel<<<blocks_for(rows), kThreads, 0, stream>>>(
        csr, offsets, ingress, inb, dropped, rows, n, k, pb);
  return (int)cudaGetLastError();
}
