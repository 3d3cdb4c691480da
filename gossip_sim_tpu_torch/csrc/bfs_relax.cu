// bfs_relax — hop-by-hop BFS frontier relaxation over the push edge list.
//
// Replaces the reference engine's `round/bfs_propagate` block
// (gossip_sim_tpu/engine/core.py:620-661: per hop, two full-width 1-key
// sorts over the N*F + N edge/pseudo-edge keys; its bit-identical twin is
// engine/sparse.py:64-95 `bfs_reach`, one segment_max per hop).
//
// Input:  tgt [O, N, F] i32 push target per (source, fanout slot), N = none;
//         origins [O] i32.
// Output: reached [O, N] u8 (bool), dist [O, N] i32 (1 << 20 = unreached).
// Scratch: frontier and next-frontier planes [2, O, N] u8.
//
// Seeding follows core.py:627-633 exactly: the origin's own targets are the
// hop-1 frontier (reached, dist 1), then the origin itself is reached at 0.
// Each hop marks every target of a frontier node in the next plane (plain
// stores of 1: concurrent writers store the same value, so the result does
// not depend on their order), then newly = next & !reached gets dist h + 1.
//
// Bound on the H100: memory.  The function must read tgt once
// (O*N*F*4 bytes) and write reached/dist once; each hop re-reads the
// frontier plane and the targets of frontier nodes, which stay in the 50 MB
// L2 at the main path's sizes.  Design: one block per origin loops over
// the hops with __syncthreads / __syncthreads_or, so there is no host sync
// and no relaunch per hop.  With O = 32 origins only 32 of the 132 SMs work;
// splitting an origin over several blocks (a grid-wide barrier per hop) is
// work for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kInf = 1 << 20;
constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
bfs_relax_kernel(const int32_t* __restrict__ tgt,
                 const int32_t* __restrict__ origins,
                 uint8_t* __restrict__ reached, int32_t* __restrict__ dist,
                 uint8_t* __restrict__ frontier, uint8_t* __restrict__ next,
                 int n, int f) {
  const int o = blockIdx.x;
  const int32_t* tg = tgt + (size_t)o * n * f;
  uint8_t* re = reached + (size_t)o * n;
  int32_t* di = dist + (size_t)o * n;
  uint8_t* fr = frontier + (size_t)o * n;
  uint8_t* nx = next + (size_t)o * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    re[i] = 0;
    di[i] = kInf;
    fr[i] = 0;
    nx[i] = 0;
  }
  __syncthreads();
  const int org = origins[o];
  for (int j = threadIdx.x; j < f; j += blockDim.x) {
    const int t = tg[(size_t)org * f + j];
    if (t >= 0 && t < n) {
      fr[t] = 1;
      re[t] = 1;
      di[t] = 1;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    re[org] = 1;
    di[org] = 0;
  }
  __syncthreads();

  const int nf = n * f;
  for (int h = 1;; ++h) {
    for (int e = threadIdx.x; e < nf; e += blockDim.x) {
      if (fr[e / f]) {
        const int t = tg[e];
        if (t >= 0 && t < n) nx[t] = 1;
      }
    }
    __syncthreads();
    int any = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint8_t nw = nx[i] & (re[i] ^ 1);
      fr[i] = nw;
      nx[i] = 0;
      if (nw) {
        re[i] = 1;
        di[i] = h + 1;
        any = 1;
      }
    }
    if (!__syncthreads_or(any)) break;
  }
}

}  // namespace

extern "C" int bfs_relax_launch(const int32_t* tgt, const int32_t* origins,
                                uint8_t* reached, int32_t* dist,
                                uint8_t* scratch, int o, int n, int f,
                                cudaStream_t stream) {
  bfs_relax_kernel<<<o, kThreads, 0, stream>>>(
      tgt, origins, reached, dist, scratch, scratch + (size_t)o * n, n, f);
  return (int)cudaGetLastError();
}
