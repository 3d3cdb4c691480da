// pull_exchange — the pull (anti-entropy) phase of one round.
//
// Replaces the reference engine's `round/pull` block
// (gossip_sim_tpu/engine/core.py:1012-1180: the [N, PS] peer draw, the
// request gates, two pseudo-entry stable sorts that rank the arrived
// requests per peer and count them, the response decision and the
// per-requester best hop).  The plain PyTorch version is
// kernels/pull_exchange.py pull_exchange_plain.
//
// Input:  reached [O, N] u8 and dist [O, N] i32 (this round's push BFS),
//         failed [O, N] u8, side [N + 1] i32 (read only while the
//         partition is on), the sampler's perm [N], class_start and
//         class_count [25] i32 and top-entry CDF [25] f32, adaptive_on [O]
//         u8 (null outside the adaptive mode), the round's hash bases and
//         thresholds.
// Output: pull_hop [O, N] i32, the least dist[peer] + 1 over the requests
//         that transferred the value to the node (kInf for none);
//         egress [O, N] i32 = requests arrived from the node + responses
//         the node sent; ingress [O, N] i32 = requests the node received +
//         transfers to it; counts [O, 6] i32 = requests arrived,
//         responses, misses (arrived - responses), dropped, suppressed,
//         rescued (nodes with a transfer).
// Scratch: the per-peer state of each origin in device memory, where it
//         does not fit shared memory (4 N words per origin).
//
// Every decision but one is a stateless hash of (node, slot) or (node,
// peer), so the order of the threads does not matter:
//   peer      cls = #{c < 24 : u_cls >= cdf[c]},
//             pos = start[cls] + floor(u_mem * f32(count[cls])), clamped to
//             the class, peer = perm[pos]; u = (edge_u32(b, node, slot)
//             >> 8) * 2^-24, exact in f32, and the product rounds once
//             (__fmul_rn), as XLA's;
//   request   live slot (slot < fanout, pull round, the sim's adaptive bit),
//             peer != node, node not failed; then failed peer > partition
//             (sides differ while the window is on) > loss
//             (edge_u32(b_loss, node, peer) < threshold) > arrived;
//   transfer  served, reached[peer], !reached[node] and the node's bloom
//             hash at or above the false-positive threshold.
// The one that depends on order is the request cap: a peer serves an
// arrived request when its rank among the requests that arrived at that
// peer, in (requester, slot) order, is below the cap.  With key = node *
// fanout + slot (unique), that rank is below the cap exactly when the key
// is at most the cap-th smallest key of the peer.  The kernel finds that
// key with cap passes of atomicMin over the arrived requests (pass k takes
// the least key above pass k - 1's), only for the peers that received more
// than the cap, and only when some peer did; with the cap off (<= 0) it
// ranks nothing.  The passes cost cap times the requests: exact for any
// cap, fast for the small caps the protocol uses.
//
// One block per origin; its threads walk the nodes.  Per-peer counts
// (requests in, responses out, the cap's keys) are shared-memory atomics
// (device-memory ones past shared memory).  Phases, each after a barrier:
//   0. zero the counts; load the class tables;
//   1. each node's requests: draw, gate, count arrivals per peer and per
//      node (the node's egress so far);
//   2. if the cap binds: the cap-th smallest key of each crowded peer;
//   3. each node's requests again: serve, transfer, count responses per
//      peer, the node's best hop and its transfers (its ingress so far);
//   4. egress += responses sent, ingress += requests received; the six
//      counts from a block reduction.
// Bound on the H100: memory.  It reads failed and reached (bytes) and
// dist once and writes three [O, N] planes; the hashes are a few dozen
// integer operations per request.  A block per origin leaves SMs idle at
// small O; the round is host-bound (PERF.md), so a simple, exact kernel
// comes first.

#include <cuda_runtime.h>
#include <stdint.h>

#include "faults.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kClasses = 25;       // stake buckets (constants.py)
constexpr int32_t kInf = 1 << 20;  // engine/core.py INF
constexpr int32_t kNoKey = 0x7FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kCounts = 6;

struct Round {
  int n, fanout, pull_on, cap, part_on, has_loss;
  uint32_t b_cls, b_mem, b_fp, b_loss;
  unsigned long long fp_threshold, loss_threshold;
};

// Per-peer state word: in shared memory, or in device memory (atomics go
// to L2, so reads skip L1).
template <bool kSmem>
__device__ __forceinline__ int32_t load_state(const int32_t* p) {
  if constexpr (kSmem) {
    return *p;
  } else {
    return __ldcg(p);
  }
}

__device__ __forceinline__ float u01(uint32_t h) {
  return __fmul_rn((float)(h >> 8), 0x1p-24f);
}

// The block's sum (or max) of one value per thread; uses 32 words of tmp.
template <bool kMax>
__device__ __forceinline__ int block_reduce(int v, int32_t* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int y = __shfl_xor_sync(kFull, v, d);
    v = kMax ? max(v, y) : v + y;
  }
  if (lane == 0) tmp[warp] = v;
  __syncthreads();
  int r = tmp[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    r = kMax ? max(r, tmp[w]) : r + tmp[w];
  __syncthreads();  // tmp is reused by the next call
  return r;
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads) pull_exchange_kernel(
    const uint8_t* __restrict__ reached, const int32_t* __restrict__ dist,
    const uint8_t* __restrict__ failed, const int32_t* __restrict__ side,
    const int32_t* __restrict__ perm, const int32_t* __restrict__ cstart,
    const int32_t* __restrict__ ccount, const float* __restrict__ cdf,
    const uint8_t* __restrict__ adaptive_on, int32_t* __restrict__ pull_hop,
    int32_t* __restrict__ egress, int32_t* __restrict__ ingress,
    int32_t* __restrict__ counts, int32_t* __restrict__ scratch, Round r) {
  extern __shared__ int32_t smem[];
  __shared__ float s_cdf[kClasses];
  __shared__ int32_t s_start[kClasses], s_count[kClasses];
  __shared__ int32_t s_tmp[32];
  const int o = blockIdx.x, n = r.n;
  int32_t* state = kSmem ? smem : scratch + (size_t)o * 4 * n;
  int32_t* req_in = state;        // requests arrived at each peer
  int32_t* resp_out = state + n;  // responses each peer sent
  int32_t* kth = state + 2 * n;   // a crowded peer's cap-th smallest key
  int32_t* next = state + 3 * n;  // the key a pass finds
  const size_t row = (size_t)o * n;
  const uint8_t* reached_o = reached + row;
  const int32_t* dist_o = dist + row;
  const uint8_t* failed_o = failed + row;

  for (int i = threadIdx.x; i < kClasses; i += blockDim.x) {
    s_cdf[i] = cdf[i];
    s_start[i] = cstart[i];
    s_count[i] = ccount[i];
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    req_in[i] = 0;
    resp_out[i] = 0;
  }
  const bool gate =
      r.pull_on && r.fanout > 0 && (adaptive_on == nullptr || adaptive_on[o]);
  __syncthreads();

  // the peer of (node, slot); it does not depend on the origin
  auto draw = [&](int node, int slot) -> int {
    const float u_cls = u01(edge_u32(r.b_cls, node, slot));
    int cls = 0;
#pragma unroll
    for (int c = 0; c < kClasses - 1; ++c) cls += u_cls >= s_cdf[c];
    const int st = s_start[cls], cnt = s_count[cls];
    const float u_mem = u01(edge_u32(r.b_mem, node, slot));
    int pos = st + (int)floorf(__fmul_rn(u_mem, (float)cnt));
    pos = min(min(pos, st + max(cnt - 1, 0)), n - 1);
    return __ldg(perm + pos);
  };
  // 0 not sent (self-draw, failed peer), 1 arrived, 2 suppressed,
  // 3 dropped; the caller checks the slot and the requester
  auto gate_request = [&](int node, int peer) -> int {
    if (peer == node || failed_o[peer]) return 0;
    if (r.part_on && __ldg(side + node) != __ldg(side + peer)) return 2;
    if (r.has_loss &&
        (unsigned long long)edge_u32(r.b_loss, node, peer) < r.loss_threshold)
      return 3;
    return 1;
  };

  // 1. requests
  int n_arrived = 0, n_sup = 0, n_drop = 0;
  for (int node = threadIdx.x; node < n; node += blockDim.x) {
    int a = 0;
    if (gate && !failed_o[node]) {
      for (int slot = 0; slot < r.fanout; ++slot) {
        const int peer = draw(node, slot);
        const int g = gate_request(node, peer);
        if (g == 1) {
          atomicAdd(req_in + peer, 1);
          ++a;
        }
        n_sup += g == 2;
        n_drop += g == 3;
      }
    }
    egress[row + node] = a;
    n_arrived += a;
  }
  __syncthreads();

  // 2. the cap: kth[p] = the cap-th smallest key of each peer that received
  // more than the cap (pass k keeps the least key above pass k - 1's)
  int most = 0;
  if (gate && r.cap > 0) {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      most = max(most, load_state<kSmem>(req_in + i));
  }
  most = block_reduce<true>(most, s_tmp);
  const bool ranked = gate && r.cap > 0 && most > r.cap;
  if (ranked) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) kth[i] = -1;
    for (int pass = 0; pass < r.cap; ++pass) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) next[i] = kNoKey;
      __syncthreads();
      for (int node = threadIdx.x; node < n; node += blockDim.x) {
        if (failed_o[node]) continue;
        for (int slot = 0; slot < r.fanout; ++slot) {
          const int peer = draw(node, slot);
          if (load_state<kSmem>(req_in + peer) <= r.cap ||
              gate_request(node, peer) != 1)
            continue;
          const int key = node * r.fanout + slot;
          if (key > load_state<kSmem>(kth + peer)) atomicMin(next + peer, key);
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        kth[i] = load_state<kSmem>(next + i);
    }
    __syncthreads();
  }

  // 3. responses
  int n_resp = 0, n_rescued = 0;
  for (int node = threadIdx.x; node < n; node += blockDim.x) {
    int best = kInf, t = 0;
    if (gate && !failed_o[node] && !reached_o[node] &&
        (unsigned long long)node_u32(r.b_fp, node) >= r.fp_threshold) {
      for (int slot = 0; slot < r.fanout; ++slot) {
        const int peer = draw(node, slot);
        if (gate_request(node, peer) != 1 || !reached_o[peer]) continue;
        if (ranked && load_state<kSmem>(req_in + peer) > r.cap &&
            node * r.fanout + slot > load_state<kSmem>(kth + peer))
          continue;
        atomicAdd(resp_out + peer, 1);
        ++t;
        best = min(best, __ldg(dist_o + peer) + 1);
      }
    }
    pull_hop[row + node] = best;
    ingress[row + node] = t;
    n_resp += t;
    n_rescued += best < kInf;
  }
  __syncthreads();

  // 4. the peers' side of the messages, and the counts
  for (int node = threadIdx.x; node < n; node += blockDim.x) {
    egress[row + node] += load_state<kSmem>(resp_out + node);
    ingress[row + node] += load_state<kSmem>(req_in + node);
  }
  const int c_arr = block_reduce<false>(n_arrived, s_tmp);
  const int c_resp = block_reduce<false>(n_resp, s_tmp);
  const int c_drop = block_reduce<false>(n_drop, s_tmp);
  const int c_sup = block_reduce<false>(n_sup, s_tmp);
  const int c_resc = block_reduce<false>(n_rescued, s_tmp);
  if (threadIdx.x == 0) {
    int32_t* c = counts + (size_t)o * kCounts;
    c[0] = c_arr;
    c[1] = c_resp;
    c[2] = c_arr - c_resp;
    c[3] = c_drop;
    c[4] = c_sup;
    c[5] = c_resc;
  }
}

template <bool kSmem>
cudaError_t launch(const uint8_t* reached, const int32_t* dist,
                   const uint8_t* failed, const int32_t* side,
                   const int32_t* perm, const int32_t* cstart,
                   const int32_t* ccount, const float* cdf,
                   const uint8_t* adaptive_on, int32_t* pull_hop,
                   int32_t* egress, int32_t* ingress, int32_t* counts,
                   int32_t* scratch, int o, int smem, const Round& r,
                   cudaStream_t stream) {
  if (kSmem && smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pull_exchange_kernel<kSmem>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  pull_exchange_kernel<kSmem><<<o, kThreads, smem, stream>>>(
      reached, dist, failed, side, perm, cstart, ccount, cdf, adaptive_on,
      pull_hop, egress, ingress, counts, scratch, r);
  return cudaGetLastError();
}

}  // namespace

// One block per origin.  scratch null: the per-peer state (4 n words) in
// smem bytes of dynamic shared memory; else in scratch (4 n words per
// origin) and smem 0.  The keys node * fanout + slot must fit int32, and
// the thresholds lie in [0, 2^32] (kernels/pull_exchange.py checks both).
extern "C" int pull_exchange_launch(
    const uint8_t* reached, const int32_t* dist, const uint8_t* failed,
    const int32_t* side, const int32_t* perm, const int32_t* cstart,
    const int32_t* ccount, const float* cdf, const uint8_t* adaptive_on,
    int32_t* pull_hop, int32_t* egress, int32_t* ingress, int32_t* counts,
    int32_t* scratch, int o, int n, int fanout, int pull_on, int cap,
    int part_on, int has_loss, uint32_t b_cls, uint32_t b_mem,
    uint32_t b_fp, uint32_t b_loss, unsigned long long fp_threshold,
    unsigned long long loss_threshold, int smem, cudaStream_t stream) {
  if (o < 1 || n < 1 || fanout < 0 ||
      (long long)n * fanout >= 0x7FFFFFFFLL ||
      (scratch == nullptr ? smem < 16LL * n : smem != 0))
    return (int)cudaErrorInvalidValue;
  const Round r{n,    fanout, pull_on, cap,          part_on,       has_loss,
                b_cls, b_mem, b_fp,   b_loss,       fp_threshold, loss_threshold};
  return (int)(scratch == nullptr
                   ? launch<true>(reached, dist, failed, side, perm, cstart,
                                  ccount, cdf, adaptive_on, pull_hop, egress,
                                  ingress, counts, scratch, o, smem, r, stream)
                   : launch<false>(reached, dist, failed, side, perm, cstart,
                                   ccount, cdf, adaptive_on, pull_hop, egress,
                                   ingress, counts, scratch, o, smem, r,
                                   stream));
}
