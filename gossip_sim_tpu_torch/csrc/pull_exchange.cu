// pull_exchange — the pull (anti-entropy) phase of one round.
//
// Replaces the reference engine's `round/pull` block
// (gossip_sim_tpu/engine/core.py:1012-1180: the [N, PS] peer draw, the
// request gates, two pseudo-entry stable sorts that rank the arrived
// requests per peer and count them, the response decision and the
// per-requester best hop) and the delivery view the round stats build from
// it (core.py:1182-1190).  The plain PyTorch version is
// kernels/pull_exchange.py pull_exchange_plain.
//
// Input:  reached [O, N] u8 and dist [O, N] i32 (this round's push BFS),
//         failed [O, N] u8, side [N + 1] i32 of 0 and 1 (read only while
//         the partition is on), the sampler's perm [N], class_start and
//         class_count [25] i32 and top-entry CDF [25] f32, adaptive_on [O]
//         u8 (null outside the adaptive mode), the round's hash bases and
//         thresholds.
// Output: pull_hop [O, N] i32, the least dist[peer] + 1 over the requests
//         that transferred the value to the node (kInf for none);
//         egress [O, N] i32 = requests arrived from the node + responses
//         the node sent; ingress [O, N] i32 = requests the node received +
//         transfers to it; reached_all [O, N] u8 = reached or a transfer;
//         dist_all [O, N] i32 = dist where reached, else pull_hop;
//         counts [O, 6] i32 = requests arrived, responses, misses (arrived
//         - responses), dropped, suppressed, rescued (nodes with a
//         transfer).
// Scratch: the per-peer state of each origin in device memory, where the
//         cluster's shared memory does not hold it.
//
// Every decision but one is a stateless hash of (node, slot) or (node,
// peer), so the order of the threads does not matter:
//   peer      (class_draw.cuh) cls = #{c < 24 : u_cls >= cdf[c]},
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
// ranks nothing.  The result does not depend on the order of the atomics.
//
// Design for the H100.  The exchange is a chain of dependent loads per
// request (two hashes, perm, the peer's failed and side bits, an atomic on
// the peer's count, its reached bit, its dist), about a hundred integer
// instructions each; what bounds it is latency and the SMs it reaches, not
// issue or bytes.  So:
//   * a thread block cluster of cs CTAs per origin (cs from O, chosen by
//     the wrapper so that the clusters fill the card in one wave);
//   * CTA r owns the node slice [r*S, (r+1)*S), S = ceil(N / cs), both as
//     requester (a thread per node walks its live slots) and as peer: the
//     per-peer words of its slice (requests in, responses out and, with
//     the cap on, the cap's two keys) and each node's own arrivals and
//     transfers live in its shared memory, and a request to another CTA's
//     peer is a distributed shared memory reduction (red.shared::cluster at
//     the peer's mapa address: nothing waits for it);
//   * the origin's failed and reached bytes, and the sides while the
//     partition is on, are staged as bitmaps of all N nodes in every CTA's
//     shared memory, so the gathers by peer hit shared memory; only
//     dist[peer] (read on a transfer) and perm stay device-memory gathers;
//   * each live request is drawn once per origin, a node's slots two at a
//     time, the class by a five-step search of integer thresholds (k >=
//     thr[c] exactly when u >= cdf[c]) where the CDF rises, as the
//     sampler's does: with the cap off, one fused pass draws, gates,
//     counts the arrival and decides the transfer;
//     with the cap on, phase 1 keeps each owned (node, live slot)'s peer
//     and its origin-independent gate (self-draw, partition, loss) in one
//     shared-memory word, which the cap's passes and phase 3 read (where
//     the words do not fit, the wrapper takes a larger cluster, and as the
//     last resort they are drawn again where used);
//   * cluster barriers order the phases; the six counts are summed per CTA
//     and gathered by rank 0, which writes counts[o] once, so nothing is
//     zeroed before the launch.
// Phases:
//   0. class tables; zero the slice's words; stage the bitmaps; barrier;
//   1. (cap off) each owned node's requests: draw, gate, count the arrival
//      at the peer, decide the transfer; write the node's outputs;
//   1. (cap on) draw, gate and keep; count arrivals; barrier; the largest
//      arrival count of the cluster (rank 0 gathers); barrier; if it passes
//      the cap, cap passes of the least key above the last, each closed by
//      two barriers; 3. the transfers, reading the kept words;
//   4. barrier; egress += responses sent, ingress += requests received;
//      the counts, summed per CTA and gathered by rank 0; barrier.
// Past the cluster's shared memory (N above ~206,000 with the cap off,
// ~142,000 with it on) the state goes to a device-memory scratch buffer
// (kSmem = false): the per-peer words there, the bytes read in place, the
// draws made where used.  Any N runs.  Bound on the H100: memory (the
// bytes in and the five planes out); the kernel sits well above it, with
// ~8-11 us of the phases' fixed cost at N=10,000 (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "class_draw.cuh"
#include "faults.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;    // the H100's non-portable cluster size
constexpr int kMiscWords = 128;    // kernels/pull_exchange.py MISC_WORDS
constexpr int32_t kInf = 1 << 20;  // engine/core.py INF
constexpr int32_t kNoKey = 0x7FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kCounts = 6;
// misc words: the class tables, this CTA's sums, rank 0's cluster sums,
// whether the class thresholds rise
constexpr int kThr = 0, kStart = 32, kCount = 64, kLocal = 96, kTotal = 104;
constexpr int kRising = 112;
// totals: arrived, responses, dropped, suppressed, rescued, most
constexpr int kSums = 5, kMost = 5;
// a drawn request's word: the peer, and its origin-independent gate in
// bits 30-31
constexpr uint32_t kPeerMask = (1u << 30) - 1;
constexpr uint32_t kOk = 0, kSelf = 1, kSup = 2, kDrop = 3;

struct Round {
  int n, fanout, pull_on, cap, part_on, has_loss;
  uint32_t b_cls, b_mem, b_fp, b_loss;
  unsigned long long fp_threshold, loss_threshold;
};

struct Geo {
  int cs, slen, keep;  // CTAs per origin, nodes per CTA, words kept
  float inv_slen;      // 1 / slen, for the owner of a peer
};

__device__ __forceinline__ bool bit(const uint32_t* b, int i) {
  return (b[i >> 5] >> (i & 31)) & 1u;
}

// Distributed shared memory by address: `local` in this CTA's shared
// memory -> the same word in CTA `rank` of the cluster; a reduction there
// that returns nothing (no wait), and a load.
__device__ __forceinline__ uint32_t cluster_addr(const int32_t* local,
                                                 int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"((uint32_t)__cvta_generic_to_shared(local)), "r"(rank));
  return out;
}
__device__ __forceinline__ void cluster_add(uint32_t addr, int v) {
  asm volatile("red.relaxed.cluster.shared::cluster.add.s32 [%0], %1;"
               :: "r"(addr), "r"(v));
}
__device__ __forceinline__ void cluster_min(uint32_t addr, int v) {
  asm volatile("red.relaxed.cluster.shared::cluster.min.s32 [%0], %1;"
               :: "r"(addr), "r"(v));
}
__device__ __forceinline__ int cluster_load(uint32_t addr) {
  int v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// 4 bytes of 0 / non-0 -> 4 bits, byte k to bit k
__device__ __forceinline__ uint32_t nibble(uint32_t x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// bits of row[base, base + 32) (0 past n): two 16-byte loads where the row
// is 16-byte aligned and the word lies inside it, else byte by byte
__device__ __forceinline__ uint32_t byte_bits(const uint8_t* row, int base,
                                              int n, bool vec) {
  if (vec && base + 32 <= n) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(row + base));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(row + base + 16));
    return nibble(a.x) | nibble(a.y) << 4 | nibble(a.z) << 8 |
           nibble(a.w) << 12 | nibble(b.x) << 16 | nibble(b.y) << 20 |
           nibble(b.z) << 24 | nibble(b.w) << 28;
  }
  uint32_t w = 0;
#pragma unroll 8
  for (int k = 0; k < 32; ++k)
    if (base + k < n && __ldg(row + base + k)) w |= 1u << k;
  return w;
}

// bits of side[base, base + 32) != 0 (0 past n): eight 16-byte loads
// where the word lies inside the table (16-byte aligned), else one by one
__device__ __forceinline__ uint32_t int_bits(const int32_t* side, int base,
                                             int n) {
  uint32_t w = 0;
  if (base + 32 <= n && (reinterpret_cast<uintptr_t>(side) & 15) == 0) {
    const int4* p = reinterpret_cast<const int4*>(side + base);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int4 v = __ldg(p + q);
      w |= (uint32_t)(v.x != 0) << (4 * q) |
           (uint32_t)(v.y != 0) << (4 * q + 1) |
           (uint32_t)(v.z != 0) << (4 * q + 2) |
           (uint32_t)(v.w != 0) << (4 * q + 3);
    }
    return w;
  }
#pragma unroll 8
  for (int k = 0; k < 32; ++k)
    if (base + k < n && __ldg(side + base + k)) w |= 1u << k;
  return w;
}

template <bool kSmem>
__global__ void __launch_bounds__(kMaxThreads) pull_exchange_kernel(
    const uint8_t* __restrict__ reached, const int32_t* __restrict__ dist,
    const uint8_t* __restrict__ failed, const int32_t* __restrict__ side,
    const int32_t* __restrict__ perm, const int32_t* __restrict__ cstart,
    const int32_t* __restrict__ ccount, const float* __restrict__ cdf,
    const uint8_t* __restrict__ adaptive_on, int32_t* __restrict__ pull_hop,
    int32_t* __restrict__ egress, int32_t* __restrict__ ingress,
    uint8_t* __restrict__ reached_all, int32_t* __restrict__ dist_all,
    int32_t* __restrict__ counts, int32_t* __restrict__ scratch, Round r,
    Geo g) {
  extern __shared__ __align__(16) int32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int o = blockIdx.x / g.cs;
  const int n = r.n, slen = g.slen, tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lo = min(n, rank * slen), hi = min(n, lo + slen);
  const bool capped = r.cap > 0;
  const int per_node = capped ? 4 : 2;
  const size_t row = (size_t)o * n;
  const uint8_t* reached_o = reached + row;
  const int32_t* dist_o = dist + row;
  const uint8_t* failed_o = failed + row;

  const int32_t* s_thr = sm + kThr;  // 24 class thresholds, then kNoKey
  const int32_t* s_start = sm + kStart;
  const int32_t* s_count = sm + kCount;
  const int nw = (n + 31) >> 5;
  uint32_t* fbits = reinterpret_cast<uint32_t*>(sm + kMiscWords);
  uint32_t* rbits = fbits + nw;
  uint32_t* sbits = rbits + nw;
  // the per-peer words: of this CTA's slice in shared memory (index node -
  // lo), or of the whole origin in scratch (index node)
  int32_t* state = kSmem ? sm + kMiscWords + 3 * nw
                         : scratch + (size_t)o * per_node * n;
  const int span = kSmem ? slen : n;
  int32_t* req_in = state;               // requests arrived at each peer
  int32_t* resp_out = state + span;      // responses each peer sent
  int32_t* kth = state + 2 * span;       // a crowded peer's cap-th key
  int32_t* nxt = state + 3 * span;       // the key a pass finds
  // a node's own arrivals and transfers, a | t << 16 (shared memory only)
  int32_t* carry = state + per_node * span;
  uint32_t* words =                      // kept draws, [slot][node - lo]
      reinterpret_cast<uint32_t*>(carry + span);
  const int base = kSmem ? lo : 0;       // index of node `lo` in the words

  // `peer`'s word of array `a`: (owner rank, offset) in the shared memory
  // of the CTA that owns it, or (0, peer) in scratch
  struct Slot {
    int rank, off;
  };
  auto owner = [&](int peer) -> Slot {
    if constexpr (kSmem) {
      int pr = __float2int_rz(__int2float_rn(peer) * g.inv_slen);
      while (pr * slen > peer) --pr;
      while ((pr + 1) * slen <= peer) ++pr;
      return {pr, peer - pr * slen};
    } else {
      return {0, peer};
    }
  };
  auto add_at = [&](int32_t* a, Slot p, int v) {
    if constexpr (kSmem) {
      cluster_add(cluster_addr(a + p.off, p.rank), v);
    } else {
      atomicAdd(a + p.off, v);
    }
  };
  auto min_at = [&](int32_t* a, Slot p, int v) {
    if constexpr (kSmem) {
      cluster_min(cluster_addr(a + p.off, p.rank), v);
    } else {
      atomicMin(a + p.off, v);
    }
  };
  // word `i` of this CTA's own slice of array `a`
  auto own = [&](const int32_t* a, int i) -> int {
    if constexpr (kSmem) {
      return a[i - lo];
    } else {
      return __ldcg(a + i);
    }
  };
  auto get_at = [&](const int32_t* a, Slot p) -> int {
    if constexpr (kSmem) {
      return cluster_load(cluster_addr(a + p.off, p.rank));
    } else {
      return __ldcg(a + p.off);  // atomics went to L2; skip L1
    }
  };
  auto failed_of = [&](int i) -> bool {
    if constexpr (kSmem) {
      return bit(fbits, i);
    } else {
      return failed_o[i] != 0;
    }
  };
  auto reached_of = [&](int i) -> bool {
    if constexpr (kSmem) {
      return bit(rbits, i);
    } else {
      return reached_o[i] != 0;
    }
  };
  auto side_differs = [&](int a, int b) -> bool {
    if constexpr (kSmem) {
      return bit(sbits, a) != bit(sbits, b);
    } else {
      return __ldg(side + a) != __ldg(side + b);
    }
  };

  // 0. class tables, sums, the slice's words, the bitmaps
  stage_class_tables(tid, nthreads, cstart, ccount, cdf, sm + kThr,
                     sm + kStart, sm + kCount, sm + kRising);
  if (tid < 8) {
    sm[kLocal + tid] = 0;
    sm[kTotal + tid] = 0;
  }
  for (int i = lo + tid; i < hi; i += nthreads) {
    req_in[i - base] = 0;
    resp_out[i - base] = 0;
    if (kSmem) carry[i - lo] = 0;
    if (capped) {
      kth[i - base] = -1;
      nxt[i - base] = kNoKey;
    }
  }
  const bool gate =
      r.pull_on && r.fanout > 0 && (adaptive_on == nullptr || adaptive_on[o]);
  const bool part = gate && r.part_on;
  if constexpr (kSmem) {
    const bool fvec = (reinterpret_cast<uintptr_t>(failed_o) & 15) == 0;
    const bool rvec = (reinterpret_cast<uintptr_t>(reached_o) & 15) == 0;
    for (int w = tid; w < nw; w += nthreads) {
      fbits[w] = byte_bits(failed_o, 32 * w, n, fvec);
      rbits[w] = byte_bits(reached_o, 32 * w, n, rvec);
      if (part) sbits[w] = int_bits(side, 32 * w, n);
    }
  }
  // every CTA of the cluster runs and has zeroed its words
  cluster.sync();
  const bool rising = sm[kRising];

  // the peer of (node, slot) and its origin-independent gate
  // (the class: #{c < 24 : k >= thr[c]}, by five halvings where the
  // thresholds rise, as the sampler's CDF does)
  auto draw = [&](int node, int slot) -> uint32_t {
    const int peer = class_draw(edge_u32(r.b_cls, node, slot),
                                edge_u32(r.b_mem, node, slot), s_thr, s_start,
                                s_count, rising, perm, n);
    uint32_t code = kOk;
    if (peer == node)
      code = kSelf;
    else if (part && side_differs(node, peer))
      code = kSup;
    else if (r.has_loss && (unsigned long long)edge_u32(r.b_loss, node,
                                                         peer) <
                               r.loss_threshold)
      code = kDrop;
    return (uint32_t)peer | code << 30;
  };
  // a node's own arrivals `a` and transfers `t`, for phase 4: in shared
  // memory, or in the egress and ingress planes
  auto note = [&](int i, int a, int t) {
    if constexpr (kSmem) {
      carry[i - lo] += a | t << 16;
    } else {
      if (a >= 0) egress[row + i] = a;
      if (t >= 0) ingress[row + i] = t;
    }
  };
  // a node's outputs but the peers' side of its messages (phase 4)
  auto finish = [&](int i, int t, int best) {
    const bool got = best < kInf;
    const bool ri = reached_of(i);
    pull_hop[row + i] = best;
    reached_all[row + i] = ri || got;
    dist_all[row + i] = ri ? __ldg(dist_o + i) : best;
  };

  int n_arr = 0, n_resp = 0, n_drop = 0, n_sup = 0, n_resc = 0;
  // the draws of a node's slots two at a time (their loads in flight
  // together); past the fanout a self-draw, which sends nothing
  auto draw2 = [&](int i, int slot, uint32_t& w0, uint32_t& w1) {
    w0 = draw(i, slot);
    w1 = slot + 1 < r.fanout ? draw(i, slot + 1) : (uint32_t)i | kSelf << 30;
  };
  // a drawn request: 1 if it arrives (counted at its peer), else 0, with
  // the suppressed and dropped counts
  auto arrive = [&](uint32_t w) -> int {
    const int peer = (int)(w & kPeerMask);
    const uint32_t code = w >> 30;
    if (code == kSelf || failed_of(peer)) return 0;
    n_sup += code == kSup;
    n_drop += code == kDrop;
    if (code != kOk) return 0;
    add_at(req_in, owner(peer), 1);
    return 1;
  };

  if (!capped) {
    // 1. one pass: each owned node's requests and its transfers
    for (int i = lo + tid; i < hi; i += nthreads) {
      int a = 0, t = 0, best = kInf;
      if (gate && !failed_of(i)) {
        const bool want =
            !reached_of(i) &&
            (unsigned long long)node_u32(r.b_fp, i) >= r.fp_threshold;
        auto transfer = [&](uint32_t w) {
          const int peer = (int)(w & kPeerMask);
          if (!want || !reached_of(peer)) return;
          add_at(resp_out, owner(peer), 1);
          ++t;
          best = min(best, __ldg(dist_o + peer) + 1);
        };
        for (int slot = 0; slot < r.fanout; slot += 2) {
          uint32_t w0, w1;
          draw2(i, slot, w0, w1);
          if (arrive(w0)) {
            ++a;
            transfer(w0);
          }
          if (arrive(w1)) {
            ++a;
            transfer(w1);
          }
        }
      }
      note(i, a, t);
      finish(i, t, best);
      n_arr += a;
      n_resp += t;
      n_resc += best < kInf;
    }
  } else {
    // 1. requests: draw, gate, keep; count the arrivals
    for (int i = lo + tid; i < hi; i += nthreads) {
      int a = 0;
      if (gate && !failed_of(i)) {
        for (int slot = 0; slot < r.fanout; slot += 2) {
          uint32_t w0, w1;
          draw2(i, slot, w0, w1);
          if (g.keep) {
            words[slot * slen + (i - lo)] = w0;
            if (slot + 1 < r.fanout) words[(slot + 1) * slen + (i - lo)] = w1;
          }
          a += arrive(w0) + arrive(w1);
        }
      }
      note(i, a, kSmem ? 0 : -1);
      n_arr += a;
    }
    auto word = [&](int i, int slot) -> uint32_t {
      return g.keep ? words[slot * slen + (i - lo)] : draw(i, slot);
    };
    cluster.sync();

    // 2. the cap: the largest arrival count of the cluster; if it passes
    // the cap, kth[p] = the cap-th smallest key of each peer that
    // received more (pass k keeps the least key above pass k - 1's)
    int most = 0;
    if (gate)
      for (int i = lo + tid; i < hi; i += nthreads)
        most = max(most, own(req_in, i));
    most = __reduce_max_sync(kFull, most);
    if ((tid & 31) == 0 && most > 0) atomicMax(sm + kLocal + kMost, most);
    __syncthreads();
    if (tid == 0 && sm[kLocal + kMost] > 0)
      atomicMax(cluster.map_shared_rank(sm + kTotal + kMost, 0),
                sm[kLocal + kMost]);
    cluster.sync();
    const bool ranked =
        gate && *cluster.map_shared_rank(sm + kTotal + kMost, 0) > r.cap;
    if (ranked) {
      for (int pass = 0; pass < r.cap; ++pass) {
        for (int i = lo + tid; i < hi; i += nthreads) {
          if (failed_of(i)) continue;
          for (int slot = 0; slot < r.fanout; ++slot) {
            const uint32_t w = word(i, slot);
            const int peer = (int)(w & kPeerMask);
            if ((w >> 30) != kOk || failed_of(peer)) continue;
            const Slot p = owner(peer);
            if (get_at(req_in, p) <= r.cap) continue;
            const int key = i * r.fanout + slot;
            if (key > get_at(kth, p)) min_at(nxt, p, key);
          }
        }
        cluster.sync();
        for (int i = lo + tid; i < hi; i += nthreads) {
          kth[i - base] = own(nxt, i);
          nxt[i - base] = kNoKey;
        }
        cluster.sync();
      }
    }

    // 3. transfers
    for (int i = lo + tid; i < hi; i += nthreads) {
      int t = 0, best = kInf;
      if (gate && !failed_of(i) && !reached_of(i) &&
          (unsigned long long)node_u32(r.b_fp, i) >= r.fp_threshold) {
        for (int slot = 0; slot < r.fanout; ++slot) {
          const uint32_t w = word(i, slot);
          const int peer = (int)(w & kPeerMask);
          if ((w >> 30) != kOk || failed_of(peer) || !reached_of(peer))
            continue;
          const Slot p = owner(peer);
          if (ranked && get_at(req_in, p) > r.cap &&
              i * r.fanout + slot > get_at(kth, p))
            continue;
          add_at(resp_out, p, 1);
          ++t;
          best = min(best, __ldg(dist_o + peer) + 1);
        }
      }
      note(i, kSmem ? 0 : -1, t);
      finish(i, t, best);
      n_resp += t;
      n_resc += best < kInf;
    }
  }
  cluster.sync();

  // 4. the peers' side of the messages, and the counts
  for (int i = lo + tid; i < hi; i += nthreads) {
    if constexpr (kSmem) {
      const int c = carry[i - lo];
      egress[row + i] = (c & 0xFFFF) + resp_out[i - lo];
      ingress[row + i] = (c >> 16) + req_in[i - lo];
    } else {
      egress[row + i] += __ldcg(resp_out + i);
      ingress[row + i] += __ldcg(req_in + i);
    }
  }
  const int sums[kSums] = {n_arr, n_resp, n_drop, n_sup, n_resc};
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    const int v = __reduce_add_sync(kFull, sums[k]);
    if ((tid & 31) == 0 && v) atomicAdd(sm + kLocal + k, v);
  }
  __syncthreads();
  if (tid < kSums && sm[kLocal + tid])
    atomicAdd(cluster.map_shared_rank(sm + kTotal + tid, 0),
              sm[kLocal + tid]);
  // no CTA leaves while rank 0's sums are written to
  cluster.sync();
  if (rank == 0 && tid == 0) {
    const int32_t* t = sm + kTotal;
    int32_t* c = counts + (size_t)o * kCounts;
    c[0] = t[0];
    c[1] = t[1];
    c[2] = t[0] - t[1];
    c[3] = t[2];
    c[4] = t[3];
    c[5] = t[4];
  }
}

template <bool kSmem>
cudaError_t configure(int cs, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      pull_exchange_kernel<kSmem>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cs > 8)
    err = cudaFuncSetAttribute(
        pull_exchange_kernel<kSmem>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchConfig_t config(cudaLaunchAttribute* attr, int grid, int cs,
                          int threads, int smem, cudaStream_t stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kSmem>
cudaError_t launch(const uint8_t* reached, const int32_t* dist,
                   const uint8_t* failed, const int32_t* side,
                   const int32_t* perm, const int32_t* cstart,
                   const int32_t* ccount, const float* cdf,
                   const uint8_t* adaptive_on, int32_t* pull_hop,
                   int32_t* egress, int32_t* ingress, uint8_t* reached_all,
                   int32_t* dist_all, int32_t* counts, int32_t* scratch,
                   int o, int threads, int smem, const Round& r,
                   const Geo& g, cudaStream_t stream) {
  cudaError_t err = configure<kSmem>(g.cs, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(attr, o * g.cs, g.cs, threads, smem, stream);
  err = cudaLaunchKernelEx(&cfg, pull_exchange_kernel<kSmem>, reached, dist,
                           failed, side, perm, cstart, ccount, cdf,
                           adaptive_on, pull_hop, egress, ingress,
                           reached_all, dist_all, counts, scratch, r, g);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Clusters of `cs` CTAs of this launch shape that the card holds at once
// (kernels/pull_exchange.py launch_geometry reads it).
extern "C" int pull_exchange_max_clusters(int cs, int threads, int smem,
                                          int state_in_smem, int* clusters) {
  if (cs < 1 || cs > kMaxCluster || threads < 32 || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = state_in_smem ? configure<true>(cs, smem)
                                        : configure<false>(cs, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(attr, cs, cs, threads, smem, 0);
  return (int)cudaOccupancyMaxActiveClusters(
      clusters,
      state_in_smem ? (void*)pull_exchange_kernel<true>
                    : (void*)pull_exchange_kernel<false>,
      &cfg);
}

// A cluster of cs CTAs of `threads` threads per origin, each owning `slen`
// nodes.  scratch null: the per-peer words of each slice (2 a node, 4 with
// the cap on), the bitmaps (3 ceil(n / 32) words) and, with `keep`, the
// kept draws (fanout a node) in smem bytes of dynamic shared memory; else
// the per-peer words in scratch (2 or 4 n words per origin), nothing kept.
// The keys node * fanout + slot must fit int32, n < 2^30, and the
// thresholds lie in [0, 2^32] (kernels/pull_exchange.py checks them).
extern "C" int pull_exchange_launch(
    const uint8_t* reached, const int32_t* dist, const uint8_t* failed,
    const int32_t* side, const int32_t* perm, const int32_t* cstart,
    const int32_t* ccount, const float* cdf, const uint8_t* adaptive_on,
    int32_t* pull_hop, int32_t* egress, int32_t* ingress,
    uint8_t* reached_all, int32_t* dist_all, int32_t* counts,
    int32_t* scratch, int o, int n, int fanout, int pull_on, int cap,
    int part_on, int has_loss, uint32_t b_cls, uint32_t b_mem,
    uint32_t b_fp, uint32_t b_loss, unsigned long long fp_threshold,
    unsigned long long loss_threshold, int cs, int slen, int threads,
    int keep, int smem, cudaStream_t stream) {
  const bool in_smem = scratch == nullptr;
  const long long nw = (n + 31LL) / 32;
  const long long need =
      4LL * (kMiscWords +
             (in_smem ? 3 * nw + (cap > 0 ? 5LL : 3LL) * slen +
                            (keep ? (long long)fanout * slen : 0)
                      : 0));
  if (o < 1 || n < 1 || n >= (1 << 30) || fanout < 0 || fanout > 0xFFFF ||
      (long long)n * fanout >= 0x7FFFFFFFLL || cs < 1 || cs > kMaxCluster ||
      slen < 1 || (long long)slen * cs < n || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || smem < need ||
      (keep && (!in_smem || cap <= 0)))
    return (int)cudaErrorInvalidValue;
  const Round r{n,    fanout, pull_on, cap,          part_on,       has_loss,
                b_cls, b_mem, b_fp,   b_loss,       fp_threshold, loss_threshold};
  const Geo g{cs, slen, keep, 1.0f / (float)slen};
  return (int)(in_smem
                   ? launch<true>(reached, dist, failed, side, perm, cstart,
                                  ccount, cdf, adaptive_on, pull_hop, egress,
                                  ingress, reached_all, dist_all, counts,
                                  scratch, o, threads, smem, r, g, stream)
                   : launch<false>(reached, dist, failed, side, perm, cstart,
                                   ccount, cdf, adaptive_on, pull_hop, egress,
                                   ingress, reached_all, dist_all, counts,
                                   scratch, o, threads, smem, r, g, stream));
}
