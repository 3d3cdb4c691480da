// traffic_rescue — the adaptive traffic round's per-value pull rescue.
//
// Replaces the reference engine's `traffic/pull_rescue` block
// (gossip_sim_tpu/engine/traffic.py:424-619: the [V, N, PS] stake-weighted
// request draw, the egress continuation by a cumsum per requester, the
// request gates, one flat sort of every arrived request by (peer, flat
// order) with pseudo entries for the per-peer counts and a sort back, the
// response decision, the per-requester minimum and a pseudo-entry sort per
// peer for the responses it sent).  The plain PyTorch version is
// kernels/traffic_rescue.py traffic_rescue_plain.
//
// Input:  pull_on [V] u8 (value live and in its pull phase), vid [V] i32,
//         holder_pre [V, N] u8 and hop_pre [V, N] i32 (after injection,
//         before the push deliveries), holder [V, N] u8 (after them),
//         failed [N] u8, side [N + 1] i32 (read while the partition is
//         on), the draw's perm [N], class_start and class_count [25] i32
//         and CDF [25] f32, push_out [N] i32 (the round's push sends per
//         node), accepted_node [N] i32 (its push acceptances), the round's
//         hash bases and thresholds.
// Output: pull_del [V, N] u8 and pull_hop [V, N] i32 (the clamped hop of a
//         rescue, -1 for none); per_value [4, V] i32: served, responses,
//         rescued, queue drops; per_node [6, N] i32: requests sent,
//         requests deferred, responses received (requester side), requests
//         arrived, requests served, responses sent (peer side); counts
//         [12] i32: the round's eleven pull_* counts
//         (kernels/traffic_rescue.py COUNT_NAMES) and the clamped hops.
// Scratch: fill [N] and meta [2] (zeroed with the outputs' counters by one
//         memset), cut, offset and hard [N], eoff [8, N] (both caps on),
//         and the buckets, one key per arrived request (ingress cap on).
// Lanes: a batch of K sweep lanes (engine/traffic.py run_traffic_lanes)
//         runs in the same launches, the lane the y index of every grid.
//         Each plane above has a leading lane axis (side and the draw
//         tables are shared), and each lane its own fanout, caps, partition
//         window, hash bases and thresholds (lanes.cuh record).  A lane's
//         requests, budgets, cuts, buckets and counts are its own: its
//         budgets continue its own push sends and acceptances.  The count
//         and fill walks return at once in a lane without the ingress cap.
//         The serial round is K = 1.
//
// A request is (value v, requester r, slot s < fanout), its key the flat
// index (v * N + r) * fanout + s: the reference's flat (value, requester,
// slot) order.  Every decision but two is a stateless hash of (value,
// requester, slot) or (value, requester, peer) (faults.cuh, class_draw.cuh)
// and every sum an integer atomic, exact in any order.  The two that
// depend on order:
//   * egress: a request is sent when push_out[r] plus the requests r wanted
//     before it, in (value, slot) order, is below the egress cap;
//   * ingress: an arrived request is served when the push acceptances of
//     its peer plus its rank among the requests that arrived at the peer,
//     in key order, is below the ingress cap.  So the served requests of a
//     peer are a prefix of its arrivals in key order: one cut per peer, the
//     key of its first refused request (k = cap - acceptances; none served
//     for k <= 0, all for arrivals <= k; else the k-th smallest key).
//
// Design: up to five device operations, in order on the stream.
//   0. a memset of the counters (counts, per_value, per_node, fill, meta);
//   1. walk (count phase; ingress cap on only): a block per tile of 32
//      requesters, a lane per requester.  The block lists the pull-phase
//      values in value order in shared memory (a ballot per warp), and its
//      8 warps each take a contiguous, equal share of the list (values
//      that switch together sit in neighbouring slots, so a share of the
//      value axis would leave most warps idle).  With the egress cap on,
//      each warp first counts its lanes' wanted requests over its share
//      (drawing them), and the shares before it give each lane its running
//      count (kept in eoff for the walks after it).  Then each lane walks
//      its share's values it misses in (value, slot) order: the draw, the
//      egress budget, failed peer > partition > request loss, and each
//      arrival adds one to its peer's count (one atomic per peer among the
//      lanes that reach it together: stake-weighted draws repeat the hub
//      peers).  The last block to finish (a ticket)
//      classifies every peer: its cut where the cap refuses all or none,
//      and for the others a bucket sized from its count, placed by a block
//      scan, and its place in the list of peers to select;
//   2. walk (fill phase): the same walk writes each arrival at a listed
//      peer into the peer's bucket (a slot by an atomic on fill);
//   3. select: a block per listed peer (a grid of two blocks per SM
//      striding the list) finds the k-th smallest key of its bucket by a
//      radix select, 8 bits a pass, with a histogram in shared memory: a
//      hub peer with thousands of requests costs a few passes over them;
//   4. walk (final phase): the block first writes its tile's entries of the
//      values not in their pull phase (none rescued); the same walk then
//      decides each arrival (the cut, or all with the cap off), the
//      response (the peer held the value before the deliveries and the
//      requester's bloom hash did not false-positive) and the minimum
//      ((clamped hop << 1 | clamp) << pb | peer) over the requester's
//      slots, and writes pull_del (push deliveries win ties) and pull_hop
//      of the pull-phase values; the sums go to the outputs by warp
//      reductions and atomics.
// With the ingress cap off only 0 and 4 run.
//
// Bound on the H100: the hashes (class, member and loss edge hashes per
// live request, a bloom node hash per (value, requester)) or the bytes (the
// pull-phase values' holder_pre, hop_pre and holder rows and the outputs),
// whichever is larger (chip_smoke.py).  The walks are chains of dependent
// loads (holder byte, draw, perm, the peer's bytes) with most lanes idle
// (only the requesters missing a value work), and each walk draws its
// requests again: latency, not bytes, sets the time (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "class_draw.cuh"
#include "faults.cuh"
#include "lanes.cuh"

namespace {

constexpr int kWarps = 8;                // value chunks of a requester tile
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int32_t kBig = 0x7FFFFFFF;     // no response; serve all
constexpr int32_t kListed = -1;          // cut of a peer to select
constexpr uint32_t kGold = 0x9E3779B1u;  // traffic.py value_basis

// kernels/traffic_rescue.py COUNT_NAMES, VALUE_ROWS and NODE_ROWS
enum Count {
  cSent, cDeferred, cFailedTarget, cSuppressed, cDropped, cArrived,
  cQueueDropped, cServed, cResponses, cRescued, cActive, cClamped, kCounts
};
enum ValueRow { vServed, vResponses, vRescued, vQdrop, kValueRows };
enum NodeRow { nSent, nDeferred, nRespIn, nArrived, nServed, nRespOut };
enum Phase { kCount, kFill, kFinal };

struct Args {
  const uint8_t* pull_on;
  const int32_t* vid;
  const uint8_t* holder_pre;
  const int32_t* hop_pre;
  const uint8_t* holder;
  const uint8_t* failed;
  const int32_t* side;
  const int32_t* perm;
  const int32_t* cstart;
  const int32_t* ccount;
  const float* cdf;
  const int32_t* push_out;
  const int32_t* accepted_node;
  uint8_t* pull_del;
  int32_t* pull_hop;
  int32_t* counts;
  int32_t* per_value;
  int32_t* per_node;
  int32_t* fill;
  int32_t* meta;    // block ticket, listed peers
  int32_t* cut;
  int32_t* offset;
  int32_t* listed;
  int32_t* eoff;
  int32_t* bucket;
  int v, n, fanout, hist, pb, ecap, icap, part_on, has_loss, key_bits;
  uint32_t b_cls, b_mem, b_loss, b_bloom;
  unsigned long long loss_thr, bloom_thr;
  int fmax;  // the widest lane's fanout: the stride of a lane's buckets
};

// one lane's knobs (kernels/traffic_rescue.py LANE_DTYPE)
struct RescueLane {
  unsigned long long loss_thr, bloom_thr;
  int32_t fanout, ecap, icap, part_on;
  uint32_t b_cls, b_mem, b_loss, b_bloom;
};
using RescueLanes = LaneArray<RescueLane>;

constexpr int kCountWords = 16;  // a lane's counts, padded
constexpr int kMetaWords = 4;    // a lane's ticket and listed peers, padded

// The arguments of lane k: its knobs, and every plane at its lane (the
// planes carry a leading lane axis; side and the draw tables are shared).
__device__ __forceinline__ Args lane_args(const Args& a0,
                                          const RescueLanes& lanes, int k) {
  Args a = a0;
  const RescueLane& l = lanes.l[k];
  a.fanout = l.fanout;
  a.ecap = l.ecap;
  a.icap = l.icap;
  a.part_on = l.part_on;
  a.b_cls = l.b_cls;
  a.b_mem = l.b_mem;
  a.b_loss = l.b_loss;
  a.b_bloom = l.b_bloom;
  a.loss_thr = l.loss_thr;
  a.bloom_thr = l.bloom_thr;
  const size_t kv = (size_t)k * a0.v, kn = (size_t)k * a0.n;
  a.pull_on += kv;
  a.vid += kv;
  a.holder_pre += kv * a0.n;
  a.hop_pre += kv * a0.n;
  a.holder += kv * a0.n;
  a.failed += kn;
  a.push_out += kn;
  a.accepted_node += kn;
  a.pull_del += kv * a0.n;
  a.pull_hop += kv * a0.n;
  a.counts += (size_t)k * kCountWords;
  a.per_value += (size_t)kValueRows * kv;
  a.per_node += 6 * kn;
  a.fill += kn;
  a.meta += (size_t)k * kMetaWords;
  a.cut += kn;
  a.offset += kn;
  a.listed += kn;
  if (a.eoff != nullptr) a.eoff += (size_t)kWarps * kn;
  if (a.bucket != nullptr) a.bucket += kv * a0.n * a0.fmax;
  return a;
}

__device__ __forceinline__ uint32_t value_basis(uint32_t b, int32_t vid) {
  return fmix32(b ^ ((uint32_t)vid * kGold));
}

// One atomic per peer among the lanes that reach it together (a drawn hub
// peer repeats within a warp): the lowest lane of each group adds the
// group's size.
__device__ __forceinline__ void add_at(int32_t* row, int peer) {
  const unsigned group = __match_any_sync(__activemask(), peer);
  if ((int)(threadIdx.x & 31) == __ffs(group) - 1)
    atomicAdd(row + peer, __popc(group));
}

// A distinct slot of `peer`'s count for each lane that reaches it: one
// atomic per group of lanes with the same peer, then each lane's rank in
// its group.
__device__ __forceinline__ int slot_at(int32_t* count, int peer) {
  const unsigned group = __match_any_sync(__activemask(), peer);
  const int leader = __ffs(group) - 1;
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == leader) base = atomicAdd(count + peer, __popc(group));
  base = __shfl_sync(group, base, leader);
  return base + __popc(group & ((1u << lane) - 1u));
}

// The last block of the count walk: each peer's cut, and for the peers
// whose cap falls inside their arrivals a bucket (offset) and a place in
// the list.  A block scan of (listed << 32 | arrivals) over the peers.
__device__ void classify_peers(const Args& a,
                               unsigned long long* s_scan) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = a.n;
  unsigned long long carry = 0;
  for (int p0 = 0; p0 < n; p0 += kThreads) {
    const int p = p0 + tid;
    unsigned long long mine = 0;
    if (p < n) {
      const int c = __ldcg(a.per_node + (size_t)nArrived * n + p);
      const int k = a.icap - min(__ldg(a.accepted_node + p), a.icap);
      int cut = kListed;
      if (k <= 0)
        cut = 0;
      else if (c <= k)
        cut = kBig;
      else
        mine = (1ull << 32) | (unsigned)c;
      a.cut[p] = cut;
    }
    unsigned long long incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) s_scan[warp] = incl;
    __syncthreads();
    unsigned long long before = carry, total = carry;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += s_scan[w];
      total += s_scan[w];
    }
    if (mine) {
      const unsigned long long excl = before + incl - mine;
      a.offset[p] = (int32_t)(excl & 0xFFFFFFFFull);
      a.listed[excl >> 32] = p;
    }
    carry = total;
    __syncthreads();  // s_scan is reused
  }
  if (tid == 0) a.meta[1] = (int32_t)(carry >> 32);
}

template <int kPhase>
__global__ void __launch_bounds__(kThreads)
    traffic_rescue_walk_kernel(const Args a0,
                               const __grid_constant__ RescueLanes lanes) {
  // the block's lane (blockIdx.y); the count and fill walks only serve the
  // lanes with the ingress cap on
  const Args a = lane_args(a0, lanes, blockIdx.y);
  if (kPhase != kFinal && a.icap <= 0) return;  // whole block
  extern __shared__ int32_t s_pull[];  // the pull-phase values, ascending
  __shared__ int32_t s_thr[32], s_start[32], s_count[32], s_rising;
  __shared__ int32_t s_chunk[kWarps][32];
  __shared__ int32_t s_node[3][32];
  __shared__ int32_t s_warp[kWarps];
  __shared__ unsigned long long s_scan[kWarps];
  __shared__ int s_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = a.n, nv = a.v, F = a.fanout;
  const int node = blockIdx.x * 32 + lane;
  const bool in = node < n;
  const bool alive = in && !__ldg(a.failed + node);
  const bool icap_on = a.icap > 0, ecap_on = a.ecap > 0;
  const bool part = a.part_on != 0;
  stage_class_tables(tid, kThreads, a.cstart, a.ccount, a.cdf, s_thr,
                     s_start, s_count, &s_rising);
  if (tid < 3 * 32) s_node[tid >> 5][tid & 31] = 0;
  // the list of pull-phase values, in value order (a ballot per warp, a
  // scan of the warps' counts, carried across steps of 256 values)
  int pulls = 0;
  for (int base = 0; base < nv; base += kThreads) {
    const int v = base + tid;
    const bool on = v < nv && __ldg(a.pull_on + v);
    const unsigned bits = __ballot_sync(kFull, on);
    if (lane == 0) s_warp[warp] = __popc(bits);
    __syncthreads();
    int before = pulls;
    for (int w = 0; w < warp; ++w) before += s_warp[w];
    if (on) s_pull[before + __popc(bits & ((1u << lane) - 1u))] = v;
    for (int w = 0; w < kWarps; ++w) pulls += s_warp[w];
    __syncthreads();
  }
  if (kPhase == kFinal) {
    // the tile's entries of the values not in their pull phase; the walk
    // writes those of the others
    for (int i = tid; i < nv * 32; i += kThreads) {
      const int v = i >> 5, nd = blockIdx.x * 32 + (i & 31);
      if (nd < n && !__ldg(a.pull_on + v)) {
        a.pull_del[(size_t)v * n + nd] = 0;
        a.pull_hop[(size_t)v * n + nd] = -1;
      }
    }
  }
  const bool rising = s_rising != 0;
  // this warp's contiguous share of the list
  const int span = (pulls + kWarps - 1) / kWarps;
  const int p0 = min(pulls, warp * span), p1 = min(pulls, p0 + span);
  auto draw = [&](uint32_t bc, uint32_t bm, int s) -> int {
    return class_draw(edge_u32(bc, node, s), edge_u32(bm, node, s), s_thr,
                      s_start, s_count, rising, a.perm, n);
  };

  // the requests this lane's requester wanted before the warp's share,
  // plus its push sends
  int run = 0;
  if (ecap_on) {
    if (kPhase == kCount || !icap_on) {
      int wanted = 0;
      for (int i = p0; i < p1; ++i) {
        const int v = s_pull[i];
        if (!alive || __ldg(a.holder_pre + (size_t)v * n + node)) continue;
        const int32_t vid = __ldg(a.vid + v);
        const uint32_t bc = value_basis(a.b_cls, vid);
        const uint32_t bm = value_basis(a.b_mem, vid);
        for (int s = 0; s < F; ++s) wanted += draw(bc, bm, s) != node;
      }
      s_chunk[warp][lane] = wanted;
      __syncthreads();
      if (in) {
        run = __ldg(a.push_out + node);
        for (int w = 0; w < warp; ++w) run += s_chunk[w][lane];
        if (kPhase == kCount) a.eoff[(size_t)warp * n + node] = run;
      }
    } else if (in) {
      run = __ldg(a.eoff + (size_t)warp * n + node);
    }
  }

  int c_sent = 0, c_def = 0, c_ft = 0, c_sup = 0, c_drop = 0, c_arr = 0;
  int c_qd = 0, c_srv = 0, c_resp = 0, c_resc = 0, c_clamp = 0;
  int resp_in = 0;
  const int my_side = (part && in) ? __ldg(a.side + node) : 0;
  for (int i = p0; i < p1; ++i) {  // uniform in the warp
    const int v = s_pull[i];
    const size_t row = (size_t)v * n;
    const bool miss = alive && !__ldg(a.holder_pre + row + node);
    int served = 0, resp = 0, qdrop = 0, rescued = 0;
    if (miss) {
      const int32_t vid = __ldg(a.vid + v);
      const uint32_t bc = value_basis(a.b_cls, vid);
      const uint32_t bm = value_basis(a.b_mem, vid);
      const uint32_t bl = value_basis(a.b_loss, vid);
      const bool fp =
          kPhase == kFinal &&
          (unsigned long long)node_u32(value_basis(a.b_bloom, vid), node) <
              a.bloom_thr;
      int win = kBig;
      for (int s = 0; s < F; ++s) {
        const int peer = draw(bc, bm, s);
        if (peer == node) continue;
        const bool sent = !ecap_on || run < a.ecap;
        ++run;
        if (!sent) {
          ++c_def;
          continue;
        }
        ++c_sent;
        if (__ldg(a.failed + peer)) {
          ++c_ft;
          continue;
        }
        if (part && __ldg(a.side + peer) != my_side) {
          ++c_sup;
          continue;
        }
        if (a.has_loss &&
            (unsigned long long)edge_u32(bl, node, peer) < a.loss_thr) {
          ++c_drop;
          continue;
        }
        const int32_t key = (int32_t)((row + node) * F + s);
        if (kPhase == kCount) {
          add_at(a.per_node + (size_t)nArrived * n, peer);
          continue;
        }
        if (kPhase == kFill) {
          if (__ldg(a.cut + peer) == kListed) {
            const int slot = slot_at(a.fill, peer);
            a.bucket[(size_t)__ldg(a.offset + peer) + slot] = key;
          }
          continue;
        }
        ++c_arr;
        if (!icap_on) add_at(a.per_node + (size_t)nArrived * n, peer);
        if (icap_on && key >= __ldg(a.cut + peer)) {
          ++qdrop;
          continue;
        }
        ++served;
        add_at(a.per_node + (size_t)nServed * n, peer);
        if (fp || !__ldg(a.holder_pre + row + peer)) continue;
        ++resp;
        add_at(a.per_node + (size_t)nRespOut * n, peer);
        const int th = __ldg(a.hop_pre + row + peer) + 1;
        const int ch = min(th, a.hist - 1);
        win = min(win, (((ch << 1) | (th > a.hist - 1 ? 1 : 0)) << a.pb) |
                           peer);
      }
      if (kPhase == kFinal) {
        const bool del = win != kBig && !__ldg(a.holder + row + node);
        a.pull_del[row + node] = del ? 1 : 0;
        a.pull_hop[row + node] = del ? win >> (a.pb + 1) : -1;
        rescued = del ? 1 : 0;
        c_clamp += del && ((win >> a.pb) & 1);
        resp_in += resp;
      }
    } else if (kPhase == kFinal && in) {
      a.pull_del[row + node] = 0;
      a.pull_hop[row + node] = -1;
    }
    if (kPhase == kFinal) {
      c_srv += served;
      c_resp += resp;
      c_qd += qdrop;
      c_resc += rescued;
      const int sums[kValueRows] = {
          __reduce_add_sync(kFull, served), __reduce_add_sync(kFull, resp),
          __reduce_add_sync(kFull, rescued), __reduce_add_sync(kFull, qdrop)};
      if (lane == 0)
#pragma unroll
        for (int r = 0; r < kValueRows; ++r)
          if (sums[r]) atomicAdd(a.per_value + (size_t)r * nv + v, sums[r]);
    }
  }

  if (kPhase == kCount) {
    // the last block to finish classifies the peers
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(a.meta, 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (s_last) {
      __threadfence();
      classify_peers(a, s_scan);
    }
    return;
  }
  if (kPhase != kFinal) return;
  atomicAdd(&s_node[0][lane], c_sent);
  atomicAdd(&s_node[1][lane], c_def);
  atomicAdd(&s_node[2][lane], resp_in);
  const int mine[kCounts] = {c_sent, c_def, c_ft,   c_sup,  c_drop, c_arr,
                             c_qd,   c_srv, c_resp, c_resc, 0,      c_clamp};
#pragma unroll
  for (int i = 0; i < kCounts; ++i) {
    const int t = __reduce_add_sync(kFull, mine[i]);
    if (lane == 0 && t) atomicAdd(a.counts + i, t);
  }
  if (blockIdx.x == 0 && tid == 0) a.counts[cActive] = pulls;
  __syncthreads();
  if (warp == 0 && in) {
    a.per_node[(size_t)nSent * n + node] = s_node[0][lane];
    a.per_node[(size_t)nDeferred * n + node] = s_node[1][lane];
    a.per_node[(size_t)nRespIn * n + node] = s_node[2][lane];
  }
}

// A block per listed peer: the k-th smallest key (k = cap - acceptances,
// 0-based) of its bucket, by a radix select of 8 bits a pass.  Keys are
// distinct, so exactly k keys are below it.
__global__ void __launch_bounds__(kThreads)
    traffic_rescue_select_kernel(const Args a0,
                                 const __grid_constant__ RescueLanes lanes) {
  const Args a = lane_args(a0, lanes, blockIdx.y);  // its lane's list
  __shared__ int32_t hist[256];
  __shared__ int32_t s_sel[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = a.n;
  const int listed = a.meta[1];
  for (int h = blockIdx.x; h < listed; h += gridDim.x) {
    const int p = a.listed[h];
    const int c = a.per_node[(size_t)nArrived * n + p];
    int k = a.icap - min(a.accepted_node[p], a.icap);
    const int32_t* keys = a.bucket + a.offset[p];
    uint32_t prefix = 0, mask = 0;
    for (int shift = ((a.key_bits - 1) / 8) * 8; shift >= 0; shift -= 8) {
      for (int i = tid; i < 256; i += kThreads) hist[i] = 0;
      __syncthreads();
      for (int i = tid; i < c; i += kThreads) {
        const uint32_t key = (uint32_t)keys[i];
        if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255], 1);
      }
      __syncthreads();
      if (warp == 0) {
        int bins[8], sum = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          bins[j] = hist[lane * 8 + j];
          sum += bins[j];
        }
        int incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += t;
        }
        const int excl = incl - sum;
        if (excl <= k && k < incl) {
          int r = k - excl, d = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (d == j && r >= bins[j]) {
              r -= bins[j];
              d = j + 1;
            }
          }
          s_sel[0] = lane * 8 + d;
          s_sel[1] = r;
        }
      }
      __syncthreads();
      prefix |= (uint32_t)s_sel[0] << shift;
      mask |= 0xFFu << shift;
      k = s_sel[1];
      __syncthreads();
    }
    if (tid == 0) a.cut[p] = (int32_t)prefix;
  }
}

}  // namespace

// ptrs: the 25 pointers of Args in order, then the counters' base (each
// plane with a leading axis of nl lanes; the counters' regions lane-major:
// counts [nl, 16], per_value [nl, 4, v], per_node [nl, 6, n], fill [nl, n],
// meta [nl, 4]); vals: v, n, hist, pb, has_loss, key_bits (of the widest
// lane's keys), the widest fanout, the counters' bytes, the select grid;
// `lanes` points at nl RescueLane records in host memory.
extern "C" int traffic_rescue_launch(void* const* ptrs, const long long* vals,
                                     const void* lanes, int nl,
                                     cudaStream_t stream) {
  Args a = {};
  a.pull_on = static_cast<const uint8_t*>(ptrs[0]);
  a.vid = static_cast<const int32_t*>(ptrs[1]);
  a.holder_pre = static_cast<const uint8_t*>(ptrs[2]);
  a.hop_pre = static_cast<const int32_t*>(ptrs[3]);
  a.holder = static_cast<const uint8_t*>(ptrs[4]);
  a.failed = static_cast<const uint8_t*>(ptrs[5]);
  a.side = static_cast<const int32_t*>(ptrs[6]);
  a.perm = static_cast<const int32_t*>(ptrs[7]);
  a.cstart = static_cast<const int32_t*>(ptrs[8]);
  a.ccount = static_cast<const int32_t*>(ptrs[9]);
  a.cdf = static_cast<const float*>(ptrs[10]);
  a.push_out = static_cast<const int32_t*>(ptrs[11]);
  a.accepted_node = static_cast<const int32_t*>(ptrs[12]);
  a.pull_del = static_cast<uint8_t*>(ptrs[13]);
  a.pull_hop = static_cast<int32_t*>(ptrs[14]);
  a.counts = static_cast<int32_t*>(ptrs[15]);
  a.per_value = static_cast<int32_t*>(ptrs[16]);
  a.per_node = static_cast<int32_t*>(ptrs[17]);
  a.fill = static_cast<int32_t*>(ptrs[18]);
  a.meta = static_cast<int32_t*>(ptrs[19]);
  a.cut = static_cast<int32_t*>(ptrs[20]);
  a.offset = static_cast<int32_t*>(ptrs[21]);
  a.listed = static_cast<int32_t*>(ptrs[22]);
  a.eoff = static_cast<int32_t*>(ptrs[23]);
  a.bucket = static_cast<int32_t*>(ptrs[24]);
  void* zero = ptrs[25];
  a.v = (int)vals[0];
  a.n = (int)vals[1];
  a.hist = (int)vals[2];
  a.pb = (int)vals[3];
  a.has_loss = (int)vals[4];
  a.key_bits = (int)vals[5];
  a.fmax = (int)vals[6];
  const size_t zero_bytes = (size_t)vals[7];
  const unsigned select_blocks = (unsigned)vals[8];
  RescueLanes lane_args;
  if (!lanes_from_host(&lane_args, static_cast<const RescueLane*>(lanes), nl,
                       nl, 1) ||
      a.v < 1 || a.n < 2 || a.fmax < 1 || a.hist < 1 || a.key_bits < 1 ||
      a.key_bits > 31 || select_blocks < 1)
    return (int)cudaErrorInvalidValue;
  bool icap_any = false;
  for (int k = 0; k < nl; ++k) {
    const RescueLane& l = lane_args.l[k];
    if (l.fanout < 1 || l.fanout > a.fmax ||
        (l.icap > 0 && (a.bucket == nullptr ||
                        (l.ecap > 0 && a.eoff == nullptr))))
      return (int)cudaErrorInvalidValue;
    icap_any |= l.icap > 0;
  }
  cudaError_t err = cudaMemsetAsync(zero, 0, zero_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 tiles((unsigned)((a.n + 31) / 32), (unsigned)nl);
  // the walks' list of pull-phase values
  const size_t smem = (size_t)a.v * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const void* walks[] = {(const void*)traffic_rescue_walk_kernel<kCount>,
                           (const void*)traffic_rescue_walk_kernel<kFill>,
                           (const void*)traffic_rescue_walk_kernel<kFinal>};
    for (const void* fn : walks) {
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
  }
  if (icap_any) {
    traffic_rescue_walk_kernel<kCount>
        <<<tiles, kThreads, smem, stream>>>(a, lane_args);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    traffic_rescue_walk_kernel<kFill>
        <<<tiles, kThreads, smem, stream>>>(a, lane_args);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    traffic_rescue_select_kernel<<<dim3(select_blocks, (unsigned)nl),
                                   kThreads, 0, stream>>>(a, lane_args);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  traffic_rescue_walk_kernel<kFinal>
      <<<tiles, kThreads, smem, stream>>>(a, lane_args);
  return (int)cudaGetLastError();
}
