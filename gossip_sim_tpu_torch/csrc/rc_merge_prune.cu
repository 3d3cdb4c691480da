// rc_merge_prune — received-cache merge fused with the prune decision.
//
// Replaces the reference engine's `round/rc_merge` and
// `round/verb3_prune_decide` blocks (gossip_sim_tpu/engine/core.py:743-862:
// row-local sorts over the C + K merged entries, a K-step capacity scan, a
// 4-key prune-order sort and an i64 cumsum), and the received-cache reset
// of `round/verb4_prune_apply` (core.py:943-948).
//
// One thread per (origin, node) row:
//   1. member lookup: an inbound source found among the cache members gets
//      +1 score if its rank is < 2 (received_cache.rs:83-98);
//   2. rank-order capacity scan: a new source inserts with score (rank < 2)
//      if its rank is < 2 or the running length is below received_cap;
//   3. the merged entries are sorted by source; the C smallest stay and
//      rc_overflow[o] counts max(n_valid - C, 0); the upsert counter gains
//      one if the row received anything;
//   4. prune decide: members ordered by (score desc, stake hi desc, stake lo
//      desc, src asc), an exclusive i64 stake cumsum, and a slot is pruned
//      iff position >= min_ingress_nodes, cumsum >= int64(f64(min(stake_dst,
//      stake_org)) * threshold), src != origin and the row fired
//      (upserts >= min_num_upserts);
//   5. a fired row's cache resets to empty.
// Sources are unique within a row, so both orders are strict and the
// result is exact.
//
// Bound on the H100: memory.  Each call reads four [O, N, C] i32 planes and
// the [O, N, K] inbound rows and writes five [O, N, C] planes; the sorts
// are ~(C + K)^2 / 4 register/local-memory steps per row.  Design: a row
// per thread keeps the merge in thread-local arrays (no shared-memory
// staging), simple and exact; the per-thread row reads are uncoalesced.  A
// warp-per-row layout with coalesced loads is work for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxW = 128;  // C + K

__device__ __forceinline__ bool prune_before(int32_t sa, int32_t ha,
                                             int32_t la, int32_t xa,
                                             int32_t sb, int32_t hb,
                                             int32_t lb, int32_t xb) {
  if (sa != sb) return sa > sb;
  if (ha != hb) return ha > hb;
  if (la != lb) return la > lb;
  return xa < xb;
}

__global__ void __launch_bounds__(kThreads)
rc_merge_prune_kernel(const int32_t* __restrict__ rc_src,
                      const int32_t* __restrict__ rc_score,
                      const int32_t* __restrict__ rc_shi,
                      const int32_t* __restrict__ rc_slo,
                      const int32_t* __restrict__ rc_ups,
                      const int32_t* __restrict__ inb,
                      const int32_t* __restrict__ shi,
                      const int32_t* __restrict__ slo,
                      const int64_t* __restrict__ stakes,
                      const int32_t* __restrict__ origins,
                      int32_t* __restrict__ o_src, int32_t* __restrict__ o_score,
                      int32_t* __restrict__ o_shi, int32_t* __restrict__ o_slo,
                      int32_t* __restrict__ o_ups,
                      int32_t* __restrict__ src_sorted,
                      uint8_t* __restrict__ pruned,
                      int32_t* __restrict__ n_pruned,
                      int32_t* __restrict__ overflow, long long rows, int n,
                      int c, int k, int received_cap, int min_num_upserts,
                      int min_ingress_nodes, double threshold) {
  const long long row = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int o = (int)(row / n);
  const int node = (int)(row % n);
  const long long base_c = row * c;
  const int32_t* ib = inb + row * k;

  int32_t es[kMaxW], ec[kMaxW], eh[kMaxW], el[kMaxW];
  int m = 0;
  for (int j = 0; j < c; ++j) {
    const int32_t s = rc_src[base_c + j];
    if (s < n) {
      es[m] = s;
      ec[m] = rc_score[base_c + j];
      eh[m] = rc_shi[base_c + j];
      el[m] = rc_slo[base_c + j];
      ++m;
    }
  }
  const int members = m;
  int ln = members;
  for (int r = 0; r < k; ++r) {
    const int32_t v = ib[r];
    if (v >= n) continue;
    int hit = -1;
    for (int j = 0; j < members; ++j) {
      if (es[j] == v) {
        hit = j;
        break;
      }
    }
    if (hit >= 0) {
      if (r < 2) ec[hit] += 1;
      continue;
    }
    if (r < 2 || ln < received_cap) {
      es[m] = v;
      ec[m] = (r < 2) ? 1 : 0;
      eh[m] = shi[v];
      el[m] = slo[v];
      ++m;
      ++ln;
    }
  }
  if (m > c) atomicAdd(&overflow[o], m - c);

  // merged row sorted by source (sources are unique)
  for (int i = 1; i < m; ++i) {
    const int32_t s = es[i], sc = ec[i], h = eh[i], l = el[i];
    int j = i;
    while (j > 0 && es[j - 1] > s) {
      es[j] = es[j - 1];
      ec[j] = ec[j - 1];
      eh[j] = eh[j - 1];
      el[j] = el[j - 1];
      --j;
    }
    es[j] = s;
    ec[j] = sc;
    eh[j] = h;
    el[j] = l;
  }
  const int kept = m < c ? m : c;
  const int ups = rc_ups[row] + (ib[0] < n ? 1 : 0);
  const bool fired = ups >= min_num_upserts;
  for (int j = 0; j < c; ++j) {
    const bool live = !fired && j < kept;
    o_src[base_c + j] = live ? es[j] : n;
    o_score[base_c + j] = live ? ec[j] : 0;
    o_shi[base_c + j] = live ? eh[j] : 0;
    o_slo[base_c + j] = live ? el[j] : 0;
  }
  o_ups[row] = fired ? 0 : ups;

  // prune order over the kept members
  for (int i = 1; i < kept; ++i) {
    const int32_t s = es[i], sc = ec[i], h = eh[i], l = el[i];
    int j = i;
    while (j > 0 && prune_before(sc, h, l, s, ec[j - 1], eh[j - 1],
                                 el[j - 1], es[j - 1])) {
      es[j] = es[j - 1];
      ec[j] = ec[j - 1];
      eh[j] = eh[j - 1];
      el[j] = el[j - 1];
      --j;
    }
    es[j] = s;
    ec[j] = sc;
    eh[j] = h;
    el[j] = l;
  }
  const int org = origins[o];
  const long long sd = stakes[node], so = stakes[org];
  const long long min_stake =
      (long long)((double)(sd < so ? sd : so) * threshold);
  long long cum = 0;
  int count = 0;
  for (int j = 0; j < c; ++j) {
    const bool member = j < kept;
    const int32_t s = member ? es[j] : n;
    const bool p = member && fired && j >= min_ingress_nodes &&
                   cum >= min_stake && s != org;
    src_sorted[base_c + j] = s;
    pruned[base_c + j] = p ? 1 : 0;
    count += p ? 1 : 0;
    if (member) cum += ((long long)eh[j] << 31) | (long long)el[j];
  }
  n_pruned[row] = count;
}

}  // namespace

extern "C" int rc_merge_prune_launch(
    const int32_t* rc_src, const int32_t* rc_score, const int32_t* rc_shi,
    const int32_t* rc_slo, const int32_t* rc_ups, const int32_t* inb,
    const int32_t* shi, const int32_t* slo, const int64_t* stakes,
    const int32_t* origins, int32_t* o_src, int32_t* o_score, int32_t* o_shi,
    int32_t* o_slo, int32_t* o_ups, int32_t* src_sorted, uint8_t* pruned,
    int32_t* n_pruned, int32_t* overflow, int o, int n, int c, int k,
    int received_cap, int min_num_upserts, int min_ingress_nodes,
    double threshold, cudaStream_t stream) {
  if (c < 1 || k < 1 || c + k > kMaxW) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)o * n;
  cudaMemsetAsync(overflow, 0, sizeof(int32_t) * (size_t)o, stream);
  if (rows > 0)
    rc_merge_prune_kernel<<<(unsigned)((rows + kThreads - 1) / kThreads),
                            kThreads, 0, stream>>>(
        rc_src, rc_score, rc_shi, rc_slo, rc_ups, inb, shi, slo, stakes,
        origins, o_src, o_score, o_shi, o_slo, o_ups, src_sorted, pruned,
        n_pruned, overflow, rows, n, c, k, received_cap, min_num_upserts,
        min_ingress_nodes, threshold);
  return (int)cudaGetLastError();
}
