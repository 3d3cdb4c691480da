// rc_merge_prune — received-cache merge fused with the prune decision.
//
// Replaces the reference engine's `round/rc_merge` and
// `round/verb3_prune_decide` blocks (gossip_sim_tpu/engine/core.py:743-862:
// row-local sorts over the C + K merged entries, a K-step capacity scan, a
// 4-key prune-order sort and an i64 cumsum), and the received-cache reset
// of `round/verb4_prune_apply` (core.py:943-948); with the value axis in
// place of the origin axis, the traffic round's `traffic/rc_merge` and
// `traffic/prune_decide` (gossip_sim_tpu/engine/traffic.py:621-709), where
// an optional per-value live mask gates which rows fire.
//
// Per (origin, node) row:
//   1. member lookup: an inbound source found among the cache members gets
//      +1 score if its rank is < 2 (received_cache.rs:83-98);
//   2. rank-order capacity scan: a new source inserts with score (rank < 2)
//      if its rank is < 2 or the running length is below received_cap;
//   3. the merged entries in source order; the C smallest stay and
//      rc_overflow[o] counts max(n_valid - C, 0); the upsert counter gains
//      one if the row received anything;
//   4. prune decide: members ordered by (score desc, stake hi desc, stake lo
//      desc, src asc), an exclusive i64 stake cumsum, and a slot is pruned
//      iff position >= min_ingress_nodes, cumsum >= int64(f64(min(stake_dst,
//      stake_org)) * threshold), src != origin and the row fired
//      (upserts >= min_num_upserts) and its origin is live (when the live
//      mask is given); src_sorted is a fired row's members in that order
//      and an unfired row's merged members in source order, then N;
//   5. a fired row's cache resets to empty.
//
// The sparse variant (rc_merge_prune_sparse_kernel, the same body with
// kSparse set) serves the sparse layout, which carries no stake planes: a
// member's stake is read from the cluster tables, shi[src] and slo[src],
// which is what the dense planes hold (every insert copies the table
// stake; index N, the pad, is 0 like an empty slot).  It stages and stores
// two planes fewer and takes no live mask (the sparse layout has no
// traffic round).
//
// min_ingress_nodes and threshold are per lane (lanes.cuh: origin row o is
// lane o / opl), so a batch of sweep lanes runs as more origin rows, and a
// batch of traffic lanes (the live mask) as K x V value rows, opl = V.
//
// Precondition (the cache invariant, which this function's own output
// keeps): each rc_src row holds its members sorted ascending and unique,
// followed by N (empty).  Inbound sources are unique within a row (a source
// pushes to distinct peers).  So every order below is strict and the result
// is exact.
//
// Bound on the H100: memory in most rounds, the row-local prune order in
// the rounds a row fires.  Each call reads four [O, N, C] i32 planes and
// the [O, N, K] inbound rows and writes five [O, N, C] planes (sparse: two
// and three, and the [N + 1] stake tables, which stay in L2).  A row fires
// only when its upsert counter reaches min_num_upserts (20), so rows fire
// together about one round in twenty; in every other round the prune order
// (the sparse variant's two random stake gathers per entry, 128-bit keys,
// a bitonic sort of ~21 passes at C = 64, the stake scan) was work for
// nothing: an unfired row prunes nothing and no one reads its src_sorted
// (prune_apply reads it only at pruned slots).  So an unfired row does the
// merge only (`fired` is decided once the merge's positions are known,
// from rc_ups, inb[row, 0] and the live mask: uniform across the row, and
// loaded late so that no register holds it through the lookup): its
// src_sorted is the merged row in source order (the words of its new
// rc_src), its pruned bytes 0.  The prune-order path runs in fired rows
// only, and the sparse variant gathers stakes there only (in a pass of
// its own, after the keys are placed).
// Design: one warp per row, several rows per block, each row staged in
// dynamic shared memory (sized from C and K by the wrapper; no per-thread
// row arrays; under the 256-thread launch bound ptxas gives each variant
// 48 registers, five blocks an SM: the sparse variant without spill, the
// dense one with 16 bytes of spill stores and 28 of loads, which cost
// less than the alternatives measured; see step 4):
//   - lane j loads slots j, j+32, ... (16-byte vectors where C % 4 == 0),
//     so every plane load and store of a warp is contiguous;
//   - member lookup: each lane binary-searches one inbound source in the
//     sorted members (the position is also the count of smaller members);
//   - the capacity scan is a ballot prefix count: below received_cap every
//     new source inserts, so the length before rank r >= 2 is members +
//     (inserted among ranks 0-1) + (new sources among ranks [2, r));
//   - merge by rank instead of a sort: a member's merged position is its
//     slot plus the inserted sources smaller than it; an inserted source's
//     is the members smaller than it plus the inserted sources before it;
//     an unfired row places (src, score, stakes) there and stores them
//     coalesced; a fired row places its prune keys there;
//   - prune order (fired rows): a bitonic sort in shared memory of 128-bit
//     keys over the kept entries, padded to a power of two;
//   - the stake cumsum is a warp shuffle scan carried across 32-slot chunks,
//     run only on a fired row's chunks that hold kept entries.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

namespace {

// one lane's knobs (kernels/rc_merge_prune.py LANE_DTYPE)
struct MergeLane {
  double threshold;     // prune_stake_threshold
  int32_t min_ingress;  // min_ingress_nodes
  int32_t pad;
};
using MergeLanes = LaneArray<MergeLane>;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kSign = 0x80000000u;
constexpr int kMaxRowsPerBlock = 8;

__device__ __forceinline__ int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Order-preserving map of a signed word onto an unsigned one, and back.
__device__ __forceinline__ uint32_t enc(int32_t x) {
  return (uint32_t)x ^ kSign;
}
__device__ __forceinline__ int32_t dec(uint32_t u) {
  return (int32_t)(u ^ kSign);
}

// Prune-order key: ascending (x, y) is (score desc, shi desc, slo desc,
// src asc).  The padding key sorts after every entry.
__device__ __forceinline__ ulonglong2 make_key(int32_t src, int32_t sc,
                                               int32_t hi, int32_t lo) {
  ulonglong2 key;
  key.x = ((unsigned long long)~enc(sc) << 32) | ~enc(hi);
  key.y = ((unsigned long long)~enc(lo) << 32) | enc(src);
  return key;
}

__device__ __forceinline__ void split_key(ulonglong2 key, int32_t& src,
                                          int32_t& sc, int32_t& hi,
                                          int32_t& lo) {
  sc = dec(~(uint32_t)(key.x >> 32));
  hi = dec(~(uint32_t)key.x);
  lo = dec(~(uint32_t)(key.y >> 32));
  src = dec((uint32_t)key.y);
}

__device__ __forceinline__ bool key_less(ulonglong2 a, ulonglong2 b) {
  return a.x < b.x || (a.x == b.x && a.y < b.y);
}

__device__ __forceinline__ void stage(int32_t* dst,
                                      const int32_t* __restrict__ src, int c,
                                      int lane) {
  if ((c & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int j = lane; j < (c >> 2); j += 32) d4[j] = __ldg(s4 + j);
  } else {
    for (int j = lane; j < c; j += 32) dst[j] = __ldg(src + j);
  }
}

__device__ __forceinline__ int lower_bound(const int32_t* a, int len,
                                           int32_t v) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The rest of a row that does not fire: the merge by rank into `ent`
// (src, score, stakes; the sparse variant gathers no stake), then the
// merged row stored coalesced as the cache and as src_sorted (the merged
// row in source order: no prune reads it), its pruned bytes 0.
template <bool kSparse>
__device__ __forceinline__ void unfired_tail(
    int4* ent, const int32_t* ms, const int32_t* msc, const int32_t* mhi,
    const int32_t* mlo, const int32_t* ins_v, const int32_t* ins_lt,
    const int32_t* ins_sc, const int32_t* __restrict__ shi,
    const int32_t* __restrict__ slo, int32_t* o_src, int32_t* o_score,
    int32_t* o_shi, int32_t* o_slo, int32_t* src_sorted, uint8_t* pruned,
    int32_t* n_pruned, int members, int n_ins, int kept, int n, int c,
    int lane) {
  for (int j = lane; j < members; j += 32) {
    const int32_t s = ms[j];
    int pos = j;
    for (int t = 0; t < n_ins; ++t) pos += ins_v[t] < s;
    if (pos < c)
      ent[pos] = make_int4(s, msc[j], kSparse ? 0 : mhi[j],
                           kSparse ? 0 : mlo[j]);
  }
  for (int t = lane; t < n_ins; t += 32) {
    const int32_t v = ins_v[t];
    int pos = ins_lt[t];
    for (int u = 0; u < n_ins; ++u) {
      const int32_t w = ins_v[u];
      pos += w < v || (w == v && u < t);
    }
    if (pos < c)
      ent[pos] = make_int4(v, ins_sc[t], kSparse ? 0 : __ldg(shi + v),
                           kSparse ? 0 : __ldg(slo + v));
  }
  __syncwarp();
  for (int j = lane; j < c; j += 32) {
    const int4 e = j < kept ? ent[j] : make_int4(n, 0, 0, 0);
    o_src[j] = e.x;
    o_score[j] = e.y;
    if (!kSparse) {
      o_shi[j] = e.z;
      o_slo[j] = e.w;
    }
    src_sorted[j] = e.x;
  }
  if ((c & 3) == 0 && (reinterpret_cast<uintptr_t>(pruned) & 3) == 0) {
    for (int j = lane; j < (c >> 2); j += 32)
      reinterpret_cast<uint32_t*>(pruned)[j] = 0u;
  } else {
    for (int j = lane; j < c; j += 32) pruned[j] = 0;
  }
  if (lane == 0) *n_pruned = 0;
}

template <bool kSparse>
__device__ __forceinline__ void merge_prune_row(
                      const int32_t* __restrict__ rc_src,
                      const int32_t* __restrict__ rc_score,
                      const int32_t* __restrict__ rc_shi,
                      const int32_t* __restrict__ rc_slo,
                      const int32_t* __restrict__ rc_ups,
                      const int32_t* __restrict__ inb,
                      const int32_t* __restrict__ shi,
                      const int32_t* __restrict__ slo,
                      const int64_t* __restrict__ stakes,
                      const int32_t* __restrict__ origins,
                      const uint8_t* __restrict__ live,
                      int32_t* __restrict__ o_src,
                      int32_t* __restrict__ o_score,
                      int32_t* __restrict__ o_shi, int32_t* __restrict__ o_slo,
                      int32_t* __restrict__ o_ups,
                      int32_t* __restrict__ src_sorted,
                      uint8_t* __restrict__ pruned,
                      int32_t* __restrict__ n_pruned,
                      int32_t* __restrict__ overflow, long long rows, int n,
                      int c, int k, int key_slots, int row_bytes,
                      int received_cap, int min_num_upserts,
                      const MergeLanes& lanes, int opl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // whole warp; no block-wide barrier follows
  // row layout (kernels/rc_merge_prune.py row_smem_bytes): key_slots prune
  // keys (an unfired row keeps its merged entries there instead), the
  // member planes (four; sparse: src and score), three words per inserted
  // inbound source
  ulonglong2* key =
      reinterpret_cast<ulonglong2*>(smem + (size_t)warp * row_bytes);
  int4* ent = reinterpret_cast<int4*>(key);
  int32_t* ms = reinterpret_cast<int32_t*>(key + key_slots);
  int32_t* msc = ms + c;
  int32_t* mhi = msc + c;
  int32_t* mlo = mhi + c;
  int32_t* ins_v = kSparse ? msc + c : mlo + c;
  int32_t* ins_lt = ins_v + k;
  int32_t* ins_sc = ins_lt + k;
  const int o = (int)((unsigned)row / (unsigned)n);  // rows < 2^31
  const int node = (int)row - o * n;
  const long long base_c = row * c;
  const int32_t* ib = inb + row * k;

  const int32_t v0 = __ldg(ib);
  stage(ms, rc_src + base_c, c, lane);
  stage(msc, rc_score + base_c, c, lane);
  if (!kSparse) {
    stage(mhi, rc_shi + base_c, c, lane);
    stage(mlo, rc_slo + base_c, c, lane);
  }
  __syncwarp();
  int members = 0;
  for (int j0 = 0; j0 < c; j0 += 32) {
    const int j = j0 + lane;
    members += __popc(__ballot_sync(kFull, j < c && ms[j] < n));
  }

  // 1 + 2: lookup, score bump, capacity scan; compact the inserted sources
  int n01 = 0, wanted = 0, n_ins = 0;
  for (int r0 = 0; r0 < k; r0 += 32) {
    const int r = r0 + lane;
    const int32_t v = r < k ? __ldg(ib + r) : n;
    const bool valid = v < n;
    int lt = 0;
    bool found = false;
    if (valid) {
      lt = lower_bound(ms, members, v);
      found = lt < members && ms[lt] == v;
    }
    if (found && (r == 0 || (r == 1 && v != v0))) msc[lt] += 1;
    const bool want = valid && !found;
    if (r0 == 0) n01 = __popc(__ballot_sync(kFull, want && r < 2));
    const unsigned wmask = __ballot_sync(kFull, want && r >= 2);
    const bool ins =
        want && (r < 2 || members + n01 + wanted + __popc(wmask & below) <
                              received_cap);
    wanted += __popc(wmask);
    const unsigned imask = __ballot_sync(kFull, ins);
    if (ins) {
      const int t = n_ins + __popc(imask & below);
      ins_v[t] = v;
      ins_lt[t] = lt;
      ins_sc[t] = r < 2 ? 1 : 0;
    }
    n_ins += __popc(imask);
  }
  __syncwarp();

  // 3: merge by rank; the C smallest sources stay
  const int m = members + n_ins;
  const int kept = m < c ? m : c;
  if (lane == 0 && m > c) atomicAdd(&overflow[o], m - c);
  // whether the row fires: uniform across the warp; an unfired row ends
  // with the merge
  const int ups = __ldg(rc_ups + row) + (v0 < n ? 1 : 0);
  const bool fired =
      ups >= min_num_upserts && (live == nullptr || __ldg(live + o) != 0);
  if (lane == 0) o_ups[row] = fired ? 0 : ups;
  if (!fired) {
    unfired_tail<kSparse>(ent, ms, msc, mhi, mlo, ins_v, ins_lt, ins_sc,
                          shi, slo, o_src + base_c, o_score + base_c,
                          o_shi + base_c, o_slo + base_c,
                          src_sorted + base_c, pruned + base_c,
                          n_pruned + row, members, n_ins, kept, n, c, lane);
    return;
  }

  // a fired row: the cache resets to empty; the merged entries become
  // prune keys
  for (int j = lane; j < c; j += 32) {
    o_src[base_c + j] = n;
    o_score[base_c + j] = 0;
    if (!kSparse) {
      o_shi[base_c + j] = 0;
      o_slo[base_c + j] = 0;
    }
  }
  // (the sparse variant places its keys with stakes 0 and gathers the
  // stakes in a pass of their own, in merged order)
  for (int j = lane; j < members; j += 32) {
    const int32_t s = ms[j];
    int pos = j;
    for (int t = 0; t < n_ins; ++t) pos += ins_v[t] < s;
    if (pos < c)
      key[pos] = kSparse ? make_key(s, msc[j], 0, 0)
                         : make_key(s, msc[j], mhi[j], mlo[j]);
  }
  for (int t = lane; t < n_ins; t += 32) {
    const int32_t v = ins_v[t];
    int pos = ins_lt[t];
    for (int u = 0; u < n_ins; ++u) {
      const int32_t w = ins_v[u];
      pos += w < v || (w == v && u < t);
    }
    if (pos < c)
      key[pos] = kSparse ? make_key(v, ins_sc[t], 0, 0)
                         : make_key(v, ins_sc[t], __ldg(shi + v),
                                    __ldg(slo + v));
  }
  if (kSparse) {
    __syncwarp();
    for (int j = lane; j < kept; j += 32) {
      const ulonglong2 kk = key[j];
      const int32_t s = dec((uint32_t)kk.y);
      key[j] = make_ulonglong2(
          (kk.x & 0xFFFFFFFF00000000ull) | ~enc(__ldg(shi + s)),
          ((unsigned long long)~enc(__ldg(slo + s)) << 32) |
              (kk.y & 0xFFFFFFFFull));
    }
  }
  const int p = pow2_ceil(kept);
  for (int j = kept + lane; j < p; j += 32)
    key[j] = make_ulonglong2(~0ull, ~0ull);
  __syncwarp();

  // 4: prune order (bitonic sort of the kept keys), stake scan, decide.
  // The sparse variant runs the sort's loops and the scan's rolled
  // (`unroll 1`): unrolled, ptxas (CUDA 12.9, sm_90a) either spills them at
  // 48 registers or takes 64, and 64 fit four blocks of 8 rows on an SM
  // where 48 fit five.  The dense variant keeps them unrolled: rolled, it
  // takes 64 registers (no spill) and measured 10-11% slower on rounds 19
  // and 20 (H100 80GB HBM3, 700 W) than unrolled with its small spill.
#define RC_SORT_LOOPS(ROLL)                                                   \
  ROLL for (int size = 2; size <= p; size <<= 1) {                            \
    ROLL for (int stride = size >> 1; stride > 0; stride >>= 1) {             \
      ROLL for (int t = lane; t < (p >> 1); t += 32) {                        \
        const int i = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));        \
        const ulonglong2 a = key[i], b = key[i + stride];                     \
        if (key_less(b, a) == ((i & size) == 0)) {                            \
          key[i] = b;                                                         \
          key[i + stride] = a;                                                \
        }                                                                     \
      }                                                                       \
      __syncwarp();                                                           \
    }                                                                         \
  }
  if constexpr (kSparse) {
    RC_SORT_LOOPS(_Pragma("unroll 1"))
  } else {
    RC_SORT_LOOPS()
  }
#undef RC_SORT_LOOPS
  const int org = __ldg(origins + o);
  const MergeLane& lane_k = lanes.l[o / opl];
  const double threshold = lane_k.threshold;
  const int min_ingress_nodes = lane_k.min_ingress;
  const long long sd = __ldg(stakes + node), so = __ldg(stakes + org);
  const long long min_stake =
      (long long)((double)(sd < so ? sd : so) * threshold);
  long long carry = 0;
  int count = 0;
#define RC_SCAN_LOOP(ROLL)                                                    \
  ROLL for (int j0 = 0; j0 < c; j0 += 32) {                                   \
    const int j = j0 + lane;                                                  \
    const bool member = j < kept;                                             \
    if (j0 >= kept) { /* nothing to prune in this chunk */                   \
      if (j < c) {                                                            \
        src_sorted[base_c + j] = n;                                           \
        pruned[base_c + j] = 0;                                               \
      }                                                                       \
      continue;                                                               \
    }                                                                         \
    int32_t s = n, sc = 0, hi = 0, lo = 0;                                    \
    if (member) split_key(key[j], s, sc, hi, lo);                             \
    const long long st =                                                      \
        member ? (long long)(((unsigned long long)(long long)hi << 31) |      \
                             (unsigned long long)(long long)lo)               \
               : 0;                                                           \
    long long x = st;                                                         \
    for (int d = 1; d < 32; d <<= 1) {                                        \
      const long long y = __shfl_up_sync(kFull, x, d);                        \
      if (lane >= d) x += y;                                                  \
    }                                                                         \
    const long long cum = carry + x - st;                                     \
    carry += __shfl_sync(kFull, x, 31);                                       \
    const bool pr = member && j >= min_ingress_nodes && cum >= min_stake &&   \
                    s != org;                                                 \
    if (j < c) {                                                              \
      src_sorted[base_c + j] = s;                                             \
      pruned[base_c + j] = pr ? 1 : 0;                                        \
    }                                                                         \
    count += __popc(__ballot_sync(kFull, pr));                                \
  }
  if constexpr (kSparse) {
    RC_SCAN_LOOP(_Pragma("unroll 1"))
  } else {
    RC_SCAN_LOOP()
  }
#undef RC_SCAN_LOOP
  if (lane == 0) n_pruned[row] = count;
}

#define RC_MERGE_PRUNE_PARAMS                                                  \
  const int32_t *__restrict__ rc_src, const int32_t *__restrict__ rc_score,   \
      const int32_t *__restrict__ rc_shi, const int32_t *__restrict__ rc_slo, \
      const int32_t *__restrict__ rc_ups, const int32_t *__restrict__ inb,    \
      const int32_t *__restrict__ shi, const int32_t *__restrict__ slo,       \
      const int64_t *__restrict__ stakes,                                     \
      const int32_t *__restrict__ origins, const uint8_t *__restrict__ live,  \
      int32_t *__restrict__ o_src, int32_t *__restrict__ o_score,             \
      int32_t *__restrict__ o_shi, int32_t *__restrict__ o_slo,               \
      int32_t *__restrict__ o_ups, int32_t *__restrict__ src_sorted,          \
      uint8_t *__restrict__ pruned, int32_t *__restrict__ n_pruned,           \
      int32_t *__restrict__ overflow, long long rows, int n, int c, int k,    \
      int key_slots, int row_bytes, int received_cap, int min_num_upserts,    \
      const __grid_constant__ MergeLanes lanes, int opl
#define RC_MERGE_PRUNE_ARGS                                                    \
  rc_src, rc_score, rc_shi, rc_slo, rc_ups, inb, shi, slo, stakes, origins,   \
      live, o_src, o_score, o_shi, o_slo, o_ups, src_sorted, pruned,          \
      n_pruned, overflow, rows, n, c, k, key_slots, row_bytes, received_cap,  \
      min_num_upserts, lanes, opl

__global__ void __launch_bounds__(32 * kMaxRowsPerBlock)
rc_merge_prune_kernel(RC_MERGE_PRUNE_PARAMS) {
  merge_prune_row<false>(RC_MERGE_PRUNE_ARGS);
}

__global__ void __launch_bounds__(32 * kMaxRowsPerBlock)
rc_merge_prune_sparse_kernel(RC_MERGE_PRUNE_PARAMS) {
  merge_prune_row<true>(RC_MERGE_PRUNE_ARGS);
}

}  // namespace

// The geometry (rows_per_block, key_slots, row_bytes) comes from the
// wrapper (kernels/rc_merge_prune.py launch_geometry); only its bounds are
// checked here.  sparse != 0 launches the sparse variant, which takes no
// stake planes (rc_shi, rc_slo, o_shi, o_slo unused) and no live mask.
// `lanes` points at nl MergeLane records in host memory, one per lane of
// opl origin rows (nl * opl = o; with the live mask, a traffic lane of opl
// value rows).
extern "C" int rc_merge_prune_launch(
    const int32_t* rc_src, const int32_t* rc_score, const int32_t* rc_shi,
    const int32_t* rc_slo, const int32_t* rc_ups, const int32_t* inb,
    const int32_t* shi, const int32_t* slo, const int64_t* stakes,
    const int32_t* origins, const uint8_t* live, int32_t* o_src,
    int32_t* o_score, int32_t* o_shi, int32_t* o_slo, int32_t* o_ups, int32_t* src_sorted, uint8_t* pruned,
    int32_t* n_pruned, int32_t* overflow, int o, int n, int c, int k,
    int rows_per_block, int key_slots, int row_bytes, int received_cap,
    int min_num_upserts, const void* lanes, int nl, int opl,
    int sparse, cudaStream_t stream) {
  MergeLanes lane_args;
  if (!lanes_from_host(&lane_args, static_cast<const MergeLane*>(lanes), nl, o, opl))
    return (int)cudaErrorInvalidValue;
  if (c < 1 || k < 1 || (long long)o * n > 0x7FFFFFFF ||
      rows_per_block < 1 || rows_per_block > kMaxRowsPerBlock ||
      key_slots < c || (key_slots & (key_slots - 1)) != 0 ||
      row_bytes % 16 != 0 ||
      row_bytes < 16 * key_slots + (sparse ? 8 : 16) * c + 12 * k ||
      (sparse && live != nullptr))
    return (int)cudaErrorInvalidValue;
  const int smem = rows_per_block * row_bytes;
  cudaError_t err =
      cudaMemsetAsync(overflow, 0, sizeof(int32_t) * (size_t)o, stream);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)o * n;
  if (rows > 0) {
    auto kernel =
        sparse ? rc_merge_prune_sparse_kernel : rc_merge_prune_kernel;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)((rows + rows_per_block - 1) / rows_per_block),
             32 * rows_per_block, smem, stream>>>(
        rc_src, rc_score, rc_shi, rc_slo, rc_ups, inb, shi, slo, stakes,
        origins, live, o_src, o_score, o_shi, o_slo, o_ups, src_sorted,
        pruned, n_pruned, overflow, rows, n, c, k, key_slots, row_bytes,
        received_cap, min_num_upserts, lane_args, opl);
  }
  return (int)cudaGetLastError();
}
