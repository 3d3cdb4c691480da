// traffic_admit — the traffic round's ingress budget: the cross-value
// contention point.
//
// Replaces the reference engine's `traffic/ingress_cap` block
// (gossip_sim_tpu/engine/traffic.py:316-342: one flat sort of every
// arrival of the round by (target, value-major arrival order) with pseudo
// entries for the per-target counts, and a sort back).
//
// Input:  active [N, S] i32 the shared active set (N = empty);
//         cand_bits / arr_bits [N, V] i32 from traffic_send (sender-major):
//         bit s of a (sender, value) word marks slot s a candidate / an
//         arrival at peer active[sender, s].
// Output: accepted [V, N, F] u8, arrived_node and accepted_node [N] i32.
// Scratch (the wrapper's, one i32 buffer of 36 K N words): cut [K, N] i64,
//         deg [K, N], total [K, N], bucket [K, N, 32] i32.
// Lanes: a batch of K sweep lanes (engine/traffic.py run_traffic_lanes)
//         runs in the same launches, the lane in each kernel's grid (y of
//         the tally and cut grids, z of the write grid).  Each plane has a
//         leading lane axis (active [K, N, S], the words [K, N, V], the
//         plane [K * V, N, F], the counts [K, N]) and each lane its own
//         ingress cap (lanes.cuh record): a lane's arrivals are ranked,
//         and cut once per target, among its own only.  The serial round is
//         K = 1.
//
// An arrival's rank at its target is its position among the target's
// arrivals in flat (value, source, slot) order; with the ingress cap on,
// the ranks below the cap are accepted.  So the accepted arrivals at a
// target are a prefix of that order, and the whole cap is one cut per
// target: the key v * N * S + src * S + slot of its first rejected arrival.
// An arrival is accepted iff the cap is off or its key is below its
// target's cut.  No atomics decide an acceptance, and no sort is needed.
//
// Design: four device operations, in order on the stream.
//   0. a memset of deg and total (2 K N words);
//   1. tally, a warp per sender: its lanes read 32 consecutive value words
//      of the sender (one 128-byte line) and a ballot per slot counts the
//      slot's arrivals over the values; lane s then adds its count to the
//      total of the target active[sender, s] and appends the entry
//      sender * S + s to the target's bucket of 32 (atomics on integers:
//      the totals are exact, the order within a bucket is arbitrary);
//   2. cut (only with a lane's cap on), a warp per target whose total
//      passes the cap: its lanes over values sum the arrivals from the
//      target's in-neighbours, a warp scan with a carried total places
//      each value's ranks, and the one value that straddles the cap is
//      walked: the in-neighbour whose arrival there has rank (cap - base)
//      among the value's arrivals in entry order is the cut.  A target with
//      more than 32 in-neighbours (its bucket overflowed) finds them by a
//      scan of the whole active set in entry order: correct, and slow only
//      there;
//   3. write, a block per tile of 32 senders x 32 values: the tile's words
//      are read once (coalesced rows) and transposed through shared memory,
//      each (value, sender) sets its accepted arrivals' bytes (fanout slot:
//      the candidates below the slot) in a zeroed shared tile, and the tile
//      goes out as contiguous rows: every byte of the plane is written once,
//      so no memset of the plane.  Blocks of the first value tile also write
//      the node counts.
//
// Bound on the H100: memory.  The words of the [N, V] planes are read from
// device memory once (tally: arr_bits; write: both, from L2), the plane
// written once; the cut kernel's reads (each in-neighbour's value line per
// target) come from L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

namespace {

// one lane's knobs (kernels/traffic_admit.py LANE_DTYPE)
struct AdmitLane {
  int32_t ingress_cap;  // <= 0: off
  int32_t pad;
};
using AdmitLanes = LaneArray<AdmitLane>;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8;             // senders / targets per block
constexpr int kBucket = 32;           // in-neighbours kept per target
constexpr int kTile = 32;             // senders and values of a write tile
constexpr int kWriteThreads = 256;
constexpr int kLines = 8;             // value lines a tally warp loads at once
constexpr long long kAcceptAll = 0x7FFFFFFFFFFFFFFFLL;

__global__ void __launch_bounds__(32 * kWarps)
traffic_admit_tally_kernel(const int32_t* __restrict__ active,
                           const int32_t* __restrict__ arr_bits,
                           int32_t* __restrict__ deg,
                           int32_t* __restrict__ total,
                           int32_t* __restrict__ bucket, int v_count, int n,
                           int s) {
  const int lane = threadIdx.x & 31;
  const int src = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (src >= n) return;  // whole warp
  {  // the block's lane (blockIdx.y): its set, words and scratch
    const long long kl = blockIdx.y;
    active += kl * n * s;
    arr_bits += kl * n * v_count;
    deg += kl * n;
    total += kl * n;
    bucket += kl * n * kBucket;
  }
  const int32_t* row = arr_bits + (long long)src * v_count;
  int count = 0;  // lane s: arrivals through slot s over every value
  for (int v0 = 0; v0 < v_count; v0 += 32 * kLines) {
    uint32_t w[kLines];  // the sender's next kLines lines, loads in flight
#pragma unroll
    for (int q = 0; q < kLines; ++q) {
      const int v = v0 + 32 * q + lane;
      w[q] = v < v_count ? (uint32_t)__ldg(row + v) : 0u;
    }
#pragma unroll
    for (int q = 0; q < kLines; ++q) {
      if (__ballot_sync(kFull, w[q] != 0u) == 0u) continue;
      for (int sl = 0; sl < s; ++sl) {
        const int c = __popc(__ballot_sync(kFull, (w[q] >> sl) & 1u));
        if (lane == sl) count += c;
      }
    }
  }
  if (lane < s) {
    const int e = src * s + lane;
    const int t = __ldg(active + e);
    if (t >= 0 && t < n) {
      const int p = atomicAdd(deg + t, 1);
      if (p < kBucket) bucket[(long long)t * kBucket + p] = e;
      if (count) atomicAdd(total + t, count);
    }
  }
}

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

__device__ __forceinline__ int arrival(const int32_t* __restrict__ arr_bits,
                                       long long e, int s, int v,
                                       int v_count) {
  const int src = (int)(e / s);
  const int slot = (int)(e - (long long)src * s);
  return (int)(((uint32_t)__ldg(arr_bits + (long long)src * v_count + v) >>
                slot) & 1u);
}

__global__ void __launch_bounds__(32 * kWarps)
traffic_admit_cut_kernel(const int32_t* __restrict__ active,
                         const int32_t* __restrict__ deg,
                         const int32_t* __restrict__ total,
                         const int32_t* __restrict__ bucket,
                         const int32_t* __restrict__ arr_bits,
                         long long* __restrict__ cut, int v_count, int n,
                         int s, const __grid_constant__ AdmitLanes lanes) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int cap = lanes.l[blockIdx.y].ingress_cap;
  if (t >= n || cap <= 0) return;  // whole warp; a lane without the cap
                                   // reads no cut
  {  // the block's lane (blockIdx.y): its set, words and scratch
    const long long kl = blockIdx.y;
    active += kl * n * s;
    arr_bits += kl * n * v_count;
    deg += kl * n;
    total += kl * n;
    bucket += kl * n * kBucket;
    cut += kl * n;
  }
  if (__ldg(total + t) <= cap) {
    if (lane == 0) cut[t] = kAcceptAll;
    return;
  }
  const long long ns = (long long)n * s;
  const int d = __ldg(deg + t);
  const bool small = d <= kBucket;
  // small: lane j < d holds in-neighbour entry e = src * S + slot
  int e = -1, src = 0, slot = 0;
  if (small && lane < d) {
    e = __ldg(bucket + (long long)t * kBucket + lane);
    src = e / s;
    slot = e - src * s;
  }
  // the value whose ranks straddle the cap, and the rank there to find
  int running = 0, vcut = -1, need = 0;
  for (int v0 = 0; v0 < v_count && vcut < 0; v0 += 32) {
    const int v = v0 + lane;
    const bool vin = v < v_count;
    int c = 0;
    if (small) {
#pragma unroll 4
      for (int j = 0; j < d; ++j) {
        const int sj = __shfl_sync(kFull, src, j);
        const int lj = __shfl_sync(kFull, slot, j);
        if (vin)
          c += (int)(((uint32_t)__ldg(arr_bits + (long long)sj * v_count +
                                      v) >> lj) & 1u);
      }
    } else {
      for (long long e0 = 0; e0 < ns; e0 += 32) {
        const long long ee = e0 + lane;
        unsigned m = __ballot_sync(kFull, ee < ns && __ldg(active + ee) == t);
        while (m) {
          const int j = __ffs(m) - 1;
          m &= m - 1u;
          if (vin) c += arrival(arr_bits, e0 + j, s, v, v_count);
        }
      }
    }
    const int incl = warp_inclusive_scan(c, lane);
    const int base = running + incl - c;
    const unsigned m =
        __ballot_sync(kFull, c > 0 && base <= cap && cap < base + c);
    if (m) {
      const int at = __ffs(m) - 1;
      vcut = v0 + at;
      need = __shfl_sync(kFull, cap - base, at);
    }
    running += __shfl_sync(kFull, incl, 31);
  }
  // vcut >= 0 here: the total passes the cap.  The first rejected arrival
  // is the need-th (from 0) arrival of value vcut in entry order.
  long long key = kAcceptAll;
  if (small) {
    const int a = lane < d ? arrival(arr_bits, e, s, vcut, v_count) : 0;
    int rank = 0;
    for (int j = 0; j < d; ++j) {
      const int ej = __shfl_sync(kFull, e, j);
      const int aj = __shfl_sync(kFull, a, j);
      rank += aj && ej < e;
    }
    const unsigned m = __ballot_sync(kFull, a && rank == need);
    if (m) key = (long long)vcut * ns + __shfl_sync(kFull, e, __ffs(m) - 1);
  } else {
    int seen = 0;
    for (long long e0 = 0; e0 < ns; e0 += 32) {
      const long long ee = e0 + lane;
      const int a = (ee < ns && __ldg(active + ee) == t)
                        ? arrival(arr_bits, ee, s, vcut, v_count)
                        : 0;
      const unsigned m = __ballot_sync(kFull, a);
      const int pc = __popc(m);
      if (seen + pc > need) {
        const int k = need - seen;
        const unsigned at = __ballot_sync(
            kFull, a && __popc(m & ((1u << lane) - 1u)) == k);
        key = (long long)vcut * ns + e0 + (__ffs(at) - 1);
        break;
      }
      seen += pc;
    }
  }
  if (lane == 0) cut[t] = key;
}

__global__ void __launch_bounds__(kWriteThreads)
traffic_admit_write_kernel(const int32_t* __restrict__ active,
                           const int32_t* __restrict__ cand_bits,
                           const int32_t* __restrict__ arr_bits,
                           const long long* __restrict__ cut,
                           const int32_t* __restrict__ total,
                           uint8_t* __restrict__ accepted,
                           int32_t* __restrict__ arrived_node,
                           int32_t* __restrict__ accepted_node, int v_count,
                           int n, int s, int f,
                           const __grid_constant__ AdmitLanes lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* sh_arr = reinterpret_cast<uint32_t*>(smem);    // [32][33]
  uint32_t* sh_cand = sh_arr + kTile * (kTile + 1);        // [32][33]
  int32_t* sh_act =
      reinterpret_cast<int32_t*>(sh_cand + kTile * (kTile + 1));  // [32 s]
  uint8_t* sh_out = reinterpret_cast<uint8_t*>(sh_act + kTile * s);
  const int row_bytes = kTile * f;  // a value's row of the tile
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int src0 = blockIdx.x * kTile, v0 = blockIdx.y * kTile;
  const int cap = lanes.l[blockIdx.z].ingress_cap;
  {  // the block's lane (blockIdx.z): its set, words, cuts and outputs
    const long long kl = blockIdx.z;
    active += kl * n * s;
    cand_bits += kl * n * v_count;
    arr_bits += kl * n * v_count;
    cut += kl * n;
    total += kl * n;
    accepted += kl * v_count * n * f;
    arrived_node += kl * n;
    accepted_node += kl * n;
  }
  const int n_src = min(kTile, n - src0), n_val = min(kTile, v_count - v0);

  if (blockIdx.y == 0 && threadIdx.x < n_src) {
    const int t = src0 + threadIdx.x;
    const int tot = __ldg(total + t);
    arrived_node[t] = tot;
    accepted_node[t] = (cap > 0 && tot > cap) ? cap : tot;
  }
  // the tile's words: warp ty reads senders ty, ty + 8, ..., a lane each
  // value (one line a sender), stored transposed [value][sender]
  constexpr int kRows = kTile / (kWriteThreads / 32);  // senders a warp
  uint32_t a[kRows], c[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int r = ty + q * (kWriteThreads / 32);
    const bool in = r < n_src && tx < n_val;
    a[q] = in ? (uint32_t)__ldg(arr_bits + (long long)(src0 + r) * v_count +
                                v0 + tx)
              : 0u;
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int r = ty + q * (kWriteThreads / 32);
    c[q] = a[q] ? (uint32_t)__ldg(cand_bits + (long long)(src0 + r) *
                                                  v_count + v0 + tx)
                : 0u;
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int r = ty + q * (kWriteThreads / 32);
    sh_arr[tx * (kTile + 1) + r] = a[q];
    sh_cand[tx * (kTile + 1) + r] = c[q];
  }
  for (int i = threadIdx.x; i < n_src * s; i += kWriteThreads)
    sh_act[i] = __ldg(active + (long long)src0 * s + i);
  for (int i = threadIdx.x; i < kTile * row_bytes / 4; i += kWriteThreads)
    reinterpret_cast<uint32_t*>(sh_out)[i] = 0u;
  __syncthreads();

  const long long ns = (long long)n * s;
  for (int vl = ty; vl < n_val; vl += kWriteThreads / 32) {
    uint32_t left = sh_arr[vl * (kTile + 1) + tx];
    const uint32_t cw = sh_cand[vl * (kTile + 1) + tx];
    const long long key0 =
        (long long)(v0 + vl) * ns + (long long)(src0 + tx) * s;
    while (left) {
      const int sl = __ffs(left) - 1;
      left &= left - 1u;
      const int fo = __popc(cw & ((1u << sl) - 1u));
      if (fo >= f) continue;
      bool ok = cap <= 0;
      if (!ok) {
        const int t = sh_act[tx * s + sl];
        ok = t >= 0 && t < n && key0 + sl < __ldg(cut + t);
      }
      if (ok) sh_out[vl * row_bytes + tx * f + fo] = 1;
    }
  }
  __syncthreads();

  // value row vl of the tile: n_src * f contiguous bytes of the plane
  const int len = n_src * f;
  for (int vl = ty; vl < n_val; vl += kWriteThreads / 32) {
    uint8_t* dst = accepted + ((long long)(v0 + vl) * n + src0) * f;
    const uint8_t* row = sh_out + vl * row_bytes;
    int i0 = 0;
    if ((reinterpret_cast<uintptr_t>(dst) & 3u) == 0u) {
      i0 = len & ~3;
      for (int i = tx; i < len / 4; i += 32)
        reinterpret_cast<uint32_t*>(dst)[i] =
            reinterpret_cast<const uint32_t*>(row)[i];
    }
    for (int i = i0 + tx; i < len; i += 32) dst[i] = row[i];
  }
}

}  // namespace

// A batch of nl lanes: active [nl, N, S], the words [nl, N, V], accepted
// [nl * V, N, F], the node counts [nl, N]; `lanes` points at nl AdmitLane
// records in host memory.  scratch: 36 * nl * n int32 words (cut [nl, n]
// i64, deg [nl, n], total [nl, n], bucket [nl, n, 32]), uninitialised; the
// launcher zeroes deg and total.
extern "C" int traffic_admit_launch(const int32_t* active,
                                    const int32_t* cand_bits,
                                    const int32_t* arr_bits, int32_t* scratch,
                                    uint8_t* accepted, int32_t* arrived_node,
                                    int32_t* accepted_node, int v_count,
                                    int n, int s, int f, const void* lanes,
                                    int nl, cudaStream_t stream) {
  AdmitLanes lane_args;
  if (!lanes_from_host(&lane_args, static_cast<const AdmitLane*>(lanes), nl,
                       nl, 1) ||
      v_count < 0 || n < 1 || s < 1 || s > 32 || f < 1 || f > s ||
      (long long)n * s > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  bool capped = false;
  for (int k = 0; k < nl; ++k) capped |= lane_args.l[k].ingress_cap > 0;
  const size_t kn = (size_t)nl * n;
  long long* cut = reinterpret_cast<long long*>(scratch);
  int32_t* deg = scratch + 2 * kn;
  int32_t* total = deg + kn;
  int32_t* bucket = total + kn;
  cudaError_t err =
      cudaMemsetAsync(deg, 0, 2 * kn * sizeof(int32_t), stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 warp_grid((unsigned)((n + kWarps - 1) / kWarps), (unsigned)nl);
  traffic_admit_tally_kernel<<<warp_grid, 32 * kWarps, 0, stream>>>(
      active, arr_bits, deg, total, bucket, v_count, n, s);
  if (capped)
    traffic_admit_cut_kernel<<<warp_grid, 32 * kWarps, 0, stream>>>(
        active, deg, total, bucket, arr_bits, cut, v_count, n, s, lane_args);
  const dim3 grid((unsigned)((n + kTile - 1) / kTile),
                  (unsigned)(v_count > 0 ? (v_count + kTile - 1) / kTile : 1),
                  (unsigned)nl);
  const size_t smem = 2 * kTile * (kTile + 1) * sizeof(uint32_t) +
                      kTile * s * sizeof(int32_t) + kTile * kTile * f;
  traffic_admit_write_kernel<<<grid, kWriteThreads, smem, stream>>>(
      active, cand_bits, arr_bits, cut, total, accepted, arrived_node,
      accepted_node, v_count, n, s, f, lane_args);
  return (int)cudaGetLastError();
}
