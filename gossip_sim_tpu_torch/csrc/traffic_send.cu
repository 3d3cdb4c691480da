// traffic_send — the traffic round's candidates, egress budget and fault
// gates, for every (value, sender).
//
// Replaces the reference engine's `traffic/candidates`, `traffic/egress_cap`
// and `traffic/network` blocks (gossip_sim_tpu/engine/traffic.py:255-314:
// verb 1's slot-key sort with a leading value axis over the shared active
// set, an exclusive cumsum per sender over the value-major candidate order,
// then the gates).
//
// Input:  active [N, S] i32 the shared active set (N = empty), pruned
//         [V, N, S] u8, failed [N] u8, v_live [V] u8, v_holder [V, N] u8,
//         v_origin/v_vid [V] i32, side [N + 1] i32.
// Output: peer [V, N, F] i32 the first F valid slots' peers (N = none);
//         code [V, N, F] u8: 5 deferred (egress cap), 2 failed target,
//         3 suppressed (partition), 4 dropped (loss), 1 arrived, 0 none;
//         cand_bits / arr_bits [N, V] i32 (sender-major, for traffic_admit's
//         walk over the values): bit s set where slot s is a candidate /
//         its message arrived.
// Scratch (egress cap on only; the wrapper's, 1 + K * ceil(V / 32) * N
//         u64 words): a block ticket, then one look-back word per (lane,
//         value chunk, sender); the launcher zeroes it.
// Lanes: a batch of K sweep lanes (engine/traffic.py run_traffic_lanes)
//         runs in one launch.  Each plane above has a leading lane axis
//         (active [K, N, S], failed [K, N], the value planes [K * V, ...],
//         the slot words [K, N, V]); side is shared.  A lane's egress cap,
//         partition window and loss basis and threshold come from its
//         record (lanes.cuh).  The grid is lane-major: a lane's chunks never
//         mix with another's, and the look-back restarts at each lane's
//         first chunk.  The serial round is K = 1.
//
// A slot is valid when the sender is live, holds the value and has not
// failed, the slot holds a peer, its prune bit is clear and the peer is not
// the value's origin.  With the egress cap on, a candidate is sent iff the
// sender's candidates before it in (value, fanout slot) order are fewer
// than the cap.  Then failed target > partition > per-value packet loss,
// whose hash is edge_u32(fmix32(basis ^ vid * GOLD), src, dst) (faults.cuh).
//
// Design: a block per tile of 32 senders x 32 values (a value chunk), 256
// threads, a 1-D grid of K * ceil(N / 32) * ceil(V / 32) blocks in
// lane-major, then chunk-major order.  A warp takes 4 of the tile's value
// rows, a lane per sender.
//   1. every load that needs no other, issued together: the senders'
//      slots (a lane per sender, 4 slots per warp), their failed flags and
//      sides, and each of a warp's 4 rows' live flag, holder bytes (one
//      line of the holder plane), origin and vid;
//   2. the prune tile: each warp ballots its rows' live holders, then
//      copies the row's prune span (a value's 32 senders' rows are 32 * S
//      contiguous bytes) into shared memory with cp.async, 16-byte vectors
//      (bytes where the plane's alignment does not allow them), only the
//      vectors that cover a live holder: rows of other senders read no
//      prune byte.  Meanwhile the slots' gathers (is a peer, the peer
//      failed, it is across the partition).  So a block waits on two
//      dependent loads, then one barrier, before it computes;
//   3. candidates: each sender's slots as bit masks (a peer, the peer
//      failed, it is across the partition), built once per block; a
//      (value, sender)'s prune bytes become a mask by one multiply per
//      word, and its candidates are the first f set bits of (peer and not
//      pruned) whose peer is not the value's origin.  With the cap on they
//      are taken in a pass of their own, for the counts; with it off, in
//      step 5's pass;
//   4. the egress count (cap on only): the exclusive running count of a
//      sender's candidates over (value, fanout slot) order, across chunks by
//      a decoupled look-back.  Blocks take tickets from an atomic counter
//      (chunk-major, so every block waits only on blocks that already run);
//      warp 0 publishes its 32 senders' chunk totals (flag A), adds the
//      totals of the earlier chunks back to the first inclusive prefix
//      (flag P), publishes its own prefix and scans its 32 rows in shared
//      memory.  Counts saturate at the cap, which is all the gate compares;
//   5. gates and stores, a row at a time per warp: one pass over the
//      fanout slots takes each next candidate (the lowest bit left; with
//      the cap off, passing over a slot that holds the origin) and its
//      gates as bit tests; the warp stages the row's peers (32 * F i32)
//      and codes (32 * F bytes) in shared memory and writes each as
//      contiguous 16-byte vectors (words or bytes where the plane's
//      alignment does not allow them); the slot words go through a 32 x 32
//      shared transpose, so each sender's 32 values leave as one 128-byte
//      line of the [N, V] planes.
// With every lane's cap off the grid is the block index and nothing is
// scanned or zeroed: one launch.  With one on: a memset of the scratch and
// one launch.
//
// Bound on the H100: memory.  It reads the [V, N, S] prune bits of the live
// holders and the [V, N] holder plane and writes the [V, N, F] peers and
// codes and the two [N, V] words; the active set is staged per block from
// L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "faults.cuh"
#include "lanes.cuh"
#include "row_stage.cuh"

namespace {

constexpr int kTile = 32;                 // senders and values of a block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kTile / kWarps;     // value rows per warp
constexpr int kSlotsPerThread = 32 / kWarps;  // a sender's slots, S <= 32
constexpr int kDefaultSmem = 48 * 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kGold = 0x9E3779B1u;
constexpr uint8_t kArrived = 1, kFailedTarget = 2, kSuppressed = 3,
                  kDropped = 4, kDeferred = 5;
// look-back word: flag << 32 | count
constexpr unsigned long long kAggregate = 1ull << 32, kPrefix = 2ull << 32;

// one lane's knobs (kernels/traffic_send.py LANE_DTYPE)
struct SendLane {
  unsigned long long loss_threshold;  // 2^32 = every message
  int32_t egress_cap;                 // <= 0: off
  int32_t part_on;                    // the partition window is on
  uint32_t loss_basis;
  int32_t pad;
};
using SendLanes = LaneArray<SendLane>;

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

struct Layout {  // byte offsets into the dynamic shared memory
  int act, parts, prn, cnt, cbt, abt, row, stage, stage_bytes, total;
  __host__ __device__ Layout(int s, int f) {
    act = 0;                                      // [s][32 senders] i32
    parts = act + kTile * s * 4;                  // [3][8 warps][32] u32
    prn = parts + 3 * kWarps * kTile * 4;         // [32 rows][32 * s] u8
    cnt = prn + kTile * kTile * s;                // [32 rows][32] i32
    cbt = cnt + kTile * kTile * 4;                // [32 senders][33] u32
    abt = cbt + kTile * (kTile + 1) * 4;
    row = abt + kTile * (kTile + 1) * 4;          // [3][32 rows] u32
    stage_bytes = align16(kTile * f * 4) + align16(kTile * f);
    stage = align16(row + 3 * kTile * 4);         // [8 warps][stage_bytes]
    total = stage + kWarps * stage_bytes;
  }
};

// n bytes from shared src to global dst, by the warp's lanes: 16-byte
// vectors where both ends allow them, else words, else bytes.
__device__ __forceinline__ void warp_copy_out(uint8_t* dst,
                                              const uint8_t* src, int n,
                                              int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if ((a & 15u) == 0 && (n & 15) == 0) {
    for (int q = lane; q < n / 16; q += 32)
      reinterpret_cast<uint4*>(dst)[q] =
          reinterpret_cast<const uint4*>(src)[q];
  } else if ((a & 3u) == 0 && (n & 3) == 0) {
    for (int q = lane; q < n / 4; q += 32)
      reinterpret_cast<uint32_t*>(dst)[q] =
          reinterpret_cast<const uint32_t*>(src)[q];
  } else {
    for (int q = lane; q < n; q += 32) dst[q] = src[q];
  }
}

// The s prune bytes (each 0 or 1) at byte b0 of the prune tile as a bit
// mask: the aligned words that hold them, four bytes' low bits gathered
// into bits 28-31 by one multiply per word.
__device__ __forceinline__ uint32_t prune_mask(const uint8_t* prn, int b0,
                                               int s) {
  const int a0 = b0 & ~3, off = b0 - a0;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(prn + a0);
  if (off + s <= 32) {
    uint32_t pb = 0;
    for (int q = 0; 4 * q < off + s; ++q)
      pb |= (((w[q] & 0x01010101u) * 0x10204080u) >> 28) << (4 * q);
    return pb >> off;
  }
  unsigned long long pb = 0;
  for (int q = 0; 4 * q < off + s; ++q)
    pb |= (unsigned long long)(((w[q] & 0x01010101u) * 0x10204080u) >> 28)
          << (4 * q);
  return (uint32_t)(pb >> off);
}

__global__ void __launch_bounds__(kThreads)
traffic_send_kernel(const int32_t* __restrict__ active,
                    const uint8_t* __restrict__ pruned,
                    const uint8_t* __restrict__ failed,
                    const uint8_t* __restrict__ v_live,
                    const uint8_t* __restrict__ v_holder,
                    const int32_t* __restrict__ v_origin,
                    const int32_t* __restrict__ v_vid,
                    const int32_t* __restrict__ side,
                    int32_t* __restrict__ peer_out,
                    uint8_t* __restrict__ code_out,
                    int32_t* __restrict__ cand_bits,
                    int32_t* __restrict__ arr_bits, unsigned long long* scan,
                    int v_count, int n, int s, int f, int tiles, int chunks,
                    int ticketed, int loss, int prune_vec,
                    const __grid_constant__ SendLanes lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_block;
  const Layout L(s, f);
  int32_t* act = reinterpret_cast<int32_t*>(smem + L.act);
  uint32_t* parts = reinterpret_cast<uint32_t*>(smem + L.parts);
  uint8_t* prn = smem + L.prn;
  int32_t* cnt = reinterpret_cast<int32_t*>(smem + L.cnt);
  uint32_t* cbt = reinterpret_cast<uint32_t*>(smem + L.cbt);
  uint32_t* abt = reinterpret_cast<uint32_t*>(smem + L.abt);
  int32_t* r_origin = reinterpret_cast<int32_t*>(smem + L.row);
  uint32_t* r_basis = reinterpret_cast<uint32_t*>(r_origin + kTile);
  uint32_t* r_hm = r_basis + kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int block = blockIdx.x;
  if (ticketed) {  // tickets in start order: a block's earlier chunks run
    if (threadIdx.x == 0)
      s_block = (int)atomicAdd(reinterpret_cast<unsigned int*>(scan), 1u);
    __syncthreads();
    block = s_block;
  }
  // the block's lane (lane-major: every chunk of lane k before lane k + 1),
  // its knobs and its planes
  const int k_lane = block / (chunks * tiles);
  block -= k_lane * chunks * tiles;
  const SendLane& kn = lanes.l[k_lane];
  const int egress_cap = kn.egress_cap;
  const int part_on = kn.part_on;
  const uint32_t loss_basis = kn.loss_basis;
  const unsigned long long loss_threshold = kn.loss_threshold;
  const bool capped = egress_cap > 0;
  {
    const long long kv = (long long)k_lane * v_count;
    active += (long long)k_lane * n * s;
    pruned += kv * n * s;
    failed += (long long)k_lane * n;
    v_live += kv;
    v_holder += kv * n;
    v_origin += kv;
    v_vid += kv;
    peer_out += kv * n * f;
    code_out += kv * n * f;
    cand_bits += kv * n;
    arr_bits += kv * n;
    if (scan != nullptr) scan += (long long)k_lane * chunks * n;
  }
  const int chunk = block / tiles;
  const int n0 = (block - chunk * tiles) * kTile;
  const int v0 = chunk * kTile;
  const int nl = min(kTile, n - n0);        // senders of this tile
  const int nv = min(kTile, v_count - v0);  // values of this chunk
  const int row_len = kTile * s;            // prune bytes of a full row
  const int node = n0 + lane;
  const int nodec = min(node, n - 1);       // a valid address for any lane

  // 1. every load that needs no other, issued together: the senders'
  // slots (a lane per sender, slots warp, warp + 8, ...), their failed
  // flags and sides, and each of the warp's value rows' live flag, holder
  // byte (a line of the holder plane), origin and vid
  int32_t pv[kSlotsPerThread];
#pragma unroll
  for (int k = 0; k < kSlotsPerThread; ++k) {
    const int j = warp + kWarps * k;
    pv[k] = (j < s && lane < nl) ? __ldg(active + (long long)node * s + j)
                                 : n;
  }
  const bool sends = lane < nl && !__ldg(failed + nodec);
  const int32_t my_side = __ldg(side + nodec);
  uint8_t live[kRows], hold[kRows];
  int32_t origin[kRows], vid[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int vc = min(v0 + warp + kWarps * i, v_count - 1);
    live[i] = __ldg(v_live + vc);
    hold[i] = __ldg(v_holder + (long long)vc * n + nodec);
    origin[i] = __ldg(v_origin + vc);
    vid[i] = loss ? __ldg(v_vid + vc) : 0;
  }
  // the 16-byte vectors j = lane + 32 t of a row's prune span, as the
  // senders each covers (0 past the span)
  uint32_t cover[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int j = lane + 32 * t;
    cover[t] = 0;
    if (16 * j < nl * s) {
      const int lo = 16 * j / s, hi = min((16 * j + 15) / s, kTile - 1);
      cover[t] = (0xFFFFu >> (15 - (hi - lo))) << lo;
    }
  }

  // 2. each warp's rows: the live holders as a 32-bit mask, then of the
  // row's prune span (nl * s bytes) only the 16-byte vectors (bytes, where
  // the plane does not allow vectors) that cover a live holder, copied to
  // shared memory by cp.async while the gathers below run
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp + kWarps * i;
    const uint32_t hm =
        __ballot_sync(kFull, r < nv && sends && live[i] && hold[i]);
    if (lane == 0) {
      r_hm[r] = hm;
      r_origin[r] = r < nv ? origin[i] : n;
      r_basis[r] = loss ? fmix32(loss_basis ^ ((uint32_t)vid[i] * kGold))
                        : 0u;
    }
    if (!hm) continue;  // whole warp
    const uint8_t* src = pruned + ((long long)(v0 + r) * n + n0) * s;
    uint8_t* dst = prn + r * row_len;
    if (prune_vec) {  // the plane and every span 16-byte aligned
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        if (cover[t] & hm)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                           (unsigned)__cvta_generic_to_shared(dst + 16 * j)),
                       "l"(src + 16 * j)
                       : "memory");
      }
    } else {
      for (int j = lane; j < nl * s; j += 32)
        if ((hm >> (j / s)) & 1u) dst[j] = __ldg(src + j);
    }
  }
  stage_commit();

  // the gathers: each sender's slots as bit masks (a peer, the peer
  // failed, it is across the partition), a part per warp, and its peers
  // slot-major
  uint32_t peer_b = 0, fail_b = 0, cross_b = 0;
#pragma unroll
  for (int k = 0; k < kSlotsPerThread; ++k) {
    const int j = warp + kWarps * k;
    if (j >= s) break;
    act[j * kTile + lane] = pv[k];
    if (pv[k] >= 0 && pv[k] < n) {
      peer_b |= 1u << j;
      if (__ldg(failed + pv[k])) fail_b |= 1u << j;
      if (__ldg(side + pv[k]) != my_side) cross_b |= 1u << j;
    }
  }
  parts[warp * kTile + lane] = peer_b;
  parts[(kWarps + warp) * kTile + lane] = fail_b;
  parts[(2 * kWarps + warp) * kTile + lane] = cross_b;
  stage_wait<0>();
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    peer_b |= parts[w * kTile + lane];
    fail_b |= parts[(kWarps + w) * kTile + lane];
    cross_b |= parts[(2 * kWarps + w) * kTile + lane];
  }

  // 3. (cap on only) candidates first, for the counts
  if (capped) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = warp + kWarps * i;
      uint32_t m = ((r_hm[r] >> lane) & 1u)
                       ? peer_b & ~prune_mask(prn, r * row_len + lane * s, s)
                       : 0u;
      const int32_t o = r_origin[r];
      uint32_t bits = 0;
      int c = 0;
      while (m && c < f) {
        const int j = __ffs(m) - 1;
        m &= m - 1;
        if (act[j * kTile + lane] != o) {
          bits |= 1u << j;
          ++c;
        }
      }
      cbt[lane * (kTile + 1) + r] = bits;
      cnt[r * kTile + lane] = c;
    }
  }

  // 4. the egress count: cnt[r][lane] becomes the sender's candidates
  // before value v0 + r, saturated at the cap
  if (capped) {
    __syncthreads();
    if (warp == 0 && lane < nl) {
      int agg = 0;
      for (int r = 0; r < kTile; ++r) agg += cnt[r * kTile + lane];
      volatile unsigned long long* words = scan + 1 + node;
      long long excl = 0;
      if (chunk > 0) {
        words[(long long)chunk * n] =
            kAggregate | (unsigned)min(agg, egress_cap);
        for (int c = chunk - 1;; --c) {
          unsigned long long w;
          while (((w = words[(long long)c * n]) >> 32) == 0) __nanosleep(32);
          excl += (unsigned)w;
          if ((w >> 32) == (kPrefix >> 32)) break;
        }
      }
      words[(long long)chunk * n] =
          kPrefix | (unsigned)min(excl + agg, (long long)egress_cap);
      long long run = excl;
      for (int r = 0; r < kTile; ++r) {
        const int t = cnt[r * kTile + lane];
        cnt[r * kTile + lane] = (int)min(run, (long long)egress_cap);
        run += t;
      }
    }
    __syncthreads();
  }

  // 5. each row's candidates (taken here with the cap off), gates, and
  // its peers and codes out through the warp's stage: one pass over the
  // fanout slots, the next candidate the lowest slot bit left
  int32_t* sp = reinterpret_cast<int32_t*>(smem + L.stage +
                                           warp * L.stage_bytes);
  uint8_t* sc = reinterpret_cast<uint8_t*>(sp) + align16(kTile * f * 4);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp + kWarps * i;
    if (r >= nv) continue;  // whole warp
    uint32_t m, cbits = 0, abits = 0;
    int room = f;  // fanout slots below room may go; the rest are deferred
    if (capped) {
      m = cbt[lane * (kTile + 1) + r];
      room = egress_cap - cnt[r * kTile + lane];
    } else {
      m = ((r_hm[r] >> lane) & 1u)
              ? peer_b & ~prune_mask(prn, r * row_len + lane * s, s)
              : 0u;
    }
    const int32_t o = r_origin[r];
    const uint32_t vb = r_basis[r];
    for (int k = 0; k < f; ++k) {
      int32_t p = n;
      uint8_t code = 0;
      int j = -1;
      while (m) {  // the next slot whose peer is not the origin
        const int jj = __ffs(m) - 1;
        m &= m - 1;
        const int32_t pp = act[jj * kTile + lane];
        if (pp != o) {
          j = jj;
          p = pp;
          break;
        }
      }
      if (j >= 0) {
        const uint32_t bit = 1u << j;
        cbits |= bit;
        if (k >= room) {
          code = kDeferred;
        } else if (fail_b & bit) {
          code = kFailedTarget;
        } else if (part_on && (cross_b & bit)) {
          code = kSuppressed;
        } else if (loss && (unsigned long long)edge_u32(
                               vb, (uint32_t)node, (uint32_t)p) <
                               loss_threshold) {
          code = kDropped;
        } else {
          code = kArrived;
          abits |= bit;
        }
      }
      sp[lane * f + k] = p;
      sc[lane * f + k] = code;
    }
    cbt[lane * (kTile + 1) + r] = cbits;
    abt[lane * (kTile + 1) + r] = abits;
    __syncwarp();
    const long long base = ((long long)(v0 + r) * n + n0) * f;
    warp_copy_out(reinterpret_cast<uint8_t*>(peer_out + base),
                  reinterpret_cast<const uint8_t*>(sp), nl * f * 4, lane);
    warp_copy_out(code_out + base, sc, nl * f, lane);
    __syncwarp();
  }
  __syncthreads();

  // the slot words, transposed: sender sl's nv values as one line
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int sl = warp + kWarps * i;
    if (sl < nl && lane < nv) {
      const long long at = (long long)(n0 + sl) * v_count + v0 + lane;
      cand_bits[at] = (int32_t)cbt[sl * (kTile + 1) + lane];
      arr_bits[at] = (int32_t)abt[sl * (kTile + 1) + lane];
    }
  }
}

}  // namespace

// A batch of nl lanes: every plane carries a leading lane axis (active
// [nl, N, S], pruned [nl * V, N, S], failed [nl, N], the value planes
// [nl * V, ...], the outputs [nl * V, N, F] and [nl, N, V]); `lanes` points
// at nl SendLane records in host memory.  loss: 0 or 1 (each lane's basis
// and threshold in its record).  scan: with any lane's egress cap on,
// 1 + nl * ceil(v_count / 32) * n u64 words (kernels/traffic_send.py
// scan_words; zeroed here), else unused (may be null).
extern "C" int traffic_send_launch(
    const int32_t* active, const uint8_t* pruned, const uint8_t* failed,
    const uint8_t* v_live, const uint8_t* v_holder, const int32_t* v_origin,
    const int32_t* v_vid, const int32_t* side, int32_t* peer_out,
    uint8_t* code_out, int32_t* cand_bits, int32_t* arr_bits,
    unsigned long long* scan, int v_count, int n, int s, int f, int loss,
    const void* lanes, int nl, cudaStream_t stream) {
  SendLanes lane_args;
  if (!lanes_from_host(&lane_args, static_cast<const SendLane*>(lanes), nl,
                       nl, 1) ||
      v_count < 0 || n < 1 || s < 1 || s > 32 || f < 1 || f > s ||
      (long long)nl * v_count * n * s >= (1ll << 40))
    return (int)cudaErrorInvalidValue;
  bool ticketed = false;
  for (int k = 0; k < nl; ++k) ticketed |= lane_args.l[k].egress_cap > 0;
  if (ticketed && scan == nullptr) return (int)cudaErrorInvalidValue;
  if (v_count == 0) return (int)cudaSuccess;
  const int tiles = (n + kTile - 1) / kTile;
  const long long chunks = (v_count + kTile - 1) / kTile;
  const long long blocks = (long long)nl * tiles * chunks;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const int smem = Layout(s, f).total;
  cudaError_t err = cudaSuccess;
  if (smem > kDefaultSmem)
    err = cudaFuncSetAttribute(traffic_send_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return (int)err;
  if (ticketed) {
    err = cudaMemsetAsync(scan, 0, (1 + nl * chunks * n) * sizeof(*scan),
                          stream);
    if (err != cudaSuccess) return (int)err;
  }
  const int prune_vec =
      (reinterpret_cast<uintptr_t>(pruned) & 15u) == 0 &&
      ((long long)n * s) % 16 == 0;
  traffic_send_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      active, pruned, failed, v_live, v_holder, v_origin, v_vid, side,
      peer_out, code_out, cand_bits, arr_bits, scan, v_count, n, s, f, tiles,
      (int)chunks, ticketed ? 1 : 0, loss, prune_vec, lane_args);
  return (int)cudaGetLastError();
}
