// health_round — the node-health planes' update of one round.
//
// Replaces the `p.health` arms of the reference engine's round
// (gossip_sim_tpu/engine/core.py:1255-1283) and traffic round
// (gossip_sim_tpu/engine/traffic.py:857-895), which the reference computes
// as a jnp.where over the [O, N] planes, a value-axis sum over [V, N] and
// one `jax.ops.segment_sum` of the (pruner -> prunee) pairs behind a
// `lax.cond` on the round's prune count.
//
// Round form (health_round_kernel), R = K * O rows of N nodes, C slots:
//   in:  prune_in, first_in [R, N] i32 (the carried planes), n_pruned
//        [R, N] i32, src_sorted [R, N, C] i32 and pruned_slot [R, N, C] u8
//        (the prune decision: row = pruner t, entry = prunee u), reached
//        [R, N] u8 (the round's delivery view), per lane its iteration and
//        measured-round gate (lanes.cuh records; row r is lane r / opl);
//   out: prune_out = prune_in + gate * (pruned slots naming each node),
//        first_out = it + 1 where first_in == 0 and the node is reached,
//        else first_in (not gated).
// Traffic form (health_round_traffic_kernel), K lanes of V values:
//   in:  the four [K, N] i32 planes (prune-received, latency sum,
//        deliveries, rescues), new_del and pull_del (or null) [K, V, N] u8,
//        v_birth [K, V] i32, n_pruned [K V, N], src_sorted / pruned_slot
//        [K V, N, C] over the value rows, per lane the round's iteration
//        and gate;
//   out: the four planes + gate * (pairs; sum over v of (del + resc) *
//        (it - v_birth + 1); of del + resc; of resc).
//
// Design, round form: a thread block cluster of cs CTAs per row
// (kernels/health_round.py round_geometry: cs and the CTA's threads so
// that the rows' clusters hold about two CTAs and 512 threads an SM: the
// more CTAs a row, the less one busy row holds the launch back; the fewer
// threads, the less a round where nothing fires costs); CTA k owns the
// row's nodes [k chunk, (k + 1) chunk) as pruners and as prunees.  A
// row's pairs land only in the row's own plane, so the cluster holds the
// whole plane: no global atomic and no grid barrier.
//   1. each CTA of a gated-in lane zeroes a count per node of the row in
//      its shared memory (kPlane: N up to 58,108 on the H100, whose
//      227 KB a block hold the row's counts, rounded up to 4, and the
//      16-byte busy flag; the kernel has no static shared memory, so the
//      opt-in limit bounds the launch's dynamic size whole);
//   2. a warp per 32 pruners of the CTA's nodes reads their n_pruned (128
//      coalesced bytes) and, where a pruner fires and its lane is gated
//      in, its C slot bytes as 16-byte words (C / 16 lanes a pruner, the
//      words side by side), fetches src_sorted at the set slots only (up
//      to eight a lane at once) and adds one to the prunee's count with a
//      shared memory atomic, one per pair (C not a multiple of 16: the
//      warp walks a firing pruner's bytes with its 32 lanes); cluster
//      barrier;
//   3. each CTA sums its own nodes' counts over the planes of the
//      cluster's CTAs that met a firing pruner (distributed shared memory
//      loads, 16 bytes each) and writes prune_in + the sum, arrives at
//      a cluster barrier, writes the first-delivery stamps and waits there
//      (a plane stays until every CTA has read it).
// Past a plane's shared memory the counts are the output plane itself
// (kDevice: each CTA copies its nodes' prune counts, a cluster barrier,
// then global atomics).
// Traffic form: one cooperative launch of one wave at most
// (kernels/health_round.py traffic_grid), two phases split by a grid
// barrier:
//   1. a block per (lane, 32 nodes), its 256 threads as 8 words of 4 nodes
//      x 32 value slices; a thread reads a 4-byte word of new_del and
//      pull_del per value of its slice (the ages it - v_birth + 1 of a
//      chunk of 256 values staged in shared memory), the slices' sums meet
//      in shared memory and each node's three planes are stored once; the
//      prune plane is copied;
//   2. the value rows' pairs into the lane's plane, a warp per 32 pruner
//      rows (4 groups' n_pruned read at once where the groups outnumber
//      the warps), the slots read as in the round form; the warp's lanes
//      step through their pairs together and lanes naming one prunee add
//      once (__match_any_sync), by a global atomic.
// The traffic form's atomics land on elements that phase 1 wrote: the
// barrier orders them (one wave's arrival at a counter in L2, ~2 us; a
// copy of the plane as an operation of its own would cost a launch).
// Every update is an integer sum, so the order of the atomics does not
// matter and the result equals the reference's segment_sum; int32 sums
// wrap as the reference's do (the arithmetic is unsigned).  A round where
// nothing fires is one pass over the planes plus a read of n_pruned: no
// host sync, no scatter.
//
// Bound on the H100: memory.  The planes in and out and the delivery view
// (traffic: both [K, V, N] delivery planes), n_pruned, and in a firing
// round the firing rows' slot bytes and src_sorted at their pruned slots.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;        // traffic form
constexpr int kRowThreads = 1024;    // round form: a CTA's most threads
constexpr int kCluster = 8;          // a row's CTAs: the portable size at most
constexpr unsigned kFull = 0xFFFFFFFFu;
// where the round form counts (kernels/health_round.py round_geometry):
// the output plane in device memory; each CTA a whole row's plane in
// shared memory, summed over the cluster at the end
constexpr int kDevice = 0, kPlane = 1;
// kPlane: the busy flag's room after the counts (kernels/health_round.py
// FLAG_BYTES)
constexpr int kFlagBytes = 16;
// traffic phase 1: a block's tile of nodes, as words of 4, and its slices
constexpr int kWordNodes = 4;
constexpr int kTileWords = 8;
constexpr int kTileNodes = kTileWords * kWordNodes;
constexpr int kSlices = kThreads / kTileWords;
constexpr int kAgeChunk = 256;
// the pairs: slot words (and traffic groups' n_pruned) read at once, and
// src_sorted entries of set slots loaded at once
constexpr int kUnroll = 4;
constexpr int kBatch = 8;
static_assert(kUnroll == 4, "walk_pairs selects among four words");

// One lane's round (kernels/health_round.py LANE_DTYPE).
struct HealthLane {
  long long it;
  int gate;
  int pad;
};

// 4 bytes of 0 / non-0 -> 4 bits, byte k to bit k
__device__ __forceinline__ unsigned nibble(unsigned x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// The pairs of the firing pruner rows of the group [i0, i0 + 32) (flat
// indices of n_pruned; bit l of `fired` for row i0 + l), by the whole warp
// in step: at each step every lane loads the next kBatch set slots of its
// four words (or none: -1) and calls emit(prunee, its row's plane) for
// each, on every lane.
// `plane` is lane l's row's plane offset (read by shuffle).
template <class Emit>
__device__ __forceinline__ void walk_pairs(const int32_t* __restrict__ src,
                                           const uint8_t* __restrict__ slot,
                                           int c, int vec, long long i0,
                                           unsigned fired, long long plane,
                                           int lane, Emit emit) {
  if (!fired) return;
  if (vec) {
    const int lpp = c >> 4;              // 16-byte words a row
    for (int q0 = 0; q0 < 32 * lpp; q0 += 32 * kUnroll) {
      // word u of this lane: slot bytes at0 + 512 u (32 lanes x 16 bytes
      // apart), of row (q0 + 32 u + lane) / lpp
      const long long at0 = i0 * c + (long long)(q0 + lane) * 16;
      uint4 w[kUnroll];
      long long pl[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + u * 32 + lane;
        const bool live = q < 32 * lpp;
        const int r = live ? q / lpp : 0;
        pl[u] = __shfl_sync(kFull, plane, r);
        w[u] = make_uint4(0u, 0u, 0u, 0u);
        if (live && ((fired >> r) & 1u))
          w[u] = __ldg(reinterpret_cast<const uint4*>(slot + at0 + 512 * u));
      }
      // the set slots of the four words as one mask, bit 16 u + byte
      unsigned long long bits = 0ull;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        bits |= (unsigned long long)(nibble(w[u].x) | (nibble(w[u].y) << 4) |
                                     (nibble(w[u].z) << 8) |
                                     (nibble(w[u].w) << 12))
                << (16 * u);
      while (__any_sync(kFull, bits != 0ull)) {
        int v[kBatch];
        long long p[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          v[j] = -1;
          p[j] = pl[0];
          if (bits) {
            const int b = __ffsll((long long)bits) - 1;
            bits &= bits - 1ull;
            v[j] = __ldg(src + at0 + 512 * (b >> 4) + (b & 15));
            const int u = b >> 4;          // a select: no local memory
            p[j] = u == 0 ? pl[0] : u == 1 ? pl[1] : u == 2 ? pl[2] : pl[3];
          }
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) emit(v[j], p[j]);
      }
    }
  } else {
    for (unsigned f = fired; f; f &= f - 1u) {
      const int r = __ffs(f) - 1;
      const long long pl = __shfl_sync(kFull, plane, r);
      const long long base = (i0 + r) * c;
      for (int b0 = 0; b0 < c; b0 += 32) {
        const int b = b0 + lane;
        int v = -1;
        if (b < c && __ldg(slot + base + b)) v = __ldg(src + base + b);
        emit(v, pl);
      }
    }
  }
}

__global__ void __launch_bounds__(kRowThreads)
health_round_kernel(const int32_t* __restrict__ prune_in,
                    const int32_t* __restrict__ first_in,
                    const int32_t* __restrict__ n_pruned,
                    const int32_t* __restrict__ src,
                    const uint8_t* __restrict__ slot,
                    const uint8_t* __restrict__ reached,
                    uint32_t* __restrict__ prune_out,
                    int32_t* __restrict__ first_out, int n, int c, int chunk,
                    int mode, int vec,
                    const __grid_constant__ LaneArray<HealthLane> lanes,
                    int opl) {
  // kPlane: [n rounded up to 4], the counts of the CTA's own pruners'
  // pairs, then the flag that this CTA counted any
  extern __shared__ uint4 cnt4[];
  uint32_t* cnt = reinterpret_cast<uint32_t*>(cnt4);
  int* busy = reinterpret_cast<int*>(cnt4 + (n + 3) / 4);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, nt = blockDim.x;
  const long long row = blockIdx.x / cs;
  const HealthLane hl = lanes.l[(int)(row / opl)];
  const int lo = rank * chunk, hi = min(n, lo + chunk);
  const long long base = row * n;

  // 1. zero the counts (in device memory: copy the owned nodes' prune
  // counts to the output, where the pairs then land, before any lands)
  const bool gate = hl.gate != 0;
  if (mode == kPlane) {
    if (tid == 0) *busy = 0;
    if (gate)
      for (int i = tid; i < (n + 3) / 4; i += nt)
        cnt4[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  } else {
    for (int u = lo + tid; u < hi; u += nt)
      prune_out[base + u] = (uint32_t)__ldg(prune_in + base + u);
    cluster.sync();
  }

  // 2. the owned pruners' pairs into the counts
  if (gate) {
    auto emit = [=](int v, long long) {
      if (v < 0 || v >= n) return;
      if (mode == kPlane)
        atomicAdd(cnt + v, 1u);
      else
        atomicAdd(prune_out + base + v, 1u);
    };
    for (int g0 = lo + (tid >> 5) * 32; g0 < hi; g0 += nt) {
      const int t = g0 + lane;
      const unsigned fired =
          __ballot_sync(kFull, t < hi && __ldg(n_pruned + base + t) > 0);
      if (mode == kPlane && fired && lane == 0) *busy = 1;
      walk_pairs(src, slot, c, vec, base + g0, fired, 0, lane, emit);
    }
  }
  cluster.sync();

  // 3. the owned nodes' planes (kPlane: their counts summed over the
  // cluster's planes, four nodes a thread: chunk is a multiple of 4)
  const int32_t stamp = (int32_t)(hl.it + 1);
  if (mode == kPlane) {
    // the cluster's CTAs that counted: lane q reads CTA q's flag
    const unsigned counted = __ballot_sync(
        kFull, lane < cs && *cluster.map_shared_rank(busy, lane));
    for (int u4 = lo + 4 * tid; u4 < hi; u4 += 4 * nt) {
      uint4 x[kCluster];
#pragma unroll
      for (int q = 0; q < kCluster; ++q) {
        x[q] = make_uint4(0u, 0u, 0u, 0u);
        if ((counted >> q) & 1u)
          x[q] = *reinterpret_cast<const uint4*>(
              cluster.map_shared_rank(cnt + u4, q));
      }
      uint4 sum = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int q = 0; q < kCluster; ++q) {
        sum.x += x[q].x;
        sum.y += x[q].y;
        sum.z += x[q].z;
        sum.w += x[q].w;
      }
      const uint32_t add[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (u4 + b < hi)
          prune_out[base + u4 + b] =
              (uint32_t)__ldg(prune_in + base + u4 + b) + add[b];
    }
    // this CTA has read the cluster's planes; the wait below keeps its
    // own until every CTA has
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  }
  for (int u = lo + tid; u < hi; u += nt) {
    const long long i = base + u;
    const int32_t f = __ldg(first_in + i);
    first_out[i] = (f == 0 && __ldg(reached + i)) ? stamp : f;
  }
  if (mode == kPlane)
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The traffic form's phase 2 over every value-row pruner: a warp per group
// of 32 rows, kUnroll groups' n_pruned read at once where the groups
// outnumber the warps; a row's pairs into its lane's plane (lane = row /
// v), lanes naming one prunee in a step adding once.
__device__ void traffic_pairs(const int32_t* __restrict__ n_pruned,
                              const int32_t* __restrict__ src,
                              const uint8_t* __restrict__ slot,
                              uint32_t* plane_out, long long rows, int n,
                              int c, int v, int vec,
                              const LaneArray<HealthLane>& lanes) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * kThreads) >> 5;
  const long long groups = (rows + 31) / 32;
  const int step = groups >= warps * kUnroll ? kUnroll : 1;
  auto emit = [&](int u, long long pl) {
    const long long key = (u >= 0 && u < n) ? pl + u : -1;
    const unsigned peers =
        __match_any_sync(kFull, (unsigned long long)key);
    if (key >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(plane_out + key, (uint32_t)__popc(peers));
  };
  for (long long g0 = warp * step; g0 < groups; g0 += warps * step) {
    int np[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = (g0 + u) * 32 + lane;
      np[u] = (u < step && i < rows) ? __ldg(n_pruned + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (u >= step || g0 + u >= groups) continue;   // warp-uniform
      const long long i = (g0 + u) * 32 + lane;
      bool fire = false;
      long long plane = 0;
      if (np[u] > 0) {
        const int ln = (int)(i / n / v);
        fire = lanes.l[ln].gate != 0;
        plane = (long long)ln * n;
      }
      walk_pairs(src, slot, c, vec, (g0 + u) * 32,
                 __ballot_sync(kFull, fire), plane, lane, emit);
    }
  }
}

// a 4-node word of a [.., N] u8 plane at node `node` of the row at `at`
__device__ __forceinline__ unsigned word_at(const uint8_t* p, long long at,
                                            int node, int n, int vec) {
  if (vec && node + 3 < n)
    return __ldg(reinterpret_cast<const unsigned*>(p + at));
  unsigned w = 0u;
#pragma unroll
  for (int b = 0; b < kWordNodes; ++b)
    if (node + b < n) w |= (unsigned)__ldg(p + at + b) << (8 * b);
  return w;
}

__global__ void __launch_bounds__(kThreads)
health_round_traffic_kernel(
    const int32_t* __restrict__ prune_in, const int32_t* __restrict__ lat_in,
    const int32_t* __restrict__ del_in, const int32_t* __restrict__ resc_in,
    const uint8_t* __restrict__ new_del, const uint8_t* __restrict__ pull_del,
    const int32_t* __restrict__ v_birth, uint32_t* __restrict__ prune_out,
    uint32_t* __restrict__ lat_out, uint32_t* __restrict__ del_out,
    uint32_t* __restrict__ resc_out, const int32_t* __restrict__ n_pruned,
    const int32_t* __restrict__ src, const uint8_t* __restrict__ slot,
    int k, int v, int n, int c, int vec, int vec_slots,
    const __grid_constant__ LaneArray<HealthLane> lanes) {
  cg::grid_group grid = cg::this_grid();
  __shared__ uint32_t s_age[kAgeChunk];
  __shared__ uint32_t s_part[3][kSlices][kTileNodes];
  const int tid = threadIdx.x;
  const int word = tid % kTileWords, slice = tid / kTileWords;
  const int tiles_per_lane = (n + kTileNodes - 1) / kTileNodes;
  const long long tiles = (long long)k * tiles_per_lane;

  // 1. per (lane, 32 nodes): the sums over the values, and the prune copy
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int lane = (int)(t / tiles_per_lane);
    const int node0 = (int)(t - (long long)lane * tiles_per_lane) * kTileNodes;
    const int node = node0 + word * kWordNodes;
    const HealthLane hl = lanes.l[lane];
    uint32_t lat[kWordNodes] = {}, dels[kWordNodes] = {},
             rescs[kWordNodes] = {};
    if (hl.gate) {
      for (int v0 = 0; v0 < v; v0 += kAgeChunk) {
        const int len = min(kAgeChunk, v - v0);
        __syncthreads();
        for (int j = tid; j < len; j += kThreads)
          s_age[j] = (uint32_t)hl.it -
                     (uint32_t)__ldg(v_birth + (long long)lane * v + v0 + j) +
                     1u;
        __syncthreads();
        if (node < n) {
#pragma unroll 4
          for (int j = slice; j < len; j += kSlices) {
            const long long at = ((long long)lane * v + v0 + j) * n + node;
            const unsigned d = word_at(new_del, at, node, n, vec);
            const unsigned r =
                pull_del ? word_at(pull_del, at, node, n, vec) : 0u;
            const unsigned all = d + r;         // bytes of 0-2: no carry
            if (!all) continue;
            const uint32_t age = s_age[j];
#pragma unroll
            for (int b = 0; b < kWordNodes; ++b) {
              const uint32_t ab = (all >> (8 * b)) & 0xFFu;
              lat[b] += ab * age;
              dels[b] += ab;
              rescs[b] += (r >> (8 * b)) & 0xFFu;
            }
          }
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kWordNodes; ++b) {
      s_part[0][slice][word * kWordNodes + b] = lat[b];
      s_part[1][slice][word * kWordNodes + b] = dels[b];
      s_part[2][slice][word * kWordNodes + b] = rescs[b];
    }
    __syncthreads();
    if (tid < 4 * kTileNodes) {
      const int plane = tid / kTileNodes, nd = tid % kTileNodes;
      const int u = node0 + nd;
      if (u < n) {
        const long long at = (long long)lane * n + u;
        if (plane == 3) {
          prune_out[at] = (uint32_t)__ldg(prune_in + at);
        } else {
          uint32_t s = 0u;
#pragma unroll 8
          for (int q = 0; q < kSlices; ++q) s += s_part[plane][q][nd];
          const int32_t* in = plane == 0 ? lat_in : plane == 1 ? del_in
                                                               : resc_in;
          uint32_t* out = plane == 0 ? lat_out : plane == 1 ? del_out
                                                            : resc_out;
          out[at] = (uint32_t)__ldg(in + at) + s;
        }
      }
    }
    __syncthreads();
  }
  grid.sync();

  // 2. the firing pruners' pairs, over the K V value rows
  traffic_pairs(n_pruned, src, slot, prune_out, (long long)k * v * n, n, c,
                v, vec_slots, lanes);
}

bool aligned(const void* p, uintptr_t to) {
  return ((uintptr_t)p % to) == 0;
}

}  // namespace

// lanes: k HealthLane records in host memory; row r (of R = k * opl) is
// lane r / opl.  cs, chunk, mode, threads: kernels/health_round.py
// round_geometry (a cluster of cs CTAs of `threads` threads a row, each
// owning chunk nodes; where the counts are: kPlane n * 4 bytes of shared
// memory a CTA, n rounded up to 4 and chunk a multiple of 4, and the busy
// flag's kFlagBytes; kDevice the output, no shared memory).
extern "C" int health_round_launch(
    const int32_t* prune_in, const int32_t* first_in, const int32_t* n_pruned,
    const int32_t* src_sorted, const uint8_t* pruned_slot,
    const uint8_t* reached, uint32_t* prune_out, int32_t* first_out, int r,
    int n, int c, const void* lanes, int k, int opl, int cs, int chunk,
    int mode, int threads, cudaStream_t stream) {
  if (r < 0 || n < 1 || c < 0 || cs < 1 || cs > kCluster || chunk < 1 ||
      (long long)cs * chunk < n || (long long)r * cs > 0x7FFFFFFFLL ||
      (mode != kDevice && mode != kPlane) || threads < 32 ||
      threads > kRowThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  LaneArray<HealthLane> la;
  if (!lanes_from_host(&la, static_cast<const HealthLane*>(lanes), k,
                       (long long)r, opl))
    return (int)cudaErrorInvalidValue;
  if (r == 0) return (int)cudaSuccess;
  if (mode == kPlane && chunk % 4) return (int)cudaErrorInvalidValue;
  const long long smem_ll =
      mode == kPlane ? 4LL * ((n + 3) / 4 * 4) + kFlagBytes : 0;
  if (smem_ll > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const int smem = (int)smem_ll;
  cudaError_t err = cudaFuncSetAttribute(
      health_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = c % 16 == 0 && aligned(pruned_slot, 16);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(r * cs));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, health_round_kernel, prune_in, first_in,
                           n_pruned, src_sorted, pruned_slot, reached,
                           prune_out, first_out, n, c, chunk, mode, vec,
                           la, opl);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// lanes: k HealthLane records (opl = 1: a record per lane of V value
// rows), each with the round's iteration and the lane's gate.  grid:
// kernels/health_round.py traffic_grid (at most the blocks the card holds
// at once: a cooperative launch).
extern "C" int health_round_traffic_launch(
    const int32_t* prune_in, const int32_t* lat_in, const int32_t* del_in,
    const int32_t* resc_in, const uint8_t* new_del, const uint8_t* pull_del,
    const int32_t* v_birth, const int32_t* n_pruned,
    const int32_t* src_sorted, const uint8_t* pruned_slot,
    uint32_t* prune_out, uint32_t* lat_out, uint32_t* del_out,
    uint32_t* resc_out, int k, int v, int n, int c, const void* lanes,
    int kl, int opl, int grid, cudaStream_t stream) {
  if (k < 1 || v < 0 || n < 1 || c < 0 || grid < 1 || kl != k || opl != 1)
    return (int)cudaErrorInvalidValue;
  LaneArray<HealthLane> la;
  if (!lanes_from_host(&la, static_cast<const HealthLane*>(lanes), kl,
                       (long long)k, opl))
    return (int)cudaErrorInvalidValue;
  int vec = n % kWordNodes == 0 && aligned(new_del, 4) &&
            (pull_del == nullptr || aligned(pull_del, 4));
  int vec_slots = c % 16 == 0 && aligned(pruned_slot, 16);
  void* args[] = {&prune_in, &lat_in,    &del_in,     &resc_in,   &new_del,
                  &pull_del, &v_birth,   &prune_out,  &lat_out,   &del_out,
                  &resc_out, &n_pruned,  &src_sorted, &pruned_slot, &k,
                  &v,        &n,         &c,          &vec,       &vec_slots,
                  &la};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)health_round_traffic_kernel, dim3((unsigned)grid),
      dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Blocks of the traffic kernel that one SM holds at once, into *blocks;
// returns the CUDA error.
extern "C" int health_round_traffic_blocks_per_sm(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, (const void*)health_round_traffic_kernel, kThreads, 0);
}
