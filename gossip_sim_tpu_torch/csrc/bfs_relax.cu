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
//
// Seeding follows core.py:627-633 exactly: the origin's own targets are the
// hop-1 frontier (reached, dist 1), then the origin itself is reached at 0.
// Each hop ORs the bit of every target of a frontier node into a bitmap,
// then newly = (OR of those bits) & ~reached gets dist h + 1.  An OR does
// not depend on the order of its writers, so the result is exact.
//
// Bound on the H100: latency.  The function must read tgt once (O*N*F*4
// bytes) and write reached/dist once, a few microseconds at 3.35 TB/s, but
// a BFS needs one dependent step per hop (~10 hops on the 10k-node
// cluster, ~12 at 100k, hundreds on a path), and each step is a chain of
// latencies: the frontier's target loads (L2, or HBM where tgt outgrows
// L2), a cluster barrier, a DSMEM load, a block barrier.  The design keeps
// that chain to one load latency a hop, whatever the frontier's size: the
// loads of a hop are issued by every thread of the CTA together, not one
// frontier word after another.
//
// Design: a thread block cluster of cs CTAs per origin (cs from O and the
// card, chosen by the wrapper: the most CTAs per origin, up to 8 and at
// most one per SM, whose clusters the card holds in one wave; cs need not
// be a power of two).  Each CTA of a cluster asks for more than half of an
// SM's shared memory, so that no SM serves two CTAs: a hop waits on the
// slowest CTA of the cluster, and one that shares its SM is slower (the
// wrapper reads the one-wave cluster count at that size).  CTA r owns the
// word-aligned node slice [r*S, (r+1)*S), S = ceil(N / cs) rounded up to
// 32, so no bitmap word is shared by two CTAs.  Each CTA keeps its bitmaps
// in shared memory: reached and frontier for its slice, and two "sent"
// bitmaps over all N nodes, by hop parity; and a list of frontier nodes.
// Each hop:
//   1. compact: the CTA's frontier words are taken `chunk` words at a time
//      (one thread per word, `chunk` <= 512); a block-wide prefix sum of the
//      words' popcounts places each set bit's node in the shared list (32 x
//      chunk slots, so a chunk always fits; a full list is relaxed before
//      the next chunk is placed);
//   2. relax: thread i takes list entries i, i + 1024, ...: it loads the
//      node's F targets (one batch of loads) and ORs each target's bit into
//      its own CTA's sent bitmap of this hop's parity (a local shared-memory
//      atomic, skipped if the bit is already in either sent bitmap).  All
//      1024 threads' loads are in flight together, so a hop waits one load
//      latency for each 1024 frontier nodes of a CTA, not one per frontier
//      word.  A CTA whose frontier is not empty also sets the hop's "live"
//      flag in every CTA of the cluster;
//   3. one cluster barrier; if no CTA was live, the BFS is over;
//   4. one thread per word of the CTA's slice reads that word of the cs
//      sent bitmaps of this parity through distributed shared memory (cs
//      loads in flight together) and ORs them: newly = that & ~reached.
//      A sent bitmap only grows, but every bit it held before this hop was
//      reached by then, so the mask leaves exactly this hop's new nodes;
//      they become the frontier, and their dist h + 1 goes straight to
//      device memory.
// The parity double buffer makes one cluster barrier per hop enough: a CTA
// writes the bitmap of this parity again only in hop h + 2, after the
// barrier of hop h + 1, which every owner reaches after its step 4 of hop
// h.  Remote traffic is cs plain loads per slice word per hop, not one
// remote atomic per edge; only the frontier's edges are touched.  At the
// end each CTA writes reached for its slice, and dist = 1 << 20 where
// unreached, coalesced.  Each cluster (origin row, or lane row) stops at
// its own last hop.
// The sent bitmaps cost N / 4 bytes per CTA, so past a few hundred
// thousand nodes the state no longer fits a block's shared memory.  Then
// the same kernel keeps each CTA's state in a device-memory scratch buffer
// instead (kInSmem false; the list stays in shared memory): a CTA reads
// its peers' sent words from L2 (ld.global.cg) after the cluster barrier,
// which orders device memory across the cluster too.  The wrapper picks
// the variant from the bytes (kernels/bfs_relax.py).
// The latency floor (a measurement aid, not on the engine's path: this
// source built with BFS_RELAX_FLOOR defined, csrc/bfs_relax_floor.cu, into
// a library of its own that the engine never loads) runs the same geometry
// for a given number of hops with an empty frontier: the clear, every
// hop's compaction pass, cluster barrier and DSMEM pass, and the final
// writes, but no edge work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int32_t kInf = 1 << 20;
constexpr int kThreads = 1024;
constexpr int kBatch = 12;  // fanout targets loaded together per node
constexpr int kMaxCluster = 8;
constexpr int kMaxChunk = 512;  // frontier words compacted per pass
constexpr int kTotWords = 32;   // the prefix sum's per-warp totals
#ifdef BFS_RELAX_FLOOR
constexpr bool kFloor = true;   // the latency floor's build
#else
constexpr bool kFloor = false;
#endif

// Word `i` of the sent bitmap of cluster rank `r`: through distributed
// shared memory, or from L2 when the state lives in device memory.
template <bool kInSmem>
__device__ __forceinline__ uint32_t peer_word(cg::cluster_group& cluster,
                                              uint32_t* own, int rank, int r,
                                              int state_words, int i) {
  if constexpr (kInSmem) {
    return *cluster.map_shared_rank(own + i, r);
  } else {
    return __ldcg(own + (ptrdiff_t)(r - rank) * state_words + i);
  }
}

// Relax the `fill` frontier nodes of `list`: OR each live target's bit into
// `sb` unless either sent bitmap has it already.
__device__ __forceinline__ void relax(const int32_t* list, int fill,
                                      const int32_t* __restrict__ tg, int n,
                                      int f, uint32_t* sb,
                                      const uint32_t* sother) {
  for (int i = threadIdx.x; i < fill; i += kThreads) {
    const int32_t* tp = tg + (size_t)list[i] * f;
    for (int j0 = 0; j0 < f; j0 += kBatch) {
      int t[kBatch];  // all loads of the batch before any atomic
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        t[u] = j0 + u < f ? __ldg(tp + j0 + u) : -1;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (t[u] < 0 || t[u] >= n) continue;
        // slices are word-aligned, so the global word is the sent word
        const int gw = t[u] >> 5;
        const uint32_t bit = 1u << (t[u] & 31);
        if (!((sb[gw] | sother[gw]) & bit)) atomicOr(&sb[gw], bit);
      }
    }
  }
}

// Dynamic shared memory: the frontier list (32 * chunk slots), the prefix
// sum's warp totals, then (kInSmem) the CTA's `state_words` words of state:
// reached and frontier bitmaps of the slice (`words` each), two sent
// bitmaps over all cs slices, two live flags.  Without kInSmem the state is
// the CTA's part of `scratch`.
template <bool kInSmem>
__global__ void __launch_bounds__(kThreads)
bfs_relax_kernel(const int32_t* __restrict__ tgt,
                 const int32_t* __restrict__ origins,
                 uint8_t* __restrict__ reached, int32_t* __restrict__ dist,
                 uint32_t* __restrict__ scratch, int n, int f, int cs,
                 int slen, int state_words, int chunk, int floor_hops) {
  extern __shared__ __align__(16) uint32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int o = blockIdx.x / cs;
  const int words = slen >> 5;         // words of one slice
  int32_t* list = reinterpret_cast<int32_t*>(sm);
  int32_t* tot = list + 32 * chunk;
  uint32_t* re =                       // reached (own slice)
      kInSmem ? sm + 32 * chunk + kTotWords
              : scratch + (size_t)blockIdx.x * state_words;
  uint32_t* fr = re + words;           // frontier (own slice)
  uint32_t* sent = fr + words;         // two bitmaps over all cs slices
  uint32_t* live_flag = sent + 2 * cs * words;  // two flags by hop parity
  const int lo = rank * slen;
  const int len = max(0, min(n, lo + slen) - lo);
  const int lwords = (len + 31) >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunk_warps = chunk >> 5;
  const int32_t* tg = tgt + (size_t)o * n * f;
  int32_t* dd = dist + (size_t)o * n + lo;

  for (int w = threadIdx.x; w < state_words; w += kThreads) re[w] = 0;
  __syncthreads();
  const int org = origins[o];
  if (!kFloor) {
    for (int j = threadIdx.x; j < f; j += kThreads) {
      const int t = tg[(size_t)org * f + j];
      if (t >= lo && t < lo + len) {
        const int i = t - lo;
        atomicOr(&fr[i >> 5], 1u << (i & 31));
        atomicOr(&re[i >> 5], 1u << (i & 31));
        dd[i] = 1;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0 && org >= lo && org < lo + len) {
      const int i = org - lo;
      re[i >> 5] |= 1u << (i & 31);
      dd[i] = 0;
    }
  }
  int live = 0;
  for (int w = threadIdx.x; w < lwords; w += kThreads) live |= fr[w] != 0;
  live = __syncthreads_or(live);
  // every CTA of the cluster runs and has cleared its state before the
  // first remote access
  cluster.sync();

  const int all_words = cs * words;
  for (int h = 1;; ++h) {
    const int b = h & 1;
    uint32_t* sb = sent + b * all_words;
    const uint32_t* sother = sent + (b ^ 1) * all_words;
    if (live && threadIdx.x < cs) {
      if constexpr (kInSmem)
        atomicOr(cluster.map_shared_rank(&live_flag[b], threadIdx.x), 1u);
      else
        atomicOr(&live_flag[b] +
                     (ptrdiff_t)((int)threadIdx.x - rank) * state_words,
                 1u);
    }
    // 1 + 2: compact the frontier a chunk of words at a time; relax the
    // list whenever the next chunk might not fit, and at the end
    int fill = 0;
    for (int base = 0; base < lwords; base += chunk) {
      const int w = base + threadIdx.x;
      const uint32_t bits =
          threadIdx.x < chunk && w < lwords ? fr[w] : 0u;
      const int cnt = __popc(bits);
      int x = cnt;  // inclusive prefix sum within the warp
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
        if (lane >= d) x += y;
      }
      if (lane == 31 && warp < chunk_warps) tot[warp] = x;
      __syncthreads();
      // every warp scans the warp totals itself: one load and a shuffle
      // scan, no chain of shared-memory reads
      int y = lane < chunk_warps ? tot[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int z = __shfl_up_sync(0xFFFFFFFFu, y, d);
        if (lane >= d) y += z;
      }
      const int total = __shfl_sync(0xFFFFFFFFu, y, 31);
      const int before =
          warp == 0 ? 0 : __shfl_sync(0xFFFFFFFFu, y, (warp - 1) & 31);
      if (fill + total > 32 * chunk) {  // uniform across the CTA
        relax(list, fill, tg, n, f, sb, sother);
        __syncthreads();
        fill = 0;
      }
      int at = fill + before + x - cnt;
      for (uint32_t bb = bits; bb; bb &= bb - 1)
        list[at++] = lo + (w << 5) + __ffs(bb) - 1;
      fill += total;
      __syncthreads();  // the list is written; tot may be written again
    }
    relax(list, fill, tg, n, f, sb, sother);
    // 3: the list and the sent bitmaps are written before the barrier
    cluster.sync();
    const uint32_t any_live =
        kInSmem ? live_flag[b] : __ldcg(&live_flag[b]);
    if (kFloor ? h > floor_hops : any_live == 0) break;
    // 4: this hop's new nodes of the slice
    int got = 0;
    for (int w = threadIdx.x; w < lwords; w += kThreads) {
      uint32_t nx = 0;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < cs)
          nx |= peer_word<kInSmem>(cluster, sb, rank, r, state_words,
                                   rank * words + w);
      uint32_t nw = nx & ~re[w];
      re[w] |= nw;
      fr[w] = nw;
      got |= nw != 0;
      for (; nw; nw &= nw - 1) dd[(w << 5) + __ffs(nw) - 1] = h + 1;
    }
    live = __syncthreads_or(got);
    if (threadIdx.x == 0) live_flag[b] = 0;
  }
  // No remote access follows the last cluster barrier, so a CTA may write
  // its slice and exit.  Reached nodes got their dist when first reached.
  uint8_t* ro = reached + (size_t)o * n + lo;
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const bool r = (re[i >> 5] >> (i & 31)) & 1u;
    ro[i] = r ? 1 : 0;
    if (!r) dd[i] = kInf;
  }
}

cudaLaunchConfig_t config(cudaLaunchAttribute* attr, int o, int cs, int smem,
                          cudaStream_t stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(o * cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kInSmem>
cudaError_t launch(const int32_t* tgt, const int32_t* origins,
                   uint8_t* reached, int32_t* dist, uint32_t* scratch, int o,
                   int n, int f, int cs, int slen, int state_words,
                   int chunk, int smem, int floor_hops,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bfs_relax_kernel<kInSmem>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(attr, o, cs, smem, stream);
  err = cudaLaunchKernelEx(&cfg, bfs_relax_kernel<kInSmem>, tgt,
                           origins, reached, dist, scratch, n, f, cs, slen,
                           state_words, chunk, floor_hops);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool valid(int o, int n, int f, int cs, int slen, int state_words, int chunk,
           int smem, bool in_smem) {
  const long long list = 4LL * (32 * chunk + kTotWords);
  return o >= 1 && n >= 1 && f >= 1 && cs >= 1 && cs <= kMaxCluster &&
         slen >= 32 && slen % 32 == 0 && (long long)slen * cs >= n &&
         (long long)o * n * f < (1LL << 62) &&
         state_words >= (2 + 2 * cs) * (slen / 32) + 2 && chunk >= 32 &&
         chunk <= kMaxChunk && chunk % 32 == 0 &&
         smem >= list + (in_smem ? 4LL * state_words : 0);
}

int dispatch(const int32_t* tgt, const int32_t* origins, uint8_t* reached,
             int32_t* dist, uint32_t* scratch, int o, int n, int f, int cs,
             int slen, int state_words, int chunk, int smem, int floor_hops,
             cudaStream_t stream) {
  if (!valid(o, n, f, cs, slen, state_words, chunk, smem,
             scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)(scratch == nullptr
                   ? launch<true>(tgt, origins, reached, dist,
                                  scratch, o, n, f, cs, slen, state_words,
                                  chunk, smem, floor_hops, stream)
                   : launch<false>(tgt, origins, reached, dist, scratch, o,
                                   n, f, cs, slen, state_words, chunk, smem,
                                   floor_hops, stream));
}

}  // namespace

#ifndef BFS_RELAX_FLOOR
// The geometry (cs, slen, state_words, chunk, smem) comes from the wrapper
// (kernels/bfs_relax.py launch_geometry); only its bounds are checked here.
// A null `scratch` keeps the state in shared memory after the frontier
// list; else `scratch` holds o * cs * state_words words of device memory.
extern "C" int bfs_relax_launch(const int32_t* tgt, const int32_t* origins,
                                uint8_t* reached, int32_t* dist,
                                uint32_t* scratch, int o, int n, int f,
                                int cs, int slen, int state_words, int chunk,
                                int smem, cudaStream_t stream) {
  return dispatch(tgt, origins, reached, dist, scratch, o, n, f, cs, slen,
                  state_words, chunk, smem, 0, stream);
}

// Clusters of `cs` CTAs of this launch shape that the card holds at once
// (kernels/bfs_relax.py launch_geometry reads it).
extern "C" int bfs_relax_max_clusters(int cs, int smem, int state_in_smem,
                                      int* clusters) {
  auto kernel = state_in_smem ? bfs_relax_kernel<true>
                              : bfs_relax_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(attr, 1, cs, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, (void*)kernel, &cfg);
}
#else
// The latency floor of the same geometry: `hops` hops with an empty
// frontier (tgt is not read; origins, reached and dist as above).
extern "C" int bfs_relax_floor_launch(const int32_t* tgt,
                                      const int32_t* origins,
                                      uint8_t* reached, int32_t* dist,
                                      uint32_t* scratch, int o, int n, int f,
                                      int cs, int slen, int state_words,
                                      int chunk, int smem, int hops,
                                      cudaStream_t stream) {
  if (hops < 0) return (int)cudaErrorInvalidValue;
  return dispatch(tgt, origins, reached, dist, scratch, o, n, f, cs, slen,
                  state_words, chunk, smem, hops, stream);
}
#endif
