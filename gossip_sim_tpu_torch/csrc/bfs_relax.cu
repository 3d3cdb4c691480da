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
// Bound on the H100: memory, and at these sizes latency.  The function must
// read tgt once (O*N*F*4 bytes) and write reached/dist once; that is a few
// microseconds, while the BFS needs one dependent step per hop (~10 hops on
// the 10k-node cluster, hundreds on a path), each a chain of latencies: an
// L2 load of the targets, a cluster barrier, a DSMEM load, a block barrier.
// Design: a thread block cluster of cs CTAs per origin (cs from O, chosen
// by the wrapper so that O * cs fills the SMs; 8 at O = 1).  CTA r owns
// the word-aligned node slice [r*S, (r+1)*S), S = ceil(N / cs) rounded up
// to 32, so no bitmap word is shared by two CTAs.  Each CTA keeps its
// bitmaps in shared memory: reached and frontier for its slice, and two
// "sent" bitmaps over all N nodes, by hop parity.  Each hop:
//   1. each warp takes frontier words of its CTA's slice, skips zero words,
//      and each lane whose bit is set reads its node's F targets (L2) and
//      ORs each target's bit into its own CTA's sent bitmap of this hop's
//      parity (a local shared-memory atomic, skipped if the bit is already
//      in either sent bitmap); a CTA whose frontier is not empty also sets
//      the hop's "live" flag in every CTA of the cluster;
//   2. one cluster barrier; if no CTA was live, the BFS is over;
//   3. one thread per word of the CTA's slice reads that word of the cs
//      sent bitmaps of this parity through distributed shared memory (cs
//      loads in flight together) and ORs them: newly = that & ~reached.
//      A sent bitmap only grows, but every bit it held before this hop was
//      reached by then, so the mask leaves exactly this hop's new nodes;
//      they become the frontier, and their dist h + 1 goes straight to
//      device memory.
// The parity double buffer makes one cluster barrier per hop enough: a CTA
// writes the bitmap of this parity again only in hop h + 2, after the
// barrier of hop h + 1, which every owner reaches after its step 3 of hop
// h.  Remote traffic is cs plain loads per slice word per hop, not one
// remote atomic per edge; only the frontier's edges are touched.  At the
// end each CTA writes reached for its slice, and dist = 1 << 20 where
// unreached, coalesced.  (Setting each target's bit in its owner's bitmap
// with one remote atomic per edge measured slower at O = 1 and at O = 32;
// PERF.md.)
// The sent bitmaps cost N / 4 bytes per CTA, so past about 800k nodes the
// state no longer fits a block's shared memory.  Then the same kernel keeps
// each CTA's state in a device-memory scratch buffer instead (kInSmem
// false): a CTA reads its peers' sent words from L2 (ld.global.cg) after
// the cluster barrier, which orders device memory across the cluster too.
// The wrapper picks the variant from the bytes (kernels/bfs_relax.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int32_t kInf = 1 << 20;
constexpr int kThreads = 512;
constexpr int kBatch = 8;  // fanout targets loaded together per frontier node
constexpr int kMaxCluster = 8;

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

// Per-CTA state, `state_words` words: reached and frontier bitmaps of the
// slice (`words` each), two sent bitmaps over all cs slices, two live flags.
template <bool kInSmem>
__global__ void __launch_bounds__(kThreads)
bfs_relax_kernel(const int32_t* __restrict__ tgt,
                 const int32_t* __restrict__ origins,
                 uint8_t* __restrict__ reached, int32_t* __restrict__ dist,
                 uint32_t* __restrict__ scratch, int n, int f, int cs,
                 int slen, int state_words) {
  extern __shared__ __align__(16) uint32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int o = blockIdx.x / cs;
  const int words = slen >> 5;         // words of one slice
  uint32_t* re =                       // reached (own slice)
      kInSmem ? sm : scratch + (size_t)blockIdx.x * state_words;
  uint32_t* fr = re + words;           // frontier (own slice)
  uint32_t* sent = fr + words;         // two bitmaps over all cs slices
  uint32_t* live_flag = sent + 2 * cs * words;  // two flags by hop parity
  const int lo = rank * slen;
  const int len = max(0, min(n, lo + slen) - lo);
  const int lwords = (len + 31) >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int32_t* tg = tgt + (size_t)o * n * f;
  int32_t* dd = dist + (size_t)o * n + lo;

  for (int w = threadIdx.x; w < state_words; w += blockDim.x) re[w] = 0;
  __syncthreads();
  const int org = origins[o];
  for (int j = threadIdx.x; j < f; j += blockDim.x) {
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
  int live = 0;
  for (int w = threadIdx.x; w < lwords; w += blockDim.x) live |= fr[w] != 0;
  live = __syncthreads_or(live);
  // every CTA of the cluster runs and has cleared its state before the
  // first remote access
  cluster.sync();

  const int all_words = cs * words;
  for (int h = 1;; ++h) {
    const int b = h & 1;
    uint32_t* sb = sent + b * all_words;
    uint32_t* sother = sent + (b ^ 1) * all_words;
    if (live && threadIdx.x < cs) {
      if constexpr (kInSmem)
        atomicOr(cluster.map_shared_rank(&live_flag[b], threadIdx.x), 1u);
      else
        atomicOr(&live_flag[b] +
                     (ptrdiff_t)((int)threadIdx.x - rank) * state_words,
                 1u);
    }
    for (int w = warp; w < lwords; w += nwarps) {
      const uint32_t bits = fr[w];
      if (bits == 0 || !((bits >> lane) & 1u)) continue;
      const int32_t* tp = tg + (size_t)(lo + (w << 5) + lane) * f;
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
    cluster.sync();
    const uint32_t any_live =
        kInSmem ? live_flag[b] : __ldcg(&live_flag[b]);
    if (any_live == 0) break;
    int got = 0;
    for (int w = threadIdx.x; w < lwords; w += blockDim.x) {
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
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const bool r = (re[i >> 5] >> (i & 31)) & 1u;
    ro[i] = r ? 1 : 0;
    if (!r) dd[i] = kInf;
  }
}

template <bool kInSmem>
cudaError_t launch(const int32_t* tgt, const int32_t* origins,
                   uint8_t* reached, int32_t* dist, uint32_t* scratch, int o,
                   int n, int f, int cs, int slen, int state_words, int smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bfs_relax_kernel<kInSmem>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
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
  err = cudaLaunchKernelEx(&cfg, bfs_relax_kernel<kInSmem>, tgt, origins,
                           reached, dist, scratch, n, f, cs, slen,
                           state_words);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The geometry (cs, slen, state_words, smem) comes from the wrapper
// (kernels/bfs_relax.py launch_geometry); only its bounds are checked here.
// A null `scratch` keeps the state in `smem` bytes of shared memory per CTA;
// else `scratch` holds o * cs * state_words words of device memory.
extern "C" int bfs_relax_launch(const int32_t* tgt, const int32_t* origins,
                                uint8_t* reached, int32_t* dist,
                                uint32_t* scratch, int o, int n, int f,
                                int cs, int slen, int state_words, int smem,
                                cudaStream_t stream) {
  if (o < 1 || n < 1 || f < 1 || cs < 1 || cs > kMaxCluster ||
      slen < 32 || slen % 32 != 0 || (long long)slen * cs < n ||
      state_words < (2 + 2 * cs) * (slen / 32) + 2 ||
      (scratch == nullptr ? smem < 4 * state_words : smem != 0))
    return (int)cudaErrorInvalidValue;
  return (int)(scratch == nullptr
                   ? launch<true>(tgt, origins, reached, dist, scratch, o, n,
                                  f, cs, slen, state_words, smem, stream)
                   : launch<false>(tgt, origins, reached, dist, scratch, o,
                                   n, f, cs, slen, state_words, smem, stream));
}
