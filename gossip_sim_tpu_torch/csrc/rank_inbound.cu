// rank_inbound — ingress counts and the K best inbound edges per target.
//
// Replaces the reference engine's `round/verb2_consume` block
// (gossip_sim_tpu/engine/core.py:663-741: a 4-operand 2-key sort of the
// N*F + N delivered-edge/pseudo-edge list, then a slot-aligned two-sort
// compaction over N*F + N*K elements; twin engine/sparse.py:98-149).
//
// Input:  tgt [O, N, F] i32, delivered [O, N, F] u8, hop1 [O, N] i32.
// Output: ingress [O, N] i32 (delivered edges into each target),
//         inb [O, N, K] i32: per target the K smallest delivered inbound
//         edges by key hop1[src] << pb | src, ascending, N = empty;
//         dropped [O] i32 = sum over targets of max(ingress - K, 0).
// Scratch: csr [O*N*F] i32, the delivered keys grouped by target, for a
//         slice whose keys do not fit shared memory; and, when a CTA's
//         counts do not fit shared memory, those.
//
// Keys are unique within a target (a source pushes to distinct peers), so
// the K smallest are one set and the result does not depend on the order
// in which atomics hand out CSR positions.
//
// One launch per call, no memset.  A thread block cluster of cs CTAs per
// origin (cs chosen by the wrapper so that the clusters fill the card in
// one wave).  CTA r owns the target slice [r*S, (r+1)*S), S = ceil(N/cs),
// and reads every edge of its origin, keeping those into its slice, so
// every atomic is on its own shared memory and no CTA waits for another:
//   0. rank 0 zeroes dropped[o]; each CTA zeroes the counts of its slice;
//      one cluster barrier, so no CTA adds to dropped before it is zeroed;
//   1. count: each delivered edge into the slice adds 1 to its target's
//      count (a shared-memory atomic); edges into lower slices are summed
//      too, which gives the slice's start in the origin's CSR;
//   2. a block scan of the counts gives each target's segment start
//      (cursor); ingress is written;
//   3. place: each delivered edge into the slice takes a position with an
//      atomic on its target's cursor and stores its key there, in the
//      CTA's shared memory (or, for a slice of more keys than fit, in the
//      device-memory CSR at the slice's start);
//   4. select, four targets a warp at a time.  A segment of at most 16
//      keys sits two keys per lane of a quarter warp, which counts each
//      key's rank by shuffles.  A longer one goes to the whole warp and
//      streams in chunks of 32 (a key per lane) through a sorted buffer of
//      the best K in shared memory: a ballot keeps the keys under the
//      buffer's largest, which are ranked among themselves by shuffles and
//      merged by rank (binary search for the other side).  No per-thread
//      array bounds K, and a long segment is shared by 32 lanes.
// Bound on the H100: memory (read tgt/delivered/hop1 once, write
// inb/ingress once).  Each CTA reads all N*F edges of its origin (from L2
// after the first), and the select issues a few warp instructions per
// target, so the kernel sits above that bound (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;
constexpr int kMiscWords = 64;  // kernels/rank_inbound.py MISC_WORDS
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int32_t kNoKey = 0x7FFFFFFF;
constexpr int kUnroll = 8;  // edges per thread with their loads in flight

// State word `*p` of this CTA: in shared memory, or in the device-memory
// scratch buffer (read from L2, where its atomics went).
template <bool kInSmem>
__device__ __forceinline__ int32_t load_state(const int32_t* p) {
  if constexpr (kInSmem) {
    return *p;
  } else {
    return __ldcg(p);
  }
}

// Exclusive scan of one value per thread over the block; `total` gets the
// block's sum.  Uses 32 words of `tmp`.
__device__ __forceinline__ int block_exclusive_scan(int v, int32_t* tmp,
                                                    int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? tmp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    tmp[lane] = w;
  }
  __syncthreads();
  const int pre = warp > 0 ? tmp[warp - 1] : 0;
  total = tmp[nwarps - 1];
  __syncthreads();  // tmp is reused by the next call
  return pre + x - v;
}

// Keys of `arr[0..m)` (sorted ascending) smaller than `x`.
__device__ __forceinline__ int count_below(const int32_t* arr, int m,
                                           int32_t x) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (arr[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Word `i` of a CSR segment: in this CTA's shared memory, or in device
// memory written by the cluster's CTAs (read from L2).
template <bool kSmemSeg>
__device__ __forceinline__ int32_t seg_key(const int32_t* seg, int i) {
  if constexpr (kSmemSeg) {
    return seg[i];
  } else {
    return __ldcg(seg + i);
  }
}

// The K smallest keys of one segment, ascending, as sources (N = empty),
// into `out`; `buf` is this warp's 2K + 64 words of shared memory.  Keys go
// to `buf` in rank order first, so the row is stored coalesced.
template <bool kSmemSeg>
__device__ __forceinline__ void select_k(const int32_t* seg, int len,
                                         int32_t* out, int32_t* buf, int k,
                                         int n, int32_t mask) {
  const int lane = threadIdx.x & 31;
  int32_t* a = buf;          // the best m keys so far, ascending
  int32_t* b = buf + k;      // the next merge's output
  int32_t* chunk = buf + 2 * k;  // this chunk's candidates, ascending
  int m = 0;
  for (int base = 0; base < len; base += 32) {
    const int idx = base + lane;
    const int32_t key = idx < len ? seg_key<kSmemSeg>(seg, idx) : kNoKey;
    const int32_t thr = m == k ? a[k - 1] : kNoKey;
    const bool cand = idx < len && key < thr;
    const unsigned cmask = __ballot_sync(kFull, cand);
    if (cmask == 0) continue;
    const int nc = __popc(cmask);
    int r = 0;
    for (unsigned mm = cmask; mm; mm &= mm - 1)
      r += __shfl_sync(kFull, key, __ffs(mm) - 1) < key;
    if (cand) chunk[r] = key;
    __syncwarp();
    if (cand) {
      const int pos = r + count_below(a, m, key);
      if (pos < k) b[pos] = key;
    }
    for (int q = lane; q < m; q += 32) {
      const int32_t x = a[q];
      const int pos = q + count_below(chunk, nc, x);
      if (pos < k) b[pos] = x;
    }
    __syncwarp();
    m = min(k, m + nc);
    int32_t* t = a;
    a = b;
    b = t;
  }
  for (int q = lane; q < k; q += 32) out[q] = q < m ? (a[q] & mask) : n;
  __syncwarp();  // the buffer is reused by this warp's next target
}

// The K smallest keys of a segment of at most 16, ranked by the eight lanes
// `ql` of a quarter warp, two keys a lane (`ql` and `ql + 8`); every lane
// of the warp calls it (the shuffles), and lanes whose quarter is not
// `active` write nothing.  The keys go to this quarter's 16 words `rbuf`
// in rank order first, so the row is stored coalesced.
template <bool kSmemSeg>
__device__ __forceinline__ void select_quarter(const int32_t* seg, int len,
                                               bool active, int32_t* out,
                                               int32_t* rbuf, int k, int n,
                                               int32_t mask, int ql) {
  const int32_t a =
      active && ql < len ? seg_key<kSmemSeg>(seg, ql) : kNoKey;
  const int32_t b =
      active && ql + 8 < len ? seg_key<kSmemSeg>(seg, ql + 8) : kNoKey;
  int ra = 0, rb = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int32_t xa = __shfl_sync(kFull, a, j, 8);
    const int32_t xb = __shfl_sync(kFull, b, j, 8);
    ra += (xa < a) + (xb < a);
    rb += (xa < b) + (xb < b);
  }
  if (active && ql < len) rbuf[ra] = a;
  if (active && ql + 8 < len) rbuf[rb] = b;
  __syncwarp();
  if (active)
    for (int q = ql; q < k; q += 8) out[q] = q < len ? (rbuf[q] & mask) : n;
  __syncwarp();  // the buffer is reused
}

// Calls fn(e, tgt[e]) for every delivered edge e < nf of an origin, the
// block's threads in turn, with several edges' loads in flight per thread:
// four edges a load where the rows are 16-byte aligned, else one.
template <typename Fn>
__device__ __forceinline__ void for_each_delivered(const int32_t* tg,
                                                   const uint8_t* dl, int nf,
                                                   Fn fn) {
  const int stride = blockDim.x;
  if ((nf & 3) == 0 && (reinterpret_cast<uintptr_t>(tg) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(dl) & 3) == 0) {
    const int4* tg4 = reinterpret_cast<const int4*>(tg);
    const uchar4* dl4 = reinterpret_cast<const uchar4*>(dl);
    const int nq = nf >> 2;
    constexpr int kQuads = kUnroll / 2;
    for (int qb = threadIdx.x; qb < nq; qb += kQuads * stride) {
      int4 t[kQuads];
      uchar4 d[kQuads];
#pragma unroll
      for (int u = 0; u < kQuads; ++u) {
        const int q = qb + u * stride;
        d[u] = q < nq ? __ldg(dl4 + q) : make_uchar4(0, 0, 0, 0);
        t[u] = q < nq ? __ldg(tg4 + q) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kQuads; ++u) {
        const int e = 4 * (qb + u * stride);
        if (d[u].x) fn(e, t[u].x);
        if (d[u].y) fn(e + 1, t[u].y);
        if (d[u].z) fn(e + 2, t[u].z);
        if (d[u].w) fn(e + 3, t[u].w);
      }
    }
    return;
  }
  for (int eb = threadIdx.x; eb < nf; eb += kUnroll * stride) {
    int t[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = eb + u * stride;
      const bool in = e < nf;
      const int tt = in ? __ldg(tg + e) : -1;
      t[u] = in && __ldg(dl + e) ? tt : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (t[u] >= 0) fn(eb + u * stride, t[u]);
  }
}

template <bool kInSmem>
__global__ void __launch_bounds__(kMaxThreads)
rank_inbound_kernel(const int32_t* __restrict__ tgt,
                    const uint8_t* __restrict__ delivered,
                    const int32_t* __restrict__ hop1,
                    int32_t* __restrict__ ingress, int32_t* __restrict__ inb,
                    int32_t* __restrict__ dropped, int32_t* __restrict__ csr,
                    int32_t* __restrict__ scratch, int n, int f, int k,
                    int pb, int cs, int slen, long long state_words,
                    int csr_cap) {
  extern __shared__ __align__(16) int32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int o = blockIdx.x / cs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int32_t* misc = sm;  // [0, 32) scan scratch, [32] edges into lower slices
  int32_t* selbuf = sm + kMiscWords + warp * (2 * k + 64);
  int32_t* after_sel = sm + kMiscWords + nwarps * (2 * k + 64);
  int32_t* cnt =
      kInSmem ? after_sel : scratch + (long long)blockIdx.x * state_words;
  int32_t* off = cnt + slen;
  int32_t* csr_sm = kInSmem ? after_sel + 2 * slen : after_sel;
  const int lo = rank * slen;
  const int len = max(0, min(n, lo + slen) - lo);
  const int nf = n * f;  // < 2^30 (wrapper)
  const int32_t* tg = tgt + (long long)o * nf;
  const uint8_t* dl = delivered + (long long)o * nf;
  const int32_t* hp = hop1 + (long long)o * n;

  // 0. zero the counts of the slice, and dropped
  for (int i = threadIdx.x; i < len; i += blockDim.x) cnt[i] = 0;
  if (threadIdx.x == 0) misc[32] = 0;
  if (rank == 0 && threadIdx.x == 0) dropped[o] = 0;
  cluster.sync();

  // 1. count the delivered edges into the slice, and those below it
  int below = 0;
  for_each_delivered(tg, dl, nf, [&](int, int t) {
    if (t < 0 || t >= n) return;
    if (t < lo)
      ++below;
    else if (t < lo + len)
      atomicAdd(cnt + (t - lo), 1);
  });
  below = __reduce_add_sync(kFull, below);
  if (lane == 0 && below) atomicAdd(misc + 32, below);
  __syncthreads();

  // 2. segment starts within the slice (cursors); ingress
  int carry = 0;
  int32_t* ing = ingress + (long long)o * n + lo;
  for (int base = 0; base < len; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int c = i < len ? load_state<kInSmem>(cnt + i) : 0;
    int total;
    const int ex = block_exclusive_scan(c, misc, total);
    if (i < len) {
      ing[i] = c;
      off[i] = carry + ex;
      cnt[i] = carry + ex;
    }
    carry += total;
  }
  // the slice's keys stay in shared memory where they fit; else they go to
  // the device-memory CSR at the slice's start within the origin's
  const bool own_smem = carry <= csr_cap;
  int32_t* keys = own_smem ? csr_sm : csr + (long long)o * nf + misc[32];
  __syncthreads();

  // 3. place each delivered edge's key in its target's segment
  const float inv_f = 1.0f / (float)f;
  for_each_delivered(tg, dl, nf, [&](int e, int t) {
    if (t < lo || t >= lo + len) return;
    // e / f by a float reciprocal, corrected (exact at any e < 2^30)
    int src = __float2int_rz(__int2float_rn(e) * inv_f);
    while (src * f > e) --src;
    while ((src + 1) * f <= e) ++src;
    const int pos = atomicAdd(cnt + (t - lo), 1);
    keys[pos] = (__ldg(hp + src) << pb) | src;
  });
  __syncthreads();

  // 4. the K best of each owned target, four targets a warp at a time: a
  // segment of at most 16 keys is ranked by its quarter of the warp, a
  // longer one by the whole warp
  const int32_t mask = (1 << pb) - 1;
  const int quarter = lane >> 3, ql = lane & 7;
  int32_t* inb_o = inb + ((long long)o * n + lo) * k;
  int drop = 0;
  for (int i0 = 4 * warp; i0 < len; i0 += 4 * nwarps) {
    const int i = i0 + quarter;
    const bool here = i < len;
    const int start = here ? off[i] : 0;
    const int seg_len = here ? load_state<kInSmem>(cnt + i) - start : 0;
    const bool small = here && seg_len <= 16;
    int32_t* out = inb_o + (long long)i * k;
    int32_t* rbuf = selbuf + 16 * quarter;
    if (own_smem)
      select_quarter<true>(keys + start, seg_len, small, out, rbuf, k, n,
                           mask, ql);
    else
      select_quarter<false>(keys + start, seg_len, small, out, rbuf, k, n,
                            mask, ql);
    if (here && ql == 0) drop += max(seg_len - k, 0);
    unsigned big = __ballot_sync(kFull, here && !small && ql == 0);
    for (; big; big &= big - 1) {
      const int src_lane = __ffs(big) - 1;
      const int s = __shfl_sync(kFull, start, src_lane);
      const int l = __shfl_sync(kFull, seg_len, src_lane);
      int32_t* o_big = inb_o + (long long)(i0 + (src_lane >> 3)) * k;
      if (own_smem)
        select_k<true>(keys + s, l, o_big, selbuf, k, n, mask);
      else
        select_k<false>(keys + s, l, o_big, selbuf, k, n, mask);
    }
  }
  if (drop > 0) atomicAdd(&dropped[o], drop);
}

template <bool kInSmem>
cudaError_t launch(const int32_t* tgt, const uint8_t* delivered,
                   const int32_t* hop1, int32_t* ingress, int32_t* inb,
                   int32_t* dropped, int32_t* csr, int32_t* scratch, int o,
                   int n, int f, int k, int pb, int cs, int slen,
                   int threads, long long state_words, int csr_cap,
                   int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rank_inbound_kernel<kInSmem>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(o * cs));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rank_inbound_kernel<kInSmem>, tgt,
                           delivered, hop1, ingress, inb, dropped, csr,
                           scratch, n, f, k, pb, cs, slen, state_words,
                           csr_cap);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Clusters of `cs` CTAs of this launch shape that the card holds at once
// (kernels/rank_inbound.py launch_geometry reads it).
extern "C" int rank_inbound_max_clusters(int cs, int threads, int smem,
                                         int state_in_smem, int* clusters) {
  void (*kernel)(const int32_t*, const uint8_t*, const int32_t*, int32_t*,
                 int32_t*, int32_t*, int32_t*, int32_t*, int, int, int, int,
                 int, int, long long, int) =
      state_in_smem ? rank_inbound_kernel<true> : rank_inbound_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cs);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters, (void*)kernel, &cfg);
}

// The geometry (cs, slen, threads, state_words, csr_cap, smem) comes from
// the wrapper (kernels/rank_inbound.py launch_geometry); only its bounds are
// checked here.  A null `scratch` keeps each CTA's 2 * slen words of state
// in shared memory after the selection buffers; else `scratch` holds
// o * cs * state_words words of device memory.  `csr_cap` words of shared
// memory per CTA follow for its slice's CSR keys (a slice with more keys
// keeps them in `csr`, device memory).
extern "C" int rank_inbound_launch(const int32_t* tgt,
                                   const uint8_t* delivered,
                                   const int32_t* hop1, int32_t* ingress,
                                   int32_t* inb, int32_t* dropped,
                                   int32_t* csr, int32_t* scratch, int o,
                                   int n, int f, int k, int pb, int cs,
                                   int slen, int threads,
                                   long long state_words, int csr_cap,
                                   int smem, cudaStream_t stream) {
  const long long sel = 4LL * (kMiscWords + (threads / 32) * (2LL * k + 64));
  const long long need =
      sel + (scratch == nullptr ? 8LL * slen : 0) + 4LL * csr_cap;
  if (o < 1 || n < 1 || f < 1 || (long long)n * f >= (1LL << 30) || k < 1 ||
      pb < 0 || pb > 30 || cs < 1 || cs > kMaxCluster || slen < 1 ||
      (long long)slen * cs < n || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || state_words < 2LL * slen || csr_cap < 0 ||
      smem < need)
    return (int)cudaErrorInvalidValue;
  return (int)(scratch == nullptr
                   ? launch<true>(tgt, delivered, hop1, ingress, inb,
                                  dropped, csr, scratch, o, n, f, k, pb, cs,
                                  slen, threads, state_words, csr_cap, smem,
                                  stream)
                   : launch<false>(tgt, delivered, hop1, ingress, inb,
                                   dropped, csr, scratch, o, n, f, k, pb, cs,
                                   slen, threads, state_words, csr_cap,
                                   smem, stream));
}

