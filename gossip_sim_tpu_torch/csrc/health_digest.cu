// health_digest — the node-health digest of a [P, N] metric stack.
//
// Replaces the reference's on-device digest (gossip_sim_tpu/obs/health.py:
// 125-146, `_device_digest_fn`: a segment_sum, `lax.top_k` and a full sort
// of each row for the Gini numerator).
//
// Input:  stack [P, N] (i32 or i64, the template's T), decile [N] i32
//         (stake-decile ids 0-9), k <= N.
// Output: acc [P, 12] i64 (written whole, no memset): the 10 decile sums,
//         the Gini numerator sum_i (2 i - n - 1) x_sorted[i] and the
//         denominator n sum x; top_idx [P, k] i32 and top_val [P, k] i64,
//         the k largest values, ties toward the lower node id.
//
// Design: each row is sorted, descending by value and stable, by an LSD
// radix sort written here, and everything is read off the sorted row.  A
// stable descending sort keeps equal values in ascending id, so sorted
// position d is the entry's place G + B (entries above it, and equal ones
// at a lower id): the top-k are positions 0 .. k - 1, and the Gini
// numerator is sum_d (n - 1 - 2 d) x_d (a run of equal values weighs the
// same whichever order it takes inside).  The sort key is max - x in the
// row's own range (u32 for an i32 stack, u64 for i64), so a row takes one
// pass of 8 bits per byte of max - min, found on the card: a row of
// counts below 65,536 takes two passes, a constant row none.
//
// One cooperative launch over tiles of kTile entries (kernels/
// health_digest.py `launch_geometry`), in phases split by grid barriers:
//   A  per tile: min, max, sum and the 10 decile sums (tile scratch);
//   B  per row (a warp): the row's sums into acc, its max and pass count;
//   per pass (every row that still needs it; 3 barriers a pass):
//   H  per tile: the digit histogram into counts[row][digit][tile], and
//      the row's digit totals (atomics);
//   S  per (row, digit), a warp: the digit's base (the totals of lower
//      digits) plus the exclusive scan of its count over the tiles;
//   X  per tile: the stable scatter: in rounds of kThreads entries, each
//      warp ranks equal digits by __match_any_sync, the warps' counts are
//      scanned per digit, and each entry goes to its digit's offset;
//   F  per tile of the sorted row: the Gini numerator's part (atomics into
//      acc, exact in any order: 64-bit unsigned, wrapping as the
//      reference's int64 sums do) and the top-k slots.
// Scratch (the two key and id buffers, tile stats, counts, totals, row
// max and passes) comes from the wrapper (kernels/health_digest.py
// `scratch_layout`); data one block writes and another reads goes through
// L2 (__ldcg) behind a barrier.
//
// Bound on the H100: bytes.  The stack once in and the small outputs once
// out; the sort's passes read and write the row's keys and ids again
// (L2-resident at P N = 800,000).  It runs once per harvest block.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;                  // entries a tile holds
constexpr int kRounds = kTile / kThreads;    // scatter rounds a tile
constexpr int kBits = 8;                     // digit bits a pass
constexpr int kBins = 1 << kBits;
constexpr int kDeciles = 10;
constexpr int kAcc = kDeciles + 2;           // deciles, numerator, denominator
constexpr int kStat = kDeciles + 3;          // tile: min, max, sum, deciles
constexpr unsigned kFull = 0xFFFFFFFFu;

struct DigestArgs {
  const void* stack;
  const int32_t* decile;
  int p, n, k, tpr;            // rows, entries, top-k, tiles per row
  unsigned long long* acc;     // [p, 12]
  int32_t* top_idx;            // [p, k]
  long long* top_val;          // [p, k]
  void* keys;                  // 2 x [p, n] of the key type
  int32_t* ids;                // 2 x [p, n]
  unsigned long long* tstat;   // [p * tpr, kStat]
  uint32_t* counts;            // [p, kBins, tpr]
  uint32_t* totals;            // [p, max passes, kBins]
  long long* rowmax;           // [p]
  int32_t* rowpasses;          // [p]
  int32_t* ctrl;               // [1]: the most passes of any row
};

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

template <typename T, typename K>
__global__ void __launch_bounds__(kThreads)
health_digest_kernel(const DigestArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ unsigned long long s_dec[kWarps][kDeciles];
  __shared__ long long s_red[3][kWarps];
  __shared__ uint32_t s_hist[kBins];
  __shared__ uint32_t s_wcount[kWarps][kBins];
  __shared__ uint32_t s_wbase[kWarps][kBins];
  __shared__ uint32_t s_run[kBins];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = a.n, tpr = a.tpr, tiles = a.p * a.tpr;
  const T* stack = static_cast<const T*>(a.stack);
  constexpr int kMaxPasses = (int)sizeof(K);
  K* keys[2] = {static_cast<K*>(a.keys),
                static_cast<K*>(a.keys) + (long long)a.p * n};
  int32_t* ids[2] = {a.ids, a.ids + (long long)a.p * n};
  const long long gtid = (long long)blockIdx.x * kThreads + tid;
  const long long gstride = (long long)gridDim.x * kThreads;

  // A: zero the totals and the pass count; each tile's min, max, sum and
  // decile sums
  for (long long i = gtid; i < (long long)a.p * kMaxPasses * kBins;
       i += gstride)
    a.totals[i] = 0u;
  if (gtid == 0) a.ctrl[0] = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int r = t / tpr, lo = (t - r * tpr) * kTile;
    const int len = min(kTile, n - lo);
    const T* row = stack + (long long)r * n + lo;
    if (tid < kWarps * kDeciles) (&s_dec[0][0])[tid] = 0ull;
    __syncthreads();
    long long mn = LLONG_MAX, mx = LLONG_MIN;
    unsigned long long sum = 0ull;
    for (int j = tid; j < len; j += kThreads) {
      const long long x = (long long)__ldg(row + j);
      mn = min(mn, x);
      mx = max(mx, x);
      sum += (unsigned long long)x;
      const int d = __ldg(a.decile + lo + j);
      if (d >= 0 && d < kDeciles)
        atomicAdd(&s_dec[warp][d], (unsigned long long)x);
    }
#pragma unroll
    for (int d = 16; d; d >>= 1) {
      mn = min(mn, __shfl_xor_sync(kFull, mn, d));
      mx = max(mx, __shfl_xor_sync(kFull, mx, d));
      sum += __shfl_xor_sync(kFull, sum, d);
    }
    if (lane == 0) {
      s_red[0][warp] = mn;
      s_red[1][warp] = mx;
      s_red[2][warp] = (long long)sum;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w) {
        mn = min(mn, s_red[0][w]);
        mx = max(mx, s_red[1][w]);
        sum += (unsigned long long)s_red[2][w];
      }
      unsigned long long* st = a.tstat + (long long)t * kStat;
      st[0] = (unsigned long long)mn;
      st[1] = (unsigned long long)mx;
      st[2] = sum;
    } else if (tid < 1 + kDeciles) {
      unsigned long long s = 0ull;
      for (int w = 0; w < kWarps; ++w) s += s_dec[w][tid - 1];
      a.tstat[(long long)t * kStat + 2 + tid] = s;
    }
    __syncthreads();
  }
  grid.sync();

  // B: per row (a warp), its sums into acc, its max and passes
  {
    const long long gwarp = gtid >> 5, nwarps = gstride >> 5;
    for (long long r = gwarp; r < a.p; r += nwarps) {
      long long mn = LLONG_MAX, mx = LLONG_MIN;
      unsigned long long s[1 + kDeciles] = {};
      for (int t = lane; t < tpr; t += 32) {
        const unsigned long long* st = a.tstat + (r * tpr + t) * kStat;
        mn = min(mn, (long long)__ldcg(st));
        mx = max(mx, (long long)__ldcg(st + 1));
#pragma unroll
        for (int q = 0; q <= kDeciles; ++q) s[q] += __ldcg(st + 2 + q);
      }
#pragma unroll
      for (int d = 16; d; d >>= 1) {
        mn = min(mn, __shfl_xor_sync(kFull, mn, d));
        mx = max(mx, __shfl_xor_sync(kFull, mx, d));
      }
#pragma unroll
      for (int q = 0; q <= kDeciles; ++q) s[q] = warp_sum(s[q]);
      if (lane == 0) {
        unsigned long long* acc = a.acc + r * kAcc;
#pragma unroll
        for (int q = 0; q < kDeciles; ++q) acc[q] = s[1 + q];
        acc[kDeciles] = 0ull;
        acc[kDeciles + 1] = (unsigned long long)n * s[0];
        const unsigned long long range =
            (unsigned long long)mx - (unsigned long long)mn;
        const int bits = range ? 64 - __clzll((long long)range) : 0;
        const int passes = (bits + kBits - 1) / kBits;
        a.rowmax[r] = mx;
        a.rowpasses[r] = passes;
        atomicMax(a.ctrl, passes);
      }
    }
  }
  grid.sync();

  const int passes_all = __ldcg(a.ctrl);
  for (int pass = 0; pass < passes_all; ++pass) {
    const int shift = pass * kBits;
    K* src_k = keys[(pass + 1) & 1];
    int32_t* src_i = ids[(pass + 1) & 1];
    K* dst_k = keys[pass & 1];
    int32_t* dst_i = ids[pass & 1];

    // H: each tile's digit histogram, and the row's digit totals
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int r = t / tpr, tt = t - r * tpr, lo = tt * kTile;
      if (pass >= __ldcg(a.rowpasses + r)) continue;   // block-uniform
      const int len = min(kTile, n - lo);
      const K mx = (K)__ldcg(a.rowmax + r);
      const long long base = (long long)r * n + lo;
      for (int q = tid; q < kBins; q += kThreads) s_hist[q] = 0u;
      __syncthreads();
      for (int j0 = 0; j0 < len; j0 += kThreads) {
        const int j = j0 + tid;
        int d = kBins;
        if (j < len) {
          const K key = pass == 0 ? (K)(mx - (K)__ldg(stack + base + j))
                                  : __ldcg(src_k + base + j);
          d = (int)((key >> shift) & (K)(kBins - 1));
        }
        const unsigned peers = __match_any_sync(kFull, d);
        if (d < kBins && lane == __ffs(peers) - 1)
          atomicAdd(&s_hist[d], (uint32_t)__popc(peers));
      }
      __syncthreads();
      for (int q = tid; q < kBins; q += kThreads) {
        const uint32_t c = s_hist[q];
        a.counts[((long long)r * kBins + q) * tpr + tt] = c;
        if (c)
          atomicAdd(a.totals + ((long long)r * kMaxPasses + pass) * kBins + q,
                    c);
      }
      __syncthreads();
    }
    grid.sync();

    // S: per (row, digit), a warp: the digit's base plus the exclusive
    // scan of its count over the row's tiles, in place
    {
      const long long gwarp = gtid >> 5, nwarps = gstride >> 5;
      for (long long item = gwarp; item < (long long)a.p * kBins;
           item += nwarps) {
        const long long r = item / kBins;
        const int d = (int)(item - r * kBins);
        if (pass >= __ldcg(a.rowpasses + r)) continue;   // warp-uniform
        const uint32_t* tot = a.totals + (r * kMaxPasses + pass) * kBins;
        uint32_t carry = 0u;
        for (int q = lane; q < d; q += 32) carry += __ldcg(tot + q);
        carry = warp_sum(carry);
        uint32_t* cnt = a.counts + (r * kBins + d) * tpr;
        for (int t0 = 0; t0 < tpr; t0 += 32) {
          const int t = t0 + lane;
          const uint32_t c = t < tpr ? __ldcg(cnt + t) : 0u;
          uint32_t incl = c;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const uint32_t y = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += y;
          }
          if (t < tpr) cnt[t] = carry + incl - c;
          carry += __shfl_sync(kFull, incl, 31);
        }
      }
    }
    grid.sync();

    // X: the stable scatter of each tile to its digits' offsets
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int r = t / tpr, tt = t - r * tpr, lo = tt * kTile;
      if (pass >= __ldcg(a.rowpasses + r)) continue;   // block-uniform
      const int len = min(kTile, n - lo);
      const K mx = (K)__ldcg(a.rowmax + r);
      const long long base = (long long)r * n + lo;
      const long long out = (long long)r * n;
      for (int q = tid; q < kBins; q += kThreads) {
        s_run[q] = __ldcg(a.counts + ((long long)r * kBins + q) * tpr + tt);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s_wcount[w][q] = 0u;
      }
      __syncthreads();
#pragma unroll 1
      for (int q = 0; q < kRounds; ++q) {
        const int j = q * kThreads + tid;
        const bool valid = j < len;
        K key = 0;
        int32_t id = 0, d = kBins;
        if (valid) {
          if (pass == 0) {
            key = (K)(mx - (K)__ldg(stack + base + j));
            id = lo + j;
          } else {
            key = __ldcg(src_k + base + j);
            id = __ldcg(src_i + base + j);
          }
          d = (int)((key >> shift) & (K)(kBins - 1));
        }
        const unsigned peers = __match_any_sync(kFull, d);
        const int rank = __popc(peers & ((1u << lane) - 1u));
        if (valid && lane == __ffs(peers) - 1)
          s_wcount[warp][d] = (uint32_t)__popc(peers);
        __syncthreads();
        for (int b = tid; b < kBins; b += kThreads) {
          uint32_t pre = s_run[b];
#pragma unroll
          for (int w = 0; w < kWarps; ++w) {
            const uint32_t c = s_wcount[w][b];
            s_wbase[w][b] = pre;
            s_wcount[w][b] = 0u;
            pre += c;
          }
          s_run[b] = pre;
        }
        __syncthreads();
        if (valid) {
          const long long pos = out + s_wbase[warp][d] + rank;
          dst_k[pos] = key;
          dst_i[pos] = id;
        }
      }
      __syncthreads();
    }
    grid.sync();
  }

  // F: the sorted rows: the Gini numerator and the top-k
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int r = t / tpr, lo = (t - r * tpr) * kTile;
    const int len = min(kTile, n - lo);
    const int passes = __ldcg(a.rowpasses + r);
    const K mx = (K)__ldcg(a.rowmax + r);
    const long long base = (long long)r * n + lo;
    const K* sk = keys[(passes + 1) & 1];
    const int32_t* si = ids[(passes + 1) & 1];
    unsigned long long num = 0ull;
    for (int j = tid; j < len; j += kThreads) {
      const int pos = lo + j;
      T x;
      int32_t id;
      if (passes == 0) {                  // a constant row keeps its order
        x = __ldg(stack + base + j);
        id = pos;
      } else {
        x = (T)(mx - __ldcg(sk + base + j));
        id = __ldcg(si + base + j);
      }
      const long long v = (long long)x;
      num += (unsigned long long)v *
             (unsigned long long)((long long)n - 1 - 2 * (long long)pos);
      if (pos < a.k) {
        a.top_idx[(long long)r * a.k + pos] = id;
        a.top_val[(long long)r * a.k + pos] = v;
      }
    }
    num = warp_sum(num);
    if (lane == 0 && num)
      atomicAdd(a.acc + (long long)r * kAcc + kDeciles, num);
  }
}

template <typename T, typename K>
cudaError_t launch(DigestArgs* a, int grid, cudaStream_t stream) {
  void* args[] = {a};
  return cudaLaunchCooperativeKernel((const void*)health_digest_kernel<T, K>,
                                     dim3((unsigned)grid), dim3(kThreads),
                                     args, 0, stream);
}

}  // namespace

// wide: the stack is i64 (else i32).  k in [0, n].  tpr: tiles of kTile
// entries per row; grid: blocks of the cooperative launch (at most what
// the card holds at once); the scratch pointers as kernels/
// health_digest.py scratch_layout carves them.
extern "C" int health_digest_launch(
    const void* stack, int wide, const int32_t* decile, int p, int n, int k,
    int tpr, int grid, unsigned long long* acc, int32_t* top_idx,
    long long* top_val, void* keys, int32_t* ids, unsigned long long* tstat,
    uint32_t* counts, uint32_t* totals, long long* rowmax,
    int32_t* rowpasses, int32_t* ctrl, cudaStream_t stream) {
  if (p < 0 || n < 1 || k < 0 || k > n || p > 65535 || grid < 1 ||
      tpr < 1 || (long long)tpr * kTile < n ||
      (long long)(tpr - 1) * kTile >= n)
    return (int)cudaErrorInvalidValue;
  if (p == 0) return (int)cudaSuccess;
  DigestArgs a{stack,  decile, p,     n,      k,      tpr,       acc,
               top_idx, top_val, keys, ids,   tstat,  counts,    totals,
               rowmax, rowpasses, ctrl};
  const cudaError_t err =
      wide ? launch<long long, unsigned long long>(&a, grid, stream)
           : launch<int32_t, uint32_t>(&a, grid, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Blocks of the digest kernel (wide: the i64 instance) that one SM holds
// at once, into *blocks; returns the CUDA error.
extern "C" int health_digest_blocks_per_sm(int wide, int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks,
      wide ? (const void*)health_digest_kernel<long long, unsigned long long>
           : (const void*)health_digest_kernel<int32_t, uint32_t>,
      kThreads, 0);
}
