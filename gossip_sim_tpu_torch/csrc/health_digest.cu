// health_digest — the node-health digest of a [P, N] metric stack.
//
// Replaces the reference's on-device digest (gossip_sim_tpu/obs/health.py:
// 125-146, `_device_digest_fn`: a segment_sum, `lax.top_k` and a full sort
// of each row for the Gini numerator).
//
// Input:  stack [P, N] (i32 or i64, the template's T), decile [N] i32
//         (stake-decile ids 0-9), k <= N.
// Output: acc [P, 12] i64, zeroed by the caller: the 10 decile sums, the
//         Gini numerator sum_i (2 i - n - 1) x_sorted[i] and the
//         denominator n sum x; top_idx [P, k] i32 and top_val [P, k] i64,
//         the k largest values, ties toward the lower node id.
//
// Design: no row is sorted.  For x_i let L, E and G count the row's
// entries below, equal to and above it, and B the equal entries at lower
// ids.  The Gini numerator is sum_i x_i (L_i - G_i) (a run of equal
// values at sorted ranks a..b weighs x (a + b - n - 1) each, and L = a - 1,
// G = n - b), and x_i's place in the descending order with ties toward
// the lower id is G_i + B_i, so an entry whose place is below k writes its
// own slot of the top-k.  A block owns kItems x kThreads entries of one
// row and streams the whole row through shared memory in tiles, counting
// L, E and B of each of its entries (G = n - L - E); then each entry adds
// x (L - G) and n x to its block's sums and x to its decile's, and the
// block adds those to acc with 64-bit atomics (unsigned: the sums wrap as
// the reference's i64 sums do, and are exact in any order).  A row of
// N = 100,000 i64 values (800 KB) does not fit one block's shared memory;
// tiled, any N does.
//
// Bound on the H100: operations.  The pairs are N^2 per row (P N^2
// comparisons, three counts each); the bytes (the stack once, the small
// outputs) are negligible beside them.  It runs once per harvest block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kItems = 8;                    // entries a thread owns
constexpr int kTile = 2048;                  // entries a tile stages
constexpr int kDeciles = 10;
constexpr int kAcc = kDeciles + 2;           // deciles, numerator, denominator

template <typename T>
__global__ void __launch_bounds__(kThreads)
health_digest_kernel(const T* __restrict__ stack,
                     const int32_t* __restrict__ decile, int n, int k,
                     unsigned long long* __restrict__ acc,
                     int32_t* __restrict__ top_idx,
                     long long* __restrict__ top_val) {
  __shared__ T tile[kTile];
  __shared__ unsigned long long sums[kAcc];
  const int p = blockIdx.y;
  const T* row = stack + (long long)p * n;
  const int base = blockIdx.x * (kThreads * kItems);
  if (threadIdx.x < kAcc) sums[threadIdx.x] = 0ull;

  T x[kItems];
  int lt[kItems], eq[kItems], before[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = base + j * kThreads + threadIdx.x;
    x[j] = i < n ? row[i] : T(0);
    lt[j] = eq[j] = before[j] = 0;
  }
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int len = min(kTile, n - t0);
    __syncthreads();
    for (int q = threadIdx.x; q < len; q += kThreads) tile[q] = row[t0 + q];
    __syncthreads();
    for (int q = 0; q < len; ++q) {
      const T y = tile[q];
      const int id = t0 + q;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int i = base + j * kThreads + threadIdx.x;
        lt[j] += y < x[j];
        const int same = y == x[j];
        eq[j] += same;
        before[j] += same & (id < i);
      }
    }
  }

  unsigned long long num = 0ull, den = 0ull;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = base + j * kThreads + threadIdx.x;
    if (i >= n) continue;
    const long long v = (long long)x[j];
    const long long gt = (long long)n - lt[j] - eq[j];
    num += (unsigned long long)v * (unsigned long long)((long long)lt[j] - gt);
    den += (unsigned long long)n * (unsigned long long)v;
    const int d = __ldg(decile + i);
    if (d >= 0 && d < kDeciles) atomicAdd(&sums[d], (unsigned long long)v);
    const long long place = gt + before[j];
    if (place < k) {
      top_idx[(long long)p * k + place] = i;
      top_val[(long long)p * k + place] = v;
    }
  }
#pragma unroll
  for (int d = 16; d; d >>= 1) {
    num += __shfl_down_sync(0xFFFFFFFFu, num, d);
    den += __shfl_down_sync(0xFFFFFFFFu, den, d);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&sums[kDeciles], num);
    atomicAdd(&sums[kDeciles + 1], den);
  }
  __syncthreads();
  if (threadIdx.x < kAcc) atomicAdd(acc + p * kAcc + threadIdx.x,
                                    sums[threadIdx.x]);
}

template <typename T>
cudaError_t launch(const void* stack, const int32_t* decile, int p, int n,
                   int k, int blocks, unsigned long long* acc,
                   int32_t* top_idx, long long* top_val,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)blocks, (unsigned)p);
  health_digest_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(stack), decile, n, k, acc, top_idx, top_val);
  return cudaGetLastError();
}

}  // namespace

// wide: the stack is i64 (else i32).  acc must be zeroed; k in [0, n].
// blocks: blocks per row, each of kThreads x kItems entries
// (kernels/health_digest.py grid).
extern "C" int health_digest_launch(const void* stack, int wide,
                                    const int32_t* decile, int p, int n,
                                    int k, int blocks,
                                    unsigned long long* acc,
                                    int32_t* top_idx, long long* top_val,
                                    cudaStream_t stream) {
  if (p < 0 || n < 1 || k < 0 || k > n || p > 65535 || blocks < 1 ||
      (long long)blocks * kThreads * kItems < n)
    return (int)cudaErrorInvalidValue;
  if (p == 0) return (int)cudaSuccess;
  return (int)(wide ? launch<long long>(stack, decile, p, n, k, blocks, acc,
                                        top_idx, top_val, stream)
                    : launch<int32_t>(stack, decile, p, n, k, blocks, acc,
                                      top_idx, top_val, stream));
}
