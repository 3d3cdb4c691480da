// class_draw.cuh — the stake-weighted node draw of the pull subsystem and
// the traffic rescue (pull.py / traffic.py class_draw_arr), on the device.
//
// A draw is two counter hashes (faults.cuh): the class uniform picks a stake
// class from the top-entry CDF, the member uniform a node within it:
//   cls = #{c < 24 : u_cls >= cdf[c]},
//   pos = start[cls] + floor(u_mem * f32(count[cls])), clamped to the class,
//   node = perm[pos];
// u = (h >> 8) * 2^-24, exact in f32, and the product rounds once
// (__fmul_rn, no contraction), as XLA's and numpy's do.  Included by
// pull_exchange.cu and traffic_rescue.cu.
#pragma once

#include <stdint.h>

constexpr int kDrawClasses = 25;           // stake buckets (constants.py)
constexpr int32_t kNoThreshold = 0x7FFFFFFF;

__device__ __forceinline__ float u01(uint32_t h) {
  return __fmul_rn((float)(h >> 8), 0x1p-24f);
}

// The class draw compares u = k * 2^-24 (k = h >> 8 < 2^24, exact) with
// the CDF: u >= cdf[c] exactly when k >= this threshold (the scaling by
// 2^24 is exact, so the compare is too).
__device__ __forceinline__ int class_threshold(float c) {
  const float y = __fmul_rn(c, 0x1p24f);
  if (!(y > 0.f)) return y == y ? 0 : 0x7FFFFFFF;  // always; NaN: never
  return y > 0x1p24f ? 0x7FFFFFFF : (int)ceilf(y);
}

// Stage the class tables in shared memory: s_thr[32] the 24 integer
// thresholds, then kNoThreshold; s_start and s_count [25]; *s_rising
// whether the thresholds rise (the sampler's CDF does), which lets
// class_draw search by halving.  The block's first warp computes the
// thresholds, so every thread must call it; a barrier must follow.
__device__ __forceinline__ void stage_class_tables(
    int tid, int nthreads, const int32_t* cstart, const int32_t* ccount,
    const float* cdf, int32_t* s_thr, int32_t* s_start, int32_t* s_count,
    int32_t* s_rising) {
  for (int i = tid; i < kDrawClasses; i += nthreads) {
    s_start[i] = cstart[i];
    s_count[i] = ccount[i];
  }
  if (tid < 32) {
    const int thr =
        tid < kDrawClasses - 1 ? class_threshold(cdf[tid]) : kNoThreshold;
    const int next = __shfl_down_sync(0xFFFFFFFFu, thr, 1);
    const bool rising =
        __all_sync(0xFFFFFFFFu, tid == 31 || thr <= next);
    s_thr[tid] = thr;
    if (tid == 0) *s_rising = rising;
  }
}

// The node drawn by the class hash h_cls and the member hash h_mem (the
// class: #{c < 24 : k >= thr[c]}, by five halvings where the thresholds
// rise, else by 24 compares); perm holds n node ids.
__device__ __forceinline__ int class_draw(uint32_t h_cls, uint32_t h_mem,
                                          const int32_t* s_thr,
                                          const int32_t* s_start,
                                          const int32_t* s_count,
                                          bool rising,
                                          const int32_t* __restrict__ perm,
                                          int n) {
  const int k = (int)(h_cls >> 8);
  int cls = 0;
  if (rising) {
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)
      cls += s_thr[cls + step - 1] <= k ? step : 0;
  } else {
#pragma unroll
    for (int c = 0; c < kDrawClasses - 1; ++c) cls += k >= s_thr[c];
  }
  const int st = s_start[cls], cnt = s_count[cls];
  int pos = st + (int)floorf(__fmul_rn(u01(h_mem), (float)cnt));
  pos = min(min(pos, st + max(cnt - 1, 0)), n - 1);
  return __ldg(perm + pos);
}
