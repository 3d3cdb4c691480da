// lanes.cuh — per-lane knobs of the kernels that read a sweep knob.
//
// A batch of K sweep lanes over O origins runs as R = K * O rows of the
// origin axis (engine/lanes.py): origin row o belongs to lane o / opl,
// opl = R / K rows per lane.  A kernel that reads a knob takes its lanes'
// values by value, as an array of at most kMaxLanes records in a kernel
// parameter (kernels/_lanes.py MAX_LANES), so that no value of a round
// goes through device memory.  The launcher copies the K records the
// caller passes from host memory into that parameter.
#pragma once

#include <string.h>

constexpr int kMaxLanes = 64;

template <typename T>
struct LaneArray {
  T l[kMaxLanes];
};

// K records from host memory into a launch's parameter; false where K is
// outside [1, kMaxLanes] or the rows do not split into K lanes of opl.
template <typename T>
inline bool lanes_from_host(LaneArray<T>* out, const T* host, int k,
                            long long rows, int opl) {
  if (k < 1 || k > kMaxLanes || opl < 1 || (long long)k * opl != rows)
    return false;
  memset(out, 0, sizeof(*out));
  memcpy(out->l, host, sizeof(T) * (size_t)k);
  return true;
}
