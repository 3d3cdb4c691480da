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
//
// A slot is valid when the sender is live, holds the value and has not
// failed, the slot holds a peer, its prune bit is clear and the peer is not
// the value's origin.  With the egress cap on, a candidate is sent iff the
// sender's candidates before it in (value, fanout slot) order are fewer
// than the cap.  Then failed target > partition > per-value packet loss,
// whose hash is edge_u32(fmix32(basis ^ vid * GOLD), src, dst) (faults.cuh).
//
// Design: a block takes 32 senders (a lane each) and walks the values in
// steps of 8, a warp per value.  The senders' slots are staged once in
// shared memory with their per-slot bits (is a peer, the peer failed, the
// peer is across the partition), so a (value, sender) reads only its S
// prune bytes.  The egress count needs no scan over memory: each warp
// writes its (value, sender) candidate counts to shared memory, and after
// one barrier every thread adds the counts of the lower warps to the
// running count it carries in a register (two count buffers, alternating,
// so one barrier a step suffices).
//
// Bound on the H100: memory.  It reads the [V, N, S] prune bits and the
// [V, N] holder plane and writes the [V, N, F] peers and codes; everything
// else is staged once per block.

#include <cuda_runtime.h>
#include <stdint.h>

#include "faults.cuh"

namespace {

constexpr int kLanes = 32;  // senders per block
constexpr int kWarps = 8;   // values per step (a warp each)
constexpr unsigned kGold = 0x9E3779B1u;
constexpr uint8_t kArrived = 1, kFailedTarget = 2, kSuppressed = 3,
                  kDropped = 4, kDeferred = 5;
constexpr uint8_t kIsPeer = 1, kPeerFailed = 2, kCross = 4;

__global__ void __launch_bounds__(kLanes * kWarps)
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
                    int32_t* __restrict__ arr_bits, int v_count, int n,
                    int s, int f, int egress_cap, int part_on, int loss,
                    uint32_t loss_basis, unsigned long long loss_threshold) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* act = reinterpret_cast<int32_t*>(smem);   // [kLanes][s]
  int32_t* cnt = act + kLanes * s;                   // [2][kWarps][kLanes]
  uint8_t* flag = reinterpret_cast<uint8_t*>(cnt + 2 * kWarps * kLanes);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kLanes;
  const int node = n0 + lane;
  const bool in_range = node < n;

  for (int i = threadIdx.x; i < kLanes * s; i += blockDim.x) {
    const int r = i / s;
    const int u = n0 + r;
    int32_t pv = n;
    uint8_t fl = 0;
    if (u < n) {
      pv = __ldg(active + (long long)u * s + (i - r * s));
      if (pv >= 0 && pv < n) {
        fl = kIsPeer;
        if (__ldg(failed + pv)) fl |= kPeerFailed;
        if (__ldg(side + u) != __ldg(side + pv)) fl |= kCross;
      }
    }
    act[i] = pv;
    flag[i] = fl;
  }
  __syncthreads();
  const int32_t* my_act = act + lane * s;
  const uint8_t* my_flag = flag + lane * s;
  const bool sends = in_range && !__ldg(failed + node);
  int carry = 0;  // this sender's candidates of the earlier steps

  for (int v0 = 0, step = 0; v0 < v_count; v0 += kWarps, ++step) {
    int32_t* buf = cnt + (step & 1) * kWarps * kLanes;
    const int v = v0 + warp;
    const long long row = (long long)v * n + node;
    uint32_t cbits = 0;
    int c = 0;
    if (v < v_count && sends && __ldg(v_live + v) &&
        __ldg(v_holder + row)) {
      const int32_t origin = __ldg(v_origin + v);
      const uint8_t* prow = pruned + row * s;
      for (int j = 0; j < s && c < f; ++j) {
        if ((my_flag[j] & kIsPeer) && !__ldg(prow + j) &&
            my_act[j] != origin) {
          cbits |= 1u << j;
          ++c;
        }
      }
    }
    buf[warp * kLanes + lane] = c;
    __syncthreads();
    int before = carry;
    for (int w = 0; w < kWarps; ++w) {
      const int cw = buf[w * kLanes + lane];
      if (w < warp) before += cw;
      carry += cw;
    }
    if (v >= v_count || !in_range) continue;
    uint32_t vb = 0;
    if (loss && cbits) vb = fmix32(loss_basis ^ ((uint32_t)__ldg(v_vid + v) *
                                                 kGold));
    uint32_t abits = 0, rest = cbits;
    for (int k = 0; k < f; ++k) {
      int32_t pv = n;
      uint8_t code = 0;
      if (rest) {
        const int j = __ffs(rest) - 1;
        rest &= rest - 1;
        pv = my_act[j];
        const uint8_t fl = my_flag[j];
        if (egress_cap > 0 && before + k >= egress_cap) {
          code = kDeferred;
        } else if (fl & kPeerFailed) {
          code = kFailedTarget;
        } else if (part_on && (fl & kCross)) {
          code = kSuppressed;
        } else if (loss && (unsigned long long)edge_u32(
                               vb, (uint32_t)node, (uint32_t)pv) <
                               loss_threshold) {
          code = kDropped;
        } else {
          code = kArrived;
          abits |= 1u << j;
        }
      }
      peer_out[row * f + k] = pv;
      code_out[row * f + k] = code;
    }
    cand_bits[(long long)node * v_count + v] = (int32_t)cbits;
    arr_bits[(long long)node * v_count + v] = (int32_t)abits;
  }
}

}  // namespace

// part: -1 no partition gate, 0 its window is off, 1 on.  loss: 0 or 1, with
// the round's basis and threshold (2^32 = every message).
extern "C" int traffic_send_launch(
    const int32_t* active, const uint8_t* pruned, const uint8_t* failed,
    const uint8_t* v_live, const uint8_t* v_holder, const int32_t* v_origin,
    const int32_t* v_vid, const int32_t* side, int32_t* peer_out,
    uint8_t* code_out, int32_t* cand_bits, int32_t* arr_bits, int v_count,
    int n, int s, int f, int egress_cap, int part, int loss,
    unsigned int loss_basis, unsigned long long loss_threshold,
    cudaStream_t stream) {
  if (v_count < 0 || n < 1 || s < 1 || s > 32 || f < 1 || f > s ||
      (long long)v_count * n * s >= (1ll << 40))
    return (int)cudaErrorInvalidValue;
  if (v_count == 0) return (int)cudaSuccess;
  const int smem = kLanes * s * 4 + 2 * kWarps * kLanes * 4 + kLanes * s;
  traffic_send_kernel<<<(unsigned)((n + kLanes - 1) / kLanes),
                        kLanes * kWarps, smem, stream>>>(
      active, pruned, failed, v_live, v_holder, v_origin, v_vid, side,
      peer_out, code_out, cand_bits, arr_bits, v_count, n, s, f, egress_cap,
      part > 0 ? 1 : 0, loss, (uint32_t)loss_basis, loss_threshold);
  return (int)cudaGetLastError();
}
