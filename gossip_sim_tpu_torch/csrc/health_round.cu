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
// Design: one cooperative launch of at most one wave of blocks
// (kernels/health_round.py grid_blocks), grid-stride, in two phases split
// by a grid barrier:
//   1. each (row, node) element (traffic: each (lane, node)) writes its
//      new planes, the prune plane as a copy of its input (traffic: after
//      its loop over the V values, coalesced across nodes);
//   2. each (row, pruner) element reads n_pruned and, where it is above
//      0 and the lane is gated in, walks the pruner's C slots and adds one
//      to the prunee's count with an atomic.
// The atomics land on elements that phase 1 wrote (the barrier).  Every
// update is an integer sum, so their order does not matter and the result
// equals the reference's segment_sum; int32 sums wrap as the reference's
// do (the arithmetic is unsigned).  A round where nothing fires is one
// pass over the [R, N] planes plus a read of n_pruned: no host sync, no
// scatter.
//
// Bound on the H100: memory.  Phase 1 reads the two (four) planes and the
// delivery view (traffic: both [K, V, N] delivery planes) and writes the
// new planes; phase 2 reads n_pruned and, in a firing round, the firing
// rows' slots.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// One lane's round (kernels/health_round.py LANE_DTYPE).
struct HealthLane {
  long long it;
  int gate;
  int pad;
};

// the pairs of pruner row `row` (of `n` nodes and `c` slots) into the
// prune plane `plane` (the row's group's n counts)
__device__ __forceinline__ void add_pairs(const int32_t* __restrict__ src,
                                          const uint8_t* __restrict__ slot,
                                          long long base, int c, int n,
                                          uint32_t* plane) {
  for (int j = 0; j < c; ++j) {
    if (!__ldg(slot + base + j)) continue;
    const int u = __ldg(src + base + j);
    if (u >= 0 && u < n) atomicAdd(plane + u, 1u);
  }
}

__global__ void __launch_bounds__(kThreads)
health_round_kernel(const int32_t* __restrict__ prune_in,
                    const int32_t* __restrict__ first_in,
                    const int32_t* __restrict__ n_pruned,
                    const int32_t* __restrict__ src_sorted,
                    const uint8_t* __restrict__ pruned_slot,
                    const uint8_t* __restrict__ reached,
                    uint32_t* __restrict__ prune_out,
                    int32_t* __restrict__ first_out, long long elems, int n,
                    int c, const __grid_constant__ LaneArray<HealthLane> lanes,
                    int opl) {
  cg::grid_group grid = cg::this_grid();
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;

  // 1. the first-delivery stamp and the copy of the prune plane
  for (long long i = tid; i < elems; i += stride) {
    const int lane = (int)(i / n / opl);
    const int32_t f = __ldg(first_in + i);
    first_out[i] = (f == 0 && __ldg(reached + i))
                       ? (int32_t)(lanes.l[lane].it + 1)
                       : f;
    prune_out[i] = (uint32_t)__ldg(prune_in + i);
  }
  grid.sync();

  // 2. the firing pruners' pairs
  for (long long i = tid; i < elems; i += stride) {
    if (__ldg(n_pruned + i) <= 0) continue;
    const long long row = i / n;
    if (!lanes.l[row / opl].gate) continue;
    add_pairs(src_sorted, pruned_slot, i * c, c, n, prune_out + row * n);
  }
}

__global__ void __launch_bounds__(kThreads)
health_round_traffic_kernel(
    const int32_t* __restrict__ prune_in, const int32_t* __restrict__ lat_in,
    const int32_t* __restrict__ del_in, const int32_t* __restrict__ resc_in,
    const uint8_t* __restrict__ new_del, const uint8_t* __restrict__ pull_del,
    const int32_t* __restrict__ v_birth, const int32_t* __restrict__ n_pruned,
    const int32_t* __restrict__ src_sorted,
    const uint8_t* __restrict__ pruned_slot, uint32_t* __restrict__ prune_out,
    uint32_t* __restrict__ lat_out, uint32_t* __restrict__ del_out,
    uint32_t* __restrict__ resc_out, int k, int v, int n, int c,
    const __grid_constant__ LaneArray<HealthLane> lanes) {
  cg::grid_group grid = cg::this_grid();
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long nodes = (long long)k * n;

  // 1. per (lane, node): the sums over the values, and the prune copy
  for (long long i = tid; i < nodes; i += stride) {
    const int lane = (int)(i / n);
    const long long node = i - (long long)lane * n;
    const HealthLane hl = lanes.l[lane];
    uint32_t lat = 0, dels = 0, rescs = 0;
    if (hl.gate) {
      const long long plane = (long long)lane * v * n + node;
      for (int j = 0; j < v; ++j) {
        const uint32_t d = __ldg(new_del + plane + (long long)j * n);
        const uint32_t r =
            pull_del ? __ldg(pull_del + plane + (long long)j * n) : 0u;
        const uint32_t all = d + r;
        if (!all) continue;
        const uint32_t age =
            (uint32_t)hl.it - (uint32_t)__ldg(v_birth + lane * v + j) + 1u;
        lat += all * age;
        dels += all;
        rescs += r;
      }
    }
    lat_out[i] = (uint32_t)__ldg(lat_in + i) + lat;
    del_out[i] = (uint32_t)__ldg(del_in + i) + dels;
    resc_out[i] = (uint32_t)__ldg(resc_in + i) + rescs;
    prune_out[i] = (uint32_t)__ldg(prune_in + i);
  }
  grid.sync();

  // 2. the firing pruners' pairs, over the K V value rows
  const long long elems = (long long)k * v * n;
  for (long long i = tid; i < elems; i += stride) {
    if (__ldg(n_pruned + i) <= 0) continue;
    const int lane = (int)(i / n / v);
    if (!lanes.l[lane].gate) continue;
    add_pairs(src_sorted, pruned_slot, i * c, c, n,
              prune_out + (long long)lane * n);
  }
}

cudaError_t launch_coop(const void* fn, void** args, int grid,
                        cudaStream_t stream) {
  return cudaLaunchCooperativeKernel(fn, dim3((unsigned)grid),
                                     dim3(kThreads), args, 0, stream);
}

}  // namespace

// lanes: k HealthLane records in host memory; row r (of R = k * opl) is
// lane r / opl.  grid: kernels/health_round.py grid_blocks (at most the
// blocks the card holds at once: a cooperative launch).
extern "C" int health_round_launch(
    const int32_t* prune_in, const int32_t* first_in, const int32_t* n_pruned,
    const int32_t* src_sorted, const uint8_t* pruned_slot,
    const uint8_t* reached, uint32_t* prune_out, int32_t* first_out, int r,
    int n, int c, const void* lanes, int k, int opl, int grid,
    cudaStream_t stream) {
  if (r < 0 || n < 1 || c < 0 || grid < 1) return (int)cudaErrorInvalidValue;
  LaneArray<HealthLane> la;
  if (!lanes_from_host(&la, static_cast<const HealthLane*>(lanes), k,
                       (long long)r, opl))
    return (int)cudaErrorInvalidValue;
  long long elems = (long long)r * n;
  if (elems == 0) return (int)cudaSuccess;
  void* args[] = {&prune_in, &first_in,  &n_pruned,  &src_sorted,
                  &pruned_slot, &reached, &prune_out, &first_out,
                  &elems,    &n,         &c,         &la,
                  &opl};
  const cudaError_t err =
      launch_coop((const void*)health_round_kernel, args, grid, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// lanes: k HealthLane records (opl = 1: a record per lane of V value
// rows), each with the round's iteration and the lane's gate.
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
  void* args[] = {&prune_in,  &lat_in,     &del_in,    &resc_in,
                  &new_del,   &pull_del,   &v_birth,   &n_pruned,
                  &src_sorted, &pruned_slot, &prune_out, &lat_out,
                  &del_out,   &resc_out,   &k,         &v,
                  &n,         &c,          &la};
  const cudaError_t err = launch_coop(
      (const void*)health_round_traffic_kernel, args, grid, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Blocks of the round (traffic = 0) or traffic (traffic = 1) kernel that
// one SM holds at once, into *blocks; returns the CUDA error.
extern "C" int health_round_blocks_per_sm(int traffic, int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks,
      traffic ? (const void*)health_round_traffic_kernel
              : (const void*)health_round_kernel,
      kThreads, 0);
}
