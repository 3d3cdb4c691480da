// push_targets — verb 1: each node's push targets for this round.
//
// Replaces the reference engine's `round/verb1_push_targets` block
// (gossip_sim_tpu/engine/core.py:559-618: a stable sort of the S slot keys
// compacts the valid slots, then the fault gates mask them) together with
// the per-edge packet-loss hash (gossip_sim_tpu/faults.py:76-121).  The
// plain PyTorch version is kernels/push_targets.py push_targets_plain.
//
// Input:  active [O, N, S] i32 (N = empty slot), pruned and tfail
//         [O, N, S] u8, origins [O] i32, side [N + 1] i32 (read only while
//         the partition is on), the round's loss-hash basis and threshold.
// Output: tgt [O, N, F] i32, the peer of each of the first F valid slots
//         in slot order, or N where the slot is missing or gated; sup and
//         drop [O, N, F] u8 (each written only when its pointer is set).
//
// A slot is valid when its peer is < N, not pruned and not the origin.  A
// valid slot's peer receives unless it is failed, else unless the
// partition separates the two sides, else unless the edge hash falls under
// the loss threshold: the reference's order of precedence.  One forward
// scan of the row takes the first F valid slots, so no sort is needed.
//
// One thread per (origin, node) row; a block stages its rows through
// shared memory (row_stage.cuh) so that every load and store of device
// memory is coalesced.  Bound on the H100: memory.  Each row reads 6 S
// bytes and writes 4 F (plus F per mask); the hash is a few integer
// operations per delivered edge.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_stage.cuh"

namespace {

constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// faults.py edge_u32: fmix32(basis ^ src * C1 ^ dst * C2), all mod 2^32
__device__ __forceinline__ uint32_t edge_u32(uint32_t basis, uint32_t src,
                                             uint32_t dst) {
  return fmix32(basis ^ (src * 0x85EBCA6Bu) ^ (dst * 0xC2B2AE35u));
}

__global__ void push_targets_kernel(
    const int32_t* __restrict__ active, const uint8_t* __restrict__ pruned,
    const uint8_t* __restrict__ tfail, const int32_t* __restrict__ origins,
    const int32_t* __restrict__ side, int32_t* __restrict__ tgt,
    uint8_t* __restrict__ sup, uint8_t* __restrict__ drop, long long rows,
    int n, int s, int f, int part_on, uint32_t basis,
    unsigned long long threshold) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int rpb = blockDim.x;
  const long long r0 = (long long)blockIdx.x * rpb;
  const int nr = (int)min((long long)rpb, rows - r0);
  int32_t* s_act = reinterpret_cast<int32_t*>(smem);
  int32_t* s_tgt = s_act + rpb * s;
  uint8_t* s_prn = reinterpret_cast<uint8_t*>(s_tgt + rpb * f);
  uint8_t* s_tf = s_prn + rpb * s;
  uint8_t* s_sup = s_tf + rpb * s;
  uint8_t* s_drop = s_sup + rpb * f;
  stage_in(reinterpret_cast<uint8_t*>(s_act),
           reinterpret_cast<const uint8_t*>(active + r0 * s), nr * s * 4);
  stage_in(s_prn, pruned + r0 * s, nr * s);
  stage_in(s_tf, tfail + r0 * s, nr * s);
  __syncthreads();

  const int i = threadIdx.x;
  if (i < nr) {
    const long long row = r0 + i;
    const int o = (int)(row / n);
    const int node = (int)(row - (long long)o * n);
    const int org = __ldg(origins + o);
    const bool loss = drop != nullptr;
    const int side_n = part_on ? __ldg(side + node) : 0;
    const int32_t* a = s_act + i * s;
    const uint8_t* pr = s_prn + i * s;
    const uint8_t* tf = s_tf + i * s;
    int32_t* t_out = s_tgt + i * f;
    uint8_t* sup_out = s_sup + i * f;
    uint8_t* drop_out = s_drop + i * f;
    int k = 0;
    for (int j = 0; j < s && k < f; ++j) {
      const int p = a[j];
      if (p >= n || pr[j] || p == org) continue;
      bool ok = !tf[j];
      bool su = false, dr = false;
      if (ok && part_on && __ldg(side + p) != side_n) {
        su = true;
        ok = false;
      }
      if (ok && loss &&
          (unsigned long long)edge_u32(basis, (uint32_t)node, (uint32_t)p) <
              threshold) {
        dr = true;
        ok = false;
      }
      t_out[k] = ok ? p : n;
      sup_out[k] = su;
      drop_out[k] = dr;
      ++k;
    }
    for (; k < f; ++k) {
      t_out[k] = n;
      sup_out[k] = 0;
      drop_out[k] = 0;
    }
  }
  __syncthreads();
  stage_out(reinterpret_cast<uint8_t*>(tgt + r0 * f),
            reinterpret_cast<const uint8_t*>(s_tgt), nr * f * 4);
  if (sup != nullptr) stage_out(sup + r0 * f, s_sup, nr * f);
  if (drop != nullptr) stage_out(drop + r0 * f, s_drop, nr * f);
}

}  // namespace

// rows = O * N; rows_per_block and smem come from the wrapper's launch
// geometry (kernels/push_targets.py launch_geometry).  sup and drop may be
// null; drop set means the loss gate is on.
extern "C" int push_targets_launch(
    const int32_t* active, const uint8_t* pruned, const uint8_t* tfail,
    const int32_t* origins, const int32_t* side, int32_t* tgt, uint8_t* sup,
    uint8_t* drop, long long rows, int n, int s, int f, int rows_per_block,
    int smem, int part_on, uint32_t basis, unsigned long long threshold,
    cudaStream_t stream) {
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        push_targets_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  push_targets_kernel<<<(unsigned)blocks, rows_per_block, smem, stream>>>(
      active, pruned, tfail, origins, side, tgt, sup, drop, rows, n, s, f,
      part_on, basis, threshold);
  return (int)cudaGetLastError();
}
