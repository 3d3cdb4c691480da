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
//         the partition is on), and per lane (lanes.cuh: origin row o is
//         lane o / opl) the partition flag and the round's loss-hash basis
//         and threshold.
// Output: tgt [O, N, F] i32, the peer of each of the first F valid slots
//         in slot order, or N where the slot is missing or gated; sup and
//         drop [O, N, F] u8 (each written only when its pointer is set);
//         the flight recorder's trace_peers and trace_code [O, N, F] i32
//         (core.py:606-618), set together or both null: each slot's peer
//         (-1 where missing) and its outcome (0 missing, 1 candidate, 2
//         failed target, 3 suppressed, 4 dropped).
//
// A slot is valid when its peer is < N, not pruned and not the origin.  A
// valid slot's peer receives unless it is failed, else unless the
// partition separates the two sides, else unless the edge hash falls under
// the loss threshold: the reference's order of precedence.  With push_on 0
// (the pull-only mode) no slot is valid and every target is N, as the
// reference's zeroed `valid` gives (core.py:566-571).  One forward
// scan of the row takes the first F valid slots, so no sort is needed.
//
// One thread per (origin, node) row of a tile of rows_per_block rows; the
// rows are staged through shared memory (row_stage.cuh) so that every load
// and store of device memory is coalesced.  Bound on the H100: memory.
// Each row reads 6 S bytes and writes 4 F (plus F per mask); the hash is a
// few integer operations per delivered edge.  So the grid is one wave (as
// many blocks as the SMs hold at once, from the occupancy of this shared
// memory), each block walks the tiles with a grid stride, and a tile's
// three slot planes are staged by asynchronous copies into a ring of
// kStages buffers: the next tile's load is in flight while the current
// tile is scanned and its targets and masks are stored (through shared
// memory, so the stores are coalesced too).  Two buffers measured fastest
// on the H100: a third costs blocks per SM and gains no bytes in flight.
// The same kernel on a single pass (a block per tile, shared memory for
// one buffer) times the same there: its resident blocks keep as many
// loads in flight (chip_smoke.py times both).
// The kernel is instantiated for the gates that are present, so an absent
// gate costs the scan no instruction, and for the trace: without it the
// instantiation is the trace-free scan, with the same shared memory and
// registers.  The trace's two planes are stored from each row's thread
// straight to device memory (F consecutive words a row); only correctness
// is asked of the traced round.

#include <cuda_runtime.h>
#include <stdint.h>

#include "faults.cuh"
#include "lanes.cuh"
#include "row_stage.cuh"

namespace {

constexpr int kDefaultSmem = 48 * 1024;
// Input buffers in the ring: a tile in use and kStages - 1 in flight
// (kernels/push_targets.py STAGES).
constexpr int kStages = 2;

// one lane's knobs (kernels/push_targets.py LANE_DTYPE)
struct PushLane {
  unsigned long long threshold;  // loss: drop where the hash is below
  uint32_t basis;                // loss: the round's edge-hash basis
  int32_t part_on;               // the partition window is on
};
using PushLanes = LaneArray<PushLane>;

// the flight recorder's slot codes (obs/trace.py TRACE_*)
constexpr int32_t kTraceCandidate = 1, kTraceFailedTarget = 2,
                  kTraceSuppressed = 3, kTraceDropped = 4;

// kPart: the partition gate is present (sup is set); kLoss: the loss gate
// is (drop is set); kTrace: the trace planes are set.  What is absent
// costs the scan nothing.
template <bool kPart, bool kLoss, bool kTrace>
__global__ void push_targets_kernel(
    const int32_t* __restrict__ active, const uint8_t* __restrict__ pruned,
    const uint8_t* __restrict__ tfail, const int32_t* __restrict__ origins,
    const int32_t* __restrict__ side, int32_t* __restrict__ tgt,
    uint8_t* __restrict__ sup, uint8_t* __restrict__ drop,
    int32_t* __restrict__ trace_peers, int32_t* __restrict__ trace_code,
    long long rows,
    int n, int s, int f, int push_on, const __grid_constant__ PushLanes lanes,
    int opl) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int rpb = blockDim.x;
  const long long tiles = (rows + rpb - 1) / rpb;
  // the tile's outputs, then kStages input buffers of a tile's slot
  // planes, each part 16-byte padded: a grid of one block per tile touches
  // the first buffer only, and may be given shared memory for that one
  const int out_bytes = (rpb * f * 6 + 15) & ~15;
  const int in_bytes = (rpb * s * 6 + 15) & ~15;
  int32_t* s_tgt = reinterpret_cast<int32_t*>(smem);
  uint8_t* s_sup = reinterpret_cast<uint8_t*>(s_tgt + rpb * f);
  uint8_t* s_drop = s_sup + rpb * f;
  uint8_t* s_in = smem + out_bytes;

  // the copies of the block's k-th tile (if it has one) into buffer
  // k % kStages, as one group: a group is committed for every k, empty past
  // the last tile, so that a wait for all but the newest kStages - 1 groups
  // is a wait for tile k
  auto load = [&](int k) {
    const long long tile = blockIdx.x + (long long)k * gridDim.x;
    if (tile < tiles) {
      const long long r0 = tile * rpb;
      const int nr = (int)min((long long)rpb, rows - r0);
      uint8_t* b = s_in + (k % kStages) * in_bytes;
      stage_in_async(b, reinterpret_cast<const uint8_t*>(active + r0 * s),
                     nr * s * 4);
      stage_in_async(b + rpb * s * 4, pruned + r0 * s, nr * s);
      stage_in_async(b + rpb * s * 5, tfail + r0 * s, nr * s);
    }
    stage_commit();
  };

  for (int k = 0; k + 1 < kStages; ++k) load(k);
  long long tile = blockIdx.x;
  for (int k = 0; tile < tiles; tile += gridDim.x, ++k) {
    // tile k + kStages - 1 goes into the buffer tile k - 1 was scanned
    // from: every thread passed the barrier after that scan
    load(k + kStages - 1);
    stage_wait<kStages - 1>();
    __syncthreads();

    const long long r0 = tile * rpb;
    const int nr = (int)min((long long)rpb, rows - r0);
    const uint8_t* b = s_in + (k % kStages) * in_bytes;
    const int i = threadIdx.x;
    if (i < nr) {
      // the row's origin and node from the tile's first row: one 64-bit
      // division per tile, a 32-bit one where the tile passes an origin
      int o = (int)(r0 / n);
      int node = (int)(r0 - (long long)o * n) + i;
      if (node >= n) {
        const int q = node / n;
        o += q;
        node -= q * n;
      }
      const int org = __ldg(origins + o);
      const PushLane& lane = lanes.l[o / opl];
      const bool part_on = kPart && lane.part_on;
      const uint32_t basis = lane.basis;
      const unsigned long long threshold = lane.threshold;
      const int side_n = part_on ? __ldg(side + node) : 0;
      const int32_t* a = reinterpret_cast<const int32_t*>(b) + i * s;
      const uint8_t* pr = b + rpb * s * 4 + i * s;
      const uint8_t* tf = b + rpb * s * 5 + i * s;
      int32_t* t_out = s_tgt + i * f;
      uint8_t* sup_out = s_sup + i * f;
      uint8_t* drop_out = s_drop + i * f;
      int32_t* tp_out = nullptr;
      int32_t* tc_out = nullptr;
      if constexpr (kTrace) {
        tp_out = trace_peers + (r0 + i) * f;
        tc_out = trace_code + (r0 + i) * f;
      }
      int kk = 0;
      for (int j = 0; push_on && j < s && kk < f; ++j) {
        const int p = a[j];
        if (p >= n || pr[j] || p == org) continue;
        bool ok = !tf[j];
        int32_t code = ok ? kTraceCandidate : kTraceFailedTarget;
        if constexpr (kPart) {
          const bool su = ok && part_on && __ldg(side + p) != side_n;
          sup_out[kk] = su;
          ok &= !su;
          if (su) code = kTraceSuppressed;
        }
        if constexpr (kLoss) {
          const bool dr =
              ok && (unsigned long long)edge_u32(basis, (uint32_t)node,
                                                 (uint32_t)p) < threshold;
          drop_out[kk] = dr;
          ok &= !dr;
          if (dr) code = kTraceDropped;
        }
        t_out[kk] = ok ? p : n;
        if constexpr (kTrace) {
          tp_out[kk] = p;
          tc_out[kk] = code;
        }
        ++kk;
      }
      for (; kk < f; ++kk) {
        t_out[kk] = n;
        if constexpr (kPart) sup_out[kk] = 0;
        if constexpr (kLoss) drop_out[kk] = 0;
        if constexpr (kTrace) {
          tp_out[kk] = -1;
          tc_out[kk] = 0;
        }
      }
    }
    __syncthreads();
    stage_out(reinterpret_cast<uint8_t*>(tgt + r0 * f),
              reinterpret_cast<const uint8_t*>(s_tgt), nr * f * 4);
    if constexpr (kPart) stage_out(sup + r0 * f, s_sup, nr * f);
    if constexpr (kLoss) stage_out(drop + r0 * f, s_drop, nr * f);
  }
}

using Kernel = void (*)(const int32_t*, const uint8_t*, const uint8_t*,
                        const int32_t*, const int32_t*, int32_t*, uint8_t*,
                        uint8_t*, int32_t*, int32_t*, long long, int, int,
                        int, int, const PushLanes, int);

template <bool kTrace>
Kernel gates_for(bool part, bool loss) {
  return part ? (loss ? push_targets_kernel<true, true, kTrace>
                      : push_targets_kernel<true, false, kTrace>)
              : (loss ? push_targets_kernel<false, true, kTrace>
                      : push_targets_kernel<false, false, kTrace>);
}

// The instantiation for the gates that are present (part: sup is set,
// loss: drop is) and the trace, with its dynamic shared memory limit
// raised to smem where that passes the default.
cudaError_t kernel_for(bool part, bool loss, bool trace, int smem,
                       Kernel* kernel) {
  *kernel = trace ? gates_for<true>(part, loss) : gates_for<false>(part, loss);
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// rows = O * N; rows_per_block, grid and smem come from the wrapper's
// launch geometry (kernels/push_targets.py launch_geometry and
// persistent_grid, the latter from push_targets_blocks_per_sm).  sup and
// drop may be null; sup set means the partition gate is present, drop set
// the loss gate.  trace_peers and trace_code are both set (the flight
// recorder) or both null.  push_on 0 sends no push (the pull-only mode).  `lanes`
// points at k PushLane records in host memory, one per lane of opl origin
// rows (k * opl = rows / n).
extern "C" int push_targets_launch(
    const int32_t* active, const uint8_t* pruned, const uint8_t* tfail,
    const int32_t* origins, const int32_t* side, int32_t* tgt, uint8_t* sup,
    uint8_t* drop, int32_t* trace_peers, int32_t* trace_code,
    long long rows, int n, int s, int f, int rows_per_block, int grid,
    int smem, int push_on, const void* lanes, int k, int opl,
    cudaStream_t stream) {
  PushLanes lane_args;
  if (n < 1 || rows % n != 0 ||
      (trace_peers == nullptr) != (trace_code == nullptr) ||
      !lanes_from_host(&lane_args, static_cast<const PushLane*>(lanes), k, rows / n, opl))
    return (int)cudaErrorInvalidValue;
  Kernel kernel;
  const cudaError_t err = kernel_for(sup != nullptr, drop != nullptr,
                                     trace_peers != nullptr, smem, &kernel);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, rows_per_block, smem, stream>>>(
      active, pruned, tfail, origins, side, tgt, sup, drop, trace_peers,
      trace_code, rows, n, s, f, push_on, lane_args, opl);
  return (int)cudaGetLastError();
}

// Blocks of the instantiation for these gates (part: sup set, loss: drop
// set), of rows_per_block threads and smem bytes of dynamic shared memory,
// that one SM holds at once, into *blocks; returns the CUDA error.
extern "C" int push_targets_blocks_per_sm(int rows_per_block, int smem,
                                          int part, int loss, int* blocks) {
  Kernel kernel;
  const cudaError_t err =
      kernel_for(part != 0, loss != 0, false, smem, &kernel);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, rows_per_block, (size_t)smem);
}
