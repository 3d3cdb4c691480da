"""``push_targets``: verb 1, each node's push targets for the round.

Replaces the reference engine's ``round/verb1_push_targets`` block
(gossip_sim_tpu/engine/core.py:559-618) with its packet-loss hash
(gossip_sim_tpu/faults.py:76-121).  The CUDA kernel is
``csrc/push_targets.cu``; :func:`push_targets_plain` is the same function in
plain PyTorch, used for CPU tensors and as the spec.

Sweep lanes (engine/lanes.py) run as more origin rows: the partition flag
and the loss basis and threshold may be per lane (``kernels/_lanes.py``),
read by each row from its lane.

With ``trace`` the call also returns the flight recorder's view of the
slots (core.py:606-618; obs/trace.py ``peers`` and ``code``): each of the
F slots' peer (-1 where the row has fewer valid slots) and its outcome
code, ``TRACE_CANDIDATE`` unless a gate took it (failed target >
suppressed > dropped), 0 for a missing slot.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..faults import edge_u32_t
from ..obs.trace import (TRACE_CANDIDATE, TRACE_DROPPED, TRACE_FAILED_TARGET,
                         TRACE_SUPPRESSED)
from . import _build, _lanes

NAME = "push_targets"
#: One lane's knobs in the launch's struct (csrc/push_targets.cu PushLane).
LANE_DTYPE = np.dtype([("threshold", "<u8"), ("basis", "<u4"),
                       ("part_on", "<i4")])
#: Input buffers in the kernel's ring (csrc/push_targets.cu kStages): the
#: tile being scanned and the next ones, in flight.
STAGES = 2


def row_bytes(s: int, f: int) -> int:
    """Shared memory the kernel stages per row: the S slots (i32 peer,
    pruned and tfail bytes) in each of the ``STAGES`` buffers and the F
    targets (i32 peer, two mask bytes)."""
    return STAGES * 6 * s + 6 * f


def stage_bytes(rows: int, s: int, f: int, buffers: int = STAGES) -> int:
    """Shared memory of a block of ``rows`` rows: the targets and masks,
    then ``buffers`` buffers of the slot planes, each part 16-byte padded.
    A grid of one block per tile uses only the first buffer, so one is
    enough for it."""
    pad = lambda b: -(-b // 16) * 16
    return pad(rows * 6 * f) + buffers * pad(rows * 6 * s)


def launch_geometry(s: int, f: int, smem_limit: int) -> tuple[int, int]:
    """Rows per block (a tile) and shared memory per block
    (``_build.row_blocks``, and fewer rows where the buffers' padding
    passes the limit)."""
    rows, _ = _build.row_blocks(NAME, row_bytes(s, f), smem_limit)
    while rows > 1 and stage_bytes(rows, s, f) > smem_limit:
        rows -= 1
    if stage_bytes(rows, s, f) > smem_limit:
        raise ValueError(f"{NAME}: a row needs {stage_bytes(1, s, f)} bytes "
                         f"of shared memory, more than the {smem_limit} "
                         f"bytes of one block")
    return rows, stage_bytes(rows, s, f)


def persistent_grid(rows: int, rows_per_block: int, sms: int,
                    blocks_per_sm: int) -> tuple[int, int]:
    """Tiles of ``rows_per_block`` rows and the blocks of the grid: one
    wave (``sms`` x ``blocks_per_sm``, the blocks the card holds at once),
    or one block per tile where there are fewer tiles."""
    tiles = -(-rows // rows_per_block)
    return tiles, max(1, min(tiles, sms * blocks_per_sm))


@functools.lru_cache(maxsize=64)
def blocks_per_sm(device: torch.device, rows_per_block: int, smem: int,
                  part: bool = False, loss: bool = False) -> int:
    """Blocks of the kernel (its instantiation for the gates that are
    present) one SM of ``device`` holds at once at this geometry
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, read once per
    device, geometry and gates)."""
    fn = _build.library(NAME).push_targets_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(rows_per_block, smem, int(part), int(loss), ctypes.byref(out))
    if rc != 0 or out.value < 1:
        raise RuntimeError(f"{NAME}: occupancy query failed (error {rc}, "
                           f"{out.value} blocks per SM)")
    return out.value


def _plain_one(active: torch.Tensor, pruned: torch.Tensor,
                       tfail: torch.Tensor, origins: torch.Tensor,
                       side: torch.Tensor, fanout: int, partition=None,
                       loss=None, push_on: bool = True,
                       trace: bool = False):
    """One lane of :func:`push_targets_plain`: scalar knobs."""
    O, N, S = active.shape
    F = min(fanout, S)
    dev = active.device
    i32 = torch.int32
    # bloom-contains(origin) == pruned bit OR peer == origin
    valid = (active < N) & ~pruned & (active != origins[:, None, None])
    if not push_on:
        valid = torch.zeros_like(valid)
    # first F valid slots; failed targets consume a slot but receive nothing
    skey = torch.where(valid, torch.arange(S, device=dev, dtype=i32), S)
    order = torch.sort(skey, dim=-1, stable=True).indices[..., :F]
    slot_ok = skey.gather(-1, order) < S
    peer = active.gather(-1, order)
    tf_slot = tfail.gather(-1, order)
    deliver_ok = slot_ok & ~tf_slot                               # [O, N, F]
    sup_mask = drop_mask = None
    if partition is not None:
        side_dst = side[peer.clamp(max=N).long()]
        sup_mask = (deliver_ok & (side[:N][None, :, None] != side_dst)
                    if partition else torch.zeros_like(deliver_ok))
        deliver_ok = deliver_ok & ~sup_mask
    if loss is not None:
        basis, threshold = loss
        src = torch.arange(N, device=dev)[None, :, None]
        drop_mask = deliver_ok & (edge_u32_t(basis, src, peer) < threshold)
        deliver_ok = deliver_ok & ~drop_mask
    tgt = torch.where(deliver_ok, peer, N).to(i32).contiguous()
    if not trace:
        return tgt, sup_mask, drop_mask
    code = torch.where(slot_ok, TRACE_CANDIDATE, 0)
    code = torch.where(slot_ok & tf_slot, TRACE_FAILED_TARGET, code)
    for mask, c in ((sup_mask, TRACE_SUPPRESSED), (drop_mask, TRACE_DROPPED)):
        if mask is not None:
            code = torch.where(mask, c, code)
    return (tgt, sup_mask, drop_mask,
            torch.where(slot_ok, peer, -1).to(i32).contiguous(),
            code.to(i32).contiguous())


def lane_knobs(rows: int, partition, loss):
    """(K, partition flags, loss bases, loss thresholds) of a call over
    ``rows`` origin rows: each knob as per-lane arrays (None where its gate
    is absent)."""
    part = None if partition is None else _lanes.values(partition, np.int32)
    basis = thr = None
    if loss is not None:
        basis = _lanes.values(loss[0], np.int64) & 0xFFFFFFFF
        thr = _lanes.values(loss[1], np.int64)
    k = _lanes.count(rows, *(a for a in (part, basis, thr) if a is not None))
    return k, part, basis, thr


def push_targets_plain(active: torch.Tensor, pruned: torch.Tensor,
                       tfail: torch.Tensor, origins: torch.Tensor,
                       side: torch.Tensor, fanout: int, partition=None,
                       loss=None, push_on: bool = True, trace: bool = False):
    """The first ``F = min(fanout, S)`` valid slots of each row and their
    delivery gates.

    ``active`` [O, N, S] i32 (N = empty), ``pruned``/``tfail`` [O, N, S]
    bool, ``origins`` [O], ``side`` [N + 1] i32 stake-bipartition sides.
    ``partition`` is None without a partition gate, else whether its window
    is on this round; ``loss`` is None without packet loss, else the round's
    ``(basis, threshold)`` (faults.py ``round_basis``, ``rate_threshold``).
    Each may be per lane: K values, lane k's for rows ``[k O / K, (k + 1)
    O / K)``.  ``push_on`` False (the pull-only mode) makes no slot valid,
    as the reference zeroes ``valid`` (core.py:566-571).  Returns ``tgt``
    [O, N, F] i32 (the peer, or N) and the ``sup_mask`` and ``drop_mask``
    [O, N, F] bool of the gates that are present (else None); with
    ``trace``, then also the trace's ``peers`` and ``code`` [O, N, F] i32.
    """
    k, part, basis, thr = lane_knobs(active.shape[0], partition, loss)
    part, basis, thr = (None if a is None else _lanes.widen(a, k)
                        for a in (part, basis, thr))
    lanes = _lanes.slices(active.shape[0], k)
    if k > 1 and _lanes.uniform(*(a for a in (part, basis, thr)
                                  if a is not None)):
        lanes = [(0, slice(None))]
    outs = []
    for j, rows in lanes:
        outs.append(_plain_one(
            active[rows], pruned[rows], tfail[rows], origins[rows], side,
            fanout, None if part is None else bool(part[j]),
            None if basis is None else (int(basis[j]), int(thr[j])),
            push_on, trace))
    if len(outs) == 1:
        return outs[0]
    return tuple(None if outs[0][i] is None
                 else torch.cat([o[i] for o in outs]).contiguous()
                 for i in range(len(outs[0])))


def _lib():
    fn = _build.library(NAME).push_targets_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([vp] * 10 + [ctypes.c_longlong] + [ci] * 7
                       + [vp, ci, ci, vp])
        fn.restype = ci
    return fn


def push_targets(active: torch.Tensor, pruned: torch.Tensor,
                 tfail: torch.Tensor, origins: torch.Tensor,
                 side: torch.Tensor, fanout: int, partition=None, loss=None,
                 push_on: bool = True, trace: bool = False):
    """Verb 1: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.  Returns what :func:`push_targets_plain` does; without
    ``trace`` the kernel's trace outputs are null and its trace-free
    instantiation runs."""
    if not active.is_cuda:
        return push_targets_plain(active, pruned, tfail, origins, side,
                                  fanout, partition, loss, push_on, trace)
    O, N, S = active.shape
    F = min(fanout, S)
    dev = active.device
    _build.check(active, "active", torch.int32, (O, N, S), dev)
    _build.check(pruned, "pruned", torch.bool, (O, N, S), dev)
    _build.check(tfail, "tfail", torch.bool, (O, N, S), dev)
    _build.check(origins, "origins", torch.int32, (O,), dev)
    _build.check(side, "side", torch.int32, (N + 1,), dev)
    k, part, basis, thr = lane_knobs(O, partition, loss)
    if thr is not None and not ((thr >= 0) & (thr <= 1 << 32)).all():
        raise ValueError(f"{NAME}: loss threshold {thr} outside [0, 2^32]")
    lanes = _lanes.pack(k, LANE_DTYPE,
                        threshold=0 if thr is None else thr,
                        basis=0 if basis is None else basis,
                        part_on=0 if part is None else part != 0)
    mask = lambda: torch.empty((O, N, F), dtype=torch.bool, device=dev)
    tgt = torch.empty((O, N, F), dtype=torch.int32, device=dev)
    sup = None if partition is None else mask()
    drop = None if loss is None else mask()
    plane = lambda: torch.empty((O, N, F), dtype=torch.int32, device=dev)
    t_peers, t_code = (plane(), plane()) if trace else (None, None)
    out = (tgt, sup, drop) + ((t_peers, t_code) if trace else ())
    if tgt.numel() == 0:
        return out
    rows, smem = launch_geometry(S, F, _build.smem_optin(dev))
    _, grid = persistent_grid(
        O * N, rows, _build.sm_count(dev),
        blocks_per_sm(dev, rows, smem, sup is not None, drop is not None))
    p = _build.ptr
    opt = lambda t: None if t is None else p(t)
    rc = _lib()(p(active), p(pruned), p(tfail), p(origins), p(side), p(tgt),
                opt(sup), opt(drop), opt(t_peers), opt(t_code), O * N, N, S,
                F, rows, grid, smem, int(bool(push_on)), lanes.ctypes.data,
                k, O // k, _build.stream_of(active))
    _build.launched(NAME, rc)
    return out
