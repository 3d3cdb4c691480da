"""``push_targets``: verb 1, each node's push targets for the round.

Replaces the reference engine's ``round/verb1_push_targets`` block
(gossip_sim_tpu/engine/core.py:559-618) with its packet-loss hash
(gossip_sim_tpu/faults.py:76-121).  The CUDA kernel is
``csrc/push_targets.cu``; :func:`push_targets_plain` is the same function in
plain PyTorch, used for CPU tensors and as the spec.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..faults import edge_u32_t
from . import _build

NAME = "push_targets"
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


def push_targets_plain(active: torch.Tensor, pruned: torch.Tensor,
                       tfail: torch.Tensor, origins: torch.Tensor,
                       side: torch.Tensor, fanout: int, partition=None,
                       loss=None):
    """The first ``F = min(fanout, S)`` valid slots of each row and their
    delivery gates.

    ``active`` [O, N, S] i32 (N = empty), ``pruned``/``tfail`` [O, N, S]
    bool, ``origins`` [O], ``side`` [N + 1] i32 stake-bipartition sides.
    ``partition`` is None without a partition gate, else whether its window
    is on this round; ``loss`` is None without packet loss, else the round's
    ``(basis, threshold)`` (faults.py ``round_basis``, ``rate_threshold``).
    Returns ``tgt`` [O, N, F] i32 (the peer, or N) and the ``sup_mask`` and
    ``drop_mask`` [O, N, F] bool of the gates that are present (else None).
    """
    O, N, S = active.shape
    F = min(fanout, S)
    dev = active.device
    i32 = torch.int32
    # bloom-contains(origin) == pruned bit OR peer == origin
    valid = (active < N) & ~pruned & (active != origins[:, None, None])
    # first F valid slots; failed targets consume a slot but receive nothing
    skey = torch.where(valid, torch.arange(S, device=dev, dtype=i32), S)
    order = torch.sort(skey, dim=-1, stable=True).indices[..., :F]
    slot_ok = skey.gather(-1, order) < S
    peer = active.gather(-1, order)
    deliver_ok = slot_ok & ~tfail.gather(-1, order)               # [O, N, F]
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
    return tgt, sup_mask, drop_mask


def _lib():
    fn = _build.library(NAME).push_targets_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([vp] * 8 + [ctypes.c_longlong] + [ci] * 7
                       + [ctypes.c_uint32, ctypes.c_ulonglong, vp])
        fn.restype = ci
    return fn


def push_targets(active: torch.Tensor, pruned: torch.Tensor,
                 tfail: torch.Tensor, origins: torch.Tensor,
                 side: torch.Tensor, fanout: int, partition=None, loss=None):
    """Verb 1: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.  Returns what :func:`push_targets_plain` does."""
    if not active.is_cuda:
        return push_targets_plain(active, pruned, tfail, origins, side,
                                  fanout, partition, loss)
    O, N, S = active.shape
    F = min(fanout, S)
    dev = active.device
    _build.check(active, "active", torch.int32, (O, N, S), dev)
    _build.check(pruned, "pruned", torch.bool, (O, N, S), dev)
    _build.check(tfail, "tfail", torch.bool, (O, N, S), dev)
    _build.check(origins, "origins", torch.int32, (O,), dev)
    _build.check(side, "side", torch.int32, (N + 1,), dev)
    basis, threshold = (0, 0) if loss is None else loss
    if not 0 <= threshold <= 1 << 32:
        raise ValueError(f"{NAME}: loss threshold {threshold} outside "
                         f"[0, 2^32]")
    mask = lambda: torch.empty((O, N, F), dtype=torch.bool, device=dev)
    tgt = torch.empty((O, N, F), dtype=torch.int32, device=dev)
    sup = None if partition is None else mask()
    drop = None if loss is None else mask()
    if tgt.numel() == 0:
        return tgt, sup, drop
    rows, smem = launch_geometry(S, F, _build.smem_optin(dev))
    _, grid = persistent_grid(
        O * N, rows, _build.sm_count(dev),
        blocks_per_sm(dev, rows, smem, sup is not None, drop is not None))
    p = _build.ptr
    opt = lambda t: None if t is None else p(t)
    rc = _lib()(p(active), p(pruned), p(tfail), p(origins), p(side), p(tgt),
                opt(sup), opt(drop), O * N, N, S, F, rows, grid, smem,
                int(bool(partition)), basis & 0xFFFFFFFF, threshold,
                _build.stream_of(active))
    _build.launched(NAME, rc)
    return tgt, sup, drop
