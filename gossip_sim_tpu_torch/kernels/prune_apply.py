"""``prune_apply``: apply this round's (pruner, prunee) pairs to the
active-set pruned bits.

Replaces the reference engine's ``round/verb4_prune_apply`` join
(gossip_sim_tpu/engine/core.py:894-941), and the traffic round's
``traffic/prune_apply`` (gossip_sim_tpu/engine/traffic.py:711-755), whose
value axis shares one [N, S] active set.  The CUDA kernel is
``csrc/prune_apply.cu``; :func:`prune_apply_plain` is the same function in
plain PyTorch, used for CPU tensors and as the spec.

Sweep lanes (engine/lanes.py) run as more origin rows: applying the
prunes takes no knob, so a batch of K lanes is K times the rows, unchanged.
Traffic lanes (engine/traffic.py) run as K x V value rows over K shared
sets: ``active`` [K, N, S], lane k's set shared by its V rows.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

NAME = "prune_apply"
#: threads per block of the kernel (csrc/prune_apply.cu kThreads)
THREADS = 256
#: bytes a thread reads or writes at once (a 16-byte vector)
VECTOR = 16


def prune_apply_plain(pruned: torch.Tensor, active: torch.Tensor,
                      src_sorted: torch.Tensor,
                      pruned_slot: torch.Tensor) -> torch.Tensor:
    """``pruned`` [O, N, S] bool | hit, where hit[o, u, s] is set iff
    ``active[o, u, s] == t`` for a live pair (pruner t = the row of
    ``pruned_slot``/``src_sorted`` [O, N, C], prunee u = its src).  An
    ``active`` of shape [N, S] is shared by every o (the traffic round's);
    one of [K, N, S] gives each of K groups of O / K rows its set (a batch
    of traffic lanes; K = O is a set per row)."""
    out = pruned.clone()
    o_i, t_i, c_i = pruned_slot.nonzero(as_tuple=True)
    u_i = src_sorted[o_i, t_i, c_i].long()
    g = group(pruned.shape[0], active)
    rows = active[u_i] if active.dim() == 2 else active[o_i // g, u_i]
    p_i, s_i = (rows == t_i[:, None]).nonzero(as_tuple=True)
    out[o_i[p_i], u_i[p_i], s_i] = True
    return out


def group(rows: int, active: torch.Tensor) -> int:
    """Origin rows per plane of ``active`` ([N, S]: all ``rows``)."""
    if active.dim() == 2:
        return max(rows, 1)
    planes = active.shape[0]
    if planes < 1 or rows % planes:
        raise ValueError(f"{NAME}: {rows} rows do not split over {planes} "
                         f"active sets")
    return rows // planes


def grid_blocks(plane: int, slots: int, sms: int, blocks_per_sm: int) -> int:
    """Blocks of the cooperative launch: one wave (``sms`` x
    ``blocks_per_sm``, all co-resident, as its grid barrier needs), or
    fewer where the larger plane (``plane`` pruned bytes, ``slots``
    pruned-slot bytes) has fewer 16-byte vectors than one wave has
    threads."""
    vectors = -(-max(plane, slots) // VECTOR)
    return max(1, min(-(-vectors // THREADS), sms * blocks_per_sm))


def _lib():
    lib = _build.library(NAME)
    fn = lib.prune_apply_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 5 + [ci] * 6 + [vp]
        fn.restype = ci
    return fn


@functools.lru_cache(maxsize=8)
def blocks_per_sm(device: torch.device, wide: bool) -> int:
    """Blocks of the kernel's 32-bit (or, ``wide``, 64-bit index)
    instantiation one SM of ``device`` holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, read once per device
    and instantiation)."""
    fn = _build.library(NAME).prune_apply_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(int(wide), ctypes.byref(out))
    if rc != 0 or out.value < 1:
        raise RuntimeError(f"{NAME}: occupancy query failed (error {rc}, "
                           f"{out.value} blocks per SM)")
    return out.value


@functools.lru_cache(maxsize=64)
def _grid(device: torch.device, plane: int, slots: int) -> int:
    """:func:`grid_blocks` on ``device`` (read once per device and shape:
    a run calls the kernel at one shape)."""
    return grid_blocks(plane, slots, _build.sm_count(device),
                       blocks_per_sm(device, wide_index(plane, slots)))


def wide_index(plane: int, slots: int) -> bool:
    """Whether the kernel needs 64-bit index math: a flat index of the
    pruned or the pruned-slot plane passes 2^31 - 1."""
    return max(plane, slots) >= 1 << 31


def prune_apply(pruned: torch.Tensor, active: torch.Tensor,
                src_sorted: torch.Tensor,
                pruned_slot: torch.Tensor) -> torch.Tensor:
    """Prune application: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns the new [O, N, S] pruned bits.
    ``active`` is [O, N, S], [N, S] shared by every o, or [K, N, S] shared
    by each lane's O / K rows (no copy of it per value is made).

    On the card one cooperative launch copies ``pruned`` into the output
    and, after a grid barrier, finds the live pairs in 16-byte vectors of
    ``pruned_slot``, spreads them over each warp's lanes and scatters
    their bits (``csrc/prune_apply.cu``)."""
    if not active.is_cuda:
        return prune_apply_plain(pruned, active, src_sorted, pruned_slot)
    O, N, S = pruned.shape
    C = src_sorted.shape[-1]
    dev = active.device
    g = group(O, active)
    _build.check(pruned, "pruned", torch.bool, (O, N, S), dev)
    _build.check(active, "active", torch.int32,
                 (N, S) if active.dim() == 2 else (O // g, N, S), dev)
    _build.check(src_sorted, "src_sorted", torch.int32, (O, N, C), dev)
    _build.check(pruned_slot, "pruned_slot", torch.bool, (O, N, C), dev)
    out = torch.empty((O, N, S), dtype=torch.bool, device=dev)
    plane, slots = O * N * S, O * N * C
    p = _build.ptr
    rc = _lib()(p(pruned), p(active), p(src_sorted), p(pruned_slot), p(out),
                O, N, S, C, g, _grid(dev, plane, slots),
                _build.stream_of(active))
    _build.launched(NAME, rc)
    return out
