"""``push_targets``: verb 1, each node's push targets for the round.

Replaces the reference engine's ``round/verb1_push_targets`` block
(gossip_sim_tpu/engine/core.py:559-618) with its packet-loss hash
(gossip_sim_tpu/faults.py:76-121).  The CUDA kernel is
``csrc/push_targets.cu``; :func:`push_targets_plain` is the same function in
plain PyTorch, used for CPU tensors and as the spec.
"""

from __future__ import annotations

import ctypes

import torch

from ..faults import edge_u32_t
from . import _build

NAME = "push_targets"


def row_bytes(s: int, f: int) -> int:
    """Shared memory the kernel stages per row: the S slots (i32 peer,
    pruned and tfail bytes) and the F targets (i32 peer, two mask bytes)."""
    return 6 * s + 6 * f


def launch_geometry(s: int, f: int, smem_limit: int) -> tuple[int, int]:
    """Rows per block and shared memory per block (``_build.row_blocks``)."""
    return _build.row_blocks(NAME, row_bytes(s, f), smem_limit)


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
        fn.argtypes = ([vp] * 8 + [ctypes.c_longlong] + [ci] * 6
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
    p = _build.ptr
    opt = lambda t: None if t is None else p(t)
    rc = _lib()(p(active), p(pruned), p(tfail), p(origins), p(side), p(tgt),
                opt(sup), opt(drop), O * N, N, S, F, rows, smem,
                int(bool(partition)), basis & 0xFFFFFFFF, threshold,
                _build.stream_of(active))
    _build.launched(NAME, rc)
    return tgt, sup, drop
