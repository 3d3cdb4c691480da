"""``trace_prune_pairs``: the flight recorder's prune pairs of one round.

Replaces the reference engine's prune-pair capture (gossip_sim_tpu/engine/
core.py:864-892: one full-width sort of the flat ``n * C + slot`` keys of
the pruned slots, behind a ``lax.cond`` on any prune firing).  The CUDA
kernel is ``csrc/trace_prune_pairs.cu`` (one CTA per row: a scan of
``n_pruned`` gives each pruner its offset, and only the firing pruners'
slots are read); :func:`trace_prune_pairs_plain` is the reference's flat
definition in plain PyTorch, used for CPU tensors and as the spec.

The rows are R = O origins in the push engine's round; the function holds
for any R (the traffic engine's V value rows, ROADMAP A13b).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "trace_prune_pairs"
#: threads per CTA (csrc/trace_prune_pairs.cu kThreads): one pruner each
#: per chunk of the scan
THREADS = 1024


def trace_prune_pairs_plain(n_pruned: torch.Tensor,
                            pruned_slot: torch.Tensor,
                            src_sorted: torch.Tensor, cap: int):
    """The first ``cap`` (pruner, prunee) pairs of each row.

    ``n_pruned`` [R, N] i32 (each pruner's pruned slots; the kernel's
    offsets, unread here), ``pruned_slot`` [R, N, C] bool and
    ``src_sorted`` [R, N, C] i32 (rc_merge_prune's prune decision and the
    slot's peer).  The pairs are the pruned slots in flat ``n * C + slot``
    order: pruner ``n``, prunee ``src_sorted[n, slot]``.  Returns ``src``
    and ``dst`` [R, cap] i32, -1 past the row's pairs."""
    R, N, C = pruned_slot.shape
    dev = pruned_slot.device
    flat = pruned_slot.reshape(R, N * C)
    pos = torch.arange(N * C, device=dev)
    order = torch.sort(torch.where(flat, pos, N * C), dim=1).values
    order = order[:, :cap]
    if order.shape[1] < cap:
        order = torch.cat([order, torch.full(
            (R, cap - order.shape[1]), N * C, device=dev,
            dtype=order.dtype)], 1)
    ok = order < N * C
    safe = order.clamp(max=max(N * C - 1, 0))
    dst = src_sorted.reshape(R, N * C).gather(1, safe) if N * C else safe
    return (torch.where(ok, safe // max(C, 1), -1).to(torch.int32),
            torch.where(ok, dst, -1).to(torch.int32))


def _lib():
    fn = _build.library(NAME).trace_prune_pairs_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
        fn.restype = ci
    return fn


def trace_prune_pairs(n_pruned: torch.Tensor, pruned_slot: torch.Tensor,
                      src_sorted: torch.Tensor, cap: int):
    """The prune pairs: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  Returns what :func:`trace_prune_pairs_plain` does;
    on the card ``n_pruned`` must count each row's pruned slots, as
    ``rc_merge_prune`` gives it."""
    cap = int(cap)
    if cap < 0:
        raise ValueError(f"{NAME}: cap must be >= 0, got {cap}")
    if not pruned_slot.is_cuda:
        return trace_prune_pairs_plain(n_pruned, pruned_slot, src_sorted,
                                       cap)
    R, N, C = pruned_slot.shape
    dev = pruned_slot.device
    _build.check(n_pruned, "n_pruned", torch.int32, (R, N), dev)
    _build.check(pruned_slot, "pruned_slot", torch.bool, (R, N, C), dev)
    _build.check(src_sorted, "src_sorted", torch.int32, (R, N, C), dev)
    src = torch.empty((R, cap), dtype=torch.int32, device=dev)
    dst = torch.empty((R, cap), dtype=torch.int32, device=dev)
    if R == 0 or cap == 0:
        return src, dst
    p = _build.ptr
    rc = _lib()(p(n_pruned), p(pruned_slot), p(src_sorted), p(src), p(dst),
                R, N, C, cap, _build.stream_of(pruned_slot))
    _build.launched(NAME, rc)
    return src, dst
