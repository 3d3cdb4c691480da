"""``rank_inbound``: ingress counts and the K best inbound edges per target.

Replaces the reference engine's ``round/verb2_consume`` block
(gossip_sim_tpu/engine/core.py:663-741; twin engine/sparse.py:98-149).
The CUDA kernel is ``csrc/rank_inbound.cu``; :func:`rank_inbound_plain` is
the same function in plain PyTorch, used for CPU tensors and as the spec.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "rank_inbound"
MAX_K = 64             # csrc/rank_inbound.cu kMaxK


def rank_inbound_plain(tgt: torch.Tensor, delivered: torch.Tensor,
                       hop1: torch.Tensor, pb: int, k: int):
    """Plain PyTorch inbound ranking.

    ``tgt`` [O, N, F] i32 targets, ``delivered`` [O, N, F] bool, ``hop1``
    [O, N] i32 the delivery hop of each source.  Returns (inb [O, N, K] i32
    inbound sources ranked by ``hop1 << pb | src`` ascending, N = empty;
    ingress [O, N] i32; dropped [O] i32 = sum of max(ingress - K, 0)).

    One sort of the packed (target, key) pairs ranks every delivered edge
    within its target (rank = position - first position of the target's
    run); kept edges land in their unique slot ``target * K + rank``."""
    O, N, F = tgt.shape
    dev = tgt.device
    nf = N * F
    kd = torch.where(delivered, tgt, N).reshape(O, nf).long()
    iota_n = torch.arange(N, device=dev, dtype=torch.int64)
    kv = (hop1.long() << pb) | iota_n[None, :]
    kv = kv[:, :, None].expand(O, N, F).reshape(O, nf)
    ingress = torch.zeros((O, N + 1), dtype=torch.int32, device=dev)
    ingress.scatter_add_(1, kd, torch.ones_like(kd, dtype=torch.int32))
    ingress = ingress[:, :N].contiguous()
    dropped = torch.clamp(ingress - k, min=0).sum(-1, dtype=torch.int32)

    sk = torch.sort((kd << 32) | kv, dim=1).values
    st, skv = sk >> 32, sk & 0xFFFFFFFF
    rank = torch.arange(nf, device=dev) - torch.searchsorted(st, st)
    keep = (st < N) & (rank < k)
    buf = torch.full((O, N * k + 1), -1, dtype=torch.int64, device=dev)
    buf.scatter_(1, torch.where(keep, st * k + rank, N * k), skv)
    buf = buf[:, :N * k]
    inb = torch.where(buf >= 0, buf & ((1 << pb) - 1), N)
    return inb.to(torch.int32).reshape(O, N, k), ingress, dropped


def _lib():
    lib = _build.library(NAME)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if lib.rank_inbound_count.argtypes is None:
        lib.rank_inbound_count.argtypes = [vp, vp, vp, ci, ci, ci, vp]
        lib.rank_inbound_count.restype = ci
        lib.rank_inbound_place.argtypes = [vp] * 9 + [ci] * 5 + [vp]
        lib.rank_inbound_place.restype = ci
    return lib


def rank_inbound(tgt: torch.Tensor, delivered: torch.Tensor,
                 hop1: torch.Tensor, pb: int, k: int):
    """Inbound ranking: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  Returns (inb, ingress, dropped) as
    :func:`rank_inbound_plain` does."""
    if not tgt.is_cuda:
        return rank_inbound_plain(tgt, delivered, hop1, pb, k)
    O, N, F = tgt.shape
    dev = tgt.device
    _build.check(tgt, "tgt", torch.int32, (O, N, F), dev)
    _build.check(delivered, "delivered", torch.bool, (O, N, F), dev)
    _build.check(hop1, "hop1", torch.int32, (O, N), dev)
    if O * N * F >= 1 << 31:
        raise ValueError(f"{NAME}: O*N*F edges must fit int32 offsets")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{NAME}: k_inbound = {k} outside [1, {MAX_K}]")
    lib = _lib()
    stream = _build.stream_of(tgt)
    ingress = torch.empty((O, N), dtype=torch.int32, device=dev)
    rc = lib.rank_inbound_count(_build.ptr(tgt), _build.ptr(delivered),
                                _build.ptr(ingress), O, N, F, stream)
    if rc != 0:
        raise RuntimeError(f"{NAME}: CUDA launch failed with error {rc}")
    offsets = (torch.cumsum(ingress.reshape(-1), 0, dtype=torch.int32)
               - ingress.reshape(-1))
    cursor = torch.empty(O * N, dtype=torch.int32, device=dev)
    csr = torch.empty(max(O * N * F, 1), dtype=torch.int32, device=dev)
    inb = torch.empty((O, N, k), dtype=torch.int32, device=dev)
    dropped = torch.empty((O,), dtype=torch.int32, device=dev)
    rc = lib.rank_inbound_place(
        _build.ptr(tgt), _build.ptr(delivered), _build.ptr(hop1),
        _build.ptr(ingress), _build.ptr(offsets), _build.ptr(cursor),
        _build.ptr(csr), _build.ptr(inb), _build.ptr(dropped),
        O, N, F, k, pb, stream)
    _build.launched(NAME, rc)
    return inb, ingress, dropped
