"""``pull_exchange``: the pull (anti-entropy) phase of one round.

Replaces the reference engine's ``round/pull`` block
(gossip_sim_tpu/engine/core.py:1012-1180; pull.py).  The CUDA kernel is
``csrc/pull_exchange.cu``, one launch per call (a block per origin);
:func:`pull_exchange_plain` is the same function in plain PyTorch, used for
CPU tensors and as the spec.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..faults import edge_u32_t, node_u32_t
from . import _build

NAME = "pull_exchange"
INF = 1 << 20          # engine/core.py INF: no pull delivery
#: The [O, 6] ``counts`` columns, under their round-row names.
COUNT_NAMES = ("pull_requests", "pull_responses", "pull_misses",
               "pull_dropped", "pull_suppressed", "pull_rescued")
#: Static shared memory of the kernel (class tables and the reduction's
#: words), rounded up: the per-peer state gets the rest of the block's.
STATIC_SMEM = 1024


class PullOut(NamedTuple):
    pull_hop: torch.Tensor  # [O, N] i32 best pull hop, INF = none
    egress: torch.Tensor    # [O, N] i32 requests arrived + responses sent
    ingress: torch.Tensor   # [O, N] i32 requests received + transfers
    counts: torch.Tensor    # [O, 6] i32, columns COUNT_NAMES


def pull_peers_plain(n: int, slots: int, basis_cls: int, basis_mem: int,
                     perm: torch.Tensor, class_start: torch.Tensor,
                     class_count: torch.Tensor,
                     cdf: torch.Tensor) -> torch.Tensor:
    """The [N, slots] pull peer table (pull.py ``sample_pull_peer`` per
    entry): the class from the top-entry CDF, then a uniform member of it,
    both from ``(edge_u32(basis, node, slot) >> 8) * 2^-24``."""
    dev = perm.device
    nodes = torch.arange(n, device=dev)[:, None]
    slot = torch.arange(slots, device=dev)[None, :]
    u01 = lambda b: ((edge_u32_t(b, nodes, slot) >> 8).to(torch.float32)
                     * 2.0 ** -24)
    u_cls, u_mem = u01(basis_cls), u01(basis_mem)
    cls = (u_cls[..., None] >= cdf[:-1]).sum(-1)
    start, count = class_start[cls], class_count[cls]
    pos = start + torch.floor(u_mem * count.to(torch.float32)).to(torch.int32)
    pos = torch.minimum(pos, start + (count - 1).clamp(min=0))
    return perm[pos.clamp(max=n - 1).long()]


def pull_exchange_plain(reached: torch.Tensor, dist: torch.Tensor,
                        failed: torch.Tensor, side: torch.Tensor,
                        perm: torch.Tensor, class_start: torch.Tensor,
                        class_count: torch.Tensor, cdf: torch.Tensor,
                        adaptive_on, *, fanout: int, slots: int,
                        pull_on: bool, bases: tuple, bloom_threshold: int,
                        cap: int, partition=None, loss=None) -> PullOut:
    """One pull exchange against this round's push outcome.

    ``reached``/``failed`` [O, N] bool and ``dist`` [O, N] i32 (the push
    BFS), ``side`` [N + 1] i32 stake-bipartition sides, the sampler's
    ``perm`` and class tables with its top-entry ``cdf`` [25] f32,
    ``adaptive_on`` [O] bool (None outside the adaptive mode).  ``fanout``
    live slots of ``slots``; ``pull_on`` whether this is a pull round;
    ``bases`` the round's (class, member, bloom) hash bases;
    ``bloom_threshold`` and ``cap`` the bloom false-positive threshold and
    the request cap (<= 0 off); ``partition`` None without a partition
    gate, else whether its window is on; ``loss`` None without packet
    loss, else the round's (basis, threshold).  Returns :class:`PullOut`.
    """
    O, N = reached.shape
    dev = reached.device
    i32 = torch.int32
    b_cls, b_mem, b_fp = bases
    peer_ns = pull_peers_plain(N, slots, b_cls, b_mem, perm, class_start,
                               class_count, cdf)                  # [N, PS]
    nodes = torch.arange(N, device=dev)
    slot_live = (torch.arange(slots, device=dev) < fanout) & bool(pull_on)
    sent = (((peer_ns != nodes[:, None]) & slot_live)[None]
            & ~failed[:, :, None])                                # [O, N, PS]
    if adaptive_on is not None:
        sent = sent & adaptive_on[:, None, None]
    peer_flat = peer_ns.long().reshape(1, -1).expand(O, -1)
    gather = lambda t: t.gather(1, peer_flat).reshape(O, N, slots)
    arrived = sent & ~gather(failed)
    zero_o = torch.zeros(O, dtype=i32, device=dev)
    n_sup = n_drop = zero_o
    if partition is not None:
        sup = arrived & bool(partition) & (side[:N][:, None]
                                           != side[peer_ns.long()])[None]
        arrived = arrived & ~sup
        n_sup = sup.sum((1, 2), dtype=i32)
    if loss is not None:
        basis, threshold = loss
        drop = arrived & (edge_u32_t(basis, nodes[:, None], peer_ns)
                          < threshold)[None]
        arrived = arrived & ~drop
        n_drop = drop.sum((1, 2), dtype=i32)

    # per peer: arrived requests, and each request's rank among them in
    # flat (requester, slot) order (a stable sort keyed by peer)
    arr_flat = arrived.reshape(O, -1)
    key = torch.where(arr_flat, peer_flat, N)
    skey, order = torch.sort(key, dim=1, stable=True)
    pos = torch.arange(key.shape[1], device=dev).expand(O, -1)
    run_start = torch.ones_like(skey, dtype=torch.bool)
    run_start[:, 1:] = skey[:, 1:] != skey[:, :-1]
    first = torch.cummax(torch.where(run_start, pos, 0), dim=1).values
    rank = torch.empty_like(pos).scatter_(1, order, pos - first)
    req_in = torch.zeros((O, N + 1), dtype=i32, device=dev).scatter_add_(
        1, key, arr_flat.to(i32))[:, :N]
    served = arrived
    if cap > 0:
        served = arrived & (rank.reshape(O, N, slots) < cap)

    fp = node_u32_t(b_fp, nodes) < bloom_threshold                # [N]
    transfer = (served & gather(reached) & ~reached[:, :, None]
                & ~fp[None, :, None])
    resp_out = torch.zeros((O, N + 1), dtype=i32, device=dev).scatter_add_(
        1, torch.where(transfer.reshape(O, -1), peer_flat, N),
        torch.ones_like(key, dtype=i32))[:, :N]
    hop = torch.where(transfer, gather(torch.where(reached, dist, 0)) + 1,
                      INF)
    pull_hop = hop.amin(-1).to(i32)
    n_arr = arrived.sum((1, 2), dtype=i32)
    n_resp = transfer.sum((1, 2), dtype=i32)
    counts = torch.stack([n_arr, n_resp, n_arr - n_resp, n_drop, n_sup,
                          (pull_hop < INF).sum(-1, dtype=i32)], dim=1)
    return PullOut(
        pull_hop=pull_hop.contiguous(),
        egress=(arrived.sum(-1, dtype=i32) + resp_out).contiguous(),
        ingress=(req_in + transfer.sum(-1, dtype=i32)).contiguous(),
        counts=counts.contiguous())


def _lib():
    fn = _build.library(NAME).pull_exchange_launch
    if fn.argtypes is None:
        vp, ci, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        fn.argtypes = ([vp] * 14 + [ci] * 7 + [u32] * 4
                       + [ctypes.c_ulonglong] * 2 + [ci, vp])
        fn.restype = ci
    return fn


def state_in_smem(n: int, smem_limit: int) -> bool:
    """Whether an origin's per-peer state (4 words a node) fits one block's
    shared memory beside the kernel's static tables."""
    return 16 * n + STATIC_SMEM <= smem_limit


def pull_exchange(reached: torch.Tensor, dist: torch.Tensor,
                  failed: torch.Tensor, side: torch.Tensor,
                  perm: torch.Tensor, class_start: torch.Tensor,
                  class_count: torch.Tensor, cdf: torch.Tensor, adaptive_on,
                  *, fanout: int, slots: int, pull_on: bool, bases: tuple,
                  bloom_threshold: int, cap: int, partition=None,
                  loss=None) -> PullOut:
    """The pull phase: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  Arguments and result as :func:`pull_exchange_plain`.
    """
    if not reached.is_cuda:
        return pull_exchange_plain(
            reached, dist, failed, side, perm, class_start, class_count, cdf,
            adaptive_on, fanout=fanout, slots=slots, pull_on=pull_on,
            bases=bases, bloom_threshold=bloom_threshold, cap=cap,
            partition=partition, loss=loss)
    O, N = reached.shape
    dev = reached.device
    _build.check(reached, "reached", torch.bool, (O, N), dev)
    _build.check(dist, "dist", torch.int32, (O, N), dev)
    _build.check(failed, "failed", torch.bool, (O, N), dev)
    _build.check(side, "side", torch.int32, (N + 1,), dev)
    _build.check(perm, "perm", torch.int32, (N,), dev)
    _build.check(class_start, "class_start", torch.int32, (25,), dev)
    _build.check(class_count, "class_count", torch.int32, (25,), dev)
    _build.check(cdf, "cdf", torch.float32, (25,), dev)
    if adaptive_on is not None:
        _build.check(adaptive_on, "adaptive_on", torch.bool, (O,), dev)
    if not 0 <= fanout <= slots:
        raise ValueError(f"{NAME}: fanout {fanout} outside [0, {slots}]")
    if N * max(fanout, 1) >= (1 << 31) - 1:
        raise ValueError(f"{NAME}: request keys node * fanout + slot pass "
                         f"int32 at N={N}, fanout={fanout}")
    b_loss, loss_thr = (0, 0) if loss is None else loss
    for what, thr in (("bloom", bloom_threshold), ("loss", loss_thr)):
        if not 0 <= thr <= 1 << 32:
            raise ValueError(f"{NAME}: {what} threshold {thr} outside "
                             f"[0, 2^32]")
    out = PullOut(*(torch.empty((O, N), dtype=torch.int32, device=dev)
                    for _ in range(3)),
                  counts=torch.empty((O, len(COUNT_NAMES)), dtype=torch.int32,
                                     device=dev))
    if O == 0 or N == 0:
        return out
    if state_in_smem(N, _build.smem_optin(dev)):
        scratch, smem = None, 16 * N
    else:
        scratch = torch.empty(O * 4 * N, dtype=torch.int32, device=dev)
        smem = 0
    p = _build.ptr
    b_cls, b_mem, b_fp = bases
    rc = _lib()(p(reached), p(dist), p(failed), p(side), p(perm),
                p(class_start), p(class_count), p(cdf),
                None if adaptive_on is None else p(adaptive_on),
                p(out.pull_hop), p(out.egress), p(out.ingress),
                p(out.counts), None if scratch is None else p(scratch),
                O, N, fanout, int(bool(pull_on)), cap, int(bool(partition)),
                int(loss is not None), b_cls & 0xFFFFFFFF,
                b_mem & 0xFFFFFFFF, b_fp & 0xFFFFFFFF, b_loss & 0xFFFFFFFF,
                bloom_threshold, loss_thr, smem, _build.stream_of(reached))
    _build.launched(NAME, rc)
    return out
