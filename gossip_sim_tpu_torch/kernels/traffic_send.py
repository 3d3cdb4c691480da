"""``traffic_send``: the traffic round's candidates, egress budget and
fault gates, for every (value, sender).

Replaces the reference engine's ``traffic/candidates``,
``traffic/egress_cap`` and ``traffic/network`` blocks
(gossip_sim_tpu/engine/traffic.py:255-314).  The CUDA kernel is
``csrc/traffic_send.cu``; :func:`traffic_send_plain` is the same function
in plain PyTorch, used for CPU tensors and as the spec.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..traffic import (TRAFFIC_ACCEPTED, TRAFFIC_DEFERRED, TRAFFIC_DROPPED,
                       TRAFFIC_FAILED_TARGET, TRAFFIC_SUPPRESSED,
                       value_basis_t)
from ..faults import edge_u32_t
from . import _build

NAME = "traffic_send"
MAX_SLOTS = 32           # slot bitmasks are one 32-bit word


class SendOut(NamedTuple):
    peer: torch.Tensor       # [V, N, F] i32 candidate peers (N = none)
    code: torch.Tensor       # [V, N, F] u8 TRAFFIC_* outcome (0 = none;
                             #   ACCEPTED marks an arrival, before the
                             #   ingress cap)
    cand_bits: torch.Tensor  # [N, V] i32 bit s: slot s is a candidate
    arr_bits: torch.Tensor   # [N, V] i32 bit s: slot s's message arrived
                             #   (sender-major: traffic_admit walks values)


def _as_i32(bits: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> the int32 with the same bits."""
    return (bits - (bits >= 1 << 31).to(torch.int64) * (1 << 32)).to(
        torch.int32)


def traffic_send_plain(active: torch.Tensor, pruned: torch.Tensor,
                       failed: torch.Tensor, v_live: torch.Tensor,
                       v_holder: torch.Tensor, v_origin: torch.Tensor,
                       v_vid: torch.Tensor, side: torch.Tensor, fanout: int,
                       egress_cap: int, partition=None,
                       loss=None) -> SendOut:
    """Each (value, sender)'s first ``F = min(fanout, S)`` valid slots of
    the shared active set, the per-sender egress budget, then the gates.

    ``active`` [N, S] i32 the shared set (N = empty), ``pruned`` [V, N, S]
    bool, ``failed`` [N] bool, ``v_live`` [V], ``v_holder`` [V, N] bool,
    ``v_origin``/``v_vid`` [V] i32, ``side`` [N + 1] i32.  A slot is valid
    when the sender is live, holds the value and has not failed, the slot
    holds a peer, its prune bit is clear and the peer is not the value's
    origin.  ``egress_cap`` > 0 sends a sender's candidates with an
    exclusive running count below it, over (value, fanout slot) order; the
    rest are deferred.  Then failed target > partition (None: no gate,
    else whether its window is on) > per-value packet loss (None, or the
    round's ``(basis, threshold)``; the hash is ``edge_u32(value_basis(
    basis, vid), src, dst)``)."""
    V, N, S = pruned.shape
    F = min(fanout, S)
    dev = pruned.device
    i32, i64 = torch.int32, torch.int64
    if S > MAX_SLOTS:
        raise ValueError(f"{NAME}: active_set_size {S} > {MAX_SLOTS}")
    sender = v_live[:, None] & v_holder & ~failed[None, :]
    valid = (sender[:, :, None] & (active < N)[None] & ~pruned
             & (active[None] != v_origin[:, None, None]))
    skey = torch.where(valid, torch.arange(S, device=dev, dtype=i32), S)
    order = torch.sort(skey, dim=-1, stable=True).indices[..., :F]
    slot_ok = skey.gather(-1, order) < S                       # [V, N, F]
    peer = torch.where(slot_ok, active[None].expand(V, N, S).gather(
        -1, order), N).to(i32)
    cnt = slot_ok.sum(-1, dtype=i32)                           # [V, N]
    before = torch.cumsum(cnt, 0, dtype=i32) - cnt
    erank = before[..., None] + torch.arange(F, device=dev, dtype=i32)
    sent = slot_ok & ((egress_cap <= 0) | (erank < egress_cap))
    tfail = failed[peer.clamp(max=N - 1).long()] & slot_ok
    live = sent & ~tfail
    code = torch.zeros((V, N, F), dtype=torch.uint8, device=dev)
    code[slot_ok & ~sent] = TRAFFIC_DEFERRED
    code[sent & tfail] = TRAFFIC_FAILED_TARGET
    if partition is not None:
        sup = (live & (side[:N][None, :, None] != side[peer.long()])
               if partition else torch.zeros_like(live))
        live = live & ~sup
        code[sup] = TRAFFIC_SUPPRESSED
    if loss is not None:
        basis, threshold = loss
        vb = value_basis_t(basis, v_vid)
        ue = edge_u32_t(vb[:, None, None],
                        torch.arange(N, device=dev)[None, :, None], peer)
        drop = live & (ue < threshold)
        live = live & ~drop
        code[drop] = TRAFFIC_DROPPED
    code[live] = TRAFFIC_ACCEPTED
    bit = torch.ones((), dtype=i64, device=dev) << order.to(i64)
    cand_bits = torch.where(slot_ok, bit, 0).sum(-1)
    arr_bits = torch.where(live, bit, 0).sum(-1)
    return SendOut(peer, code, _as_i32(cand_bits).T.contiguous(),
                   _as_i32(arr_bits).T.contiguous())


def _lib():
    fn = _build.library(NAME).traffic_send_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([vp] * 12 + [ci] * 7
                       + [ctypes.c_uint, ctypes.c_ulonglong, vp])
        fn.restype = ci
    return fn


def traffic_send(active: torch.Tensor, pruned: torch.Tensor,
                 failed: torch.Tensor, v_live: torch.Tensor,
                 v_holder: torch.Tensor, v_origin: torch.Tensor,
                 v_vid: torch.Tensor, side: torch.Tensor, fanout: int,
                 egress_cap: int, partition=None, loss=None) -> SendOut:
    """The send block: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  Returns :class:`SendOut`."""
    if not pruned.is_cuda:
        return traffic_send_plain(active, pruned, failed, v_live, v_holder,
                                  v_origin, v_vid, side, fanout, egress_cap,
                                  partition, loss)
    V, N, S = pruned.shape
    F = min(fanout, S)
    dev = pruned.device
    if S > MAX_SLOTS or F < 1:
        raise ValueError(f"{NAME}: needs 1 <= fanout and active_set_size "
                         f"<= {MAX_SLOTS}, got {fanout} and {S}")
    i32 = torch.int32
    _build.check(active, "active", i32, (N, S), dev)
    _build.check(pruned, "pruned", torch.bool, (V, N, S), dev)
    _build.check(failed, "failed", torch.bool, (N,), dev)
    _build.check(v_live, "v_live", torch.bool, (V,), dev)
    _build.check(v_holder, "v_holder", torch.bool, (V, N), dev)
    _build.check(v_origin, "v_origin", i32, (V,), dev)
    _build.check(v_vid, "v_vid", i32, (V,), dev)
    _build.check(side, "side", i32, (N + 1,), dev)
    out = SendOut(torch.empty((V, N, F), dtype=i32, device=dev),
                  torch.empty((V, N, F), dtype=torch.uint8, device=dev),
                  torch.empty((N, V), dtype=i32, device=dev),
                  torch.empty((N, V), dtype=i32, device=dev))
    basis, threshold = loss if loss is not None else (0, 0)
    p = _build.ptr
    rc = _lib()(p(active), p(pruned), p(failed), p(v_live), p(v_holder),
                p(v_origin), p(v_vid), p(side), *(p(t) for t in out),
                V, N, S, F, int(egress_cap),
                -1 if partition is None else int(bool(partition)),
                int(loss is not None), basis & 0xFFFFFFFF, int(threshold),
                _build.stream_of(pruned))
    _build.launched(NAME, rc)
    return out
