"""``traffic_send``: the traffic round's candidates, egress budget and
fault gates, for every (value, sender).

Replaces the reference engine's ``traffic/candidates``,
``traffic/egress_cap`` and ``traffic/network`` blocks
(gossip_sim_tpu/engine/traffic.py:255-314).  The CUDA kernel is
``csrc/traffic_send.cu``; :func:`traffic_send_plain` is the same function
in plain PyTorch, used for CPU tensors and as the spec.

The kernel takes a block per tile of 32 senders x 32 values
(``TILE``), chunk-major: it stages the tile's prune bytes as 16-byte
vectors (only those that cover a live holder), writes each value row's
peers and codes as contiguous vectors from shared memory, and each
sender's 32 slot words as one line of the [N, V] planes.  With the egress
cap on, the running count per sender crosses the value chunks by a
decoupled look-back over a scratch of ``1 + ceil(V / 32) * N`` words that
the launcher zeroes: a memset and one launch; with it off, one launch.

A batch of K traffic lanes (engine/traffic.py ``run_traffic_lanes``) is one
launch too: the lane is the outermost index of the grid, each lane reads
its own active set, churn mask and value planes and its egress cap,
partition flag and loss basis and threshold from its record
(``LANE_DTYPE``, csrc/lanes.cuh), and the look-back restarts at each
lane's first value chunk.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..traffic import (TRAFFIC_ACCEPTED, TRAFFIC_DEFERRED, TRAFFIC_DROPPED,
                       TRAFFIC_FAILED_TARGET, TRAFFIC_SUPPRESSED,
                       value_basis_t)
from ..faults import edge_u32_t
from . import _build, _lanes

NAME = "traffic_send"
MAX_SLOTS = 32           # slot bitmasks are one 32-bit word
TILE = 32                # senders and values of a kernel block
#: One lane's record of the launch (csrc/traffic_send.cu SendLane).
LANE_DTYPE = np.dtype([("loss_threshold", "<u8"), ("egress_cap", "<i4"),
                       ("part_on", "<i4"), ("loss_basis", "<u4"),
                       ("pad", "<i4")])


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


def _send_one(active: torch.Tensor, pruned: torch.Tensor,
              failed: torch.Tensor, v_live: torch.Tensor,
              v_holder: torch.Tensor, v_origin: torch.Tensor,
              v_vid: torch.Tensor, side: torch.Tensor, fanout: int,
              egress_cap: int, partition=None, loss=None) -> SendOut:
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


def traffic_send_plain(active: torch.Tensor, pruned: torch.Tensor,
                       failed: torch.Tensor, v_live: torch.Tensor,
                       v_holder: torch.Tensor, v_origin: torch.Tensor,
                       v_vid: torch.Tensor, side: torch.Tensor, fanout: int,
                       egress_cap, partition=None, loss=None) -> SendOut:
    """The send block in plain PyTorch (see :func:`_send_one` for one
    run).  The lane form takes every plane with a leading lane axis
    (``active`` [K, N, S], ``pruned`` [K, V, N, S], ``failed`` [K, N], the
    value planes [K, V, ...]) and each knob as a scalar or K per-lane
    values (``loss``: a (basis, threshold) pair of either), and runs each
    lane with its own scalars; its outputs carry the lane axis
    (``peer``/``code`` [K, V, N, F], the slot words [K, N, V])."""
    if active.dim() == 2:
        return _send_one(active, pruned, failed, v_live, v_holder, v_origin,
                         v_vid, side, fanout, int(egress_cap), partition,
                         loss)
    k = active.shape[0]
    cap, part, basis, thr = lane_knobs(k, egress_cap, partition, loss)
    outs = [_send_one(active[j], pruned[j], failed[j], v_live[j],
                      v_holder[j], v_origin[j], v_vid[j], side, fanout,
                      int(cap[j]), None if part is None else bool(part[j]),
                      None if basis is None else (int(basis[j]), int(thr[j])))
            for j in range(k)]
    return SendOut(*(torch.stack(x) for x in zip(*outs)))


def lane_knobs(k: int, egress_cap, partition, loss):
    """Each of K lanes' egress cap, partition flag (None: no gate), loss
    basis and threshold (None: no loss gate), as numpy arrays."""
    cap = _lanes.per_lane(egress_cap, k, np.int64)
    part = (None if partition is None
            else _lanes.per_lane(partition, k, np.int64) != 0)
    basis = thr = None
    if loss is not None:
        basis = _lanes.per_lane(loss[0], k, np.int64) & 0xFFFFFFFF
        thr = _lanes.per_lane(loss[1], k, np.int64)
    return cap, part, basis, thr


def scan_words(v: int, n: int, k: int = 1) -> int:
    """The look-back scratch (u64 words) of a call with an egress cap on:
    the block ticket, then a word per (lane, value chunk, sender)."""
    return 1 + k * -(-v // TILE) * n


def _lib():
    fn = _build.library(NAME).traffic_send_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 13 + [ci] * 5 + [vp, ci, vp]
        fn.restype = ci
    return fn


def traffic_send(active: torch.Tensor, pruned: torch.Tensor,
                 failed: torch.Tensor, v_live: torch.Tensor,
                 v_holder: torch.Tensor, v_origin: torch.Tensor,
                 v_vid: torch.Tensor, side: torch.Tensor, fanout: int,
                 egress_cap, partition=None, loss=None) -> SendOut:
    """The send block: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  Returns :class:`SendOut`.  Takes the one-run form or
    the lane form of :func:`traffic_send_plain` (at most
    :data:`~._lanes.MAX_LANES` lanes).  On the card: one launch (every
    lane in its grid), and with an egress cap on in any lane a memset of
    its look-back scratch before it."""
    if not pruned.is_cuda:
        return traffic_send_plain(active, pruned, failed, v_live, v_holder,
                                  v_origin, v_vid, side, fanout, egress_cap,
                                  partition, loss)
    if active.dim() == 2:
        out = _launch(active[None], pruned[None], failed[None],
                      v_live[None], v_holder[None], v_origin[None],
                      v_vid[None], side, fanout, egress_cap, partition, loss)
        return SendOut(*(t[0] for t in out))
    return _launch(active, pruned, failed, v_live, v_holder, v_origin, v_vid,
                   side, fanout, egress_cap, partition, loss)


def _launch(active, pruned, failed, v_live, v_holder, v_origin, v_vid, side,
            fanout, egress_cap, partition, loss) -> SendOut:
    K, V, N, S = pruned.shape
    F = min(fanout, S)
    dev = pruned.device
    if S > MAX_SLOTS or F < 1:
        raise ValueError(f"{NAME}: needs 1 <= fanout and active_set_size "
                         f"<= {MAX_SLOTS}, got {fanout} and {S}")
    _lanes.check_batch(K, NAME)
    i32 = torch.int32
    _build.check(active, "active", i32, (K, N, S), dev)
    _build.check(pruned, "pruned", torch.bool, (K, V, N, S), dev)
    _build.check(failed, "failed", torch.bool, (K, N), dev)
    _build.check(v_live, "v_live", torch.bool, (K, V), dev)
    _build.check(v_holder, "v_holder", torch.bool, (K, V, N), dev)
    _build.check(v_origin, "v_origin", i32, (K, V), dev)
    _build.check(v_vid, "v_vid", i32, (K, V), dev)
    _build.check(side, "side", i32, (N + 1,), dev)
    cap, part, basis, thr = lane_knobs(K, egress_cap, partition, loss)
    records = _lanes.pack(
        K, LANE_DTYPE, egress_cap=cap,
        part_on=0 if part is None else part.astype(np.int64),
        loss_basis=0 if basis is None else basis,
        loss_threshold=0 if thr is None else thr)
    out = SendOut(torch.empty((K, V, N, F), dtype=i32, device=dev),
                  torch.empty((K, V, N, F), dtype=torch.uint8, device=dev),
                  torch.empty((K, N, V), dtype=i32, device=dev),
                  torch.empty((K, N, V), dtype=i32, device=dev))
    scan = (torch.empty(scan_words(V, N, K), dtype=torch.int64, device=dev)
            if (cap > 0).any() else None)
    p = _build.ptr
    rc = _lib()(p(active), p(pruned), p(failed), p(v_live), p(v_holder),
                p(v_origin), p(v_vid), p(side), *(p(t) for t in out),
                None if scan is None else p(scan), V, N, S, F,
                int(loss is not None), records.ctypes.data, K,
                _build.stream_of(pruned))
    _build.launched(NAME, rc)
    return out
