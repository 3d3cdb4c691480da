"""``traffic_rescue``: the adaptive traffic round's per-value pull rescue.

Replaces the reference engine's ``traffic/pull_rescue`` block
(gossip_sim_tpu/engine/traffic.py:424-619): per value in its pull phase,
every live node still missing it draws ``fanout`` stake-weighted requests;
the requests continue the node's push egress budget and the peer's push
ingress budget, a peer that held the value before the round's deliveries
answers, and the requester keeps the least (clamped hop, clamp bit, peer)
response.  The CUDA kernel is ``csrc/traffic_rescue.cu``;
:func:`traffic_rescue_plain` is the same function in plain PyTorch, used for
CPU tensors and as the spec.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..faults import edge_u32_t, node_u32_t
from ..traffic import TrafficTables, class_draw_arr, u01_t, value_basis_t
from . import _build, _lanes

NAME = "traffic_rescue"
#: the round's counts, in the order of ``RescueOut.counts``: the eleven
#: pull_* rows of an adaptive traffic round, then the rescues whose hop was
#: clamped (they join the round's ``hop_clamped``)
COUNT_NAMES = ("pull_sent", "pull_deferred", "pull_failed_target",
               "pull_suppressed", "pull_dropped", "pull_arrived",
               "pull_queue_dropped", "pull_served", "pull_responses",
               "pull_rescued", "pull_active_values", "hop_clamped")
#: rows of ``RescueOut.per_value``
VALUE_ROWS = ("served", "responses", "rescued", "queue_dropped")
#: rows of ``RescueOut.per_node``: the requester side, then the peer side
NODE_ROWS = ("sent", "deferred", "responses_in", "arrived", "served",
             "responses_out")
COUNT_WORDS = 16   # counts, padded
META_WORDS = 4     # the count walk's block ticket and listed peers, padded
WALK_WARPS = 8     # value chunks of a requester tile (eoff rows)
BIG = 0x7FFFFFFF
#: One lane's record of the launch (csrc/traffic_rescue.cu RescueLane).
LANE_DTYPE = np.dtype([("loss_thr", "<u8"), ("bloom_thr", "<u8"),
                       ("fanout", "<i4"), ("ecap", "<i4"), ("icap", "<i4"),
                       ("part_on", "<i4"), ("b_cls", "<u4"), ("b_mem", "<u4"),
                       ("b_loss", "<u4"), ("b_bloom", "<u4")])


class RescueOut(NamedTuple):
    pull_del: torch.Tensor   # [V, N] bool rescued this round
    pull_hop: torch.Tensor   # [V, N] i32 the rescue's clamped hop, -1 none
    per_value: torch.Tensor  # [4, V] i32 VALUE_ROWS
    per_node: torch.Tensor   # [6, N] i32 NODE_ROWS
    counts: torch.Tensor     # [12] i32 COUNT_NAMES


class Requests(NamedTuple):
    peer: torch.Tensor           # [V, N, F] i32 each request's drawn peer
    sent: torch.Tensor           # [V, N, F] bool within the egress budget
    deferred: torch.Tensor       # [V, N, F] bool wanted, past the budget
    failed_target: torch.Tensor  # [V, N, F] bool sent to a failed peer
    suppressed: torch.Tensor     # [V, N, F] bool partition-suppressed
    dropped: torch.Tensor        # [V, N, F] bool lost
    arrived: torch.Tensor        # [V, N, F] bool arrived at its peer


def rescue_requests(pull_on, v_vid, holder_pre, hop_pre, v_holder, failed,
                    side, perm, class_start, class_count, cdf, push_out,
                    accepted_node, fanout: int, hist_bins: int, pb: int,
                    egress_cap: int, ingress_cap: int, draw, bloom,
                    partition=None, loss=None) -> Requests:
    """The requests of :func:`traffic_rescue_plain` (same arguments): their
    peers, the egress budget and the gates, up to the arrivals."""
    V, N = holder_pre.shape
    F = int(fanout)
    dev = holder_pre.device
    i32 = torch.int32
    nodes = torch.arange(N, device=dev)
    slots = torch.arange(F, device=dev)
    vb = lambda b: value_basis_t(b, v_vid)
    tables = TrafficTables(perm, class_start, class_count, cdf)
    b_cls, b_mem = draw
    peers = class_draw_arr(
        tables,
        u01_t(edge_u32_t(vb(b_cls)[:, None, None], nodes[None, :, None],
                         slots[None, None, :])),
        u01_t(edge_u32_t(vb(b_mem)[:, None, None], nodes[None, :, None],
                         slots[None, None, :]))).to(i32)       # [V, N, F]
    pl = peers.long()
    want = (pull_on[:, None, None] & ~holder_pre[:, :, None]
            & ~failed[None, :, None] & (peers != nodes[None, :, None]))
    cw = want.permute(1, 0, 2).reshape(N, V * F).to(i32)
    prank = (torch.cumsum(cw, 1, dtype=i32) - cw).reshape(N, V, F).permute(
        1, 0, 2)
    sent = want & ((egress_cap <= 0)
                   | (push_out[None, :, None] + prank < egress_cap))
    deferred = want & ~sent
    peer_failed = failed[pl]
    live = sent & ~peer_failed
    failed_target = sent & peer_failed
    suppressed = torch.zeros_like(live)
    if partition:
        suppressed = live & (side[:N][None, :, None] != side[pl])
        live = live & ~suppressed
    dropped = torch.zeros_like(live)
    if loss is not None:
        basis, threshold = loss
        ue = edge_u32_t(vb(basis)[:, None, None], nodes[None, :, None], pl)
        dropped = live & (ue < threshold)
        live = live & ~dropped
    return Requests(peers, sent, deferred, failed_target, suppressed,
                    dropped, live)


def lane_knobs(k: int, fanout, egress_cap, ingress_cap, draw, bloom,
               partition, loss) -> np.ndarray:
    """The K lanes' records (:data:`LANE_DTYPE`) of a call: each knob a
    scalar or K per-lane values (``draw``, ``bloom`` and ``loss`` pairs of
    either; ``partition`` None or False: no gate; ``loss`` None: none)."""
    per = lambda v: _lanes.per_lane(v, k, np.int64)
    u32 = lambda v: per(v) & 0xFFFFFFFF
    loss_basis, loss_thr = loss if loss is not None else (0, 0)
    return _lanes.pack(
        k, LANE_DTYPE, fanout=per(fanout), ecap=per(egress_cap),
        icap=per(ingress_cap),
        part_on=0 if partition is None else per(partition) != 0,
        b_cls=u32(draw[0]), b_mem=u32(draw[1]), b_loss=u32(loss_basis),
        b_bloom=u32(bloom[0]), loss_thr=per(loss_thr),
        bloom_thr=per(bloom[1]))


def traffic_rescue_plain(pull_on, v_vid, holder_pre, hop_pre, v_holder,
                         failed, side, perm, class_start, class_count, cdf,
                         push_out, accepted_node, fanout, hist_bins: int,
                         pb: int, egress_cap, ingress_cap, draw, bloom,
                         partition=None, loss=None) -> RescueOut:
    """The pull rescue in plain PyTorch (see :func:`_rescue_one`).  The
    lane form takes every per-run plane with a leading lane axis
    (``pull_on``/``v_vid`` [K, V], the value planes [K, V, N], ``failed``,
    ``push_out`` and ``accepted_node`` [K, N]; ``side`` and the draw tables
    shared) and each knob as a scalar or K per-lane values
    (:func:`lane_knobs`), runs each lane with its own, and returns every
    output with a leading lane axis."""
    if failed.dim() == 1:
        return _rescue_one(pull_on, v_vid, holder_pre, hop_pre, v_holder,
                           failed, side, perm, class_start, class_count, cdf,
                           push_out, accepted_node, int(fanout), hist_bins,
                           pb, int(egress_cap), int(ingress_cap), draw,
                           bloom, partition, loss)
    k = failed.shape[0]
    kn = lane_knobs(k, fanout, egress_cap, ingress_cap, draw, bloom,
                    partition, loss)
    outs = [_rescue_one(
        pull_on[j], v_vid[j], holder_pre[j], hop_pre[j], v_holder[j],
        failed[j], side, perm, class_start, class_count, cdf, push_out[j],
        accepted_node[j], int(r["fanout"]), hist_bins, pb, int(r["ecap"]),
        int(r["icap"]), (int(r["b_cls"]), int(r["b_mem"])),
        (int(r["b_bloom"]), int(r["bloom_thr"])), bool(r["part_on"]),
        None if loss is None else (int(r["b_loss"]), int(r["loss_thr"])))
        for j, r in enumerate(kn)]
    return RescueOut(*(torch.stack(x) for x in zip(*outs)))


def _rescue_one(pull_on, v_vid, holder_pre, hop_pre, v_holder, failed,
                side, perm, class_start, class_count, cdf, push_out,
                accepted_node, fanout: int, hist_bins: int, pb: int,
                egress_cap: int, ingress_cap: int, draw, bloom,
                partition=None, loss=None) -> RescueOut:
    """The pull rescue of one round.

    ``pull_on`` [V] bool (value live and in its pull phase), ``v_vid`` [V]
    i32, ``holder_pre`` [V, N] bool and ``hop_pre`` [V, N] i32 (after
    injection, before the push deliveries), ``v_holder`` [V, N] bool (after
    them), ``failed`` [N] bool, ``side`` [N + 1] i32, the draw tables
    (``perm`` [N], ``class_start``/``class_count`` [25] i32, ``cdf`` [25]
    f32), ``push_out`` [N] i32 the round's push sends per node,
    ``accepted_node`` [N] i32 its push acceptances.  ``draw`` is the round's
    (class basis, member basis), ``bloom`` its (basis, threshold);
    ``partition`` None (no gate) or whether its window is on, ``loss`` None
    or the round's (basis, threshold).  Request (v, r, s < fanout) draws
    its peer from ``edge_u32(value_basis(b, vid), r, s)`` hashes; it is
    wanted when v is on, r misses it, r is live and the peer is not r; sent
    when ``push_out[r]`` plus r's wanted requests before it in (value, slot)
    order is below ``egress_cap`` (or the cap is off); then failed peer >
    partition > loss (``edge_u32(value_basis(b, vid), r, peer)``); an
    arrival is served when the peer's push acceptances (at most the cap)
    plus its rank among the peer's arrivals in flat (value, requester,
    slot) order is below ``ingress_cap`` (or the cap is off); a served
    request gets a response when the peer held the value and r's bloom hash
    ``node_u32(value_basis(b, vid), r)`` is at or above its threshold.
    r is rescued when it got a response and the push did not deliver to
    it, with the least ``((min(hop + 1, H - 1) << 1 | clamp) << pb) | peer``
    over its responses."""
    V, N = holder_pre.shape
    F = int(fanout)
    H = int(hist_bins)
    dev = holder_pre.device
    i32 = torch.int32
    nodes = torch.arange(N, device=dev)
    req = rescue_requests(pull_on, v_vid, holder_pre, hop_pre, v_holder,
                          failed, side, perm, class_start, class_count, cdf,
                          push_out, accepted_node, fanout, hist_bins, pb,
                          egress_cap, ingress_cap, draw, bloom, partition,
                          loss)
    peers, arrived = req.peer, req.arrived
    pl = peers.long()
    # ingress: rank among the peer's arrivals in flat (v, r, s) order
    tgt = torch.where(arrived, pl, N).reshape(-1)
    order = torch.sort(tgt, stable=True).indices
    st = tgt[order]
    rank = torch.empty_like(tgt)
    rank[order] = (torch.arange(st.numel(), device=dev)
                   - torch.searchsorted(st, st))
    arrived_node = torch.bincount(tgt, minlength=N + 1)[:N].to(i32)
    if ingress_cap > 0:
        room = ingress_cap - accepted_node.clamp(max=ingress_cap)   # [N]
        served = arrived & (rank.reshape(V, N, F) < room[pl])
        served_node = torch.minimum(
            arrived_node, (ingress_cap - accepted_node).clamp(min=0))
    else:
        served = arrived
        served_node = arrived_node
    qdropped = arrived & ~served
    holds = holder_pre.gather(1, pl.reshape(V, -1)).reshape(V, N, F)
    fp = node_u32_t(value_basis_t(bloom[0], v_vid)[:, None],
                    nodes[None, :]) < bloom[1]
    transfer = served & holds & ~fp[:, :, None]
    th = hop_pre.gather(1, pl.reshape(V, -1)).reshape(V, N, F) + 1
    ch = th.clamp(max=H - 1)
    rkey = torch.where(transfer,
                       (((ch << 1) | (th > H - 1).to(i32)) << pb) | peers,
                       BIG)
    win = rkey.min(-1).values                                  # [V, N]
    pull_del = (win != BIG) & ~v_holder
    pull_hop = torch.where(pull_del, win >> (pb + 1), -1).to(i32)
    clamped = pull_del & (((win >> pb) & 1) == 1)
    resp_out = torch.bincount(torch.where(transfer, pl, N).reshape(-1),
                              minlength=N + 1)[:N].to(i32)
    per_value = torch.stack([served.sum((1, 2), dtype=i32),
                             transfer.sum((1, 2), dtype=i32),
                             pull_del.sum(1, dtype=i32),
                             qdropped.sum((1, 2), dtype=i32)])
    per_node = torch.stack([req.sent.sum((0, 2), dtype=i32),
                            req.deferred.sum((0, 2), dtype=i32),
                            transfer.sum((0, 2), dtype=i32),
                            arrived_node, served_node.to(i32), resp_out])
    counts = torch.stack([m.sum(dtype=i32) for m in (
        req.sent, req.deferred, req.failed_target, req.suppressed,
        req.dropped, arrived, qdropped, served, transfer, pull_del, pull_on,
        clamped)])
    return RescueOut(pull_del, pull_hop, per_value, per_node, counts)


def _lib():
    fn = _build.library(NAME).traffic_rescue_launch
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_longlong),
                       vp, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    return fn


def key_bits(v: int, n: int, fanout: int) -> int:
    """Bits of the largest request key (v * N + r) * fanout + s."""
    return max(1, (v * n * fanout - 1).bit_length())


def traffic_rescue(pull_on, v_vid, holder_pre, hop_pre, v_holder, failed,
                   side, perm, class_start, class_count, cdf, push_out,
                   accepted_node, fanout, hist_bins: int, pb: int,
                   egress_cap, ingress_cap, draw, bloom, partition=None,
                   loss=None) -> RescueOut:
    """The pull rescue: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  Returns :class:`RescueOut`; takes the one-run form or
    the lane form of :func:`traffic_rescue_plain` (at most
    :data:`~._lanes.MAX_LANES` lanes).

    On the card: a memset of the counters and one walk kernel with every
    lane's ingress cap off; with one on, a count walk (its last block per
    lane places each peer's cut or bucket), a fill walk, a select kernel
    (the cut of each peer whose cap falls inside its arrivals) and the
    final walk (``csrc/traffic_rescue.cu``), each with the lane in its
    grid."""
    if not holder_pre.is_cuda:
        return traffic_rescue_plain(
            pull_on, v_vid, holder_pre, hop_pre, v_holder, failed, side,
            perm, class_start, class_count, cdf, push_out, accepted_node,
            fanout, hist_bins, pb, egress_cap, ingress_cap, draw, bloom,
            partition, loss)
    if failed.dim() == 1:
        out = _launch(pull_on[None], v_vid[None], holder_pre[None],
                      hop_pre[None], v_holder[None], failed[None], side,
                      perm, class_start, class_count, cdf, push_out[None],
                      accepted_node[None], fanout, hist_bins, pb, egress_cap,
                      ingress_cap, draw, bloom, partition, loss)
        return RescueOut(*(t[0] for t in out))
    return _launch(pull_on, v_vid, holder_pre, hop_pre, v_holder, failed,
                   side, perm, class_start, class_count, cdf, push_out,
                   accepted_node, fanout, hist_bins, pb, egress_cap,
                   ingress_cap, draw, bloom, partition, loss)


def _launch(pull_on, v_vid, holder_pre, hop_pre, v_holder, failed, side,
            perm, class_start, class_count, cdf, push_out, accepted_node,
            fanout, hist_bins, pb, egress_cap, ingress_cap, draw, bloom,
            partition, loss) -> RescueOut:
    K, V, N = holder_pre.shape
    dev = holder_pre.device
    _lanes.check_batch(K, NAME)
    kn = lane_knobs(K, fanout, egress_cap, ingress_cap, draw, bloom,
                    partition, loss)
    F = int(kn["fanout"].max())
    if (int(kn["fanout"].min()) < 1 or V * N * F >= 1 << 31
            or 4 * V > _build.smem_optin(dev)):
        raise ValueError(f"{NAME}: needs fanout >= 1, V * N * fanout < 2^31 "
                         f"and the list of V values in a block's shared "
                         f"memory, got V={V}, N={N}, fanout={F}")
    i32, u8 = torch.int32, torch.bool
    _build.check(pull_on, "pull_on", u8, (K, V), dev)
    _build.check(v_vid, "v_vid", i32, (K, V), dev)
    _build.check(holder_pre, "holder_pre", u8, (K, V, N), dev)
    _build.check(hop_pre, "hop_pre", i32, (K, V, N), dev)
    _build.check(v_holder, "v_holder", u8, (K, V, N), dev)
    _build.check(failed, "failed", u8, (K, N), dev)
    _build.check(side, "side", i32, (N + 1,), dev)
    _build.check(perm, "perm", i32, (N,), dev)
    _build.check(class_start, "class_start", i32, (25,), dev)
    _build.check(class_count, "class_count", i32, (25,), dev)
    _build.check(cdf, "cdf", torch.float32, (25,), dev)
    _build.check(push_out, "push_out", i32, (K, N), dev)
    _build.check(accepted_node, "accepted_node", i32, (K, N), dev)
    icap_on = kn["icap"] > 0
    both = bool((icap_on & (kn["ecap"] > 0)).any())
    # the counters, zeroed by one memset: counts [K, 16], per_value
    # [K, 4, V], per_node [K, 6, N], fill [K, N], meta [K, 4]
    at = np.cumsum([0, K * COUNT_WORDS, K * 4 * V, K * 6 * N, K * N,
                    K * META_WORDS])
    zero = torch.empty(int(at[-1]), dtype=i32, device=dev)
    region = lambda j: zero[int(at[j]):int(at[j + 1])]
    counts = region(0).view(K, COUNT_WORDS)[:, :len(COUNT_NAMES)]
    per_value = region(1).view(K, 4, V)
    per_node = region(2).view(K, 6, N)
    fill, meta = region(3), region(4)
    scratch = torch.empty(K * N * (3 + (WALK_WARPS if both else 0)),
                          dtype=i32, device=dev)
    cut, offset, listed = (scratch[j * K * N:(j + 1) * K * N]
                           for j in range(3))
    eoff = scratch[3 * K * N:] if both else None
    bucket = (torch.empty(K * V * N * F, dtype=i32, device=dev)
              if icap_on.any() else None)
    out = RescueOut(torch.empty((K, V, N), dtype=torch.bool, device=dev),
                    torch.empty((K, V, N), dtype=i32, device=dev), per_value,
                    per_node, counts)
    p = lambda t: None if t is None else t.data_ptr()
    ptrs = (ctypes.c_void_p * 26)(*(p(t) for t in (
        pull_on, v_vid, holder_pre, hop_pre, v_holder, failed, side, perm,
        class_start, class_count, cdf, push_out, accepted_node, out.pull_del,
        out.pull_hop, counts, per_value, per_node, fill, meta, cut, offset,
        listed, eoff, bucket, zero)))
    vals = (ctypes.c_longlong * 9)(
        V, N, int(hist_bins), int(pb), int(loss is not None),
        key_bits(V, N, F), F, zero.numel() * 4, 2 * _build.sm_count(dev))
    rc = _lib()(ptrs, vals, kn.ctypes.data, K, _build.stream_of(holder_pre))
    _build.launched(NAME, rc)
    return out
