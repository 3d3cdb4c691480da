"""The concurrent-traffic round on PyTorch tensors (push and adaptive).

The port of the reference engine's ``engine/traffic.py``: an M-slot value
axis whose in-flight values all push through ONE shared [N, S] active set
(one rotation schedule, one churn mask), with per-value prune bits and
received-cache scoring and per-node queue caps, one hop per round.  Same
state layout, same per-round semantics and bit-exact results under the
same stakes, seed and knobs.  In ``gossip_mode="adaptive"`` each value
carries a direction bit (``v_pull``): a value in its pull phase sends no
push candidates, and the nodes still missing it send rescue requests that
continue the round's queue budgets.  The round's blocks, in order:

* churn (faults.py hashes)                           plain PyTorch
* inject: stake-weighted origins into free slots     plain PyTorch
* candidates + egress budget + fault gates
  (traffic.py:255-314)                               -> ``traffic_send``
* ingress budget (traffic.py:316-342)                -> ``traffic_admit``
* consume: inbound ranking per (value, target)
  (traffic.py:344-417)                               -> ``rank_inbound``
* adaptive only: the pull rescue of the pull-phase
  values (traffic.py:424-619)                        -> ``traffic_rescue``
* received-cache merge + prune decide, rows firing
  only while their value is live (traffic.py:621-709) -> ``rc_merge_prune``
* prune apply on the shared edges (traffic.py:711-755) -> ``prune_apply``
* the shared hash-driven rotation, retire, the direction
  switch and the round stats (traffic.py:757-1000)   plain PyTorch

Traffic lanes (``run_traffic_lanes``, the reference's ``vmap`` of the
round over a lane axis): K runs of one cluster, each with its own shared
active set, churn mask, value slots, queue budgets and knobs, as one round
body over a leading lane axis of every state field
(:func:`traffic_lane_round`; the serial round is its one-lane case).  The
kernels take the K lanes in one launch each: ``traffic_send``,
``traffic_admit`` and ``traffic_rescue`` with the lane in their grids,
``rank_inbound``, ``rc_merge_prune`` and ``prune_apply`` over the K x V
value rows.  A knob every lane shares stays a host scalar.

``trace=True`` (the flight recorder, ROADMAP A13) and the health planes
(A12) are not ported: the health planes stay zero.  Entry points run on
``cuda`` unless the CPU is asked for.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels as K
from ..adaptive import (SALT_ADAPT_PBLOOM, SALT_ADAPT_PCLASS,
                        SALT_ADAPT_PLOSS, SALT_ADAPT_PMEMBER,
                        switch_update_arr)
from ..faults import (SALT_CHURN, edge_u32_t, node_u32_t, partition_active,
                      partition_active_lanes, rate_threshold, round_basis,
                      round_basis_lanes)
from ..kernels.traffic_rescue import COUNT_NAMES as RESCUE_COUNTS
from ..traffic import (SALT_TRAFFIC_LOSS, SALT_TRAFFIC_OCLASS,
                       SALT_TRAFFIC_OMEMBER, SALT_TRAFFIC_RCLASS,
                       SALT_TRAFFIC_RMEMBER, SALT_TRAFFIC_ROT, TRAFFIC_ACCEPTED,
                       TRAFFIC_DEFERRED, TRAFFIC_DROPPED,
                       TRAFFIC_FAILED_TARGET, TRAFFIC_SUPPRESSED,
                       TrafficTables, build_shared_active_set, class_draw_t,
                       traffic_tables, u01_t)
from .core import (ClusterTables, _check_key_bounds, _pack_base,
                   resolve_device, stack_rows)
from .lanes import cat_lanes, check_lane_knobs, lane_groups, num_lanes
from .params import EngineKnobs, EngineParams, EngineStatic


class TrafficState(NamedTuple):
    """One traffic simulation: the shared network and V value slots
    (``V = traffic_values``), with the reference's field names."""

    active: torch.Tensor       # [N, S] i32 the ONE shared active set
    failed: torch.Tensor       # [N] bool churn failure mask
    next_vid: torch.Tensor     # [] i32 monotone global value-id counter
    v_live: torch.Tensor       # [V] bool slot holds an in-flight value
    v_vid: torch.Tensor        # [V] i32 value id (-1 = free slot)
    v_origin: torch.Tensor     # [V] i32 injection origin (N = free)
    v_birth: torch.Tensor      # [V] i32 injection round
    v_stall: torch.Tensor      # [V] i32 consecutive no-progress rounds
    v_holder: torch.Tensor     # [V, N] bool node holds the value
    v_hop: torch.Tensor        # [V, N] i32 delivery hop (-1 = unreached)
    v_m: torch.Tensor          # [V] i32 accepted msgs + prunes (RMR)
    pruned: torch.Tensor       # [V, N, S] bool per-value prune bits on the
                               #   shared active-set slots
    rc_src: torch.Tensor       # [V, N, C] i32 received-cache peers, N = empty
    rc_score: torch.Tensor     # [V, N, C] i32
    rc_shi: torch.Tensor       # [V, N, C] i32
    rc_slo: torch.Tensor       # [V, N, C] i32
    rc_upserts: torch.Tensor   # [V, N] i32
    inj_acc: torch.Tensor      # [] i32 measured-round values injected
    injdrop_acc: torch.Tensor  # [] i32 injections dropped (table full)
    ret_acc: torch.Tensor      # [] i32 values retired
    conv_acc: torch.Tensor     # [] i32 retired with full coverage
    defer_acc: torch.Tensor    # [N] i32 egress-cap deferrals per sender
    qdrop_acc: torch.Tensor    # [N] i32 ingress-cap drops per receiver
    sent_acc: torch.Tensor     # [N] i32 wire messages per sender
    recv_acc: torch.Tensor     # [N] i32 accepted messages per receiver
    prune_acc: torch.Tensor    # [N] i32 prune messages per pruner
    # adaptive push-pull (all-zero outside mode "adaptive", except v_qdrop,
    # which root-causes starvation in every traffic mode)
    v_pull: torch.Tensor       # [V] bool value is in its pull-rescue phase
    v_rescued: torch.Tensor    # [V] i32 nodes delivered via pull rescue
    v_qdrop: torch.Tensor      # [V] i32 ingress queue drops (push and pull
                               #   requests) that hit the value
    health_prune_recv: torch.Tensor   # [N] i32 (health gate A12; zeros)
    health_lat_acc: torch.Tensor      # [N] i32 (zeros)
    health_del_acc: torch.Tensor      # [N] i32 (zeros)
    health_rescued_acc: torch.Tensor  # [N] i32 (zeros)


def device_traffic_tables(stakes, device="cuda") -> TrafficTables:
    """The traffic draws' class tables as tensors on ``device``."""
    dev = resolve_device(device)
    t = traffic_tables(np.asarray(stakes, dtype=np.int64))
    return TrafficTables(*(torch.as_tensor(a, device=dev) for a in t))


def init_traffic_state(stakes, params: EngineParams, seed: int,
                       device="cuda") -> TrafficState:
    """A fresh traffic state: the shared active set (built on the CPU by
    ``traffic.build_shared_active_set``) and V empty value slots."""
    p = params.validate()
    if not p.has_traffic:
        raise ValueError("init_traffic_state requires traffic to be "
                         "engaged (traffic_values > 1 or a queue cap)")
    dev = resolve_device(device)
    stakes = np.asarray(stakes, dtype=np.int64)
    N, S, C = p.num_nodes, p.active_set_size, p.rc_slots
    V = p.traffic_values
    active = build_shared_active_set(stakes, seed, S, p.init_draws)
    zi = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    zb = lambda *shape: torch.zeros(shape, dtype=torch.bool, device=dev)
    full = lambda shape, v: torch.full(shape, v, dtype=torch.int32,
                                       device=dev)
    return TrafficState(
        active=active.to(dev), failed=zb(N),
        next_vid=zi(), v_live=zb(V), v_vid=full((V,), -1),
        v_origin=full((V,), N), v_birth=zi(V), v_stall=zi(V),
        v_holder=zb(V, N), v_hop=full((V, N), -1), v_m=zi(V),
        pruned=zb(V, N, S), rc_src=full((V, N, C), N), rc_score=zi(V, N, C),
        rc_shi=zi(V, N, C), rc_slo=zi(V, N, C), rc_upserts=zi(V, N),
        inj_acc=zi(), injdrop_acc=zi(), ret_acc=zi(), conv_acc=zi(),
        defer_acc=zi(N), qdrop_acc=zi(N), sent_acc=zi(N), recv_acc=zi(N),
        prune_acc=zi(N), v_pull=zb(V), v_rescued=zi(V), v_qdrop=zi(V),
        health_prune_recv=zi(N), health_lat_acc=zi(N), health_del_acc=zi(N),
        health_rescued_acc=zi(N))


def _reset(mask: torch.Tensor, value, x: torch.Tensor) -> torch.Tensor:
    """``x`` with the value slots of ``mask`` ([K, V]) set to ``value``."""
    return torch.where(mask.reshape(tuple(mask.shape)
                                    + (1,) * (x.dim() - mask.dim())),
                       value, x)


class TrafficLanes:
    """The per-lane knobs of a traffic run of K lanes (the serial run is
    K = 1).  ``knobs`` is an :class:`EngineKnobs` of ``[K]`` numpy leaves
    (``lanes.stack_knobs``).  A value every lane shares stays a host
    scalar, so the serial round makes the launches (and the host work) it
    always made; a value the lanes differ in is K numpy values for a
    kernel, which takes it per lane by value, or a [K] tensor on the device
    for the plain blocks (made once per run, or once per round where it
    depends on the iteration)."""

    def __init__(self, knobs: EngineKnobs, device):
        self.kn = knobs
        self.k = int(np.shape(knobs.impair_seed)[0])
        self.device = device
        self._host = {f: _host_lanes(getattr(knobs, f))
                      for f in EngineKnobs._fields}
        self._thr: dict = {}
        self._dev: dict = {}

    def host(self, name: str):
        """Knob ``name``: a Python scalar where every lane shares it, else
        its K values (numpy)."""
        return self._host[name]

    def threshold(self, name: str):
        """``rate_threshold`` of knob ``name``: a Python int where every
        lane shares it, else K int64 values."""
        t = self._thr.get(name)
        if t is None:
            t = self._thr[name] = _host_lanes(np.array(
                [rate_threshold(float(v)) for v in getattr(self.kn, name)],
                np.int64))
        return t

    def plain(self, key: str, values, dtype=None):
        """Per-lane ``values`` for the plain blocks: a scalar as it is, K
        values as a [K] tensor on the device (made once, under ``key``;
        ``key`` None: made anew)."""
        if not isinstance(values, np.ndarray):
            return values
        t = None if key is None else self._dev.get(key)
        if t is None:
            t = torch.as_tensor(values, dtype=dtype, device=self.device)
            if key is not None:
                self._dev[key] = t
        return t

    def knob(self, name: str, dtype=None):
        """Knob ``name`` for the plain blocks (see :meth:`plain`)."""
        return self.plain(name, self._host[name], dtype)

    def basis(self, it: int, salt: int):
        """Each lane's round basis of ``salt`` at iteration ``it``: a
        Python int where every lane shares its seed, else K values."""
        seed = self._host["impair_seed"]
        if not isinstance(seed, np.ndarray):
            return round_basis(int(seed), it, salt)
        return round_basis_lanes(seed, [it], salt)

    def hash_basis(self, it: int, salt: int, nd: int):
        """:meth:`basis` for the plain hashes: a Python int, or a [K, 1 *
        nd] tensor that broadcasts against [K, ...] planes."""
        b = self.basis(it, salt)
        if isinstance(b, int):
            return b
        return lane_col(torch.as_tensor(b, device=self.device), nd)

    def partition(self, it: int):
        """Whether each lane's partition window is on at ``it``: a bool,
        or K bools."""
        pa, heal = self._host["partition_at"], self._host["heal_at"]
        if not isinstance(pa, np.ndarray) and not isinstance(heal,
                                                              np.ndarray):
            return partition_active(it, pa, heal)
        return _host_lanes(partition_active_lanes(
            it, self.kn.partition_at, self.kn.heal_at))

    def gate(self, it: int):
        """The measured-round gate of the accumulators at ``it`` (1 from
        each lane's ``warm_up_rounds`` on): an int, or a [K] i32 tensor on
        the device."""
        warm = self._host["warm_up_rounds"]
        if not isinstance(warm, np.ndarray):
            return 1 if it >= warm else 0
        return self.plain(None, _host_lanes(
            (it >= warm.astype(np.int64)).astype(np.int32)), torch.int32)


def lane_col(x, nd: int):
    """A per-lane value for a [K, ...] plane of ``nd`` more axes: a scalar
    as it is, a [K] tensor as [K, 1, ...]."""
    return x.reshape((-1,) + (1,) * nd) if torch.is_tensor(x) else x


def _host_lanes(a):
    """Per-lane numpy values as one Python scalar where all are equal."""
    a = np.asarray(a).reshape(-1)
    return a[0].item() if (a == a[0]).all() else a


def traffic_lane_round(p: EngineStatic, lanes: TrafficLanes,
                       tables: ClusterTables, ttables: TrafficTables,
                       state: TrafficState, it: int, detail: bool = False):
    """One traffic round of K lanes at iteration ``it`` (a host int): every
    state field has a leading lane axis [K, ...], and each lane's knobs
    come from ``lanes``.  Returns (state, rows), every row with a leading
    [K] axis.  The kernels take the K lanes in one launch each (the K x V
    value rows of ``rank_inbound``, ``rc_merge_prune`` and
    ``prune_apply``; a lane axis in the grids of ``traffic_send``,
    ``traffic_admit`` and ``traffic_rescue``); the plain blocks take a
    value every lane shares as a host scalar and the others per lane."""
    N, S, C, Kin, H = (p.num_nodes, p.active_set_size, p.rc_slots,
                       p.k_inbound, p.hist_bins)
    _check_key_bounds(N, H, Kin)
    V = p.traffic_slots
    F = min(p.push_fanout, S)
    pb = _pack_base(N).bit_length() - 1
    it = int(it)
    k = lanes.k
    dev = state.active.device
    i32 = torch.int32
    iota_n = torch.arange(N, device=dev)
    hb = lambda salt, nd: lanes.hash_basis(it, salt, nd)
    kb = lambda salt: lanes.basis(it, salt)

    # ---- churn (faults.py): one hash per (iteration, node) --------------
    failed = state.failed                                          # [K, N]
    if p.has_churn:
        hu = node_u32_t(hb(SALT_CHURN, 1), iota_n)
        thr = lambda name: lane_col(lanes.plain(
            "threshold:" + name, lanes.threshold(name)), 1)
        fail_ev = hu < thr("churn_fail_rate")
        rec_ev = hu < thr("churn_recover_rate")
        failed = torch.where(failed, ~rec_ev, fail_ev)

    # ---- inject: R stake-weighted origins into ascending free slots -----
    rate = lanes.host("traffic_rate")
    rate = (min(max(int(rate), 0), V) if not isinstance(rate, np.ndarray)
            else lanes.plain("traffic_rate",
                             np.clip(rate.astype(np.int64), 0, V), i32))
    free = ~state.v_live                                           # [K, V]
    free_i = free.to(i32)
    freerank = torch.cumsum(free_i, 1, dtype=i32) - free_i
    n_free = free_i.sum(1, dtype=i32)                              # [K]
    n_inj = (torch.minimum(n_free, rate) if torch.is_tensor(rate)
             else torch.clamp(n_free, max=rate))
    injd = rate - n_inj
    do_inj = free & (freerank < n_inj[:, None])
    origin_new = class_draw_t(ttables, hb(SALT_TRAFFIC_OCLASS, 1),
                              hb(SALT_TRAFFIC_OMEMBER, 1),
                              lambda b: node_u32_t(b, freerank))
    onehot_o = iota_n == origin_new[..., None]                    # [K, V, N]
    v_live = state.v_live | do_inj
    v_vid = torch.where(do_inj, state.next_vid[:, None] + freerank,
                        state.v_vid)
    v_origin = torch.where(do_inj, origin_new, state.v_origin)
    v_birth = _reset(do_inj, it, state.v_birth)
    v_holder = torch.where(do_inj[..., None], onehot_o, state.v_holder)
    v_hop = torch.where(do_inj[..., None],
                        torch.where(onehot_o, 0, -1).to(i32), state.v_hop)
    v_m = _reset(do_inj, 0, state.v_m)
    pruned = _reset(do_inj, False, state.pruned)
    rc_src = _reset(do_inj, N, state.rc_src)
    rc_score = _reset(do_inj, 0, state.rc_score)
    rc_shi = _reset(do_inj, 0, state.rc_shi)
    rc_slo = _reset(do_inj, 0, state.rc_slo)
    rc_ups = _reset(do_inj, 0, state.rc_upserts)
    next_vid = state.next_vid + n_inj
    v_pull = _reset(do_inj, False, state.v_pull)
    v_rescued = _reset(do_inj, 0, state.v_rescued)
    v_qdrop = _reset(do_inj, 0, state.v_qdrop)
    # pre-delivery holder/hop state: the pull-rescue responders and
    # requesters consult this snapshot
    holder_pre, hop_pre = v_holder, v_hop

    # ---- send (kernel): candidates on the lane's shared set, egress
    # budget, failed target > partition > per-value loss; a pull-phase
    # value sends no push candidates (traffic_send gates senders on its
    # live mask) ----------------------------------------------------------
    active = state.active                                          # [K, N, S]
    part = lanes.partition(it) if p.has_partition else None
    loss = ((kb(SALT_TRAFFIC_LOSS), lanes.threshold("packet_loss_rate"))
            if p.has_loss else None)
    senders = v_live & ~v_pull if p.has_adaptive else v_live
    ecap = lanes.host("node_egress_cap")
    snd = K.traffic_send(active, pruned, failed, senders, v_holder, v_origin,
                         v_vid, tables.side, F, ecap, partition=part,
                         loss=loss)
    code = snd.code                                            # [K, V, N, F]

    # ---- admit (kernel): the ingress budget across each lane's values ---
    icap = lanes.host("node_ingress_cap")
    adm = K.traffic_admit(snd.cand_bits, snd.arr_bits, active, F, icap)
    accepted = adm.accepted
    arrived = code == TRAFFIC_ACCEPTED
    qdropped = arrived & ~accepted
    accepted_node = adm.accepted_node                              # [K, N]
    qdrop_node = adm.arrived_node - accepted_node

    # ---- consume (kernel): accepted inbound ranked per (value, target)
    # by (clamped hop, src), over the K x V value rows; first deliveries --
    hop1 = torch.clamp(v_hop + 1, max=H - 1).to(i32)
    inb, ingress_mv, inb_dropped = K.rank_inbound(
        snd.peer.view(k * V, N, F), accepted.view(k * V, N, F),
        hop1.view(k * V, N), pb, Kin)
    first_src = inb.view(k, V, N, Kin)[..., 0]
    has_inb = first_src < N
    src_hop = v_hop.gather(2, first_src.clamp(max=N - 1).long())
    first_hop = torch.clamp(src_hop + 1, max=H - 1)
    new_del = has_inb & ~v_holder                                 # [K, V, N]
    v_holder = v_holder | new_del
    v_hop = torch.where(new_del, first_hop, v_hop)
    hop_clamped = (new_del & (src_hop + 1 > H - 1)).sum((1, 2), dtype=i32)
    delivered = new_del.sum((1, 2), dtype=i32)
    accepted_total = accepted.sum((1, 2, 3), dtype=i32)
    v_qdrop = v_qdrop + qdropped.sum((2, 3), dtype=i32)
    sent = (code != 0) & (code != TRAFFIC_DEFERRED)
    deferred = code == TRAFFIC_DEFERRED
    sent_node = sent.sum((1, 3), dtype=i32)                        # [K, N]
    node_deferred = deferred.sum((1, 3), dtype=i32)                # [K, N] src

    # ---- adaptive (kernel): every live node missing a pull-phase value
    # requests it; requests continue the lane's push budgets, the least
    # (clamped hop, clamp bit, peer) response delivers ----------------------
    resc = None
    if p.has_adaptive:
        resc = K.traffic_rescue(
            v_pull & v_live, v_vid, holder_pre, hop_pre, v_holder, failed,
            tables.side, ttables.perm, ttables.class_start,
            ttables.class_count, ttables.cdf, sent_node, accepted_node,
            lanes.host("pull_fanout"), H, pb, ecap, icap,
            draw=(kb(SALT_ADAPT_PCLASS), kb(SALT_ADAPT_PMEMBER)),
            bloom=(kb(SALT_ADAPT_PBLOOM),
                   lanes.threshold("pull_bloom_fp_rate")),
            partition=part,
            loss=((kb(SALT_ADAPT_PLOSS), lanes.threshold("packet_loss_rate"))
                  if p.has_loss else None))
        served_v, resp_v, rescued_v, qdrop_v = resc.per_value.unbind(1)
        v_holder = v_holder | resc.pull_del
        v_hop = torch.where(resc.pull_del, resc.pull_hop, v_hop)
        hop_clamped = hop_clamped + resc.counts[:, -1]
        v_m = v_m + served_v + resp_v
        v_rescued = v_rescued + rescued_v
        v_qdrop = v_qdrop + qdrop_v

    # ---- received-cache merge + prune decide (kernel; rows of live
    # values fire, with the value's origin in place of the origin) -------
    mp = K.rc_merge_prune(
        rc_src.view(k * V, N, C), rc_score.view(k * V, N, C),
        rc_shi.view(k * V, N, C), rc_slo.view(k * V, N, C),
        rc_ups.view(k * V, N), inb, tables.shi, tables.slo, tables.stakes,
        v_origin.view(k * V), received_cap=p.received_cap,
        min_num_upserts=p.min_num_upserts,
        min_ingress_nodes=lanes.host("min_ingress_nodes"),
        prune_stake_threshold=lanes.host("prune_stake_threshold"),
        live=v_live.view(k * V))
    n_pruned = mp.n_pruned.view(k, V, N)
    m_prunes = n_pruned.sum(-1, dtype=i32)                         # [K, V]
    v_m = v_m + ingress_mv.view(k, V, N).sum(-1, dtype=i32) + m_prunes

    # ---- prune apply (kernel) on each lane's shared edges --------------
    pruned = K.prune_apply(pruned.view(k * V, N, S), active, mp.src_sorted,
                           mp.pruned_slot).view(k, V, N, S)

    # ---- shared rotation: one hash-driven schedule per lane --------------
    u_rot = u01_t(node_u32_t(hb(SALT_TRAFFIC_ROT, 1), iota_n))
    rotate = u_rot < lane_col(lanes.knob("probability_of_rotation",
                                         torch.float32), 1)
    tries = torch.arange(p.rot_tries, device=dev)[None, :]
    cands = class_draw_t(ttables, hb(SALT_TRAFFIC_RCLASS, 2),
                         hb(SALT_TRAFFIC_RMEMBER, 2),
                         lambda b: edge_u32_t(b, iota_n[:, None], tries))
    chosen = torch.full((k, N), N, dtype=i32, device=dev)
    found_new = torch.zeros((k, N), dtype=torch.bool, device=dev)
    for t in range(p.rot_tries):
        cand = cands[..., t]
        ok = (cand != iota_n) & ~(active == cand[..., None]).any(-1)
        chosen = torch.where(ok & ~found_new, cand, chosen)
        found_new = found_new | ok
    do_rot = rotate & found_new                                    # [K, N]
    cnt = (active < N).sum(-1, dtype=i32)
    full_row = cnt >= S
    shift_act = torch.cat([active[..., 1:], chosen[..., None]], -1)
    slot_oh = (torch.arange(S, device=dev)
               == torch.clamp(cnt, max=S - 1)[..., None])
    append_act = torch.where(slot_oh & ~full_row[..., None],
                             chosen[..., None], active)
    new_active = torch.where(do_rot[..., None],
                             torch.where(full_row[..., None], shift_act,
                                         append_act), active)
    shift_prn = torch.cat([pruned[..., 1:],
                           torch.zeros_like(pruned[..., :1])], -1)
    pruned = torch.where((do_rot & full_row)[:, None, :, None], shift_prn,
                         pruned)

    # ---- retire: stall tracking, retirement, slot recycle (rescues count
    # as progress) ---------------------------------------------------------
    progress = new_del.any(-1)
    if resc is not None:
        progress = progress | resc.pull_del.any(-1)
    v_stall = torch.where(~v_live, 0, torch.where(
        do_inj | progress, 0, state.v_stall + 1)).to(i32)
    holders = v_holder.sum(-1, dtype=i32)                          # [K, V]
    full_v = holders == N
    stall = lane_col(lanes.knob("traffic_stall_rounds", i32), 1)
    retire = v_live & (full_v | (v_stall >= stall))
    v_live_post = v_live & ~retire
    hops_sum = torch.where(v_holder, v_hop, 0).sum(-1, dtype=i32)
    # the direction switch (end of round, survivors only)
    new_v_pull, switched = v_pull, None
    if p.has_adaptive:
        new_v_pull = v_live_post & switch_update_arr(
            holders, N, v_pull,
            lane_col(lanes.knob("adaptive_switch_threshold",
                                torch.float64), 1),
            lane_col(lanes.knob("adaptive_switch_hysteresis",
                                torch.float64), 1))
        switched = (new_v_pull & ~v_pull).sum(-1, dtype=i32)

    # ---- round stats: the rescue's requests are requester egress and peer
    # ingress, its responses peer egress and requester ingress -------------
    g = lanes.gate(it)
    g1 = lane_col(g, 1)
    n_retired = retire.sum(-1, dtype=i32)
    n_conv = (retire & full_v).sum(-1, dtype=i32)
    sent_all, recv_all = sent_node, accepted_node
    qdrop_all, inflow = qdrop_node, accepted_node
    if resc is not None:
        (req_sent, req_def, resp_in, req_arrived, req_served,
         resp_out) = resc.per_node.unbind(1)
        node_deferred = node_deferred + req_def
        sent_all = sent_node + req_sent + resp_out
        recv_all = accepted_node + req_served + resp_in
        qdrop_all = qdrop_node + (req_arrived - req_served)
        inflow = accepted_node + req_served
    new_state = TrafficState(
        active=new_active, failed=failed, next_vid=next_vid,
        v_live=v_live_post, v_vid=v_vid, v_origin=v_origin,
        v_birth=v_birth, v_stall=v_stall, v_holder=v_holder, v_hop=v_hop,
        v_m=v_m, pruned=pruned,
        rc_src=mp.rc_src.view(k, V, N, C),
        rc_score=mp.rc_score.view(k, V, N, C),
        rc_shi=mp.rc_shi.view(k, V, N, C),
        rc_slo=mp.rc_slo.view(k, V, N, C),
        rc_upserts=mp.rc_upserts.view(k, V, N),
        inj_acc=state.inj_acc + g * n_inj,
        injdrop_acc=state.injdrop_acc + g * injd,
        ret_acc=state.ret_acc + g * n_retired,
        conv_acc=state.conv_acc + g * n_conv,
        defer_acc=state.defer_acc + g1 * node_deferred,
        qdrop_acc=state.qdrop_acc + g1 * qdrop_all,
        sent_acc=state.sent_acc + g1 * sent_all,
        recv_acc=state.recv_acc + g1 * recv_all,
        prune_acc=state.prune_acc + g1 * n_pruned.sum(1, dtype=i32),
        v_pull=new_v_pull, v_rescued=v_rescued, v_qdrop=v_qdrop,
        health_prune_recv=state.health_prune_recv,
        health_lat_acc=state.health_lat_acc,
        health_del_acc=state.health_del_acc,
        health_rescued_acc=state.health_rescued_acc)
    count = lambda c: (code == c).sum((1, 2, 3), dtype=i32)
    rows = {
        "injected": n_inj,
        "inject_dropped": injd,
        "live": v_live_post.sum(-1, dtype=i32),
        "sends": sent.sum((1, 2, 3), dtype=i32),
        "deferred": count(TRAFFIC_DEFERRED),
        "failed_target": count(TRAFFIC_FAILED_TARGET),
        "suppressed": count(TRAFFIC_SUPPRESSED),
        "dropped": count(TRAFFIC_DROPPED),
        "arrived": arrived.sum((1, 2, 3), dtype=i32),
        "queue_dropped": qdropped.sum((1, 2, 3), dtype=i32),
        "accepted": accepted_total,
        "delivered": delivered,
        "redundant": accepted_total - delivered,
        "prunes_sent": m_prunes.sum(-1, dtype=i32),
        "retired": n_retired,
        "converged": n_conv,
        "hop_clamped": hop_clamped,
        "qdepth_max": node_deferred.amax(-1),
        "inflow_max": inflow.amax(-1),
        "inb_dropped": inb_dropped.view(k, V).sum(-1, dtype=i32),
        "rc_overflow": mp.rc_overflow.view(k, V).sum(-1, dtype=i32),
        # per-value retirement records (valid where ret_mask)
        "ret_mask": retire,
        "ret_vid": v_vid,
        "ret_origin": v_origin,
        "ret_birth": v_birth,
        "ret_holders": holders,
        "ret_m": v_m,
        "ret_full": full_v,
        "ret_hops_sum": hops_sum,
        "ret_rescued": v_rescued,
        "ret_qdrop": v_qdrop,
    }
    if resc is not None:
        # the pull-rescue counters (the sim_adaptive series) and the
        # end-of-round direction flips
        rows.update(zip(RESCUE_COUNTS[:-1], resc.counts[:, :-1].unbind(1)))
        rows["switched_to_pull"] = switched
    if detail:
        rows["live_mask"] = v_live_post
        rows["t_holder"] = v_holder
        rows["t_hop"] = torch.where(v_holder, v_hop, -1).to(i32)
        rows["node_deferred"] = node_deferred
        rows["node_queue_dropped"] = qdrop_all
        rows["node_sent"] = sent_all
        rows["node_recv"] = recv_all
    return new_state, rows


def _check_traffic(p: EngineStatic) -> None:
    if p.traffic_slots <= 0:
        raise ValueError("traffic_round_step requires traffic_slots > 0")


def _one_lane(params: EngineParams, state: TrafficState, trace: bool):
    """The serial entry points' refusals and their run as one lane: (static,
    lanes, the state with a lane axis of one)."""
    if trace:
        raise NotImplementedError(
            "the flight recorder (trace=True) is not ported yet (ROADMAP A13)")
    p, kn = params.validate().split()
    _check_traffic(p)
    one = EngineKnobs(*(np.asarray(v).reshape(1) for v in kn))
    return (p, TrafficLanes(one, state.active.device),
            TrafficState(*(x[None] for x in state)))


def traffic_round_step(params: EngineParams, tables: ClusterTables,
                       ttables: TrafficTables, state: TrafficState, it: int,
                       detail: bool = False, trace: bool = False):
    """One traffic round for all V value slots at iteration ``it`` (a host
    int).  Returns (state, rows); ``detail`` adds the per-value and
    per-node rows.  This is the one-lane case of
    :func:`traffic_lane_round`."""
    p, lanes, st = _one_lane(params, state, trace)
    st, rows = traffic_lane_round(p, lanes, tables, ttables, st, it, detail)
    return (TrafficState(*(x[0] for x in st)),
            {name: v[0] for name, v in rows.items()})


def run_traffic_rounds(params: EngineParams, tables: ClusterTables,
                       ttables: TrafficTables, state: TrafficState,
                       num_iters: int, start_it: int = 0,
                       detail: bool = False, trace: bool = False):
    """Run ``num_iters`` traffic rounds from iteration ``start_it``.
    Returns (state, rows) with every row stacked on a leading
    [num_iters] axis."""
    p, lanes, st = _one_lane(params, state, trace)
    per_round = []
    for i in range(int(num_iters)):
        st, rows = traffic_lane_round(p, lanes, tables, ttables, st,
                                      int(start_it) + i, detail)
        per_round.append(rows)
    return (TrafficState(*(x[0] for x in st)),
            {name: v[:, 0] for name, v in stack_rows(per_round).items()})


def broadcast_traffic_state(state: TrafficState,
                            lanes: int) -> TrafficState:
    """One TrafficState as ``lanes`` identical lanes ``[K, ...]``.  Each
    lane is a contiguous copy (the kernels refuse an ``expand`` view); the
    lanes of a traffic sweep start from the state a serial point would
    (``init_traffic_state`` reads only shapes and the seed)."""
    return TrafficState(*(x.unsqueeze(0).repeat((lanes,) + (1,) * x.dim())
                          for x in state))


def traffic_lane_state(states: TrafficState, lane: int) -> TrafficState:
    """One lane's TrafficState out of a ``[K, ...]`` batch."""
    return TrafficState(*(x[lane] for x in states))


def run_traffic_lanes(static: EngineStatic, tables: ClusterTables,
                      ttables: TrafficTables, lane_state: TrafficState,
                      lane_knobs: EngineKnobs, num_iters: int,
                      start_it: int = 0, detail: bool = False):
    """A lane-batched traffic sweep: K stacked knob vectors
    (``lanes.stack_knobs``; the static is ``merge_lane_statics`` of the
    lanes') over a ``[K, ...]`` stack of states
    (:func:`broadcast_traffic_state`), ``num_iters`` rounds from
    ``start_it``.  Returns (states ``[K, ...]``, rows ``[num_iters, K,
    ...]``); a lane equals a serial :func:`run_traffic_rounds` with its
    knobs, and the reference's lane.  Each round of up to
    :data:`~..kernels._lanes.MAX_LANES` lanes is one round body
    (:func:`traffic_lane_round`), each kernel one launch with the lane in
    its grid; more lanes run in groups of at most that many."""
    k = num_lanes(lane_knobs)
    _check_traffic(static)
    check_lane_knobs(static, [EngineKnobs(*(np.asarray(v)[j]
                                            for v in lane_knobs))
                              for j in range(k)])
    if lane_state.active.shape[0] != k:
        raise ValueError(f"states carry {lane_state.active.shape[0]} lanes, "
                         f"knobs {k}")
    parts = []
    for g, w in lane_groups(k):
        lanes = TrafficLanes(EngineKnobs(*(np.asarray(v)[g:g + w]
                                           for v in lane_knobs)),
                             lane_state.active.device)
        st = TrafficState(*(x[g:g + w] for x in lane_state))
        per_round = []
        for i in range(int(num_iters)):
            st, rows = traffic_lane_round(static, lanes, tables, ttables, st,
                                          int(start_it) + i, detail)
            per_round.append(rows)
        parts.append((st, stack_rows(per_round)))
    if len(parts) == 1:
        return parts[0]
    return cat_lanes(parts, TrafficState)
