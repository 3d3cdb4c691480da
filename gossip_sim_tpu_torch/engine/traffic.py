"""The concurrent-traffic round on PyTorch tensors (push mode).

The port of the reference engine's ``engine/traffic.py``: an M-slot value
axis whose in-flight values all push through ONE shared [N, S] active set
(one rotation schedule, one churn mask), with per-value prune bits and
received-cache scoring and per-node queue caps, one hop per round.  Same
state layout, same per-round semantics and bit-exact results under the
same stakes, seed and knobs.  The round's blocks, in order:

* churn (faults.py hashes)                           plain PyTorch
* inject: stake-weighted origins into free slots     plain PyTorch
* candidates + egress budget + fault gates
  (traffic.py:255-314)                               -> ``traffic_send``
* ingress budget (traffic.py:316-342)                -> ``traffic_admit``
* consume: inbound ranking per (value, target)
  (traffic.py:344-417)                               -> ``rank_inbound``
* received-cache merge + prune decide, rows firing
  only while their value is live (traffic.py:621-709) -> ``rc_merge_prune``
* prune apply on the shared edges (traffic.py:711-755) -> ``prune_apply``
* the shared hash-driven rotation, retire and the
  round stats (traffic.py:757-1000)                  plain PyTorch

``trace=True`` (the flight recorder, ROADMAP A13), the adaptive pull rescue
(A11b) and the health planes (A12) are not ported: the health planes stay
zero.  Entry points run on ``cuda`` unless the CPU is asked for.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels as K
from ..faults import (SALT_CHURN, edge_u32_t, node_u32_t, partition_active,
                      rate_threshold, round_basis)
from ..traffic import (SALT_TRAFFIC_LOSS, SALT_TRAFFIC_OCLASS,
                       SALT_TRAFFIC_OMEMBER, SALT_TRAFFIC_RCLASS,
                       SALT_TRAFFIC_RMEMBER, SALT_TRAFFIC_ROT, TRAFFIC_ACCEPTED,
                       TRAFFIC_DEFERRED, TRAFFIC_DROPPED,
                       TRAFFIC_FAILED_TARGET, TRAFFIC_SUPPRESSED,
                       TrafficTables, build_shared_active_set, class_draw_t,
                       traffic_tables, u01_t)
from .core import ClusterTables, _check_key_bounds, _pack_base, resolve_device
from .params import EngineParams


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
    v_pull: torch.Tensor       # [V] bool (adaptive: A11b; False here)
    v_rescued: torch.Tensor    # [V] i32 (adaptive: A11b; 0 here)
    v_qdrop: torch.Tensor      # [V] i32 ingress queue drops that hit it
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
    """``x`` with the value slots of ``mask`` [V] set to ``value``."""
    return torch.where(mask.reshape((-1,) + (1,) * (x.dim() - 1)), value, x)


def traffic_round_step(params: EngineParams, tables: ClusterTables,
                       ttables: TrafficTables, state: TrafficState, it: int,
                       detail: bool = False, trace: bool = False):
    """One traffic round for all V value slots at iteration ``it`` (a host
    int).  Returns (state, rows); ``detail`` adds the per-value and
    per-node rows."""
    if trace:
        raise NotImplementedError(
            "the flight recorder (trace=True) is not ported yet (ROADMAP A13)")
    p, kn = params.validate().split()
    if p.traffic_slots <= 0:
        raise ValueError("traffic_round_step requires traffic_slots > 0")
    N, S, C, Kin, H = (p.num_nodes, p.active_set_size, p.rc_slots,
                       p.k_inbound, p.hist_bins)
    _check_key_bounds(N, H, Kin)
    V = p.traffic_slots
    F = min(p.push_fanout, S)
    pb = _pack_base(N).bit_length() - 1
    it = int(it)
    seed = int(kn.impair_seed)
    dev = state.active.device
    i32 = torch.int32
    iota_n = torch.arange(N, device=dev)
    basis = lambda salt: round_basis(seed, it, salt)

    # ---- churn (faults.py): one hash per (iteration, node) --------------
    failed = state.failed
    if p.has_churn:
        hu = node_u32_t(basis(SALT_CHURN), iota_n)
        fail_ev = hu < rate_threshold(float(kn.churn_fail_rate))
        rec_ev = hu < rate_threshold(float(kn.churn_recover_rate))
        failed = torch.where(failed, ~rec_ev, fail_ev)

    # ---- inject: R stake-weighted origins into ascending free slots -----
    rate = min(max(int(kn.traffic_rate), 0), V)
    free = ~state.v_live
    free_i = free.to(i32)
    freerank = torch.cumsum(free_i, 0, dtype=i32) - free_i
    n_inj = torch.clamp(free_i.sum(dtype=i32), max=rate)
    injd = rate - n_inj
    do_inj = free & (freerank < n_inj)
    origin_new = class_draw_t(ttables, basis(SALT_TRAFFIC_OCLASS),
                              basis(SALT_TRAFFIC_OMEMBER),
                              lambda b: node_u32_t(b, freerank))
    onehot_o = iota_n[None, :] == origin_new[:, None]             # [V, N]
    v_live = state.v_live | do_inj
    v_vid = torch.where(do_inj, state.next_vid + freerank, state.v_vid)
    v_origin = torch.where(do_inj, origin_new, state.v_origin)
    v_birth = _reset(do_inj, it, state.v_birth)
    v_holder = torch.where(do_inj[:, None], onehot_o, state.v_holder)
    v_hop = torch.where(do_inj[:, None],
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

    # ---- send (kernel): candidates on the shared set, egress budget,
    # failed target > partition > per-value loss ---------------------------
    active = state.active
    snd = K.traffic_send(
        active, pruned, failed, v_live, v_holder, v_origin, v_vid,
        tables.side, F, int(kn.node_egress_cap),
        partition=(partition_active(it, int(kn.partition_at),
                                    int(kn.heal_at))
                   if p.has_partition else None),
        loss=((basis(SALT_TRAFFIC_LOSS),
               rate_threshold(float(kn.packet_loss_rate)))
              if p.has_loss else None))
    code = snd.code

    # ---- admit (kernel): the ingress budget across the value axis ------
    icap = int(kn.node_ingress_cap)
    adm = K.traffic_admit(snd.cand_bits, snd.arr_bits, active, F, icap)
    accepted = adm.accepted
    arrived = code == TRAFFIC_ACCEPTED
    qdropped = arrived & ~accepted
    accepted_node = adm.accepted_node
    qdrop_node = adm.arrived_node - accepted_node

    # ---- consume (kernel): accepted inbound ranked per (value, target)
    # by (clamped hop, src); first deliveries --------------------------
    hop1 = torch.clamp(v_hop + 1, max=H - 1).to(i32)
    inb, ingress_mv, inb_dropped = K.rank_inbound(
        snd.peer, accepted, hop1, pb, Kin)
    first_src = inb[..., 0]
    has_inb = first_src < N
    src_hop = v_hop.gather(1, first_src.clamp(max=N - 1).long())
    first_hop = torch.clamp(src_hop + 1, max=H - 1)
    new_del = has_inb & ~v_holder                                 # [V, N]
    v_holder = v_holder | new_del
    v_hop = torch.where(new_del, first_hop, v_hop)
    hop_clamped = (new_del & (src_hop + 1 > H - 1)).sum(dtype=i32)
    delivered = new_del.sum(dtype=i32)
    accepted_total = accepted.sum(dtype=i32)
    v_qdrop = v_qdrop + qdropped.sum((1, 2), dtype=i32)

    # ---- received-cache merge + prune decide (kernel; rows of live
    # values fire, with the value's origin in place of the origin) -------
    mp = K.rc_merge_prune(
        rc_src, rc_score, rc_shi, rc_slo, rc_ups, inb, tables.shi,
        tables.slo, tables.stakes, v_origin, received_cap=p.received_cap,
        min_num_upserts=p.min_num_upserts,
        min_ingress_nodes=int(kn.min_ingress_nodes),
        prune_stake_threshold=float(kn.prune_stake_threshold), live=v_live)
    m_prunes = mp.n_pruned.sum(-1, dtype=i32)                     # [V]
    v_m = v_m + ingress_mv.sum(-1, dtype=i32) + m_prunes

    # ---- prune apply (kernel) on the shared edges --------------------
    pruned = K.prune_apply(pruned, active, mp.src_sorted, mp.pruned_slot)

    # ---- shared rotation: one hash-driven schedule ----------------------
    u_rot = u01_t(node_u32_t(basis(SALT_TRAFFIC_ROT), iota_n))
    rotate = u_rot < float(kn.probability_of_rotation)
    tries = torch.arange(p.rot_tries, device=dev)[None, :]
    cands = class_draw_t(ttables, basis(SALT_TRAFFIC_RCLASS),
                         basis(SALT_TRAFFIC_RMEMBER),
                         lambda b: edge_u32_t(b, iota_n[:, None], tries))
    chosen = torch.full((N,), N, dtype=i32, device=dev)
    found_new = torch.zeros((N,), dtype=torch.bool, device=dev)
    for t in range(p.rot_tries):
        cand = cands[:, t]
        ok = (cand != iota_n) & ~(active == cand[:, None]).any(-1)
        chosen = torch.where(ok & ~found_new, cand, chosen)
        found_new = found_new | ok
    do_rot = rotate & found_new
    cnt = (active < N).sum(-1, dtype=i32)
    full_row = cnt >= S
    shift_act = torch.cat([active[:, 1:], chosen[:, None]], -1)
    slot_oh = (torch.arange(S, device=dev)[None, :]
               == torch.clamp(cnt, max=S - 1)[:, None])
    append_act = torch.where(slot_oh & ~full_row[:, None], chosen[:, None],
                             active)
    new_active = torch.where(do_rot[:, None],
                             torch.where(full_row[:, None], shift_act,
                                         append_act), active)
    shift_prn = torch.cat([pruned[:, :, 1:],
                           torch.zeros_like(pruned[:, :, :1])], -1)
    pruned = torch.where((do_rot & full_row)[None, :, None], shift_prn,
                         pruned)

    # ---- retire: stall tracking, retirement, slot recycle ---------------
    progress = new_del.any(-1)
    v_stall = torch.where(~v_live, 0, torch.where(
        do_inj | progress, 0, state.v_stall + 1)).to(i32)
    holders = v_holder.sum(-1, dtype=i32)                         # [V]
    full_v = holders == N
    retire = v_live & (full_v | (v_stall >= int(kn.traffic_stall_rounds)))
    v_live_post = v_live & ~retire
    hops_sum = torch.where(v_holder, v_hop, 0).sum(-1, dtype=i32)

    # ---- round stats -----------------------------------------------------
    g = 1 if it >= int(kn.warm_up_rounds) else 0
    sent = (code != 0) & (code != TRAFFIC_DEFERRED)
    deferred = code == TRAFFIC_DEFERRED
    node_deferred = deferred.sum((0, 2), dtype=i32)               # [N] src
    sent_node = sent.sum((0, 2), dtype=i32)
    n_retired = retire.sum(dtype=i32)
    n_conv = (retire & full_v).sum(dtype=i32)
    new_state = TrafficState(
        active=new_active, failed=failed, next_vid=next_vid,
        v_live=v_live_post, v_vid=v_vid, v_origin=v_origin,
        v_birth=v_birth, v_stall=v_stall, v_holder=v_holder, v_hop=v_hop,
        v_m=v_m, pruned=pruned, rc_src=mp.rc_src, rc_score=mp.rc_score,
        rc_shi=mp.rc_shi, rc_slo=mp.rc_slo, rc_upserts=mp.rc_upserts,
        inj_acc=state.inj_acc + g * n_inj,
        injdrop_acc=state.injdrop_acc + g * injd,
        ret_acc=state.ret_acc + g * n_retired,
        conv_acc=state.conv_acc + g * n_conv,
        defer_acc=state.defer_acc + g * node_deferred,
        qdrop_acc=state.qdrop_acc + g * qdrop_node,
        sent_acc=state.sent_acc + g * sent_node,
        recv_acc=state.recv_acc + g * accepted_node,
        prune_acc=state.prune_acc + g * mp.n_pruned.sum(0, dtype=i32),
        v_pull=v_pull, v_rescued=v_rescued, v_qdrop=v_qdrop,
        health_prune_recv=state.health_prune_recv,
        health_lat_acc=state.health_lat_acc,
        health_del_acc=state.health_del_acc,
        health_rescued_acc=state.health_rescued_acc)
    count = lambda c: (code == c).sum(dtype=i32)
    rows = {
        "injected": n_inj,
        "inject_dropped": injd,
        "live": v_live_post.sum(dtype=i32),
        "sends": sent.sum(dtype=i32),
        "deferred": node_deferred.sum(dtype=i32),
        "failed_target": count(TRAFFIC_FAILED_TARGET),
        "suppressed": count(TRAFFIC_SUPPRESSED),
        "dropped": count(TRAFFIC_DROPPED),
        "arrived": arrived.sum(dtype=i32),
        "queue_dropped": qdropped.sum(dtype=i32),
        "accepted": accepted_total,
        "delivered": delivered,
        "redundant": accepted_total - delivered,
        "prunes_sent": m_prunes.sum(dtype=i32),
        "retired": n_retired,
        "converged": n_conv,
        "hop_clamped": hop_clamped,
        "qdepth_max": node_deferred.max(),
        "inflow_max": accepted_node.max(),
        "inb_dropped": inb_dropped.sum(dtype=i32),
        "rc_overflow": mp.rc_overflow.sum(dtype=i32),
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
    if detail:
        rows["live_mask"] = v_live_post
        rows["t_holder"] = v_holder
        rows["t_hop"] = torch.where(v_holder, v_hop, -1).to(i32)
        rows["node_deferred"] = node_deferred
        rows["node_queue_dropped"] = qdrop_node
        rows["node_sent"] = sent_node
        rows["node_recv"] = accepted_node
    return new_state, rows


def run_traffic_rounds(params: EngineParams, tables: ClusterTables,
                       ttables: TrafficTables, state: TrafficState,
                       num_iters: int, start_it: int = 0,
                       detail: bool = False, trace: bool = False):
    """Run ``num_iters`` traffic rounds from iteration ``start_it``.
    Returns (state, rows) with every row stacked on a leading
    [num_iters] axis."""
    per_round = []
    for i in range(int(num_iters)):
        state, rows = traffic_round_step(params, tables, ttables, state,
                                         int(start_it) + i, detail=detail,
                                         trace=trace)
        per_round.append(rows)
    if not per_round:
        return state, {}
    return state, {k: torch.stack([r[k] for r in per_round])
                   for k in per_round[0]}
