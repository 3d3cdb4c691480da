"""The five-verb gossip round on PyTorch tensors (dense and sparse layouts).

The port of the reference engine's ``engine/core.py``: same state layout,
same per-round semantics, and bit-exact results under the same stakes, seed
and knobs.  The round's blocks run through the hand-written kernels of
:mod:`gossip_sim_tpu_torch.kernels` (CUDA tensors) or their plain versions
(CPU tensors):

* verb 1 push targets with the fault gates and the
  packet-loss hash (gossip.rs:494-615)            -> ``push_targets``
* BFS frontier relaxation (gossip.rs:494-615)     -> ``bfs_relax``
* inbound ranking, verb 2 (gossip.rs:618-653)     -> ``rank_inbound``
* received-cache merge + prune decide, verb 3
  (received_cache.rs:38-131)                      -> ``rc_merge_prune``
* prune application, verb 4
  (push_active_set.rs:56-71)                      -> ``prune_apply``
* rotation with its stake-weighted sampler, verb 5
  (gossip.rs:739-754; push_active_set.rs:153-186), and its draws: the
  round key, its sub keys and the uniforms        -> ``rotate``
* the pull (anti-entropy) phase of the pull, push-pull and adaptive
  modes (pull.py): peer draw, request gates and
  cap, responses, rescue hop                      -> ``pull_exchange``

An unimpaired, churn, loss or partition round makes no other draw.  The
other threefry draws go to the ``threefry`` kernel (``rng``):
``init_state``'s keys and uniforms, and in the fail round the round key,
its sub keys and sub key 0's uniforms.  What stays plain PyTorch is
elementwise or a reduction: the fault events, the round statistics and
``init_state``'s draw loop.  The reference's
sort-join ``_lookup`` computes exactly ``table[queries]`` and is a gather
here.

Float rows follow the reference's type promotion with 64-bit types on:
``hop_mean``/``hop_median`` divide int64 sums in float64 and cast to
float32, while ``coverage``/``rmr``/``branching`` divide int32 counts in
float32.  Entry points run on ``cuda``
unless the CPU is asked for; with no GPU and no CPU request they raise.

``EngineParams.representation`` picks the round's layout.  ``"dense"``
carries the received cache's four ``[O, N, C]`` planes.  ``"sparse"`` (push
mode without traffic) carries ``rc_shi``/``rc_slo`` at zero width,
``[O, N, 0]``, and ``rc_merge_prune`` reads each member's stake from
``tables.shi``/``tables.slo`` at its ``rc_src`` (index N, the pad, is 0 as
on an empty dense slot).  Every other step is the same in both layouts,
so rows and the other state fields are bit for bit the dense round's.
The reference's ``gossip_sim_tpu/engine/sparse.py`` has no module here:
its ``bfs_reach`` computes what the ``bfs_relax`` kernel does, its
``rank_inbound`` what the ``rank_inbound`` kernel does, and its direct
table gathers (the tfail rebuild, the rotation's candidate translation
and failed-peer lookup) are what this module's ``_lookup_rows`` and the
``rotate`` kernel already do in both layouts.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels as K
from .. import rng
from ..adaptive import switch_update_arr
from ..faults import (SALT_CHURN, SALT_EDGE, node_u32_t, partition_active,
                      rate_threshold, round_basis, stake_bipartition)
from ..identity import stake_buckets_array
from ..kernels.pull_exchange import COUNT_NAMES as PULL_COUNT_NAMES
from ..pull import (SALT_PULL_BLOOM, SALT_PULL_CLASS, SALT_PULL_LOSS,
                    SALT_PULL_MEMBER)
from .params import EngineParams
from .sampler import SamplerTables, build_sampler_tables, sample_members

INF = 1 << 20          # unreached sentinel (maps to u64::MAX, gossip.rs:490)
MAX_NODES_I32 = 32767  # past it the inbound keys' bounds are checked
MAX_NODES = 1 << 24    # inbound keys hop << pb | src stay in int32
INIT_SALT = 0x696E6974  # domain separation of the init draw stream


def _pack_base(num_nodes: int) -> int:
    """Smallest power of two >= N, floored at 16384 (the reference's node-id
    packing base for the inbound sort keys)."""
    return 1 << max(14, (num_nodes - 1).bit_length())


def resolve_device(device=None) -> torch.device:
    """The engine's device: ``cuda`` unless ``device`` says otherwise.
    Raises when CUDA is asked for (or defaulted to) and none is present —
    the engine never falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the engine runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' (CLI: --device cpu) to run on the "
            "CPU")
    return dev


class ClusterTables(NamedTuple):
    """Static per-cluster tables (tensors on the engine device)."""

    stakes: torch.Tensor     # [N + 1] i64 lamports; index N is a 0 pad
    buckets: torch.Tensor    # [N] i32 log2 stake buckets
    sampler: SamplerTables
    shi: torch.Tensor        # [N + 1] i32 stake >> 31
    slo: torch.Tensor        # [N + 1] i32 stake & 0x7fffffff
    side: torch.Tensor       # [N + 1] i32 stake-bipartition side (faults.py)
    stake_decile: torch.Tensor  # [N] i32 stake-rank decile, 0 = lowest


class SimState(NamedTuple):
    """O batched independent single-origin simulations."""

    key: torch.Tensor          # [O, 2] i64 per-origin threefry key (u32 words)
    active: torch.Tensor       # [O, N, S] i32 peer per slot, oldest->newest
    pruned: torch.Tensor       # [O, N, S] bool peer-has-pruned-this-origin bit
    tfail: torch.Tensor        # [O, N, S] bool peer-is-failed bit
    rc_src: torch.Tensor       # [O, N, C] i32 received-cache peers, N = empty
    rc_score: torch.Tensor     # [O, N, C] i32 per-peer scores
    rc_shi: torch.Tensor       # [O, N, C] i32 member stake >> 31
                               # ([O, N, 0] in the sparse layout)
    rc_slo: torch.Tensor       # [O, N, C] i32 member stake & 0x7fffffff
                               # ([O, N, 0] in the sparse layout)
    rc_upserts: torch.Tensor   # [O, N] i32 upsert counter
    failed: torch.Tensor       # [O, N] bool fault-injection mask
    egress_acc: torch.Tensor   # [O, N] i32 measured-round egress counts
    ingress_acc: torch.Tensor  # [O, N] i32 measured-round ingress counts
    prune_acc: torch.Tensor    # [O, N] i32 measured-round prunes sent
    stranded_acc: torch.Tensor  # [O, N] i32 measured rounds stranded
    hops_hist_acc: torch.Tensor  # [O, H] i32 aggregate hop histogram
    pull_hops_hist_acc: torch.Tensor  # [O, H] i32 pull-sourced hop histogram
    pull_rescued_acc: torch.Tensor    # [O, N] i32 measured rounds each node
                                      # was rescued by a pull response
    health_prune_recv: torch.Tensor   # [O, N] i32 (health gate; zeros here)
    health_first_round: torch.Tensor  # [O, N] i32 (health gate; zeros here)
    adaptive_pull_on: torch.Tensor    # [O] bool: the pull phase runs this
                                      # round (adaptive mode; else False)


def make_cluster_tables(stakes_lamports: np.ndarray,
                        device="cuda") -> ClusterTables:
    """Build the static tables from the per-node stake vector."""
    dev = resolve_device(device)
    stakes = np.asarray(stakes_lamports, dtype=np.int64)
    if stakes.shape[0] > MAX_NODES:
        raise ValueError(f"num_nodes must be <= {MAX_NODES}, got "
                         f"{stakes.shape[0]}")
    if not ((stakes >= 0).all() and (stakes < (1 << 62)).all()):
        raise ValueError("stakes must be in [0, 2^62)")
    buckets = stake_buckets_array(stakes.astype(np.uint64)).astype(np.int32)
    padded = np.concatenate([stakes, [0]])
    side = np.concatenate([stake_bipartition(stakes),
                           [False]]).astype(np.int32)
    n = stakes.shape[0]
    order = np.argsort(stakes, kind="stable")
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n, dtype=np.int64)
    stake_decile = (rank * 10 // n).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=dev)
    return ClusterTables(
        stakes=t(padded), buckets=t(buckets),
        sampler=build_sampler_tables(buckets, dev),
        shi=t((padded >> 31).astype(np.int32)),
        slo=t((padded & 0x7FFFFFFF).astype(np.int32)),
        side=t(side), stake_decile=t(stake_decile))


def _lookup_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[o, idx[o, ...]]`` per origin row: the reference's sort-join
    ``_lookup`` (a query past the table reads its last entry)."""
    O = table.shape[0]
    n = table.shape[1]
    flat = idx.reshape(O, -1).clamp(max=n - 1).long()
    return table.gather(1, flat).reshape(idx.shape)


# --------------------------------------------------------------------------
# initialization
# --------------------------------------------------------------------------

def init_state(key: torch.Tensor, tables: ClusterTables,
               origins: torch.Tensor, params: EngineParams) -> SimState:
    """Build O fresh single-origin sims with rotated-in active sets.

    Mirrors ``initialize_gossip`` (gossip_main.rs:263-277 ->
    gossip.rs:805-813): rotating an empty entry inserts weighted-distinct
    peers until the entry exceeds ``size`` and then evicts the oldest
    (push_active_set.rs:165-185).  ``key`` is a [2] threefry key
    (:func:`rng.prng_key`)."""
    p = params.validate()
    N, S, E = p.num_nodes, p.active_set_size, p.init_draws
    dev = tables.stakes.device
    origins = origins.to(device=dev, dtype=torch.int32)
    O = int(origins.shape[0])
    key = key.to(dev)

    okeys = rng.fold_in(key[None, :].expand(O, 2), origins)
    draw_keys = rng.fold_in(okeys, INIT_SALT)
    self_idx = torch.arange(N, device=dev, dtype=torch.int32)[None, :]
    perm = tables.sampler.perm
    slots = torch.arange(S + 1, device=dev)
    buf = torch.full((O, N, S + 1), N, dtype=torch.int32, device=dev)
    cnt = torch.zeros((O, N), dtype=torch.int32, device=dev)
    for e in range(E):
        u = rng.uniform(rng.fold_in(draw_keys, e), (N, 2))       # [O, N, 2]
        member = sample_members(tables.sampler, tables.buckets, origins,
                                u[..., 0:1], u[..., 1:2])[..., 0]
        cand = perm[member.clamp(max=N - 1).long()]
        dup = (buf == cand[..., None]).any(-1) | (cand == self_idx)
        ins = ~dup & (cnt <= S)
        slot = torch.clamp(cnt, max=S)
        oh = (slots[None, None, :] == slot[..., None]) & ins[..., None]
        buf = torch.where(oh, cand[..., None], buf)
        cnt = cnt + ins.to(torch.int32)
    # Evict the oldest iff the entry overfilled (push_active_set.rs:182-185).
    active = torch.where((cnt > S)[..., None], buf[..., 1:], buf[..., :S])

    C, H = p.rc_slots, p.hist_bins
    # the sparse layout derives the member stakes from the cluster tables,
    # so its stake planes are zero-width (same fields in both layouts)
    Cs = 0 if p.representation == "sparse" else C
    zi = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    zb = lambda *shape: torch.zeros(shape, dtype=torch.bool, device=dev)
    return SimState(
        key=okeys, active=active.contiguous(), pruned=zb(O, N, S),
        tfail=zb(O, N, S),
        rc_src=torch.full((O, N, C), N, dtype=torch.int32, device=dev),
        rc_score=zi(O, N, C), rc_shi=zi(O, N, Cs), rc_slo=zi(O, N, Cs),
        rc_upserts=zi(O, N), failed=zb(O, N), egress_acc=zi(O, N),
        ingress_acc=zi(O, N), prune_acc=zi(O, N), stranded_acc=zi(O, N),
        hops_hist_acc=zi(O, H), pull_hops_hist_acc=zi(O, H),
        pull_rescued_acc=zi(O, N), health_prune_recv=zi(O, N),
        health_first_round=zi(O, N), adaptive_pull_on=zb(O))


# --------------------------------------------------------------------------
# the round
# --------------------------------------------------------------------------

def _check_key_bounds(N: int, H: int, Kin: int) -> None:
    """The reference's bounds on the int32 inbound keys past
    ``MAX_NODES_I32`` nodes (gossip_sim_tpu/engine/core.py:487-499), with
    its wording: ``hop1 << pb | src`` and the compaction keys must fit."""
    if N <= MAX_NODES_I32:
        return
    pack = _pack_base(N)
    pb = pack.bit_length() - 1
    if H * pack >= (1 << 31):
        raise ValueError(
            f"inbound sort keys (hop << {pb} | src) overflow i32: "
            f"hist_bins * pack = {H * pack} >= 2^31; reduce hist_bins "
            f"(< {(1 << 31) // pack}) for num_nodes={N}")
    if 2 * N * Kin >= (1 << 31):
        raise ValueError(
            f"inbound compaction keys overflow i32: 2*N*K = "
            f"{2 * N * Kin} >= 2^31; reduce inbound_cap for "
            f"num_nodes={N}")


def round_step(params: EngineParams, tables: ClusterTables,
               origins: torch.Tensor, state: SimState, it: int,
               detail: bool = False, edge_detail: bool = False,
               trace: bool = False):
    """One full gossip round for all O origin-sims at iteration ``it`` (a
    host int).  Returns (state, rows); ``detail`` adds the per-node rows,
    ``edge_detail`` the per-edge targets and hops [O, N, F] (-1 where no
    message was delivered).  Before it reads the state it refuses the
    flight recorder and node-health planes (``NotImplementedError`` naming
    their ROADMAP items), sparse with a pull mode or traffic
    (``ValueError``) and inbound keys past int32; then a state whose stake
    planes are not the representation's width (``ValueError``)."""
    if trace:
        raise NotImplementedError(
            "the flight recorder (trace=True) is not ported yet (ROADMAP A13)")
    p, kn = params.validate().split()
    N, S, F, C, Kin, H = (p.num_nodes, p.active_set_size, p.push_fanout,
                          p.rc_slots, p.k_inbound, p.hist_bins)
    _check_key_bounds(N, H, Kin)
    for name in ("rc_shi", "rc_slo"):
        width = getattr(state, name).shape[-1]
        if width != p.stake_slots:
            raise ValueError(
                f"representation={p.representation!r} carries {name} "
                f"{p.stake_slots} wide, but the state's {name} is {width} "
                f"wide: build the state with init_state under the same "
                f"representation")
    F = min(F, S)
    pb = _pack_base(N).bit_length() - 1
    it = int(it)
    dev = state.active.device
    origins = origins.to(device=dev, dtype=torch.int32)
    O = int(origins.shape[0])
    i32 = torch.int32

    # ---- fault injection (gossip.rs:756-771; fires at it == when_to_fail)
    failed, tfail = state.failed, state.tfail
    if p.has_fail:
        # truncating, like the reference's `as usize` (gossip.rs:758); the
        # f64 product matches the host double arithmetic bit for bit
        n_fail = int(np.floor(np.float64(kn.fail_fraction) * N))
        if it == int(kn.fail_at) and n_fail > 0:
            # sub key 0 of the round key (rotate draws from keys 1 .. T + 1)
            kr = rng.fold_in(state.key, it)
            subs = rng.split(kr, p.rot_tries + 2)                 # [O, T+2, 2]
            r = rng.uniform(subs[:, 0], (N,))
            kidx = min(max(n_fail - 1, 0), N - 1)
            kth = torch.sort(r, dim=-1).values[:, kidx:kidx + 1]
            failed = failed | (r <= kth)
            tfail = _lookup_rows(failed, state.active) & (state.active < N)

    # ---- continuous churn (faults.py): one hash per (iteration, node)
    if p.has_churn:
        basis_c = round_basis(int(kn.impair_seed), it, SALT_CHURN)
        hu = node_u32_t(basis_c, torch.arange(N, device=dev))
        fail_ev = hu < rate_threshold(float(kn.churn_fail_rate))
        rec_ev = hu < rate_threshold(float(kn.churn_recover_rate))
        failed = torch.where(failed, ~rec_ev[None, :], fail_ev[None, :])
        tfail = _lookup_rows(failed, state.active) & (state.active < N)

    # ---- verb 1: push targets (kernel; gossip.rs:494-615) ---------------
    peer = state.active
    partition = (partition_active(it, int(kn.partition_at), int(kn.heal_at))
                 if p.has_partition else None)
    loss = ((round_basis(int(kn.impair_seed), it, SALT_EDGE),
             rate_threshold(float(kn.packet_loss_rate)))
            if p.has_loss else None)
    # pull-only mode sends no push; the push machinery still runs on the
    # empty edge set (BFS, verbs 2-4 and rotation, which moves the state)
    tgt, sup_mask, drop_mask = K.push_targets(
        peer, state.pruned, tfail, origins, tables.side, F, partition, loss,
        push_on=p.has_push)

    # ---- BFS frontier relaxation (kernel) --------------------------------
    reached, dist = K.bfs_relax(tgt, origins)

    # ---- delivered edges + verb 2: consume (gossip.rs:618-653) -----------
    delivered = (tgt < N) & reached[:, :, None]                   # [O, N, F]
    deg_out = delivered.sum(-1, dtype=i32)                        # egress
    m_push = deg_out.sum(-1, dtype=i32)                           # [O]
    n_reached = reached.sum(-1, dtype=i32)                        # [O]
    zero_o = torch.zeros((O,), dtype=i32, device=dev)
    dropped_cnt = ((drop_mask & reached[:, :, None]).sum((1, 2), dtype=i32)
                   if drop_mask is not None else zero_o)
    suppressed_cnt = ((sup_mask & reached[:, :, None]).sum((1, 2), dtype=i32)
                      if sup_mask is not None else zero_o)
    hop1 = torch.clamp(dist + 1, max=H - 1).to(i32)               # per src
    inb, ingress_round, inb_dropped = K.rank_inbound(
        tgt, delivered.contiguous(), hop1, pb, Kin)

    # ---- received-cache merge + verb 3 prune decide (kernel); the sparse
    # layout passes no stake planes and the kernel reads tables.shi/slo ----
    planes = ((None, None) if p.representation == "sparse"
              else (state.rc_shi, state.rc_slo))
    mp = K.rc_merge_prune(
        state.rc_src, state.rc_score, *planes,
        state.rc_upserts, inb, tables.shi, tables.slo, tables.stakes,
        origins, received_cap=p.received_cap,
        min_num_upserts=p.min_num_upserts,
        min_ingress_nodes=int(kn.min_ingress_nodes),
        prune_stake_threshold=float(kn.prune_stake_threshold))
    n_pruned = mp.n_pruned
    m_prunes = n_pruned.sum(-1, dtype=i32)                        # [O]

    # ---- verb 4: prune apply (kernel) ------------------------------------
    pruned_bits = K.prune_apply(state.pruned, peer, mp.src_sorted,
                                mp.pruned_slot)

    # ---- verb 5: rotate (kernel; gossip.rs:739-754;
    # push_active_set.rs:153-186), drawing its uniforms from sub keys
    # 1 .. T + 1 of the round key fold_in(key, it) itself ------------------
    sm = tables.sampler
    new_active, new_pruned, new_tfail, rot_failed = K.rotate(
        peer, pruned_bits, tfail, failed, state.key, it, origins,
        tables.buckets, sm.perm, sm.class_start, sm.class_count,
        sm.class_cdf, float(np.float32(kn.probability_of_rotation)),
        p.rot_tries, rng.partitionable())

    # ---- pull phase (kernel; pull.py): one request/response exchange
    # against this round's push outcome, every decision a counter hash ----
    if p.has_pull:
        seed = int(kn.impair_seed)
        basis = lambda salt: round_basis(seed, it, salt)
        pull = K.pull_exchange(
            reached, dist, failed, tables.side, sm.perm, sm.class_start,
            sm.class_count, sm.class_cdf[-1],
            state.adaptive_pull_on if p.has_adaptive else None,
            fanout=int(kn.pull_fanout), slots=p.pull_slots,
            pull_on=it % int(kn.pull_interval) == 0,
            bases=(basis(SALT_PULL_CLASS), basis(SALT_PULL_MEMBER),
                   basis(SALT_PULL_BLOOM)),
            bloom_threshold=rate_threshold(float(kn.pull_bloom_fp_rate)),
            cap=int(kn.pull_request_cap), partition=partition,
            loss=((basis(SALT_PULL_LOSS),
                   rate_threshold(float(kn.packet_loss_rate)))
                  if p.has_loss else None))
        # the delivery view of the stats (push BFS plus the pull rescues)
        # comes from the kernel
        reached_all, dist_all = pull.reached_all, pull.dist_all
        pull_got = pull.pull_hop < INF
    else:
        reached_all, dist_all = reached, dist

    # ---- statistics (gossip_stats.rs) -------------------------------------
    # coverage, hops and stranded count pull rescues; m, n, rmr and
    # branching keep their push semantics
    f64 = torch.float64
    hbin = torch.where(reached_all, torch.clamp(dist_all, max=H - 1),
                       H).long()
    hr = torch.zeros((O, H + 1), dtype=i32, device=dev)
    hr.scatter_add_(1, hbin, torch.ones_like(hbin, dtype=i32))
    hr = hr[:, :H].contiguous()                                   # [O, H]
    pos_counts = hr.clone()
    pos_counts[:, 0] = 0                 # HopsStat filters origin's 0 hops
    cnt = pos_counts.sum(-1)
    hsum = (pos_counts.long() * torch.arange(H, device=dev)).sum(-1)
    hop_mean = torch.where(cnt > 0, hsum.to(f64) / cnt.clamp(min=1).to(f64),
                           torch.nan)
    csum = torch.cumsum(pos_counts[:, 1:], -1)                    # [O, H-1]
    lo_i = torch.div(cnt - 1, 2, rounding_mode="floor")
    hi_i = torch.div(cnt, 2, rounding_mode="floor")
    val_of = lambda i: 1 + (csum <= i[:, None]).sum(-1)
    hop_median = torch.where(cnt > 0, (val_of(lo_i) + val_of(hi_i)).to(f64)
                             / 2.0, 0.0)
    pos = reached_all & (dist_all > 0)
    hop_max = torch.where(pos, dist_all, 0).amax(-1)
    hop_min = torch.where(cnt > 0, torch.where(pos, dist_all, INF).amin(-1),
                          0)

    stranded = ~reached_all & ~failed
    stranded_cnt = stranded.sum(-1, dtype=i32)
    n_reached_all = (reached_all.sum(-1, dtype=i32) if p.has_pull
                     else n_reached)
    m_total = m_push + m_prunes
    nn = n_reached
    # int32 / int32 divides in float32 in the reference (its float64 rows
    # come from int64 sums: hop_mean, hop_median)
    f32 = torch.float32
    rmr = torch.where(nn > 1, m_total.to(f32) / (nn - 1).clamp(min=1).to(f32)
                      - 1.0, 0.0)
    branching = m_push.to(f32) / nn.clamp(min=1).to(f32)

    g = 1 if it >= int(kn.warm_up_rounds) else 0
    egress_round, ingress_all = deg_out, ingress_round
    new_pull_hist = state.pull_hops_hist_acc
    new_pull_rescued = state.pull_rescued_acc
    if p.has_pull:
        # pull messages join the push deliveries' ingress and egress; the
        # pull-tagged accumulators keep the pull-sourced slice apart
        egress_round = deg_out + pull.egress
        ingress_all = ingress_round + pull.ingress
        pbin = torch.where(pull_got, torch.clamp(pull.pull_hop, max=H - 1),
                           H).long()
        hr_pull = torch.zeros((O, H + 1), dtype=i32, device=dev)
        hr_pull.scatter_add_(1, pbin, torch.ones_like(pbin, dtype=i32))
        new_pull_hist = state.pull_hops_hist_acc + g * hr_pull[:, :H]
        new_pull_rescued = state.pull_rescued_acc + g * pull_got.to(i32)
    new_adapt = state.adaptive_pull_on
    if p.has_adaptive:
        # re-decided from THIS round's push coverage (adaptive.py)
        new_adapt = switch_update_arr(
            n_reached, N, state.adaptive_pull_on,
            kn.adaptive_switch_threshold, kn.adaptive_switch_hysteresis)
    new_state = SimState(
        key=state.key, active=new_active, pruned=new_pruned,
        tfail=new_tfail,
        rc_src=mp.rc_src, rc_score=mp.rc_score, rc_shi=mp.rc_shi,
        rc_slo=mp.rc_slo, rc_upserts=mp.rc_upserts, failed=failed,
        egress_acc=state.egress_acc + g * egress_round,
        ingress_acc=state.ingress_acc + g * ingress_all,
        prune_acc=state.prune_acc + g * n_pruned,
        stranded_acc=state.stranded_acc + g * stranded.to(i32),
        hops_hist_acc=state.hops_hist_acc + g * hr,
        pull_hops_hist_acc=new_pull_hist,
        pull_rescued_acc=new_pull_rescued,
        health_prune_recv=state.health_prune_recv,
        health_first_round=state.health_first_round,
        adaptive_pull_on=new_adapt)
    rows = {
        # the reference's compiled round divides by the constant N as a
        # multiply by its float32 reciprocal
        "coverage": (n_reached_all.to(f32)
                     * float(np.float32(1) / np.float32(N))),
        "unvisited": (N - n_reached_all).to(i32),
        "m": m_total,
        "n": nn,
        "rmr": rmr,
        "hop_mean": hop_mean.to(torch.float32),
        "hop_median": hop_median.to(torch.float32),
        "hop_max": hop_max.to(i32),
        "hop_min": hop_min.to(i32),
        "stranded": stranded_cnt,
        "branching": branching,
        "prunes_sent": m_prunes,
        "inb_dropped": inb_dropped,
        "rc_overflow": mp.rc_overflow,
        "rot_failed": rot_failed,
        "delivered": m_push,
        "dropped": dropped_cnt,
        "suppressed": suppressed_cnt,
        "failed_count": failed.sum(-1, dtype=i32),
        # nodes whose hop distance exceeds the last histogram bin
        "hop_clamped": (reached_all & (dist_all >= H)).sum(-1, dtype=i32),
    }
    if p.has_pull:
        rows.update(zip(PULL_COUNT_NAMES, pull.counts.unbind(1)))
    if p.has_adaptive:
        # the bit in effect this round, and whether this round flipped it
        rows["adaptive_pull_active"] = state.adaptive_pull_on
        rows["adaptive_switched"] = new_adapt != state.adaptive_pull_on
    if detail:
        rows["stranded_mask"] = stranded
        # the push distance; pull_hop is the pull-sourced one (-1 = none)
        rows["dist"] = torch.where(reached, dist, -1).to(i32)
        rows["failed_mask"] = failed
        if p.has_pull:
            rows["pull_hop"] = torch.where(pull_got, pull.pull_hop, -1)
    if edge_detail:
        # the per-edge hop matrix (the reference's orders dump,
        # gossip.rs:374-390): edge src -> tgt delivered at hop dist[src] + 1
        rows["push_targets"] = torch.where(delivered, tgt, -1)
        rows["edge_hops"] = torch.where(delivered, hop1[:, :, None], -1)
    return new_state, rows


# --------------------------------------------------------------------------
# multi-round runner
# --------------------------------------------------------------------------

def run_rounds(params: EngineParams, tables: ClusterTables,
               origins: torch.Tensor, state: SimState, num_iters: int,
               start_it: int = 0, detail: bool = False,
               edge_detail: bool = False, trace: bool = False):
    """Run ``num_iters`` rounds from iteration ``start_it``.  Returns
    (state, rows) with every row stacked on a leading [num_iters] axis."""
    per_round = []
    for i in range(int(num_iters)):
        state, rows = round_step(params, tables, origins, state,
                                 int(start_it) + i, detail=detail,
                                 edge_detail=edge_detail, trace=trace)
        per_round.append(rows)
    if not per_round:
        return state, {}
    return state, {k: torch.stack([r[k] for r in per_round])
                   for k in per_round[0]}
