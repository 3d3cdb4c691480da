"""Concurrent CRDS traffic: the M-value message-stream model (the port's
copy of what the engine needs from the reference package's ``traffic.py``).

All in-flight values push through ONE shared [N, S] active set with one
rotation schedule and one churn mask; prune bits and received-cache scoring
stay per value, on the shared slots.  Round ``it`` injects ``traffic_rate``
new values at stake-weighted origins into the free slots of ``traffic_values``
(an injection with no free slot is dropped and counted).  A value advances
one hop per round: every holder pushes it to its first ``push_fanout`` valid
shared-set slots.  ``node_egress_cap`` bounds the messages a node sends per
round across all values (the excess is deferred), ``node_ingress_cap`` the
messages it accepts (the excess is dropped).  Per-slot precedence:

    egress-deferred > failed target > partition suppressed >
    packet loss > ingress-dropped > accepted

with egress ranked in (value, fanout slot) order per sender and ingress in
(value, source, fanout slot) order per receiver.  A value retires when every
node holds it, or after ``traffic_stall_rounds`` rounds without a new
delivery; its slot recycles.

Every stochastic choice is a stateless counter hash (faults.py): injection
origins, per-value packet loss (``value_basis``), the shared active set's
initialization and the shared rotation.  The ``*_t`` functions are the
vectorized draws on int64 tensors of u32 values, bit-equal to the
reference's numpy/JAX lanes; :func:`build_shared_active_set` runs them on
CPU tensors for ``engine.traffic.init_traffic_state``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .faults import (_GOLD, edge_u32_t, fmix32, fmix32_t, mul32_t,
                     round_basis)
from .pull import pull_class_tables

# domain-separation salts of the traffic hash streams (faults.py convention)
SALT_TRAFFIC_OCLASS = 0x52DCE729   # injection origin: stake-class uniform
SALT_TRAFFIC_OMEMBER = 0x1F83D9AB  # injection origin: within-class uniform
SALT_TRAFFIC_LOSS = 0x5BE0CD19     # per-(value, src, dst) packet loss
SALT_TRAFFIC_ROT = 0x428A2F98      # shared rotation: per-node event uniform
SALT_TRAFFIC_RCLASS = 0x71374491   # rotation candidate: class uniform
SALT_TRAFFIC_RMEMBER = 0xB5C0FBCF  # rotation candidate: member uniform
SALT_TRAFFIC_ICLASS = 0xE9B5DBA5   # shared-set init: class uniform
SALT_TRAFFIC_IMEMBER = 0x3956C25B  # shared-set init: member uniform

# per-candidate-slot outcome codes (0-4 are the flight recorder's TRACE_*
# codes; 5-6 the queue caps')
TRAFFIC_EMPTY = 0            # no candidate in this slot
TRAFFIC_ACCEPTED = 1         # arrived and accepted
TRAFFIC_FAILED_TARGET = 2    # sent into a churn-failed target
TRAFFIC_SUPPRESSED = 3       # partition-suppressed
TRAFFIC_DROPPED = 4          # lost to packet loss
TRAFFIC_DEFERRED = 5         # sender's node_egress_cap exhausted (queued)
TRAFFIC_QUEUE_DROPPED = 6    # receiver's node_ingress_cap exhausted
TRAFFIC_CODE_NAMES = {
    TRAFFIC_EMPTY: "empty",
    TRAFFIC_ACCEPTED: "accepted",
    TRAFFIC_FAILED_TARGET: "failed_target",
    TRAFFIC_SUPPRESSED: "suppressed",
    TRAFFIC_DROPPED: "dropped",
    TRAFFIC_DEFERRED: "deferred",
    TRAFFIC_QUEUE_DROPPED: "queue_dropped",
}

_M32 = 0xFFFFFFFF


def value_basis(basis: int, vid: int) -> int:
    """Decorrelate a per-round hash basis per value id (scalar path), so
    two values crossing one edge in one round draw independent loss
    coins."""
    return fmix32((basis ^ ((vid * _GOLD) & _M32)) & _M32)


def value_basis_t(basis: int, vid: torch.Tensor) -> torch.Tensor:
    """``value_basis`` over a tensor of value ids (int64 u32 lanes out)."""
    return fmix32_t(basis ^ mul32_t(vid.long() & _M32, _GOLD))


def u01_t(h: torch.Tensor) -> torch.Tensor:
    """u32 hashes (int64 lanes) -> f32 uniforms ``(h >> 8) * 2^-24``, exact
    (24 bits fit the f32 mantissa)."""
    return (h >> 8).to(torch.float32) * (2.0 ** -24)


class TrafficTables(NamedTuple):
    """Stake-class sampling tables of every traffic draw: the pull
    subsystem's top-entry class CDF (weights ``(bucket + 1)^2``)."""

    perm: object         # [N] i32 node ids sorted by bucket (stable)
    class_start: object  # [NB] i32
    class_count: object  # [NB] i32
    cdf: object          # [NB] f32 inclusive CDF, cdf[-1] == 1.0


def traffic_tables(stakes) -> TrafficTables:
    """The tables as numpy arrays."""
    pt = pull_class_tables(stakes)
    return TrafficTables(perm=pt.perm, class_start=pt.class_start,
                         class_count=pt.class_count, cdf=pt.cdf)


def class_draw_arr(tables: TrafficTables, u_cls: torch.Tensor,
                   u_mem: torch.Tensor) -> torch.Tensor:
    """Stake-weighted node draws (tensor tables; same shapes in and out;
    may return the drawer itself, which callers discard): the class is the
    number of CDF entries (all but the last) at or below ``u_cls``, then
    ``floor(u_mem * count)`` in f32 within it, then a permutation
    gather."""
    cls = (u_cls[..., None] >= tables.cdf[:-1]).sum(-1)
    start = tables.class_start[cls]
    count = tables.class_count[cls]
    pos = start + torch.floor(u_mem * count.to(torch.float32)).to(
        torch.int32)
    pos = torch.minimum(pos, start + (count - 1).clamp(min=0))
    return tables.perm[pos.long()]


def class_draw_t(tables: TrafficTables, basis_cls: int, basis_mem: int,
                 hash_fn) -> torch.Tensor:
    """Draws whose uniforms are ``u01(hash_fn(basis))`` for the class and
    member bases (int32 node ids)."""
    return class_draw_arr(tables, u01_t(hash_fn(basis_cls)),
                          u01_t(hash_fn(basis_mem))).to(torch.int32)


def build_shared_active_set(stakes, seed: int, active_set_size: int,
                            init_draws: int) -> torch.Tensor:
    """The ONE [N, S] active set every value pushes through, as a CPU int32
    tensor: per node, ``init_draws`` stake-weighted draws (counter hashes
    of (seed, node, draw) under the init salts), keeping the first S
    distinct non-self candidates; unfilled slots hold N."""
    stakes = np.asarray(stakes, dtype=np.int64)
    n = int(stakes.shape[0])
    s = int(active_set_size)
    tables = TrafficTables(*(torch.as_tensor(a)
                             for a in traffic_tables(stakes)))
    nodes = torch.arange(n)[:, None]
    draws = torch.arange(int(init_draws))[None, :]
    cands = class_draw_t(tables, round_basis(seed, 0, SALT_TRAFFIC_ICLASS),
                         round_basis(seed, 0, SALT_TRAFFIC_IMEMBER),
                         lambda b: edge_u32_t(b, nodes, draws))   # [N, E]
    active = torch.full((n, s), n, dtype=torch.int32)
    cnt = torch.zeros(n, dtype=torch.int64)
    self_idx = torch.arange(n, dtype=torch.int32)
    for d in range(int(init_draws)):
        c = cands[:, d]
        dup = (active == c[:, None]).any(-1) | (c == self_idx)
        rows = (~dup & (cnt < s)).nonzero().squeeze(1)
        active[rows, cnt[rows]] = c[rows]
        cnt[rows] += 1
    return active


#: terminal causes a retirement record carries
CAUSE_CONVERGED = "converged"              # full coverage, push alone
CAUSE_RESCUED_BY_PULL = "rescued_by_pull"  # full coverage, pull finished it
CAUSE_STARVED_QUEUE_DROP = "starved_queue_drop"  # stalled with queue drops
CAUSE_STALLED = "stalled"                  # stalled, no queue drop involved


def terminal_cause(full: bool, rescued: int, qdrops: int) -> str:
    """The terminal cause of a retired value: converged (or rescued by
    pull, when pull deliveries finished it), else starved by queue drops
    when its messages hit an ingress cap, else stalled."""
    if full:
        return CAUSE_RESCUED_BY_PULL if rescued > 0 else CAUSE_CONVERGED
    return CAUSE_STARVED_QUEUE_DROP if qdrops > 0 else CAUSE_STALLED


def retire_record(vid, origin, birth, it, holders, n, m_msgs, full,
                  hops_sum, rescued=0, qdrops=0) -> dict:
    """The per-value retirement record the stats layer, the Influx series
    and the run report read.  ``latency_rounds`` counts the injection round;
    RMR is the push path's ``m / (n - 1) - 1`` with m = accepted messages +
    prunes."""
    holders = int(holders)
    return {
        "vid": int(vid),
        "origin": int(origin),
        "birth": int(birth),
        "retired_at": int(it),
        "latency_rounds": int(it) - int(birth) + 1,
        "holders": holders,
        "coverage": holders / float(n),
        "m": int(m_msgs),
        "rmr": (m_msgs / (holders - 1) - 1.0) if holders > 1 else 0.0,
        "converged": bool(full),
        "mean_hop": (hops_sum / holders) if holders > 0 else 0.0,
        "rescued_by_pull": int(rescued),
        "qdrops": int(qdrops),
        "cause": terminal_cause(bool(full), int(rescued), int(qdrops)),
    }
