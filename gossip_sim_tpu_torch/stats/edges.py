"""Shared per-edge accounting over flight-recorder arrays (obs/trace.py):
the port's own copy of the reference package's ``stats/edges.py``.

The stats layer's scalar aggregates (coverage, RMR, stranded counts) and
the trace tooling (tools/trace_report.py, tools/trace_smoke.py) must agree
on what counts as a delivered edge, a first delivery, and a redundant
delivery — so the definitions live here once, as pure-numpy functions over
single-round trace arrays (no leading round/origin axes; callers slice).

Conventions (matching obs/trace.py):

* ``peers``  [N, F] int   candidate target per fanout slot, -1 empty
* ``code``   [N, F] int   slot outcome (TRACE_* codes)
* ``dist``   [N]    int   hop distance from origin, -1 unreached
* ``first_src`` [N] int   first-delivery sender per receiver, -1 none
* ``active`` [N, S] int   pre-round active set, -1 empty
* ``pruned`` [N, S] bool  pre-round per-slot pruned bits
* ``failed`` [N]    bool  node-failure mask
"""

from __future__ import annotations

import numpy as np

from ..obs.trace import (TRACE_CANDIDATE, TRACE_DROPPED, TRACE_FAILED_TARGET,
                         TRACE_SUPPRESSED)

# stranded-path failure causes (explain_stranded)
CAUSE_PRUNED = "pruned"
CAUSE_SENDER_UNREACHED = "sender_unreached"
CAUSE_SENDER_FAILED = "sender_failed"
CAUSE_FANOUT_TRUNCATED = "fanout_truncated"
CAUSE_SUPPRESSED = "suppressed"
CAUSE_DROPPED = "dropped"
CAUSE_TARGET_FAILED = "target_failed"
CAUSE_NO_SENDERS = "no_potential_senders"
CAUSE_INCONSISTENT = "inconsistent_delivered"
# push-stranded node rescued by the pull (anti-entropy) phase (pull.py):
# not stranded in the stats layer, but the push-path failure analysis is
# still reported so "pull papered over a push hole" stays visible
CAUSE_RESCUED_BY_PULL = "rescued_by_pull"
# concurrent-traffic queue-cap outcomes (traffic.py, trace schema v3):
# the slot's candidate message was never sent (sender's egress budget
# exhausted — deferred to a later round) or arrived but was dropped by
# the receiver's ingress budget.  Per-value traffic arrays slice straight
# into explain_stranded (active shared, pruned/peers/code/dist per value).
CAUSE_EGRESS_DEFERRED = "egress_deferred"
CAUSE_QUEUE_DROPPED = "queue_dropped"


def delivered_mask(code: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """[N, F] bool: slots that actually carried a message this round — a
    deliverable candidate pushed by a source the BFS reached."""
    return (code == TRACE_CANDIDATE) & (dist >= 0)[:, None]


def delivered_edges(peers: np.ndarray, code: np.ndarray,
                    dist: np.ndarray) -> np.ndarray:
    """Delivered (src, dst) pairs as an ``[E, 2]`` int array."""
    src, slot = np.nonzero(delivered_mask(code, dist))
    return np.stack([src, peers[src, slot]], axis=1).astype(np.int64)


def edge_keys(edges: np.ndarray, num_nodes: int) -> np.ndarray:
    """Pack [E, 2] (src, dst) pairs into sortable int64 keys."""
    return edges[:, 0].astype(np.int64) * num_nodes + edges[:, 1]


def first_delivery_edges(first_src: np.ndarray,
                         dist: np.ndarray) -> np.ndarray:
    """First-delivery (src, dst, hop) rows [E, 3] for every receiver that
    was reached through gossip this round (``dist > 0``; the origin's own
    dist-0 entry is the tree root, not an edge)."""
    dst = np.nonzero((dist > 0) & (first_src >= 0))[0]
    return np.stack([first_src[dst], dst, dist[dst]], axis=1).astype(np.int64)


def build_delivery_tree(first_src: np.ndarray, dist: np.ndarray,
                        origin: int):
    """-> (parent [N] int, ok bool).  ``parent[n]`` is the first-delivery
    sender for reached non-origin nodes, -1 otherwise.  ``ok`` is True iff
    every reached node's parent chain terminates at the origin with strictly
    decreasing hop distance — i.e. the recorded first deliveries really form
    a tree rooted at the origin."""
    n = dist.shape[0]
    parent = np.full(n, -1, np.int64)
    reached = (dist > 0) & (first_src >= 0)
    parent[reached] = first_src[reached]
    ok = bool(dist[origin] == 0)
    # every reached node needs a recorded first delivery ...
    ok &= not np.any((dist > 0) & (first_src < 0))
    if ok and reached.any():
        p = parent[reached]
        # ... whose sender is reached exactly one hop closer to the origin
        ok = bool(np.all(dist[p] >= 0) and np.all(dist[p] + 1
                                                  == dist[reached]))
    return parent, ok


def redundant_edge_counts(peers: np.ndarray, code: np.ndarray,
                          dist: np.ndarray, first_src: np.ndarray,
                          num_nodes: int) -> dict:
    """Redundant deliveries per edge this round: a delivered edge
    ``src -> dst`` is redundant when ``src`` is not ``dst``'s first-delivery
    sender (RMR's numerator is exactly these plus prune messages).
    Returns ``{(src, dst): count}`` (count is 1 per round per edge)."""
    edges = delivered_edges(peers, code, dist)
    if edges.shape[0] == 0:
        return {}
    red = edges[first_src[edges[:, 1]] != edges[:, 0]]
    keys, counts = np.unique(edge_keys(red, num_nodes), return_counts=True)
    return {(int(k) // num_nodes, int(k) % num_nodes): int(c)
            for k, c in zip(keys, counts)}


def explain_stranded(active: np.ndarray, pruned: np.ndarray,
                     peers: np.ndarray, code: np.ndarray, dist: np.ndarray,
                     failed: np.ndarray, origin: int,
                     pull_hop: np.ndarray | None = None) -> list:
    """Root-cause every stranded node of one round.

    A node is stranded when it is unreached and not failed (the stats
    layer's definition).  For each, every *potential sender* — a node whose
    pre-round active set contains it — is classified by why its path failed:

    * ``pruned``            the slot's pruned bit was set for this origin
    * ``sender_unreached``  the sender itself never got the message
      (``sender_failed`` when the sender was down outright)
    * ``fanout_truncated``  the slot was valid but beyond the first
      ``push_fanout`` valid slots, so no push was attempted
    * ``suppressed`` / ``dropped``  the push was attempted by a reached
      sender and lost to the partition / packet loss
    * ``target_failed``     can only appear for failed targets, i.e. never
      for a stranded node; listed for completeness
    * ``inconsistent_delivered``  a reached sender's slot claims delivery —
      impossible for a stranded node; flags a corrupt trace

    ``pull_hop`` (trace schema v2, pull modes): per-node pull delivery hop,
    -1 = none.  A push-unreached node with a pull rescue is NOT stranded —
    its entry carries ``rescued_by_pull`` in the summary (with the push-path
    causes preserved), so the analysis still shows why push alone would
    have stranded it.

    Returns ``[{node, causes: [{sender, slot, cause}], summary: {...}}]``
    with one entry per push-unreached non-failed node (``causes`` empty and
    summary ``no_potential_senders`` when nobody even pointed at it).
    """
    stranded = np.nonzero((dist < 0) & ~failed)[0]
    out = []
    for r in stranded:
        senders, slots = np.nonzero(active == r)
        causes = []
        for s, slot in zip(senders.tolist(), slots.tolist()):
            if pruned[s, slot]:
                cause = CAUSE_PRUNED
            elif dist[s] < 0:
                cause = CAUSE_SENDER_FAILED if failed[s] \
                    else CAUSE_SENDER_UNREACHED
            else:
                k = np.nonzero(peers[s] == r)[0]
                if k.size == 0:
                    cause = CAUSE_FANOUT_TRUNCATED
                else:
                    from ..traffic import (TRAFFIC_DEFERRED,
                                           TRAFFIC_QUEUE_DROPPED)
                    c = int(code[s, k[0]])
                    cause = {
                        TRACE_SUPPRESSED: CAUSE_SUPPRESSED,
                        TRACE_DROPPED: CAUSE_DROPPED,
                        TRACE_FAILED_TARGET: CAUSE_TARGET_FAILED,
                        # traffic (v3) queue-cap outcomes
                        TRAFFIC_DEFERRED: CAUSE_EGRESS_DEFERRED,
                        TRAFFIC_QUEUE_DROPPED: CAUSE_QUEUE_DROPPED,
                    }.get(c, CAUSE_INCONSISTENT)
            causes.append({"sender": int(s), "slot": int(slot),
                           "cause": cause})
        summary = {}
        for c in causes:
            summary[c["cause"]] = summary.get(c["cause"], 0) + 1
        if not causes:
            summary[CAUSE_NO_SENDERS] = 1
        entry = {"node": int(r), "causes": causes, "summary": summary}
        if pull_hop is not None and pull_hop[r] >= 0:
            summary[CAUSE_RESCUED_BY_PULL] = 1
            entry["pull_hop"] = int(pull_hop[r])
            entry["stranded"] = False
        elif pull_hop is not None:
            entry["stranded"] = True
        out.append(entry)
    return out


def diff_delivered(peers_a, code_a, dist_a, peers_b, code_b, dist_b,
                   num_nodes: int) -> dict:
    """Edge-by-edge delivered-set diff of one round between two traces
    (e.g. baseline vs packet-loss run).  Returns packed-key sets split into
    common / only_a / only_b plus counts."""
    ka = set(edge_keys(delivered_edges(peers_a, code_a, dist_a),
                       num_nodes).tolist())
    kb = set(edge_keys(delivered_edges(peers_b, code_b, dist_b),
                       num_nodes).tolist())
    return {
        "common": ka & kb,
        "only_a": ka - kb,
        "only_b": kb - ka,
        "n_a": len(ka),
        "n_b": len(kb),
    }


def unpack_edge(key: int, num_nodes: int) -> tuple:
    return int(key) // num_nodes, int(key) % num_nodes
