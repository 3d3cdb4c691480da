"""Pull-gossip (anti-entropy) primitives: the port's copy of what the
engine needs from the reference package's ``pull.py``.

Each round where ``it % pull_interval == 0``, every live node
stake-weight-samples ``pull_fanout`` pull peers and sends each a pull
request.  A peer that is live and holds the origin's value this round
(push-reached, the origin included) answers with it, unless the requester
already has it or its bloom digest false-positives the value away.
``pull_request_cap`` > 0 bounds the arrived requests a peer serves per
round, in (requester, slot) order.  Pull deliveries get
``hop = holder_hop + 1``; they count toward coverage and hops but not
toward the push RMR rows.

Every decision is a stateless counter hash of ``(impair_seed, iteration,
node ids)`` (faults.py):

    peer draw    u_class/u_member = u01(edge_u32(basis, node, slot))
    bloom FP     node_u32(basis_fp, node)          < fp_rate   * 2^32
    request loss edge_u32(basis_loss, node, peer)  < loss_rate * 2^32

The peer draw is the push sampler's top-entry class CDF (weights
``(bucket + 1)^2``) with hash-derived uniforms ``(h >> 8) * 2^-24``,
exact in float32.  The engine's block is the ``pull_exchange`` kernel
(kernels/pull_exchange.py); :func:`sample_pull_peer` is the scalar spec of
its peer draw.

Per-slot precedence: dead requester / self-draw > failed peer > partition
suppression > request loss > arrival; an arrived request is then capped /
not held / already held / bloom false positive / answered (the ``PULL_*``
codes, the flight recorder's).  Numpy only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .constants import NUM_PUSH_ACTIVE_SET_ENTRIES
from .faults import edge_u32
from .identity import stake_buckets_array

NB = NUM_PUSH_ACTIVE_SET_ENTRIES  # 25

# domain-separation salts for the pull hash streams (faults.py convention)
SALT_PULL_CLASS = 0x1B873593    # peer draw: stake-class uniform
SALT_PULL_MEMBER = 0xE6546B64   # peer draw: within-class uniform
SALT_PULL_BLOOM = 0xCC9E2D51    # per-(round, requester) bloom-FP event
SALT_PULL_LOSS = 0x38B34AE5     # per-(round, requester, peer) request loss

# per-slot outcome codes (the flight recorder's ``pull_code``)
PULL_EMPTY = 0            # inactive slot / self-draw / dead requester
PULL_RESPONSE = 1         # value transferred to the requester
PULL_PEER_FAILED = 2      # request sent into a churn-failed peer
PULL_SUPPRESSED = 3       # cross-partition request suppressed
PULL_DROPPED = 4          # request lost to packet loss
PULL_MISS_NOT_HELD = 5    # peer does not hold the value this round
PULL_MISS_ALREADY_HELD = 6  # requester already holds it (bloom true match)
PULL_MISS_BLOOM_FP = 7    # bloom false positive filtered the rescue out
PULL_MISS_CAPPED = 8      # peer's pull_request_cap already exhausted
PULL_CODE_NAMES = {
    PULL_EMPTY: "empty",
    PULL_RESPONSE: "response",
    PULL_PEER_FAILED: "peer_failed",
    PULL_SUPPRESSED: "suppressed",
    PULL_DROPPED: "dropped",
    PULL_MISS_NOT_HELD: "miss_not_held",
    PULL_MISS_ALREADY_HELD: "miss_already_held",
    PULL_MISS_BLOOM_FP: "miss_bloom_fp",
    PULL_MISS_CAPPED: "miss_capped",
}


def u01_from_u32(h: int) -> np.float32:
    """u32 hash -> f32 uniform in [0, 1): ``(h >> 8) * 2^-24``.  The 24
    surviving bits fit the f32 mantissa, so the value is exact."""
    return np.float32(h >> 8) * np.float32(2.0 ** -24)


class PullTables(NamedTuple):
    """Stake-class tables of the pull peer draw (numpy).  ``cdf`` is the
    top-entry (k = 24) class CDF, weights ``(bucket + 1)^2``, in the same
    f64-cumsum -> f32 arithmetic as ``engine/sampler.build_sampler_tables``,
    so it equals ``sampler.class_cdf[-1]`` bit for bit."""

    perm: np.ndarray         # [N] i32  node ids sorted by bucket (stable)
    class_start: np.ndarray  # [NB] i32
    class_count: np.ndarray  # [NB] i32
    cdf: np.ndarray          # [NB] f32 inclusive CDF, cdf[-1] == 1.0


def pull_class_tables(stakes) -> PullTables:
    """The pull sampling tables from the per-node stake vector."""
    buckets = stake_buckets_array(
        np.asarray(stakes, dtype=np.int64).astype(np.uint64)).astype(np.int32)
    class_count = np.bincount(buckets, minlength=NB).astype(np.int32)
    class_start = np.concatenate(
        [[0], np.cumsum(class_count)[:-1]]).astype(np.int32)
    c = np.arange(NB)
    mass = class_count.astype(np.float64) * ((c + 1) ** 2)
    cdf = np.cumsum(mass)
    total = cdf[-1] if cdf[-1] != 0 else 1.0
    cdf = (cdf / total).astype(np.float32)
    cdf[-1] = 1.0
    return PullTables(
        perm=np.argsort(buckets, kind="stable").astype(np.int32),
        class_start=class_start,
        class_count=class_count,
        cdf=cdf,
    )


def sample_pull_peer(tables: PullTables, basis_cls: int, basis_mem: int,
                     node: int, slot: int) -> int:
    """One stake-weighted pull peer draw (scalar; may return ``node``
    itself, and a self-draw discards the slot): the f32 class compare
    against the CDF, then ``floor(u * count)`` in f32 within the class."""
    u_cls = u01_from_u32(edge_u32(basis_cls, node, slot))
    cls = int(np.count_nonzero(u_cls >= tables.cdf[:-1]))
    start = int(tables.class_start[cls])
    count = int(tables.class_count[cls])
    u_mem = u01_from_u32(edge_u32(basis_mem, node, slot))
    pos = start + int(np.floor(u_mem * np.float32(count)))
    pos = min(pos, start + max(count - 1, 0))
    return int(tables.perm[pos])
