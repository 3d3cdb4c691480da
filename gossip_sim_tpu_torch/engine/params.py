"""Engine parameters: shapes and block gates vs numeric knobs.

The port's copy of the reference package's ``engine/params.py``, cut to the
fields the single-origin push round reads.  Every field it keeps has the
reference's name, default and dtype, so a parameter set means the same thing
to both engines.  ``EngineParams`` is the user-facing NamedTuple; ``split``
gives the two views ``round_step`` reads:

* ``EngineStatic`` — array extents, ranking widths and the booleans that
  select which impairment blocks run
  (``has_fail``/``has_loss``/``has_churn``/``has_partition``);
* ``EngineKnobs`` — every numeric knob as a fixed-dtype numpy scalar.

The knob dtypes are part of the bit-exactness contract:

* ``probability_of_rotation`` is f32 — it is compared against f32 uniforms;
* the stake-threshold / impairment rates are f64 — thresholds derive from
  host double products (``int(rate * 2**32)``, received_cache.rs:112-115);
* iteration boundaries are i32 and ``impair_seed`` is u32 (faults.py).

Of the reference's features this port lacks yet, only the selectors are
kept: ``gossip_mode``, ``traffic_values`` and the queue caps, ``health`` and
``representation``.  :meth:`EngineParams.validate` refuses a non-default
value of each with ``NotImplementedError`` naming its ROADMAP item.  The
knobs that only shape those features (pull fanout and interval, adaptive
thresholds, traffic rate), the reference's prune-apply budget ``pa_slots``
(the ``prune_apply`` kernel needs none) and the flight recorder's capture
width come back with the slice that reads them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..constants import MIN_NUM_UPSERTS, RECEIVED_CACHE_CAPACITY


def _resolve_k_inbound(inbound_cap: int, push_fanout: int) -> int:
    """Inbound ranking width (0 = auto-size from the fanout)."""
    if inbound_cap > 0:
        return inbound_cap
    return max(16, 2 * push_fanout)


class EngineKnobs(NamedTuple):
    """Numeric knobs at the reference's dtypes.  Construct via
    :meth:`EngineParams.split`."""

    probability_of_rotation: np.float32   # gossip_main.rs:124
    prune_stake_threshold: np.float64     # received_cache.rs:112-115 (f64)
    min_ingress_nodes: np.int32           # gossip_main.rs:135
    warm_up_rounds: np.int32              # measured-round boundary
    fail_at: np.int32                     # --when-to-fail; -1 = never
    fail_fraction: np.float64             # --fraction-to-fail (host double)
    packet_loss_rate: np.float64          # faults.py Bernoulli rates: the
    churn_fail_rate: np.float64           # u32 thresholds derive from f64
    churn_recover_rate: np.float64        # products exactly like the oracle
    partition_at: np.int32                # bipartition window start
    heal_at: np.int32                     # bipartition window end (-1 never)
    impair_seed: np.uint32                # counter-hash seed (faults.py)


class EngineStatic(NamedTuple):
    """Array shapes, ranking widths, and the booleans selecting which
    impairment blocks run.  With all four gates False the round is the
    exact unimpaired reference round."""

    num_nodes: int
    push_fanout: int
    active_set_size: int
    min_num_upserts: int
    received_cap: int
    rc_slots: int
    inbound_cap: int
    hist_bins: int
    rot_tries: int
    init_draws: int
    has_fail: bool = False
    has_loss: bool = False
    has_churn: bool = False
    has_partition: bool = False

    @property
    def k_inbound(self) -> int:
        return _resolve_k_inbound(self.inbound_cap, self.push_fanout)


class EngineParams(NamedTuple):
    """The full user-facing parameter set."""

    num_nodes: int
    push_fanout: int = 6                 # gossip_main.rs:90
    active_set_size: int = 12            # gossip_main.rs:97
    probability_of_rotation: float = 0.013333  # gossip_main.rs:124 (1/75)
    prune_stake_threshold: float = 0.15  # gossip_main.rs:142
    min_ingress_nodes: int = 2           # gossip_main.rs:135
    warm_up_rounds: int = 200            # gossip_main.rs:223
    fail_at: int = -1                    # --when-to-fail; -1 = never
    fail_fraction: float = 0.0           # --fraction-to-fail

    min_num_upserts: int = MIN_NUM_UPSERTS          # received_cache.rs:21
    received_cap: int = RECEIVED_CACHE_CAPACITY     # received_cache.rs:78

    # Network-impairment / fault-injection knobs (faults.py; no reference
    # equivalent beyond the one-shot fail_at above).  All decisions are
    # stateless counter hashes of (impair_seed, iteration, node ids), shared
    # bit-exactly with the reference engine.  With every knob at its default
    # the round is IDENTICAL to the unimpaired engine (the blocks are gated
    # on the EngineStatic booleans derived here).
    packet_loss_rate: float = 0.0    # per-message Bernoulli drop probability
    churn_fail_rate: float = 0.0     # per-iteration P(alive node fails)
    churn_recover_rate: float = 0.0  # per-iteration P(failed node recovers)
    partition_at: int = -1           # iteration the stake bipartition starts
    heal_at: int = -1                # iteration it heals (-1 = never)
    impair_seed: int = 0             # hash seed for all impairment streams

    # Selectors of reference features not ported yet; only the defaults
    # are accepted (validate raises NotImplementedError otherwise).
    gossip_mode: str = "push"        # "pull"/"push-pull"/"adaptive": A10
    traffic_values: int = 1          # > 1 or a queue cap: A11
    node_ingress_cap: int = 0
    node_egress_cap: int = 0
    health: bool = False             # node-health planes: A12
    representation: str = "dense"    # "sparse": A7

    # Dense-shape knobs (see engine/core.py):
    rc_slots: int = 64      # physical received-cache slots per (origin, node)
    inbound_cap: int = 0    # inbound peers ranked per (origin, dest, round);
                            # 0 = auto: max(16, 2*push_fanout) so fanout
                            # sweeps can't silently truncate scoring
    hist_bins: int = 64     # on-device hop-histogram bins
    rot_tries: int = 8      # rejection-sampling tries per rotation event
    init_draws: int = 64    # candidate draws per entry at initialization

    @property
    def has_churn(self) -> bool:
        return self.churn_fail_rate > 0.0 or self.churn_recover_rate > 0.0

    @property
    def has_traffic(self) -> bool:
        """True when the reference would engage its concurrent-traffic
        subsystem: more than one value slot, or a queue cap."""
        return (self.traffic_values > 1 or self.node_ingress_cap > 0
                or self.node_egress_cap > 0)

    @property
    def k_inbound(self) -> int:
        """Resolved inbound ranking width (``inbound_cap``; 0 = auto-size
        from the fanout).  Truncation beyond this is counted per round in
        ``rows["inb_dropped"]`` and warned about by the CLI."""
        return _resolve_k_inbound(self.inbound_cap, self.push_fanout)

    def split(self) -> tuple[EngineStatic, EngineKnobs]:
        """(shapes and block gates, knobs at their dtypes)."""
        static = EngineStatic(
            num_nodes=self.num_nodes,
            push_fanout=self.push_fanout,
            active_set_size=self.active_set_size,
            min_num_upserts=self.min_num_upserts,
            received_cap=self.received_cap,
            rc_slots=self.rc_slots,
            inbound_cap=self.inbound_cap,
            hist_bins=self.hist_bins,
            rot_tries=self.rot_tries,
            init_draws=self.init_draws,
            has_fail=self.fail_at >= 0 and self.fail_fraction > 0.0,
            has_loss=self.packet_loss_rate > 0.0,
            has_churn=self.has_churn,
            has_partition=self.partition_at >= 0,
        )
        knobs = EngineKnobs(
            probability_of_rotation=np.float32(self.probability_of_rotation),
            prune_stake_threshold=np.float64(self.prune_stake_threshold),
            min_ingress_nodes=np.int32(self.min_ingress_nodes),
            warm_up_rounds=np.int32(self.warm_up_rounds),
            fail_at=np.int32(self.fail_at),
            fail_fraction=np.float64(self.fail_fraction),
            packet_loss_rate=np.float64(self.packet_loss_rate),
            churn_fail_rate=np.float64(self.churn_fail_rate),
            churn_recover_rate=np.float64(self.churn_recover_rate),
            partition_at=np.int32(self.partition_at),
            heal_at=np.int32(self.heal_at),
            impair_seed=np.uint32(self.impair_seed & 0xFFFFFFFF),
        )
        return static, knobs

    def validate(self) -> "EngineParams":
        """Refuse the unported features (NotImplementedError naming the
        ROADMAP item), then check the slice's own fields."""
        if self.gossip_mode != "push":
            raise NotImplementedError(
                f"gossip_mode={self.gossip_mode!r}: pull and adaptive modes "
                f"are not ported yet (ROADMAP A10)")
        if self.has_traffic:
            raise NotImplementedError(
                "concurrent traffic is not ported yet (ROADMAP A11)")
        if self.health:
            raise NotImplementedError(
                "node-health planes are not ported yet (ROADMAP A12)")
        if self.representation != "dense":
            raise NotImplementedError(
                f"representation={self.representation!r} is not ported yet "
                f"(ROADMAP A7)")
        assert self.num_nodes >= 2
        # The node-id cap (engine/core.py MAX_NODES) is enforced with a
        # ValueError in make_cluster_tables.
        # Enough physical slots for the reference's insert cap (or for every
        # possible peer, whichever is smaller) so the 50-entry cap semantics
        # (received_cache.rs:78) hold without overflow eviction.
        assert self.rc_slots >= min(self.received_cap, self.num_nodes - 1), (
            "rc_slots too small for the received-cache insert cap")
        assert self.k_inbound >= 2, "need at least the two scored ranks"
        assert self.init_draws > self.active_set_size
        for r in (self.packet_loss_rate, self.churn_fail_rate,
                  self.churn_recover_rate):
            assert 0.0 <= r <= 1.0, "impairment rates must be in [0, 1]"
        if self.partition_at >= 0 and self.heal_at >= 0:
            assert self.heal_at >= self.partition_at, (
                "heal_at must not precede partition_at")
        return self
