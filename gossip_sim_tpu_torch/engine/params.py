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

``gossip_mode`` selects the protocol phases: ``"push"`` (the reference
round), ``"pull"`` (the push phase sends nothing), ``"push-pull"`` and
``"adaptive"`` (push, and the pull phase once a sim's coverage crosses the
switch threshold); the pull and adaptive knobs shape the pull phase.

``traffic_values``, the queue caps, ``traffic_rate`` and
``traffic_stall_rounds`` shape the concurrent-traffic engine
(engine/traffic.py), in push mode or adaptive (the per-value pull rescue);
``traffic_slots`` is its value axis (0 with traffic off: one value slot and
both caps off run the single-value engine untouched).  ``representation``
selects the round's layout: ``"dense"`` carries the received cache's four
planes, ``"sparse"`` carries ``rc_shi``/``rc_slo`` at zero width and
derives the member stakes from the cluster tables (push mode without
traffic only; results are bit for bit the dense round's).  Of the
reference's features this port lacks yet, only the ``health`` selector is
kept: :meth:`EngineParams.validate` refuses it with
``NotImplementedError`` naming its ROADMAP item.  The
reference's prune-apply budget ``pa_slots`` (the ``prune_apply`` kernel
needs none) and the flight recorder's capture width come back with the
slice that reads them.
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


def _resolve_pull_slots(pull_slots: int, pull_fanout: int) -> int:
    """Pull-request slots per node (0 = auto: max(8, fanout)).  Slots past
    ``pull_fanout`` send nothing, and each slot's draws depend on (node,
    slot) only, so the width never changes a result."""
    if pull_slots > 0:
        return pull_slots
    return max(8, pull_fanout)


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
    pull_fanout: np.int32                 # pull requests per node per round
    pull_interval: np.int32               # rounds between pull exchanges
    pull_bloom_fp_rate: np.float64        # bloom false-positive probability
    pull_request_cap: np.int32            # served requests per peer (<=0 off)
    adaptive_switch_threshold: np.float64   # coverage fraction that turns
                                            # a sim's pull phase on
    adaptive_switch_hysteresis: np.float64  # window below the threshold
                                            # before it turns off again
    traffic_rate: np.int32                # values injected per round
    node_ingress_cap: np.int32            # msgs accepted/node/round (<=0 off)
    node_egress_cap: np.int32             # msgs sent/node/round (<=0 off)
    traffic_stall_rounds: np.int32        # no-progress rounds before retire


class EngineStatic(NamedTuple):
    """Array shapes, ranking widths, the booleans selecting which
    impairment blocks run, the gossip mode and the round layout.  With all
    four gates False in push mode the round is the exact unimpaired
    reference round.  ``pull_slots`` is the resolved pull-request width (0
    without a pull phase)."""

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
    gossip_mode: str = "push"
    pull_slots: int = 0
    traffic_slots: int = 0
    representation: str = "dense"

    @property
    def k_inbound(self) -> int:
        return _resolve_k_inbound(self.inbound_cap, self.push_fanout)

    @property
    def stake_slots(self) -> int:
        """Width of the carried ``rc_shi``/``rc_slo`` planes: ``rc_slots``
        in the dense layout, 0 in the sparse one."""
        return 0 if self.representation == "sparse" else self.rc_slots

    @property
    def has_traffic(self) -> bool:
        return self.traffic_slots > 0

    @property
    def has_pull(self) -> bool:
        return self.gossip_mode != "push"

    @property
    def has_push(self) -> bool:
        return self.gossip_mode != "pull"

    @property
    def has_adaptive(self) -> bool:
        return self.gossip_mode == "adaptive"


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

    # Pull gossip (pull.py): "push" is the reference round, "pull" runs
    # the pull phase alone, "push-pull" both, "adaptive" both with the
    # direction switch (adaptive.py).  Every pull decision is a stateless
    # counter hash of (impair_seed, iteration, node ids).
    gossip_mode: str = "push"
    pull_fanout: int = 2             # pull requests per live node per round
    pull_interval: int = 1           # rounds between pull exchanges
    pull_bloom_fp_rate: float = 0.1  # bloom FP probability (Solana's 0.1)
    pull_request_cap: int = 0        # requests served per peer per round
                                     # (<= 0 = unlimited)
    pull_slots: int = 0              # pull-request slots per node
                                     # (0 = auto: max(8, pull_fanout))
    adaptive_switch_threshold: float = 0.9   # coverage fraction that turns
                                             # a sim's pull phase on
    adaptive_switch_hysteresis: float = 0.05  # it turns off below
                                              # threshold - hysteresis

    # Concurrent traffic (traffic.py): with one value slot and both queue
    # caps off the traffic engine is gated out and the single-value engine
    # runs untouched.  Every traffic decision is a stateless counter hash.
    traffic_values: int = 1          # concurrent value slots (static M)
    traffic_rate: int = 1            # new values injected per round
    node_ingress_cap: int = 0        # msgs accepted per node per round
                                     # across all values (<= 0 = no cap)
    node_egress_cap: int = 0         # msgs sent per node per round across
                                     # all values (<= 0 = no cap; excess
                                     # candidates defer to the next round)
    traffic_stall_rounds: int = 3    # consecutive no-progress rounds
                                     # before a value retires unconverged

    # Selector of a reference feature not ported yet; only the default is
    # accepted (validate raises NotImplementedError otherwise).
    health: bool = False             # node-health planes: A12
    # Round layout: "dense" carries the received cache's stake planes,
    # "sparse" carries them at zero width ([O, N, 0]) and derives the
    # member stakes from the cluster tables.  Rows and state are bit for
    # bit the same; push mode without traffic only.
    representation: str = "dense"

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
    def has_pull(self) -> bool:
        """True when the gossip mode has the pull phase."""
        return self.gossip_mode != "push"

    @property
    def has_push(self) -> bool:
        return self.gossip_mode != "pull"

    @property
    def has_adaptive(self) -> bool:
        return self.gossip_mode == "adaptive"

    @property
    def pull_slots_resolved(self) -> int:
        """Resolved pull-request width (``pull_slots``; 0 = auto:
        max(8, pull_fanout))."""
        return _resolve_pull_slots(self.pull_slots, self.pull_fanout)

    @property
    def has_traffic(self) -> bool:
        """True when the concurrent-traffic engine is engaged: more than one
        value slot, or a queue cap."""
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
            gossip_mode=self.gossip_mode,
            pull_slots=self.pull_slots_resolved if self.has_pull else 0,
            traffic_slots=self.traffic_values if self.has_traffic else 0,
            representation=self.representation,
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
            pull_fanout=np.int32(self.pull_fanout),
            pull_interval=np.int32(max(1, self.pull_interval)),
            pull_bloom_fp_rate=np.float64(self.pull_bloom_fp_rate),
            pull_request_cap=np.int32(self.pull_request_cap),
            adaptive_switch_threshold=np.float64(
                self.adaptive_switch_threshold),
            adaptive_switch_hysteresis=np.float64(
                self.adaptive_switch_hysteresis),
            traffic_rate=np.int32(self.traffic_rate),
            node_ingress_cap=np.int32(self.node_ingress_cap),
            node_egress_cap=np.int32(self.node_egress_cap),
            traffic_stall_rounds=np.int32(max(1, self.traffic_stall_rounds)),
        )
        return static, knobs

    def validate(self) -> "EngineParams":
        """Refuse the unported feature (NotImplementedError naming the
        ROADMAP item) and the representations' unsupported modes
        (ValueError), then check the slice's own fields."""
        if self.gossip_mode not in ("push", "pull", "push-pull", "adaptive"):
            raise ValueError(f"unknown gossip_mode: {self.gossip_mode!r}")
        if self.representation not in ("dense", "sparse"):
            raise ValueError(
                f"unknown representation: {self.representation!r}")
        if self.representation == "sparse":
            if self.has_pull:
                raise ValueError(
                    "the sparse frontier round implements the push phase "
                    "only; pull/adaptive modes need the dense representation")
            if self.has_traffic:
                raise ValueError(
                    "the sparse frontier round does not carry the traffic "
                    "subsystem yet; use representation='dense' with traffic")
        if self.health:
            raise NotImplementedError(
                "node-health planes are not ported yet (ROADMAP A12)")
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
        if self.has_adaptive:
            if not 0.0 < self.adaptive_switch_threshold <= 1.0:
                raise ValueError("adaptive_switch_threshold must be in (0, 1]")
            if not (0.0 <= self.adaptive_switch_hysteresis
                    < self.adaptive_switch_threshold):
                raise ValueError("adaptive_switch_hysteresis must be in "
                                 "[0, adaptive_switch_threshold)")
        if self.has_pull:
            if self.pull_fanout < 1:
                raise ValueError("pull_fanout must be >= 1")
            if self.pull_interval < 1:
                raise ValueError("pull_interval must be >= 1")
            if not 0.0 <= self.pull_bloom_fp_rate <= 1.0:
                raise ValueError("pull_bloom_fp_rate must be in [0, 1]")
            if self.pull_fanout > self.pull_slots_resolved:
                raise ValueError("pull_fanout exceeds the static pull_slots "
                                 "width — raise EngineParams.pull_slots")
        # the reference's traffic checks (gossip_sim_tpu/engine/params.py
        # 529-550)
        if self.traffic_values < 1:
            raise ValueError("traffic_values must be >= 1")
        if self.has_traffic:
            if self.traffic_rate < 0:
                raise ValueError("traffic_rate must be >= 0")
            if self.traffic_stall_rounds < 1:
                raise ValueError("traffic_stall_rounds must be >= 1")
            if self.gossip_mode not in ("push", "adaptive"):
                raise ValueError(
                    "the traffic subsystem models concurrent PUSH streams; "
                    "fixed pull modes are not supported with traffic_values "
                    "> 1 or queue caps")
            if self.fail_at >= 0 and self.fail_fraction > 0.0:
                raise ValueError(
                    "one-shot fail_at draws from the PRNG, which the traffic "
                    "round does not; use churn_fail_rate with traffic")
            if (self.gossip_mode == "adaptive"
                    and self.node_ingress_cap >= 16384):
                raise ValueError(
                    "adaptive traffic requires node_ingress_cap < 16384 "
                    "(sort-key packing bound); caps that large are "
                    "equivalent to no cap — use 0")
        return self
