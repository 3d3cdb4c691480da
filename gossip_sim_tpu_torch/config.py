"""Simulation configuration, sweep test types, and step sizes.

Mirrors the reference's ``Config`` (gossip.rs:111-133), ``Testing``
(gossip.rs:33-76) and ``StepSize`` (gossip.rs:78-109).  Flag names and
defaults are the compatibility contract (gossip_main.rs:53-241).  This
package's ``Config`` carries the fields the experiment harness (account
sources, sweeps, Influx), all-origins mode and the round layout
(``engine_representation``) read, plus ``device`` (where
the engine runs: ``"cuda"`` unless the CPU is asked for).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace


class Testing(enum.Enum):
    ACTIVE_SET_SIZE = "active-set-size"
    PUSH_FANOUT = "push-fanout"
    MIN_INGRESS_NODES = "min-ingress-nodes"
    PRUNE_STAKE_THRESHOLD = "prune-stake-threshold"
    ORIGIN_RANK = "origin-rank"
    FAIL_NODES = "fail-nodes"
    ROTATE_PROBABILITY = "rotate-probability"
    PACKET_LOSS = "packet-loss"
    CHURN = "churn"
    PULL_FANOUT = "pull-fanout"
    TRAFFIC_RATE = "traffic-rate"
    NODE_INGRESS_CAP = "node-ingress-cap"
    ADAPTIVE_THRESHOLD = "adaptive-threshold"
    NO_TEST = "no-test"

    def __str__(self):
        # Display names match the reference (gossip.rs:45-58).
        return {
            Testing.ACTIVE_SET_SIZE: "ActiveSetSize",
            Testing.PUSH_FANOUT: "PushFanout",
            Testing.MIN_INGRESS_NODES: "MinIngressNodes",
            Testing.PRUNE_STAKE_THRESHOLD: "PruneStakeThreshold",
            Testing.ORIGIN_RANK: "OriginRank",
            Testing.FAIL_NODES: "FailNodes",
            Testing.ROTATE_PROBABILITY: "RotateProbability",
            Testing.PACKET_LOSS: "PacketLoss",
            Testing.CHURN: "Churn",
            Testing.PULL_FANOUT: "PullFanout",
            Testing.TRAFFIC_RATE: "TrafficRate",
            Testing.NODE_INGRESS_CAP: "NodeIngressCap",
            Testing.ADAPTIVE_THRESHOLD: "AdaptiveThreshold",
            Testing.NO_TEST: "NoTest",
        }[self]

    @classmethod
    def parse(cls, s: str) -> "Testing":
        for t in cls:
            if t.value == s:
                return t
        raise ValueError(f"Invalid test type: {s}")


@dataclass(frozen=True)
class StepSize:
    """Integer-or-float sweep step (gossip.rs:78-109)."""

    value: float
    is_integer: bool

    @classmethod
    def parse(cls, s: str) -> "StepSize":
        try:
            return cls(value=int(s), is_integer=True)
        except ValueError:
            return cls(value=float(s), is_integer=False)

    def as_int(self) -> int:
        return int(self.value)

    def as_float(self) -> float:
        return float(self.value)

    def __str__(self):
        return str(int(self.value)) if self.is_integer else str(self.value)


@dataclass
class Config:
    """Flat simulation config (gossip.rs:111-133). Defaults from
    gossip_main.rs:90,97,104,113,124,135,142,150-169,204-224."""

    gossip_push_fanout: int = 6
    gossip_active_set_size: int = 12
    gossip_iterations: int = 1
    accounts_from_file: bool = False
    account_file: str = ""
    origin_rank: int = 1
    probability_of_rotation: float = 0.013333
    prune_stake_threshold: float = 0.15
    min_ingress_nodes: int = 2
    filter_zero_staked_nodes: bool = False
    num_buckets_for_stranded_node_hist: int = 10
    num_buckets_for_message_hist: int = 5
    num_buckets_for_hops_stats_hist: int = 15
    fraction_to_fail: float = 0.1
    when_to_fail: int = 0
    test_type: Testing = Testing.NO_TEST
    num_simulations: int = 1
    step_size: StepSize = field(default_factory=lambda: StepSize(1, True))
    warm_up_rounds: int = 200
    print_stats: bool = False

    # Network-impairment / fault-injection knobs (faults.py).  All-off
    # defaults keep every output bit-identical to the unimpaired simulator.
    packet_loss_rate: float = 0.0
    churn_fail_rate: float = 0.0
    churn_recover_rate: float = 0.0
    partition_at: int = -1
    heal_at: int = -1

    # Pull gossip / anti-entropy (pull.py).  gossip_mode "push" keeps every
    # output bit-identical to the push-only simulator.
    gossip_mode: str = "push"       # "push" | "pull" | "push-pull" |
                                    # "adaptive" (adaptive.py)
    pull_fanout: int = 2            # pull requests per live node per round
    pull_interval: int = 1          # rounds between pull exchanges
    pull_bloom_fp_rate: float = 0.1  # bloom false-positive probability
    pull_request_cap: int = 0       # requests served per peer (<=0 = no cap)
    # Adaptive push-pull (adaptive.py), read under gossip_mode "adaptive"
    adaptive_switch_threshold: float = 0.9   # coverage fraction that turns
                                             # a sim's pull phase on
    adaptive_switch_hysteresis: float = 0.05  # window below the threshold
                                              # before it turns off
    # Concurrent traffic (traffic.py).  traffic_values == 1 with both caps
    # off keeps every output bit-identical to the single-value simulator.
    traffic_values: int = 1         # concurrent value slots (static M)
    traffic_rate: int = 1           # new values injected per round
    node_ingress_cap: int = 0       # msgs accepted/node/round (<=0 = no cap)
    node_egress_cap: int = 0        # msgs sent/node/round (<=0 = no cap)
    traffic_stall_rounds: int = 3   # no-progress rounds before a value
                                    # retires unconverged
    engine_representation: str = "dense"  # the round's layout: "dense"
                                    # carries the received cache's stake
                                    # planes; "sparse" derives them from
                                    # the cluster tables.  Bit-identical
                                    # rows and state either way; sparse is
                                    # push mode only, without traffic

    influx_spool: str = ""          # durable spool file: Influx points
                                    # dropped after retry exhaustion or
                                    # queue overflow are appended here as
                                    # line protocol
    seed: int = 42                  # deterministic by construction
    num_synthetic_nodes: int = 0    # >0: synthetic cluster
    all_origins: bool = False       # every node an origin, in batches
    origin_batch: int = 0           # origins per device batch (0 = auto)
    mesh_devices: int = 0           # devices the origin batches split over
                                    # (0 = all; one GPU until ROADMAP A6b)
    mesh_node_shards: int = 1       # node-axis shards per origin shard
                                    # (1 = origins axis only; ROADMAP A6b)
    device: str = "cuda"            # "cuda" (default) or "cpu"

    def stepped(self, **kw) -> "Config":
        return replace(self, **kw)

    @property
    def impairments_on(self) -> bool:
        """Any fault-injection knob beyond the reference's one-shot
        FAIL_NODES (the engine's loss, churn and partition gates)."""
        return (self.packet_loss_rate > 0.0 or self.churn_fail_rate > 0.0
                or self.churn_recover_rate > 0.0 or self.partition_at >= 0)

    @property
    def wants_delivery_stats(self) -> bool:
        """Record delivered/dropped/suppressed counters when impairments are
        on, or when the run is a point of an impairment sweep."""
        return (self.impairments_on
                or self.test_type in (Testing.PACKET_LOSS, Testing.CHURN))

    @property
    def has_pull(self) -> bool:
        """The gossip mode has the pull (anti-entropy) phase, and with it
        the pull counters and series."""
        return self.gossip_mode != "push"

    @property
    def traffic_on(self) -> bool:
        """The concurrent-traffic engine is engaged: more than one value
        slot, or a queue cap (EngineParams.has_traffic)."""
        return (self.traffic_values > 1 or self.node_ingress_cap > 0
                or self.node_egress_cap > 0)
