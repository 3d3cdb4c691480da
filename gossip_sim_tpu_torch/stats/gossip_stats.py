"""Per-simulation statistics hub (reference: gossip_stats.rs:1228-1965).

Collects hops, coverage, RMR, stranded, branching factor and message-count
series across measured rounds; runs the end-of-simulation calculations and
builds histograms.  ``GossipStatsCollection`` aggregates across sweep runs.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from ..config import Config, StepSize, Testing
from .collections import StatCollection
from .histogram import Histogram
from .hops import HopsStatCollection
from .stranded import StrandedNodeCollection
from .trackers import EgressIngressMessageTracker, branching_factor_outbound

log = logging.getLogger(__name__)


@dataclass
class SimulationParameters:
    """Config snapshot stored with each GossipStats
    (gossip_stats.rs:1193-1226)."""

    gossip_push_fanout: int = 0
    gossip_active_set_size: int = 0
    gossip_iterations: int = 0
    origin_rank: int = 0
    probability_of_rotation: float = 0.0
    prune_stake_threshold: float = 0.0
    min_ingress_nodes: int = 0
    fraction_to_fail: float = 0.0
    when_to_fail: int = 0
    packet_loss_rate: float = 0.0
    churn_fail_rate: float = 0.0
    churn_recover_rate: float = 0.0
    partition_at: int = -1
    heal_at: int = -1
    gossip_mode: str = "push"
    pull_fanout: int = 0
    pull_interval: int = 1
    pull_bloom_fp_rate: float = 0.0
    pull_request_cap: int = 0
    test_type: Testing = Testing.NO_TEST
    num_simulations: int = 0
    step_size: StepSize = field(default_factory=lambda: StepSize(0, True))


class GossipStats:
    def __init__(self):
        self.hops_stats = HopsStatCollection()
        self.coverage_stats = StatCollection("Coverage")
        self.rmr_stats = StatCollection("RMR")
        self.stranded_node_collection = StrandedNodeCollection()
        self.outbound_branching_factors = StatCollection("Outbound Branching Factor")
        self.origin = None
        self.simulation_parameters = SimulationParameters()
        self.failed_nodes = set()
        self.egress_messages = EgressIngressMessageTracker()
        self.ingress_messages = EgressIngressMessageTracker()
        self.prune_messages = EgressIngressMessageTracker()
        self.validator_stake_distribution = Histogram()
        # degraded-delivery series (faults.py); empty unless impairments ran
        self.delivered_stats = StatCollection("Delivered Messages")
        self.dropped_stats = StatCollection("Dropped Messages")
        self.suppressed_stats = StatCollection("Suppressed Messages")
        self.failed_count_series = []
        # pull-phase series (pull.py); empty unless a pull mode ran
        self.pull_requests_stats = StatCollection("Pull Requests")
        self.pull_responses_stats = StatCollection("Pull Responses")
        self.pull_misses_stats = StatCollection("Pull Misses")
        self.pull_dropped_stats = StatCollection("Pull Dropped Requests")
        self.pull_suppressed_stats = StatCollection(
            "Pull Suppressed Requests")
        self.pull_rescued_stats = StatCollection("Pull Rescued Nodes")
        # adaptive direction-switch series (adaptive.py); empty unless
        # gossip_mode "adaptive" ran.  active is the 0/1 direction bit in
        # effect each measured round, switched flags the rounds whose
        # coverage flipped it
        self.adaptive_active_series = []
        self.adaptive_switched_series = []
        # iterations from heal_at until coverage regained the recovery
        # threshold; None = no heal configured or never measured, -1 = never
        # recovered within the run
        self.recovery_iterations = None
        # full post-heal (iteration, coverage) samples — fed by both
        # backends for every iteration >= heal_at including warm-up rounds,
        # so the metric is iteration-exact and agrees with the all-origins
        # aggregate path (stats/aggregate.py add_batch)
        self._post_heal_coverage = []

    # -- setup ---------------------------------------------------------------

    def set_simulation_parameters(self, config: Config):
        self.simulation_parameters = SimulationParameters(
            gossip_push_fanout=config.gossip_push_fanout,
            gossip_active_set_size=config.gossip_active_set_size,
            gossip_iterations=config.gossip_iterations,
            origin_rank=config.origin_rank,
            probability_of_rotation=config.probability_of_rotation,
            prune_stake_threshold=config.prune_stake_threshold,
            min_ingress_nodes=config.min_ingress_nodes,
            fraction_to_fail=config.fraction_to_fail,
            when_to_fail=config.when_to_fail,
            packet_loss_rate=config.packet_loss_rate,
            churn_fail_rate=config.churn_fail_rate,
            churn_recover_rate=config.churn_recover_rate,
            partition_at=config.partition_at,
            heal_at=config.heal_at,
            gossip_mode=config.gossip_mode,
            pull_fanout=config.pull_fanout,
            pull_interval=config.pull_interval,
            pull_bloom_fp_rate=config.pull_bloom_fp_rate,
            pull_request_cap=config.pull_request_cap,
            test_type=config.test_type,
            num_simulations=config.num_simulations,
            step_size=config.step_size,
        )

    def set_origin(self, origin):
        self.origin = origin

    def parity_snapshot(self) -> dict:
        """Every deterministic per-sim series/counter as one dict — THE
        bit-exactness surface two runs of the same simulation must agree
        on.  Both the lane-sweep regression tests and the
        tools/lane_smoke.py CI gate diff this snapshot, so the parity
        contract has exactly one definition; extend it here when a new
        stats field lands and every parity check picks it up."""
        return {
            "coverage": list(self.coverage_stats.collection),
            "rmr": list(self.rmr_stats.collection),
            "branching": list(self.outbound_branching_factors.collection),
            "hops": list(self.hops_stats.raw_hop_collection),
            "stranded": dict(self.stranded_node_collection.stranded_nodes),
            "egress": dict(self.egress_messages.counts),
            "ingress": dict(self.ingress_messages.counts),
            "prunes": dict(self.prune_messages.counts),
            "delivered": list(self.delivered_stats.collection),
            "dropped": list(self.dropped_stats.collection),
            "suppressed": list(self.suppressed_stats.collection),
            "failed_count_series": list(self.failed_count_series),
            "failed_nodes": set(self.failed_nodes),
            "pull_requests": list(self.pull_requests_stats.collection),
            "pull_responses": list(self.pull_responses_stats.collection),
            "pull_misses": list(self.pull_misses_stats.collection),
            "pull_dropped": list(self.pull_dropped_stats.collection),
            "pull_suppressed": list(self.pull_suppressed_stats.collection),
            "pull_rescued": list(self.pull_rescued_stats.collection),
            "adaptive_active": list(self.adaptive_active_series),
            "adaptive_switched": list(self.adaptive_switched_series),
            "recovery_iterations": self.recovery_iterations,
        }

    def initialize_message_stats(self, stakes):
        self.egress_messages.initialize_counts_map(stakes)
        self.ingress_messages.initialize_counts_map(stakes)
        self.prune_messages.initialize_counts_map(stakes)

    def set_failed_nodes(self, failed_nodes):
        self.failed_nodes.update(failed_nodes)

    # -- per-round inserts ---------------------------------------------------

    def insert_coverage(self, value):
        self.coverage_stats.push(value)

    def insert_rmr(self, rmr):
        self.rmr_stats.push(rmr)

    def insert_hops_stat(self, distances):
        """distances: {pubkey: hops} or iterable of hops."""
        hops = (list(distances.values()) if isinstance(distances, dict)
                else list(distances))
        self.hops_stats.insert(hops)

    def insert_stranded_nodes(self, stranded_nodes, stakes):
        self.stranded_node_collection.insert_nodes(stranded_nodes, stakes)

    def calculate_outbound_branching_factor(self, pushes):
        self.outbound_branching_factors.push(branching_factor_outbound(pushes))

    def insert_branching_factor(self, value):
        self.outbound_branching_factors.push(value)

    def update_message_counts(self, egress, ingress):
        self.egress_messages.update_message_counts(egress)
        self.ingress_messages.update_message_counts(ingress)

    def update_prune_counts(self, prunes):
        self.prune_messages.update_message_counts(prunes)

    def insert_delivery(self, delivered, dropped, suppressed, failed_count):
        """Per-round degraded-delivery counters (faults.py)."""
        self.delivered_stats.push(delivered)
        self.dropped_stats.push(dropped)
        self.suppressed_stats.push(suppressed)
        self.failed_count_series.append(int(failed_count))

    def has_delivery_stats(self):
        return not self.delivered_stats.is_empty()

    def insert_pull(self, requests, responses, misses, dropped, suppressed,
                    rescued):
        """Per-round pull-phase counters (pull.py)."""
        self.pull_requests_stats.push(requests)
        self.pull_responses_stats.push(responses)
        self.pull_misses_stats.push(misses)
        self.pull_dropped_stats.push(dropped)
        self.pull_suppressed_stats.push(suppressed)
        self.pull_rescued_stats.push(rescued)

    def has_pull_stats(self):
        return not self.pull_requests_stats.is_empty()

    def insert_adaptive(self, active, switched):
        """Per-round adaptive direction-switch telemetry (adaptive.py)."""
        self.adaptive_active_series.append(int(active))
        self.adaptive_switched_series.append(int(switched))

    def has_adaptive_stats(self):
        return bool(self.adaptive_active_series)

    def note_post_heal_coverage(self, it, coverage):
        """Record one post-heal (iteration, coverage) sample.  Both backends
        feed every iteration >= heal_at — warm-up rounds included — so the
        recovery metric below sees the true iteration axis."""
        self._post_heal_coverage.append((int(it), float(coverage)))

    def calc_recovery_iterations(self, heal_at, threshold=None):
        """Iterations after ``heal_at`` until coverage regains ``threshold``
        (COVERAGE_RECOVERY_THRESHOLD by default), measured on the full
        post-heal series — 0 means coverage was already at the bar on the
        heal iteration itself, matching the all-origins aggregate path.
        Sets ``recovery_iterations`` (-1 = never recovered in this run)."""
        from ..constants import COVERAGE_RECOVERY_THRESHOLD
        if threshold is None:
            threshold = COVERAGE_RECOVERY_THRESHOLD
        if heal_at < 0 or not self._post_heal_coverage:
            self.recovery_iterations = None
            return None
        for it, cov in self._post_heal_coverage:
            if cov >= threshold:
                self.recovery_iterations = it - heal_at
                break
        else:
            self.recovery_iterations = -1
        return self.recovery_iterations

    # -- end-of-simulation ---------------------------------------------------

    def build_stranded_node_histogram(self, upper_bound, lower_bound, num_buckets):
        self.stranded_node_collection.build_histogram(
            upper_bound, lower_bound, num_buckets)

    def build_aggregate_hops_stats_histogram(self, upper_bound, lower_bound,
                                             num_buckets):
        self.hops_stats.build_histogram(upper_bound, lower_bound, num_buckets)

    def build_message_histograms(self, num_buckets, normalize, stakes):
        self.egress_messages.build_histogram(num_buckets, stakes)
        self.ingress_messages.build_histogram(num_buckets, stakes)
        if normalize:
            self.egress_messages.normalize_message_counts()
            self.ingress_messages.normalize_message_counts()

    def build_prune_histogram(self, num_buckets, normalize, stakes):
        self.prune_messages.build_histogram(num_buckets, stakes)
        if normalize:
            self.prune_messages.normalize_message_counts()

    def build_validator_stake_distribution_histogram(self, num_buckets, stakes):
        vals = sorted(stakes.values(), reverse=True)
        self.validator_stake_distribution.build(vals[0], 0, num_buckets, vals)

    def run_all_calculations(self):
        """(gossip_stats.rs:1858-1867)"""
        self.coverage_stats.calculate_stats()
        self.rmr_stats.calculate_stats()
        self.hops_stats.aggregate_hop_stats()
        self.hops_stats.calc_last_delivery_hop_stats()
        self.stranded_node_collection.calculate_stats()
        self.outbound_branching_factors.calculate_stats()
        if self.has_delivery_stats():
            self.delivered_stats.calculate_stats()
            self.dropped_stats.calculate_stats()
            self.suppressed_stats.calculate_stats()
        if self.has_pull_stats():
            for sc in (self.pull_requests_stats, self.pull_responses_stats,
                       self.pull_misses_stats, self.pull_dropped_stats,
                       self.pull_suppressed_stats, self.pull_rescued_stats):
                sc.calculate_stats()
        sp = self.simulation_parameters
        if sp.heal_at >= 0:
            self.calc_recovery_iterations(sp.heal_at)

    # -- accessors -----------------------------------------------------------

    def get_coverage_stats(self):
        return self.coverage_stats.summary()

    def get_rmr_stats(self):
        return self.rmr_stats.summary()

    def get_rmr_by_index(self, index):
        return self.rmr_stats.get_stat_by_index(index)

    def get_per_hop_stats_by_index(self, i):
        s = self.hops_stats.per_round_stats[i]
        return (s.mean, s.median, s.max, s.min)

    def get_hops_stat_by_iteration(self, i):
        return self.hops_stats.get_stat_by_iteration(i)

    def get_aggregate_hop_stats(self):
        s = self.hops_stats.aggregate_stats
        return (s.mean, s.median, s.max, s.min)

    def get_last_delivery_hop_stats(self):
        self.hops_stats.calc_last_delivery_hop_stats()
        s = self.hops_stats.last_delivery_hop_stats
        return (s.mean, s.median, s.max, s.min)

    def get_stranded_stats(self):
        """11-tuple matching gossip_stats.rs:1572-1602."""
        c = self.stranded_node_collection
        return (c.total_stranded_iterations,
                c.stranded_iterations_per_node,
                c.mean_stranded_per_iteration,
                c.mean_stranded_iterations_per_stranded_node,
                c.median_stranded_iterations_per_stranded_node,
                c.stranded_node_mean_stake,
                c.stranded_node_median_stake,
                c.stranded_node_max_stake,
                c.stranded_node_min_stake,
                c.weighted_stranded_node_mean_stake,
                c.weighted_stranded_node_median_stake)

    def get_stranded_node_stats_by_iteration(self, i):
        return self.stranded_node_collection.per_iter_stats[i]

    def get_outbound_branching_factor_by_index(self, i):
        return self.outbound_branching_factors.get_stat_by_index(i)

    def get_stranded_node_histogram(self):
        return self.stranded_node_collection.histogram

    def get_aggregate_hop_stat_histogram(self):
        return self.hops_stats.histogram

    def get_egress_messages_histogram(self):
        return self.egress_messages.histogram

    def get_ingress_messages_histogram(self):
        return self.ingress_messages.histogram

    def get_prune_message_histogram(self):
        return self.prune_messages.histogram

    def get_validator_stake_distribution_histogram(self):
        return self.validator_stake_distribution

    def is_empty(self):
        return self.coverage_stats.is_empty()

    # -- printing ------------------------------------------------------------

    def _print_stat_collection(self, sc):
        log.info("%s Mean: %.6f", sc.collection_type, sc.mean)
        log.info("%s Median: %.6f", sc.collection_type, sc.median)
        log.info("%s Max: %.6f", sc.collection_type, sc.max)
        log.info("%s Min: %.6f", sc.collection_type, sc.min)

    def _print_histogram(self, name, hist):
        log.info("|---- %s HISTOGRAM W/ %s BUCKETS ----|", name, hist.num_buckets)
        for bucket, count in hist.items():
            lo = hist.min_entry + bucket * hist.bucket_range
            hi = hist.min_entry + (bucket + 1) * hist.bucket_range - 1
            if lo == hi:
                log.info("Bucket: %s: Count: %s", hi, count)
            else:
                log.info("Bucket: %s-%s: Count: %s", lo, hi, count)

    def print_all(self):
        """(gossip_stats.rs:1869-1883)"""
        log.info("|---- COVERAGE STATS ----|")
        self._print_stat_collection(self.coverage_stats)
        log.info("|---- RELATIVE MESSAGE REDUNDANCY (RMR) STATS ----|")
        self._print_stat_collection(self.rmr_stats)
        agg = self.hops_stats.aggregate_stats
        log.info("|---- AGGREGATE HOP STATS ----|")
        log.info("Aggregate Hops Mean: %.6f", agg.mean)
        log.info("Aggregate Hops Median: %.2f", agg.median)
        log.info("Aggregate Hops Max: %s", agg.max)
        self._print_histogram("HOPS STATS", self.hops_stats.histogram)
        ldh = self.hops_stats.last_delivery_hop_stats
        log.info("|---- LAST DELIVERY HOP STATS ----|")
        log.info("LDH Mean: %.6f  Median: %.2f  Max: %s  Min: %s",
                 ldh.mean, ldh.median, ldh.max, ldh.min)
        c = self.stranded_node_collection
        log.info("|---- STRANDED NODE STATS ----|")
        log.info("Total stranded node iterations: %s", c.total_stranded_iterations)
        log.info("Mean iterations a node was stranded: %.6f",
                 c.stranded_iterations_per_node)
        log.info("Mean nodes stranded per iteration: %.6f",
                 c.mean_stranded_per_iteration)
        log.info("Mean iterations a stranded node was stranded: %.6f",
                 c.mean_stranded_iterations_per_stranded_node)
        log.info("Median iterations a stranded node was stranded: %s",
                 c.median_stranded_iterations_per_stranded_node)
        log.info("Mean stake: %.2f  Median stake: %s  Max: %s  Min: %s",
                 c.stranded_node_mean_stake, c.stranded_node_median_stake,
                 c.stranded_node_max_stake, c.stranded_node_min_stake)
        log.info("Mean weighted stake: %.2f  Median weighted stake: %s",
                 c.weighted_stranded_node_mean_stake,
                 c.weighted_stranded_node_median_stake)
        self._print_histogram("STRANDED NODES", c.histogram)
        log.info("Total stranded nodes: %s", c.stranded_count())
        log.info("Total failed: %s", len(self.failed_nodes))
        log.info("|---- OUTBOUND BRANCHING FACTOR ----|")
        self._print_stat_collection(self.outbound_branching_factors)
        self._print_histogram("EGRESS MESSAGES", self.egress_messages.histogram)
        if self.has_delivery_stats():
            log.info("|---- DEGRADED DELIVERY STATS ----|")
            for sc in (self.delivered_stats, self.dropped_stats,
                       self.suppressed_stats):
                self._print_stat_collection(sc)
            if self.failed_count_series:
                log.info("Failed nodes (last measured round): %s",
                         self.failed_count_series[-1])
        if self.has_pull_stats():
            log.info("|---- PULL (ANTI-ENTROPY) STATS ----|")
            for sc in (self.pull_requests_stats, self.pull_responses_stats,
                       self.pull_misses_stats, self.pull_rescued_stats):
                self._print_stat_collection(sc)
            log.info("Pull dropped total: %s  Pull suppressed total: %s",
                     int(sum(self.pull_dropped_stats.collection)),
                     int(sum(self.pull_suppressed_stats.collection)))
        if self.recovery_iterations is not None:
            if self.recovery_iterations >= 0:
                log.info("Coverage recovered %s iteration(s) after heal",
                         self.recovery_iterations)
            else:
                log.info("Coverage did NOT recover after heal within the run")


class GossipStatsCollection:
    """Across-simulation aggregation (gossip_stats.rs:1886-1965)."""

    def __init__(self):
        self.collection = []
        self.num_sims = 0

    def set_number_of_simulations(self, n):
        self.num_sims = n

    def push(self, stats: GossipStats):
        self.collection.append(stats)

    def is_empty(self):
        return not self.collection

    def print_all(self, gossip_iterations, warm_up_rounds, test_type):
        measured = gossip_iterations - warm_up_rounds
        log.info("|--- GOSSIP STATS COLLECTION ACROSS ALL %s SIMULATION(S) ---|",
                 self.num_sims)
        log.info("|--- Gossip Iterations: %s", gossip_iterations)
        log.info("|--- Warm Up Rounds: %s", warm_up_rounds)
        log.info("|--- Total Measured Rounds For Gossip Stats: %s", measured)
        log.info("|--- Test Type: %s", test_type)
        for i, stats in enumerate(self.collection):
            log.info("Simulation Iteration: %s, Origin: %s", i, stats.origin)
            stats.print_all()
        total = sum(s.stranded_node_collection.total_stranded_iterations
                    for s in self.collection)
        log.info("Total stranded node iterations across all simulations %s", total)
