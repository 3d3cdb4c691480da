"""Stranded-node statistics (reference: gossip_stats.rs:745-1166).

``StrandedNodeStats``: per-iteration stake stats over the stranded set.
``StrandedNodeCollection``: cumulative per-node stranded counts plus plain and
*weighted* stake stats — each strand event re-counts the node's stake
(gossip_stats.rs:974-1028) — and a stranded-count histogram.
"""

from __future__ import annotations

from .histogram import Histogram


def _median(sorted_vals):
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    if n % 2 == 0:
        return (sorted_vals[n // 2 - 1] + sorted_vals[n // 2]) / 2.0
    return float(sorted_vals[n // 2])


class StrandedNodeStats:
    """Per-iteration stranded stake stats (gossip_stats.rs:766-843)."""

    def __init__(self, stranded_nodes=None, stakes=None):
        if not stranded_nodes:
            self.count = 0
            self.mean_stake = 0.0
            self.median_stake = 0.0
            self.max_stake = 0
            self.min_stake = 0
            return
        vals = sorted(stakes[pk] for pk in stranded_nodes)
        self.count = len(vals)
        self.mean_stake = sum(vals) / len(vals)
        self.median_stake = _median(vals)
        self.max_stake = vals[-1]
        self.min_stake = vals[0]


class StrandedNodeCollection:
    def __init__(self):
        self.per_iter_stats = []
        self.stranded_nodes = {}  # pubkey -> (stake, times_stranded)
        self.total_gossip_iterations = 0
        self.total_stranded_iterations = 0
        self.mean_stranded_per_iteration = 0.0
        self.mean_stranded_iterations_per_stranded_node = 0.0
        self.median_stranded_iterations_per_stranded_node = 0.0
        self.stranded_iterations_per_node = 0.0
        self.total_nodes = 0
        self.total_stranded_stake = 0
        self.stranded_node_mean_stake = 0.0
        self.stranded_node_median_stake = 0.0
        self.stranded_node_max_stake = 0
        self.stranded_node_min_stake = 0
        self.weighted_total_stranded_stake = 0
        self.weighted_stranded_node_mean_stake = 0.0
        self.weighted_stranded_node_median_stake = 0.0
        self.histogram = Histogram()

    def insert_nodes(self, stranded_nodes, stakes):
        """Record one iteration's stranded set (gossip_stats.rs:1040-1061)."""
        self.per_iter_stats.append(StrandedNodeStats(stranded_nodes, stakes))
        for pk in stranded_nodes:
            if pk in self.stranded_nodes:
                stake, count = self.stranded_nodes[pk]
                self.stranded_nodes[pk] = (stake, count + 1)
            elif pk in stakes:
                self.stranded_nodes[pk] = (stakes[pk], 1)
        self.total_gossip_iterations += 1
        if self.total_nodes == 0:
            self.total_nodes = len(stakes)

    def calculate_stats(self):
        """(gossip_stats.rs:964-1038)"""
        self.total_stranded_iterations = 0
        self.total_stranded_stake = 0
        self.weighted_total_stranded_stake = 0
        iter_counts, stranded_stakes, weighted_stakes = [], [], []
        for stake, times in self.stranded_nodes.values():
            self.total_stranded_iterations += times
            iter_counts.append(times)
            self.total_stranded_stake += stake
            self.weighted_total_stranded_stake += stake * times
            stranded_stakes.append(stake)
            weighted_stakes.extend([stake] * times)

        count = len(self.stranded_nodes)
        self.mean_stranded_per_iteration = (
            self.total_stranded_iterations / self.total_gossip_iterations
            if self.total_gossip_iterations else 0.0)
        self.stranded_node_mean_stake = (
            self.total_stranded_stake / count if count else float("nan"))
        self.mean_stranded_iterations_per_stranded_node = (
            self.total_stranded_iterations / count if count else float("nan"))
        self.weighted_stranded_node_mean_stake = (
            self.weighted_total_stranded_stake / self.total_stranded_iterations
            if self.total_stranded_iterations else float("nan"))
        self.stranded_iterations_per_node = (
            self.total_stranded_iterations / self.total_nodes
            if self.total_nodes else 0.0)

        iter_counts.sort()
        stranded_stakes.sort()
        weighted_stakes.sort()
        self.median_stranded_iterations_per_stranded_node = _median(iter_counts)
        self.stranded_node_median_stake = _median(stranded_stakes)
        self.weighted_stranded_node_median_stake = _median(weighted_stakes)
        self.stranded_node_max_stake = stranded_stakes[-1] if stranded_stakes else 0
        self.stranded_node_min_stake = stranded_stakes[0] if stranded_stakes else 0

    def get_sorted_stranded(self):
        """Sorted by (times stranded desc, stake desc)
        (gossip_stats.rs:1069-1083)."""
        return sorted(self.stranded_nodes.items(),
                      key=lambda kv: (-kv[1][1], -kv[1][0]))

    def stranded_count(self):
        return len(self.stranded_nodes)

    def build_histogram(self, upper_bound, lower_bound, num_buckets):
        self.histogram.build(
            upper_bound, lower_bound, num_buckets,
            [times for _, times in self.stranded_nodes.values()])
