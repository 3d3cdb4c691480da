"""Per-node message-count trackers with stake-bucketed histograms
(reference: gossip_stats.rs:359-461) and the outbound branching factor
(gossip_stats.rs:1168-1191)."""

from __future__ import annotations

from .histogram import Histogram


class EgressIngressMessageTracker:
    def __init__(self):
        self.counts = {}  # pubkey -> cumulative message count
        self.count_per_bucket = []
        self.histogram = Histogram()

    def initialize_counts_map(self, stakes):
        for pk in stakes:
            self.counts[pk] = 0

    def update_message_counts(self, new_messages):
        for pk, n in new_messages.items():
            self.counts[pk] += n

    def build_histogram(self, num_buckets, stakes):
        sorted_stakes = sorted(stakes.items(), key=lambda kv: -kv[1])
        self.count_per_bucket = [0] * num_buckets
        self.histogram.build_from_map(num_buckets, self.counts, sorted_stakes,
                                      self.count_per_bucket)

    def normalize_message_counts(self):
        self.histogram.normalize_histogram(self.count_per_bucket)

    def clear(self):
        for pk in self.counts:
            self.counts[pk] = 0


def branching_factor_outbound(pushes):
    """Mean outbound degree over visited nodes: sum(|pushes[src]|) / |pushes|
    (gossip_stats.rs:1174-1190)."""
    if not pushes:
        return 0.0
    return sum(len(d) for d in pushes.values()) / len(pushes)
