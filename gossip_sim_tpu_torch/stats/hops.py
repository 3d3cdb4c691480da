"""Hop-count statistics (reference: gossip_stats.rs:27-227).

``HopsStat`` filters unreached (u64::MAX) and origin (0) distances, then takes
mean/median/max/min (gossip_stats.rs:46-98).  ``HopsStatCollection``
accumulates raw hops across rounds (keeping 0s, dropping unreached —
gossip_stats.rs:163-175), producing aggregate stats, last-delivery-hop stats
(stats over per-round max, gossip_stats.rs:196-204) and a histogram.
"""

from __future__ import annotations

from ..constants import UNREACHED
from .histogram import Histogram


class HopsStat:
    def __init__(self, hops=None):
        if not hops:
            self.mean = 0.0
            self.median = 0.0
            self.max = 0
            self.min = 0
            return
        filtered = sorted(h for h in hops if h != UNREACHED and h != 0)
        count = len(filtered)
        self.mean = (sum(filtered) / count) if count else float("nan")
        if count == 0:
            self.median = 0.0
        elif count == 1:
            self.median = float(filtered[0])
        elif count % 2 == 0:
            mid = count // 2
            self.median = (filtered[mid - 1] + filtered[mid]) / 2.0
        else:
            self.median = float(filtered[count // 2])
        self.max = filtered[-1] if filtered else 0
        self.min = filtered[0] if filtered else 0


class HopsStatCollection:
    def __init__(self):
        self.per_round_stats = []
        self.raw_hop_collection = []
        self.aggregate_stats = HopsStat()
        self.last_delivery_hop_stats = HopsStat()
        self.histogram = Histogram()

    def insert(self, hops):
        self.per_round_stats.append(HopsStat(list(hops)))
        self.raw_hop_collection.extend(h for h in hops if h != UNREACHED)

    def get_stat_by_iteration(self, index):
        return self.per_round_stats[index]

    def aggregate_hop_stats(self):
        self.aggregate_stats = HopsStat(self.raw_hop_collection)

    def calc_last_delivery_hop_stats(self):
        self.last_delivery_hop_stats = HopsStat(
            [s.max for s in self.per_round_stats])

    def build_histogram(self, upper_bound, lower_bound, num_buckets):
        self.histogram.build(upper_bound, lower_bound, num_buckets,
                             self.raw_hop_collection)
