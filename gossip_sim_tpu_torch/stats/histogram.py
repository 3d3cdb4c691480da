"""Fixed-bucket histogram (reference: gossip_stats.rs:549-743).

Two build modes:
  * ``build`` — bucket raw u64 values into ``num_buckets`` equal ranges over
    [lower_bound, upper_bound] (gossip_stats.rs:575-619).
  * ``build_from_map`` — bucket nodes **by stake** and sum each node's message
    count into its stake bucket (gossip_stats.rs:621-666); used for the
    egress/ingress/prune message histograms.
``normalize_histogram`` divides each bucket by a per-bucket node count
(gossip_stats.rs:672-682).
"""

from __future__ import annotations

import logging

log = logging.getLogger(__name__)


class Histogram:
    def __init__(self):
        self.entries = {}  # bucket -> count, kept sorted by bucket on read
        self.min_entry = 0
        self.max_entry = 0
        self.bucket_range = 0
        self.num_buckets = 0

    def build(self, upper_bound, lower_bound, num_buckets, values):
        # NOTE: like the reference (gossip_stats.rs:608-611), only
        # ``bucket == num_buckets`` is clamped — when
        # (upper-lower)/num_buckets truncates, in-range values near the
        # upper bound land in buckets beyond num_buckets-1.  Kept for
        # output parity with the reference's BTreeMap behavior.
        self.min_entry = int(lower_bound)
        self.max_entry = int(upper_bound)
        self.num_buckets = int(num_buckets)
        if upper_bound == lower_bound or lower_bound + 1 == upper_bound:
            log.warning("histogram: max and min entries equal or off by 1")
            self.bucket_range = 1
        else:
            # floor to >= 1: the reference divides by an unchecked u64 range
            # (gossip_stats.rs:588) and would panic when range < num_buckets
            self.bucket_range = max(
                1, (self.max_entry - self.min_entry) // self.num_buckets)
        self.entries = {b: 0 for b in range(self.num_buckets)}
        for v in values:
            v = int(v)
            if self.min_entry <= v <= self.max_entry:
                bucket = (v - self.min_entry) // self.bucket_range
                if bucket == self.num_buckets:
                    bucket -= 1
                self.entries[bucket] = self.entries.get(bucket, 0) + 1
            else:
                log.error("histogram: entry %s outside [%s, %s]",
                          v, self.min_entry, self.max_entry)

    def build_from_counts(self, upper_bound, lower_bound, num_buckets,
                          value_counts):
        """``build`` semantics fed pre-binned data: ``value_counts`` maps a
        value -> how many times it occurred.  Avoids materializing raw-value
        arrays when the source is an on-device histogram."""
        self.min_entry = int(lower_bound)
        self.max_entry = int(upper_bound)
        self.num_buckets = int(num_buckets)
        if upper_bound == lower_bound or lower_bound + 1 == upper_bound:
            log.warning("histogram: max and min entries equal or off by 1")
            self.bucket_range = 1
        else:
            self.bucket_range = max(
                1, (self.max_entry - self.min_entry) // self.num_buckets)
        self.entries = {b: 0 for b in range(self.num_buckets)}
        for v, n in value_counts.items():
            v = int(v)
            if self.min_entry <= v <= self.max_entry:
                bucket = (v - self.min_entry) // self.bucket_range
                if bucket == self.num_buckets:
                    bucket -= 1
                self.entries[bucket] = self.entries.get(bucket, 0) + int(n)
            else:
                log.error("histogram: entry %s outside [%s, %s]",
                          v, self.min_entry, self.max_entry)

    def build_from_map(self, num_buckets, counts, sorted_stakes, count_per_bucket):
        """counts: {pubkey: message count}; sorted_stakes: [(pubkey, stake)]
        descending by stake. Buckets are stake ranges; values are summed
        message counts (gossip_stats.rs:621-666)."""
        self.min_entry = 0
        self.max_entry = int(sorted_stakes[0][1])
        self.num_buckets = int(num_buckets)
        if self.max_entry == self.min_entry:
            log.warning("histogram: max and min entries equal")
            self.bucket_range = 1
        else:
            self.bucket_range = (self.max_entry - self.min_entry) // self.num_buckets
            if self.bucket_range == 0:
                self.bucket_range = 1
        self.entries = {b: 0 for b in range(self.num_buckets)}
        for pubkey, stake in sorted_stakes:
            msgs = counts[pubkey]
            if self.min_entry <= stake <= self.max_entry:
                bucket = (int(stake) - self.min_entry) // self.bucket_range
                if bucket >= self.num_buckets:
                    bucket = self.num_buckets - 1
                self.entries[bucket] = self.entries.get(bucket, 0) + msgs
                count_per_bucket[bucket] += 1
            else:
                log.error("message histogram: stake %s outside bounds", stake)

    def normalize_histogram(self, normalization_vector):
        for bucket in list(self.entries):
            n = normalization_vector[bucket]
            if n:
                self.entries[bucket] //= n

    def items(self):
        return sorted(self.entries.items())
