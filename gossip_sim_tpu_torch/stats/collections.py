"""Generic f64 series -> mean/median/max/min (reference: gossip_stats.rs:229-347)."""

from __future__ import annotations


def _seq_sum(values):
    """Plain sequential f64 accumulation (Python's builtin ``sum`` is
    compensated since 3.12; the reference's ``iter().sum::<f64>()`` is not)."""
    acc = 0.0
    for v in values:
        acc += v
    return acc


class StatCollection:
    def __init__(self, collection_type=""):
        self.collection = []
        self.mean = 0.0
        self.median = 0.0
        self.max = 0.0
        self.min = 0.0
        self.collection_type = collection_type

    def push(self, value):
        self.collection.append(float(value))

    def calculate_stats(self):
        data = sorted(self.collection)
        n = len(data)
        self.mean = _seq_sum(data) / n if n else float("nan")
        if n == 0:
            self.median = float("nan")
        elif n % 2 == 0:
            self.median = (data[n // 2 - 1] + data[n // 2]) / 2.0
        else:
            self.median = data[n // 2]
        self.max = data[-1] if data else 0.0
        self.min = data[0] if data else 0.0

    def get_stat_by_index(self, index):
        return self.collection[index]

    def is_empty(self):
        return not self.collection

    def summary(self):
        return (self.mean, self.median, self.max, self.min)
