"""Concurrent-traffic statistics (the port's copy of the reference
package's ``stats/traffic.py``).

A traffic run produces per-round contention series (queue depths,
deferrals, drops across the whole value axis) and per-value retirement
records (coverage, latency, RMR per injected value).  ``TrafficStats``
collects both and gives the deterministic ``parity_snapshot()`` (held
against the reference package's), the ``summary()`` the run report, the
end-of-run Influx point and the CLI summary line read, and
``state_dict``/``load_state_dict``, which a ``kind="traffic"`` checkpoint
carries as ``meta["traffic_stats"]`` (checkpoint.py).
"""

from __future__ import annotations

import numpy as np

#: the per-round series (the engine's rows of the same names)
ROUND_FIELDS = [
    "injected", "inject_dropped", "live", "sends", "deferred",
    "failed_target", "suppressed", "dropped", "arrived", "queue_dropped",
    "accepted", "delivered", "redundant", "prunes_sent", "retired",
    "converged", "hop_clamped", "qdepth_max", "inflow_max",
]

#: per-value retirement record keys (traffic.retire_record); the last
#: three root-cause the terminal state: every record carries its cause and
#: its rescue and queue-drop evidence
RECORD_FIELDS = ["vid", "origin", "birth", "retired_at", "latency_rounds",
                 "holders", "coverage", "m", "rmr", "converged", "mean_hop",
                 "rescued_by_pull", "qdrops", "cause"]

#: the per-round adaptive pull-rescue series (fed only under gossip_mode
#: "adaptive", and emitted as the ``sim_adaptive`` Influx series)
ADAPTIVE_ROUND_FIELDS = [
    "pull_sent", "pull_deferred", "pull_failed_target", "pull_suppressed",
    "pull_dropped", "pull_arrived", "pull_queue_dropped", "pull_served",
    "pull_responses", "pull_rescued", "pull_active_values",
    "switched_to_pull",
]


class TrafficStats:
    """Per-round series + per-value records of one traffic simulation."""

    def __init__(self):
        self.rounds = {k: [] for k in ROUND_FIELDS}
        self.adaptive_rounds = {k: [] for k in ADAPTIVE_ROUND_FIELDS}
        self.iterations = []
        self.records = []          # retirement record dicts, vid order
        self.final = {}            # end-of-run accumulator summary

    # -- feeds ------------------------------------------------------------

    def feed_round(self, it: int, values: dict) -> None:
        self.iterations.append(int(it))
        for k in ROUND_FIELDS:
            self.rounds[k].append(int(values[k]))
        if "pull_sent" in values:
            # adaptive mode: the pull-rescue series rides along
            for k in ADAPTIVE_ROUND_FIELDS:
                self.adaptive_rounds[k].append(int(values[k]))

    def feed_records(self, records) -> None:
        self.records.extend(records)

    def feed_final(self, final: dict) -> None:
        """End-of-run totals read off the engine state: the measured-round
        accumulators plus the live (unfinished) value count."""
        self.final = {k: (int(v) if np.isscalar(v) or isinstance(v, int)
                          else [int(x) for x in v])
                      for k, v in final.items()}

    def is_empty(self) -> bool:
        return not self.iterations

    # -- parity / persistence -----------------------------------------------

    def parity_snapshot(self) -> dict:
        """Every deterministic series and record as one dict: the traffic
        twin of GossipStats.parity_snapshot, the surface two runs (and the
        reference package's run) must agree on.  The adaptive series
        appears only when it was fed."""
        snap = {
            "iterations": list(self.iterations),
            "rounds": {k: list(v) for k, v in self.rounds.items()},
            "records": [
                {f: rec[f] for f in RECORD_FIELDS} for rec in self.records],
            "final": dict(self.final),
        }
        if any(self.adaptive_rounds.values()):
            snap["adaptive_rounds"] = {
                k: list(v) for k, v in self.adaptive_rounds.items()}
        return snap

    def state_dict(self) -> dict:
        return self.parity_snapshot()

    def load_state_dict(self, d: dict) -> None:
        self.iterations = [int(x) for x in d.get("iterations", [])]
        self.rounds = {k: [int(x) for x in d.get("rounds", {}).get(k, [])]
                       for k in ROUND_FIELDS}
        self.adaptive_rounds = {
            k: [int(x) for x in d.get("adaptive_rounds", {}).get(k, [])]
            for k in ADAPTIVE_ROUND_FIELDS}
        self.records = []
        for r in d.get("records", []):
            rec = dict(r)
            # pre-v7 checkpoints: records predate the root-causing fields
            rec.setdefault("rescued_by_pull", 0)
            rec.setdefault("qdrops", 0)
            rec.setdefault("cause", "converged" if rec.get("converged")
                           else "stalled")
            self.records.append(rec)
        self.final = dict(d.get("final", {}))

    # -- aggregation ------------------------------------------------------

    def summary(self) -> dict:
        """Flat aggregate dict for the run report, the end-of-run Influx
        point, and the CLI summary line."""
        recs = self.records
        lat = np.asarray([r["latency_rounds"] for r in recs], np.float64)
        cov = np.asarray([r["coverage"] for r in recs], np.float64)
        rmr = np.asarray([r["rmr"] for r in recs], np.float64)
        tot = {k: int(np.sum(self.rounds[k], dtype=np.int64))
               for k in ("injected", "inject_dropped", "sends", "deferred",
                         "queue_dropped", "dropped", "suppressed",
                         "delivered", "redundant", "accepted",
                         "prunes_sent", "retired", "converged",
                         "hop_clamped")}
        causes = [r.get("cause") for r in recs]
        pull_qdrop = int(np.sum(self.adaptive_rounds["pull_queue_dropped"],
                                dtype=np.int64))
        pull_def = int(np.sum(self.adaptive_rounds["pull_deferred"],
                              dtype=np.int64))
        out = {
            "measured_rounds": len(self.iterations),
            "values_injected": tot["injected"],
            "values_retired": tot["retired"],
            "values_converged": tot["converged"],
            "values_stranded": tot["retired"] - tot["converged"],
            # terminal-cause attribution (traffic.terminal_cause): every
            # retired value is exactly one of converged / rescued_by_pull
            # / starved_queue_drop / stalled
            "values_rescued": causes.count("rescued_by_pull"),
            "values_starved_queue_drop": causes.count("starved_queue_drop"),
            "values_stalled": causes.count("stalled"),
            "nodes_rescued": int(sum(r.get("rescued_by_pull", 0)
                                     for r in recs)),
            "values_unfinished": int(self.final.get("live_at_end", 0)),
            "inject_dropped": tot["inject_dropped"],
            "sends": tot["sends"],
            "delivered": tot["delivered"],
            "redundant": tot["redundant"],
            "loss_dropped": tot["dropped"],
            "suppressed": tot["suppressed"],
            "queue_deferred": tot["deferred"],
            "queue_dropped": tot["queue_dropped"],
            # queue-drop side attribution: the ingress side is every
            # arrival over a receiver's cap (push arrivals, and pull
            # requests in adaptive mode), the egress side the sender-cap
            # deferrals; "queue_dropped" above counts push arrivals only
            "queue_dropped_ingress": tot["queue_dropped"] + pull_qdrop,
            "queue_deferred_egress": tot["deferred"] + pull_def,
            "prunes_sent": tot["prunes_sent"],
            "hop_clamped": tot["hop_clamped"],
            "qdepth_max": int(max(self.rounds["qdepth_max"], default=0)),
            "inflow_max": int(max(self.rounds["inflow_max"], default=0)),
            "live_max": int(max(self.rounds["live"], default=0)),
        }
        if any(self.adaptive_rounds.values()):
            # adaptive pull-rescue totals (sim_adaptive series aggregate)
            out.update({f"adaptive_{k}": int(np.sum(self.adaptive_rounds[k],
                                                    dtype=np.int64))
                        for k in ("pull_sent", "pull_responses",
                                  "pull_rescued", "pull_deferred",
                                  "pull_queue_dropped",
                                  "switched_to_pull")})
        if len(recs):
            out.update({
                "value_latency_mean": float(lat.mean()),
                "value_latency_p50": float(np.percentile(lat, 50)),
                "value_latency_p90": float(np.percentile(lat, 90)),
                "value_latency_max": int(lat.max()),
                "value_coverage_mean": float(cov.mean()),
                "value_coverage_min": float(cov.min()),
                "value_rmr_mean": float(rmr.mean()),
            })
        else:
            out.update({
                "value_latency_mean": 0.0, "value_latency_p50": 0.0,
                "value_latency_p90": 0.0, "value_latency_max": 0,
                "value_coverage_mean": 0.0, "value_coverage_min": 0.0,
                "value_rmr_mean": 0.0,
            })
        return out


class TrafficStatsCollection:
    """Sweep-ordered TrafficStats (one per sweep point)."""

    def __init__(self):
        self.collection = []
        self.points = []      # the swept knob value per point

    def push(self, point_value, stats: TrafficStats) -> None:
        self.points.append(point_value)
        self.collection.append(stats)

    def is_empty(self) -> bool:
        return not self.collection

    def summaries(self) -> list:
        return [dict(point=p, **s.summary())
                for p, s in zip(self.points, self.collection)]
