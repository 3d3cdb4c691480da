"""Cross-origin aggregate statistics for ``--all-origins`` mode.

The single-origin path harvests per-iteration detail arrays and feeds the
reference-shaped ``GossipStats`` (gossip_stats.rs:1228-1884).  At all-origins
scale (N origins x iterations) that would mean shipping [O, N] detail off
device every round, so the engine instead accumulates everything on device —
``hops_hist_acc``, ``stranded_acc``, ``egress/ingress/prune_acc`` plus the
per-round scalar rows — and this module turns those accumulators into the
same statistics the reference prints and reports: coverage/RMR collections
(gossip_stats.rs:229-347), aggregate-hop and last-delivery-hop stats
(gossip_stats.rs:27-227), the 11 stranded-node stats (gossip_stats.rs:
964-1038), branching factor, and the stake-bucketed message histograms
(gossip_stats.rs:359-461).

Divergence note: aggregate hop mean/median/max come from the on-device hop
histogram, whose top bin clamps hops >= hist_bins-1 (64 by default, far
above the ~11-hop diameters seen in practice, README.md:232-241).

The port's own copy of the reference package's ``stats/aggregate.py``
(numpy only, same fields, same results).
"""

from __future__ import annotations

import logging

import numpy as np

from .collections import StatCollection
from .histogram import Histogram
from .hops import HopsStat
from .stranded import StrandedNodeCollection
from .trackers import EgressIngressMessageTracker

log = logging.getLogger(__name__)


def lane_rows(rows: dict, lane: int) -> dict:
    """One sweep lane's rows out of a lane-batched engine harvest.

    ``run_rounds_lanes`` (engine/lanes.py) returns rows with a lane axis
    after the iteration axis — every leaf is ``[iters, K, ...]`` where a
    serial ``run_rounds`` harvest is ``[iters, ...]``.  Slicing one lane
    restores exactly the serial shape, so the per-sim stats feeders
    (cli._feed_measured_round and friends) consume a lane unchanged: the
    lane-batched sweep and the serial sweep flow through one stats path
    and can never drift.  Works on device arrays and the np.asarray'd
    harvest alike."""
    return {k: v[:, lane] for k, v in rows.items()}


class HistogramHopsStat:
    """HopsStat (mean/median/max/min, zeros filtered) computed from binned
    counts instead of raw values (gossip_stats.rs:46-98 semantics)."""

    def __init__(self, counts: np.ndarray):
        counts = np.asarray(counts, dtype=np.int64).copy()
        if counts.size:
            counts[0] = 0               # hop 0 = the origin itself; filtered
        total = int(counts.sum())
        if total == 0:
            self.mean, self.median, self.max, self.min = 0.0, 0.0, 0, 0
            return
        hops = np.arange(counts.size, dtype=np.int64)
        self.mean = float((hops * counts).sum() / total)
        cum = np.cumsum(counts)
        lo_i, hi_i = (total - 1) // 2, total // 2
        lo_v = int(np.searchsorted(cum, lo_i, side="right"))
        hi_v = int(np.searchsorted(cum, hi_i, side="right"))
        self.median = (lo_v + hi_v) / 2.0
        nz = np.nonzero(counts)[0]
        self.max = int(nz[-1])
        self.min = int(nz[0])


class AllOriginsStats:
    """Aggregates engine rows + on-device accumulators across origin batches
    into reference-shaped statistics.

    Per-point series stay as numpy chunks (measured_points reaches ~1e7 at
    the 10k-origins x 1000-iterations target; boxed-float lists would cost
    GBs); finalize() computes the StatCollection summaries vectorized."""

    def __init__(self, index, hist_bins: int):
        self.index = index               # NodeIndex (pubkeys <-> stakes)
        self.N = len(index)
        self.hist_bins = hist_bins
        self.coverage_stats = StatCollection("Coverage")
        self.rmr_stats = StatCollection("RMR")
        self.branching_stats = StatCollection("Outbound Branching Factor")
        self.delivered_stats = StatCollection("Delivered Messages")
        self.dropped_stats = StatCollection("Dropped Messages")
        self.suppressed_stats = StatCollection("Suppressed Messages")
        self.failed_stats = StatCollection("Failed Nodes")
        # pull-phase aggregates (pull.py); empty unless a pull mode ran
        self.pull_requests_stats = StatCollection("Pull Requests")
        self.pull_responses_stats = StatCollection("Pull Responses")
        self.pull_misses_stats = StatCollection("Pull Misses")
        self.pull_rescued_stats = StatCollection("Pull Rescued Nodes")
        self._chunks = {"coverage": [], "rmr": [], "branching": [],
                        "ldh": [], "delivered": [], "dropped": [],
                        "suppressed": [], "failed": [],
                        "pull_requests": [], "pull_responses": [],
                        "pull_misses": [],
                        "pull_rescued": []}  # per-batch [measured*O] arrays
        self.hops_hist = np.zeros(hist_bins, np.int64)
        self.stranded_counts = np.zeros(self.N, np.int64)
        self.egress = np.zeros(self.N, np.int64)
        self.ingress = np.zeros(self.N, np.int64)
        self.prunes = np.zeros(self.N, np.int64)
        self.measured_points = 0         # (round, origin) pairs measured
        self.num_origins = 0
        self.inb_dropped = 0
        self.rc_overflow = 0
        self.hop_clamped = 0             # hops clamped into the top bin
        self.total_dropped = 0           # loss-dropped messages (measured)
        self.total_suppressed = 0        # partition-suppressed (measured)
        self.impaired = False            # set by finalize(config)
        self.pull = False                # a pull mode ran (set by finalize)
        self.total_pull_requests = 0     # arrived pull requests (measured)
        self.total_pull_responses = 0    # pull value transfers (measured)
        self.total_pull_rescued = 0      # pull-rescued (origin, round) pairs
        self.total_pull_dropped = 0      # loss-dropped pull requests
        self.total_pull_suppressed = 0   # partition-suppressed pull requests
        self.pull_hops_hist = np.zeros(hist_bins, np.int64)
        self.pull_rescued_counts = np.zeros(self.N, np.int64)
        # per-origin iterations-to-recover coverage after heal (faults.py);
        # -1 = that origin never recovered within the run
        self.recovery_iters = []
        # filled by finalize():
        self.aggregate_hops = HopsStat()
        self.ldh_stats = HopsStat()
        self.stranded = StrandedNodeCollection()
        self.hops_histogram = Histogram()
        self.egress_tracker = EgressIngressMessageTracker()
        self.ingress_tracker = EgressIngressMessageTracker()
        self.prune_tracker = EgressIngressMessageTracker()

    # -- per-batch accumulation -------------------------------------------

    def add_batch(self, rows, state, warm_up_rounds: int, heal_at: int = -1,
                  impaired: bool = False, pull: bool = False):
        """Fold one origin batch's rows (leading [iters] axis) + final
        SimState accumulators (already warm-up-gated on device).

        ``heal_at`` >= 0 additionally extracts per-origin
        iterations-to-recover-coverage from the full (unwarmed) coverage
        series.  ``impaired`` gates the delivery-counter accumulation —
        the engine always emits the counter rows (all-zero when the knobs
        are off), so unimpaired runs must not retain them.  ``pull`` gates
        the pull-phase counters (pull.py) the same way."""
        cov = np.asarray(rows["coverage"])[warm_up_rounds:]
        if cov.size:
            self._chunks["coverage"].append(
                cov.ravel().astype(np.float64))
            self._chunks["rmr"].append(
                np.asarray(rows["rmr"])[warm_up_rounds:]
                .ravel().astype(np.float64))
            self._chunks["branching"].append(
                np.asarray(rows["branching"])[warm_up_rounds:]
                .ravel().astype(np.float64))
            self._chunks["ldh"].append(
                np.asarray(rows["hop_max"])[warm_up_rounds:]
                .ravel().astype(np.int64))
            if impaired:
                for key, row_key in (("delivered", "delivered"),
                                     ("dropped", "dropped"),
                                     ("suppressed", "suppressed"),
                                     ("failed", "failed_count")):
                    self._chunks[key].append(
                        np.asarray(rows[row_key])[warm_up_rounds:]
                        .ravel().astype(np.float64))
            if pull:
                for key in ("pull_requests", "pull_responses",
                            "pull_misses", "pull_rescued"):
                    self._chunks[key].append(
                        np.asarray(rows[key])[warm_up_rounds:]
                        .ravel().astype(np.float64))
        if impaired:
            self.total_dropped += int(
                np.asarray(rows["dropped"])[warm_up_rounds:].sum())
            self.total_suppressed += int(
                np.asarray(rows["suppressed"])[warm_up_rounds:].sum())
        if pull:
            self.total_pull_requests += int(
                np.asarray(rows["pull_requests"])[warm_up_rounds:].sum())
            self.total_pull_responses += int(
                np.asarray(rows["pull_responses"])[warm_up_rounds:].sum())
            self.total_pull_rescued += int(
                np.asarray(rows["pull_rescued"])[warm_up_rounds:].sum())
            self.total_pull_dropped += int(
                np.asarray(rows["pull_dropped"])[warm_up_rounds:].sum())
            self.total_pull_suppressed += int(
                np.asarray(rows["pull_suppressed"])[warm_up_rounds:].sum())
            self.pull_hops_hist += np.asarray(
                state.pull_hops_hist_acc, dtype=np.int64).sum(axis=0)
            self.pull_rescued_counts += np.asarray(
                state.pull_rescued_acc, dtype=np.int64).sum(axis=0)
        if "hop_clamped" in rows:
            # measured rounds only, matching the warm-up-gated hops
            # histogram this guard is about (and the single-origin path)
            self.hop_clamped += int(
                np.asarray(rows["hop_clamped"])[warm_up_rounds:].sum())
        if heal_at >= 0:
            from ..constants import COVERAGE_RECOVERY_THRESHOLD
            cov_full = np.asarray(rows["coverage"])       # [iters, O]
            after = cov_full[heal_at:] >= COVERAGE_RECOVERY_THRESHOLD
            if after.shape[0]:
                hit = after.any(axis=0)
                first = after.argmax(axis=0)
                self.recovery_iters.extend(
                    int(first[o]) if hit[o] else -1
                    for o in range(after.shape[1]))
        self.hops_hist += np.asarray(state.hops_hist_acc,
                                     dtype=np.int64).sum(axis=0)
        self.stranded_counts += np.asarray(state.stranded_acc,
                                           dtype=np.int64).sum(axis=0)
        self.egress += np.asarray(state.egress_acc, np.int64).sum(axis=0)
        self.ingress += np.asarray(state.ingress_acc, np.int64).sum(axis=0)
        self.prunes += np.asarray(state.prune_acc, np.int64).sum(axis=0)
        self.inb_dropped += int(np.asarray(rows["inb_dropped"]).sum())
        self.rc_overflow += int(np.asarray(rows["rc_overflow"]).sum())
        self.measured_points += int(cov.size)
        self.num_origins += int(np.asarray(rows["coverage"]).shape[-1])

    # -- resumable snapshot (the journal's sidecar, ROADMAP A14) ----------

    _SCALAR_STATE = ("measured_points", "num_origins", "inb_dropped",
                     "rc_overflow", "hop_clamped", "total_dropped",
                     "total_suppressed", "total_pull_requests",
                     "total_pull_responses", "total_pull_rescued",
                     "total_pull_dropped", "total_pull_suppressed")
    _ARRAY_STATE = ("hops_hist", "stranded_counts", "egress", "ingress",
                    "prunes", "pull_hops_hist", "pull_rescued_counts")

    def state_dict(self) -> dict:
        """Everything ``add_batch`` has accumulated, as npz-ready arrays.
        The reference's all-origins journal snapshots this after each
        committed origin batch (the port's is ROADMAP A14);
        ``load_state_dict`` + the remaining
        batches reproduce an uninterrupted run exactly — the per-point
        chunks concatenate to the same series ``finalize`` would see."""
        out = {}
        for f in self._SCALAR_STATE:
            out["scalar." + f] = np.int64(getattr(self, f))
        for f in self._ARRAY_STATE:
            out["array." + f] = np.asarray(getattr(self, f))
        out["array.recovery_iters"] = np.asarray(self.recovery_iters,
                                                 np.int64)
        for k, chunks in self._chunks.items():
            dtype = np.int64 if k == "ldh" else np.float64
            out["chunk." + k] = (np.concatenate(chunks) if chunks
                                 else np.empty(0, dtype))
        return out

    def load_state_dict(self, sd: dict) -> None:
        for f in self._SCALAR_STATE:
            setattr(self, f, int(sd["scalar." + f]))
        for f in self._ARRAY_STATE:
            setattr(self, f, np.asarray(sd["array." + f]))
        self.recovery_iters = [int(v)
                               for v in np.asarray(sd["array.recovery_iters"])]
        for k in self._chunks:
            arr = np.asarray(sd["chunk." + k])
            self._chunks[k] = [arr] if arr.size else []

    # -- end-of-run -------------------------------------------------------

    @staticmethod
    def _fill_stat_collection(sc, arr):
        """Vectorized StatCollection summary (collections.py semantics:
        mean/median with two-middle averaging/max/min)."""
        if arr.size == 0:
            sc.mean = sc.median = float("nan")
            sc.max = sc.min = 0.0
            return
        sc.mean = float(arr.mean())
        sc.median = float(np.median(arr))
        sc.max = float(arr.max())
        sc.min = float(arr.min())

    def finalize(self, config):
        self.impaired = config.impairments_on
        cov = np.concatenate(self._chunks["coverage"]) if \
            self._chunks["coverage"] else np.empty(0)
        self._fill_stat_collection(self.coverage_stats, cov)
        self._fill_stat_collection(
            self.rmr_stats,
            np.concatenate(self._chunks["rmr"]) if self._chunks["rmr"]
            else np.empty(0))
        self._fill_stat_collection(
            self.branching_stats,
            np.concatenate(self._chunks["branching"])
            if self._chunks["branching"] else np.empty(0))
        for sc, key in ((self.delivered_stats, "delivered"),
                        (self.dropped_stats, "dropped"),
                        (self.suppressed_stats, "suppressed"),
                        (self.failed_stats, "failed"),
                        (self.pull_requests_stats, "pull_requests"),
                        (self.pull_responses_stats, "pull_responses"),
                        (self.pull_misses_stats, "pull_misses"),
                        (self.pull_rescued_stats, "pull_rescued")):
            self._fill_stat_collection(
                sc, np.concatenate(self._chunks[key])
                if self._chunks[key] else np.empty(0))
        self.pull = bool(self._chunks["pull_requests"])
        self.aggregate_hops = HistogramHopsStat(self.hops_hist)
        # LDH = HopsStat over per-round maxima (gossip_stats.rs:196-210):
        # filter 0 (rounds where nobody beyond the origin was reached)
        ldh = (np.concatenate(self._chunks["ldh"])
               if self._chunks["ldh"] else np.empty(0, np.int64))
        ldh = ldh[ldh > 0]
        s = HopsStat()
        if ldh.size:
            s.mean = float(ldh.mean())
            s.median = float(np.median(ldh))
            s.max = int(ldh.max())
            s.min = int(ldh.min())
        self.ldh_stats = s

        # Stranded collection from the per-node strand counts; mirrors
        # insert_nodes called once per (origin, measured round)
        # (gossip_stats.rs:1040-1061).
        c = self.stranded
        stakes_arr = self.index.stakes
        c.stranded_nodes = {
            self.index.pubkeys[i]: (int(stakes_arr[i]),
                                    int(self.stranded_counts[i]))
            for i in np.nonzero(self.stranded_counts)[0]}
        c.total_gossip_iterations = self.measured_points
        c.total_nodes = self.N
        c.calculate_stats()
        # a node can be stranded once per (origin sim, measured round), so
        # the count bound is measured_points, not measured rounds
        c.build_histogram(max(self.measured_points, 1), 0,
                          config.num_buckets_for_stranded_node_hist)

        # Aggregate hop histogram, rebucketed to the CLI bound like the
        # single-origin path (gossip_main.rs:567-578).  Rebucket the 64 bin
        # *counts* directly — expanding to raw values would materialize
        # ~origins x rounds x N entries at target scale.
        from ..constants import STANDARD_HISTOGRAM_UPPER_BOUND
        self.hops_histogram.build_from_counts(
            STANDARD_HISTOGRAM_UPPER_BOUND, 0,
            config.num_buckets_for_hops_stats_hist,
            {h: int(c) for h, c in enumerate(self.hops_hist) if h > 0 and c})

        stakes_map = {pk: int(s)
                      for pk, s in zip(self.index.pubkeys, stakes_arr)}
        for tracker, counts in ((self.egress_tracker, self.egress),
                                (self.ingress_tracker, self.ingress),
                                (self.prune_tracker, self.prunes)):
            tracker.counts = {self.index.pubkeys[i]: int(counts[i])
                              for i in range(self.N)}
            tracker.build_histogram(config.num_buckets_for_message_hist,
                                    stakes_map)
            tracker.normalize_message_counts()

    def recovery_summary(self):
        """Aggregate iterations-to-recover-coverage after heal, or None when
        no heal was configured.  ``-1`` entries (never recovered) are counted
        in ``unrecovered`` and excluded from mean/max; with zero recoveries
        mean/max are 0 (``unrecovered == origins`` disambiguates — and the
        Influx line protocol rejects NaN fields)."""
        if not self.recovery_iters:
            return None
        arr = np.asarray(self.recovery_iters, np.int64)
        ok = arr[arr >= 0]
        return {
            "origins": int(arr.size),
            "unrecovered": int((arr < 0).sum()),
            "mean": float(ok.mean()) if ok.size else 0.0,
            "max": int(ok.max()) if ok.size else 0,
        }

    # -- output -----------------------------------------------------------

    def _print_sc(self, sc):
        log.info("%s Mean: %.6f", sc.collection_type, sc.mean)
        log.info("%s Median: %.6f", sc.collection_type, sc.median)
        log.info("%s Max: %.6f", sc.collection_type, sc.max)
        log.info("%s Min: %.6f", sc.collection_type, sc.min)

    def print_all(self):
        """The reference's print_all shape (gossip_stats.rs:1869-1883),
        aggregated over every origin."""
        log.info("|--- ALL-ORIGINS AGGREGATE: %s origins x %s measured "
                 "points ---|", self.num_origins, self.measured_points)
        log.info("|---- COVERAGE STATS ----|")
        self._print_sc(self.coverage_stats)
        log.info("|---- RELATIVE MESSAGE REDUNDANCY (RMR) STATS ----|")
        self._print_sc(self.rmr_stats)
        log.info("|---- AGGREGATE HOP STATS ----|")
        log.info("Aggregate Hops Mean: %.6f", self.aggregate_hops.mean)
        log.info("Aggregate Hops Median: %.2f", self.aggregate_hops.median)
        log.info("Aggregate Hops Max: %s", self.aggregate_hops.max)
        ldh = self.ldh_stats
        log.info("|---- LAST DELIVERY HOP STATS ----|")
        log.info("LDH Mean: %.6f  Median: %.2f  Max: %s  Min: %s",
                 ldh.mean, ldh.median, ldh.max, ldh.min)
        c = self.stranded
        log.info("|---- STRANDED NODE STATS ----|")
        log.info("Total stranded node iterations: %s",
                 c.total_stranded_iterations)
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
        log.info("Total stranded nodes: %s", c.stranded_count())
        log.info("|---- OUTBOUND BRANCHING FACTOR ----|")
        self._print_sc(self.branching_stats)
        if self.impaired:
            log.info("|---- DEGRADED DELIVERY STATS ----|")
            for sc in (self.delivered_stats, self.dropped_stats,
                       self.suppressed_stats, self.failed_stats):
                self._print_sc(sc)
            log.info("Total dropped: %s  Total suppressed: %s",
                     self.total_dropped, self.total_suppressed)
        if self.pull:
            log.info("|---- PULL (ANTI-ENTROPY) STATS ----|")
            for sc in (self.pull_requests_stats, self.pull_responses_stats,
                       self.pull_misses_stats, self.pull_rescued_stats):
                self._print_sc(sc)
            log.info("Pull totals: %s requests, %s responses, %s rescued, "
                     "%s dropped, %s suppressed",
                     self.total_pull_requests, self.total_pull_responses,
                     self.total_pull_rescued, self.total_pull_dropped,
                     self.total_pull_suppressed)
        rec = self.recovery_summary()
        if rec is not None:
            log.info("|---- COVERAGE RECOVERY AFTER HEAL ----|")
            log.info("Origins: %s  Unrecovered: %s  Mean iters: %.2f  "
                     "Max iters: %s", rec["origins"], rec["unrecovered"],
                     rec["mean"], rec["max"])
        if self.hop_clamped:
            log.info("Hop histogram top-bin clamped samples: %s",
                     self.hop_clamped)

    def emit_influx(self, dp_queue, start_ts: str):
        """Aggregate versions of the reference series
        (influx_db.rs:346-602), one point per run, with the pull series
        in the pull modes."""
        if dp_queue is None:
            return
        from ..sinks import InfluxDataPoint

        dp = InfluxDataPoint(start_ts, 0)
        dp.create_data_point(self.coverage_stats.mean, "coverage")
        dp.create_rmr_data_point((self.rmr_stats.mean, 0, 0))
        dp.create_hops_stat_point(self.aggregate_hops)
        dp.create_data_point(self.branching_stats.mean, "branching_factor")
        c = self.stranded
        dp.create_stranded_iteration_point(
            c.total_stranded_iterations,
            c.stranded_iterations_per_node,
            c.mean_stranded_per_iteration,
            c.mean_stranded_iterations_per_stranded_node,
            c.median_stranded_iterations_per_stranded_node,
            c.weighted_stranded_node_mean_stake,
            c.weighted_stranded_node_median_stake)
        dp.create_histogram_point("stranded_node_histogram", c.histogram)
        dp.create_histogram_point("aggregate_hops_histogram",
                                  self.hops_histogram)
        dp.create_messages_point("egress_message_count",
                                 self.egress_tracker.histogram, 0)
        dp.create_messages_point("ingress_message_count",
                                 self.ingress_tracker.histogram, 0)
        dp.create_messages_point("prune_message_count",
                                 self.prune_tracker.histogram, 0)
        if self.impaired:
            dp.create_delivery_point(
                self.delivered_stats.mean, self.dropped_stats.mean,
                self.suppressed_stats.mean, self.failed_stats.mean)
        if self.pull:
            dp.create_sim_pull_point(
                self.pull_requests_stats.mean, self.pull_responses_stats.mean,
                self.pull_misses_stats.mean,
                round(self.total_pull_dropped
                      / max(self.measured_points, 1), 4),
                round(self.total_pull_suppressed
                      / max(self.measured_points, 1), 4),
                self.pull_rescued_stats.mean)
        rec = self.recovery_summary()
        if rec is not None:
            dp.create_recovery_point(rec["origins"], rec["mean"],
                                     rec["max"], rec["unrecovered"])
        dp_queue.push_back(dp)
