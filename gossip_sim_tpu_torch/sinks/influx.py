"""InfluxDB line-protocol sink (reference: influx_db.rs); the port's own
copy of the reference package's ``sinks/influx.py``.

A background reporter thread polls a shared datapoint queue every 100 ms
(1 ms once the ``start`` sentinel arrives) and POSTs line-protocol strings to
InfluxDB's ``/write`` endpoint with basic auth (influx_db.rs:148-206,36-97).
The ``end`` sentinel plus a dequeued==sent tracker drains the queue before
exit (influx_db.rs:23,100-144,189-202); the tracker is a plain locked
object.  A failed POST is retried with exponential backoff; a point that
exhausts its retries, or finds the bounded send queue full, goes to the
``--influx-spool`` file when one is set, else it is counted as dropped.

Series and field names are the compatibility contract
(influx_db.rs:252-603): ``rmr``, ``coverage``/``branching_factor`` (generic
``data``), ``hops_stat``, ``stranded_node_stats``, ``iteration``,
``simulation_config``, ``validator_stake_distribution``, ``config``,
``stranded_node_iterations``, ``stranded_node_histogram``,
``aggregate_hops_histogram``, ``{egress,ingress,prune}_message_count``, and
the reference package's ``delivery`` / ``coverage_recovery`` (impairments)
and ``sim_perf`` (wall time and throughput of a measured round block, and
the sender's queue depth), ``sim_pull`` (pull-phase counters) and
``sim_adaptive`` (the adaptive direction bit), ``sim_traffic`` and
``sim_traffic_summary`` (concurrent traffic: per-round contention counts
and the end-of-run aggregate), ``sim_node_health`` (the node-health
digest of a measured block, under ``--health``) and ``sim_trace`` (one
flight-recorder segment flush, under ``--trace-dir``).  The series of
features the port lacks yet come with them: ``sim_capacity`` (A15).
"""

from __future__ import annotations

import base64
import logging
import os
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from collections import deque

log = logging.getLogger(__name__)


def load_dotenv(path: str = ".env") -> bool:
    """Minimal dotenv: KEY=VALUE lines -> os.environ (existing keys win).

    Replaces the reference's ``dotenv::dotenv()`` (gossip_main.rs:244-246).
    """
    if not os.path.exists(path):
        return False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            os.environ.setdefault(key.strip(), value.strip().strip("'\""))
    return True


def get_timestamp_now() -> str:
    """Nanosecond timestamp + newline (influx_db.rs:25-32)."""
    return f"{time.time_ns()}\n"


class DatapointQueue:
    """Shared FIFO between the simulation and the reporter thread
    (the reference's ``Arc<Mutex<VecDeque<InfluxDataPoint>>>``,
    gossip_main.rs:730-769)."""

    def __init__(self):
        self._dq = deque()
        self._lock = threading.Lock()

    def push_back(self, dp: "InfluxDataPoint") -> None:
        with self._lock:
            self._dq.append(dp)

    def pop_front(self):
        with self._lock:
            return self._dq.popleft() if self._dq else None

    def __len__(self):
        with self._lock:
            return len(self._dq)

    def drain_deterministic_lines(self) -> list:
        """Drain the queue into its deterministic wire payload: every line
        with the per-point ns timestamp (the trailing token) stripped and
        the telemetry-only series dropped (:func:`deterministic_wire_lines`).
        This is THE
        normalized form two runs of the same simulation must agree on (and
        the reference package's runs of it): the Influx bit-exactness
        contract has this one definition."""
        raw = []
        while len(self):
            raw.extend(self.pop_front().data().splitlines())
        return deterministic_wire_lines(raw)


def deterministic_wire_lines(lines) -> list:
    """Normalize raw line-protocol strings into the deterministic wire
    payload (the same filter/strip :meth:`DatapointQueue.
    drain_deterministic_lines` applies): the per-point timestamp stripped,
    and the telemetry-only series dropped: ``sim_perf`` and
    ``sim_capacity`` (wall-clock-valued; the port does not emit the second
    yet, ROADMAP A15) and ``sim_node_health`` (only under the opt-in
    ``--health`` gate, which must not move a bit of this payload)."""
    out = []
    for ln in lines:
        if (not ln or ln.startswith("sim_perf")
                or ln.startswith("sim_capacity")
                or ln.startswith("sim_node_health")):
            continue
        out.append(ln.rsplit(" ", 1)[0])
    return out


class Tracker:
    """dequeued==sent drain tracker (influx_db.rs:100-144)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.dequeued = 0
        self.sent = 0

    def add_dequeued(self):
        with self._lock:
            self.dequeued += 1

    def add_sent(self):
        with self._lock:
            self.sent += 1

    def equal(self) -> bool:
        with self._lock:
            return self.sent == self.dequeued


class InfluxDataPoint:
    """Line-protocol string builder (influx_db.rs:252-603)."""

    def __init__(self, start_timestamp: str = "0", simulation_iter: int = 0):
        self.datapoint = ""
        self.timestamp = get_timestamp_now()
        self.simulation_iteration = simulation_iter
        self.start_timestamp = start_timestamp

    def data(self) -> str:
        return self.datapoint

    # -- sentinels (influx_db.rs:290-318) ---------------------------------

    def set_start(self):
        self.datapoint += "start"

    def is_start(self) -> bool:
        return self.datapoint == "start"

    def set_last_datapoint(self):
        self.datapoint += "end"

    def last_datapoint(self) -> bool:
        return self.datapoint == "end"

    # -- timestamps -------------------------------------------------------

    def get_timestamp_now(self) -> str:
        # 1 us sleep so consecutive points never collide on the same ns
        # timestamp (influx takes only one of equal-timestamp points,
        # influx_db.rs:320-332).
        time.sleep(1e-6)
        return get_timestamp_now()

    def append_timestamp(self):
        self.datapoint += self.timestamp

    def set_and_append_timestamp(self):
        self.datapoint += self.get_timestamp_now()

    # -- series builders (influx_db.rs:346-602) ---------------------------

    def create_rmr_data_point(self, result):
        rmr, m, n = result
        self.datapoint += (
            f"rmr,simulation_iter={self.simulation_iteration},"
            f"start_time={self.start_timestamp} rmr={rmr},m={m},n={n} ")
        self.append_timestamp()

    def create_data_point(self, data: float, stat_type: str):
        self.datapoint += (
            f"{stat_type},simulation_iter={self.simulation_iteration},"
            f"start_time={self.start_timestamp} data={data} ")
        self.append_timestamp()

    def create_hops_stat_point(self, stat):
        self.datapoint += (
            f"hops_stat,simulation_iter={self.simulation_iteration},"
            f"start_time={self.start_timestamp} "
            f"mean={stat.mean},median={stat.median},max={stat.max} ")
        self.append_timestamp()

    def create_stranded_node_stat_point(self, stat):
        self.datapoint += (
            f"stranded_node_stats,simulation_iter={self.simulation_iteration},"
            f"start_time={self.start_timestamp} "
            f"count={stat.count},mean={stat.mean_stake},"
            f"median={stat.median_stake},max={stat.max_stake},"
            f"min={stat.min_stake} ")
        self.append_timestamp()

    def create_iteration_point(self, gossip_iter: int, simulation_iter_val: int):
        self.datapoint += (
            f"iteration,simulation_iter={self.simulation_iteration},"
            f"start_time={self.start_timestamp} "
            f"gossip_iter={gossip_iter},simulation_iter_val={simulation_iter_val} ")
        self.append_timestamp()

    def create_test_type_point(self, num_simulations, gossip_iterations,
                               warm_up_rounds, step_size, node_count,
                               probability_of_rotation, api, start_value,
                               test_type):
        self.datapoint += (
            f"simulation_config,start_time={self.start_timestamp} "
            f"num_simulations={num_simulations},"
            f"gossip_iterations_per_simulation={gossip_iterations},"
            f"warm_up_rounds={warm_up_rounds},"
            f"step_size={step_size},"
            f"node_count={node_count},"
            f"probability_of_rotation={probability_of_rotation},"
            f"api=\"{api}\","
            f"start_value=\"{start_value}\","
            f"test_type=\"{test_type}\" ")
        self.append_timestamp()

    def create_validator_stake_distribution_histogram_point(self, histogram):
        for bucket, count in histogram.items():
            self.datapoint += (
                f"validator_stake_distribution,"
                f"start_time={self.start_timestamp} "
                f"bucket={bucket},count={count} ")
            self.set_and_append_timestamp()

    def create_config_point(self, push_fanout, active_set_size, origin_rank,
                            prune_stake_threshold, min_ingress_nodes,
                            fraction_to_fail, rotation_probability):
        self.datapoint += (
            f"config,simulation_iter={self.simulation_iteration},"
            f"start_time={self.start_timestamp} "
            f"push_fanout={push_fanout},"
            f"active_set_size={active_set_size},"
            f"origin_rank={origin_rank},"
            f"prune_stake_threshold={prune_stake_threshold},"
            f"min_ingress_nodes={min_ingress_nodes},"
            f"fraction_to_fail={fraction_to_fail},"
            f"rotation_probability={rotation_probability} ")
        self.append_timestamp()

    def create_stranded_iteration_point(self, total_stranded,
                                        mean_iter_stranded_per_node,
                                        mean_stranded_per_iter,
                                        mean_iter_stranded,
                                        median_iter_stranded,
                                        mean_weighted_stake,
                                        median_weighted_stake):
        self.datapoint += (
            f"stranded_node_iterations,"
            f"simulation_iter={self.simulation_iteration},"
            f"start_time={self.start_timestamp} "
            f"total_stranded={total_stranded},"
            f"mean_iter_stranded_per_node={mean_iter_stranded_per_node},"
            f"mean_stranded_per_iter={mean_stranded_per_iter},"
            f"mean_iter_stranded={mean_iter_stranded},"
            f"median_iter_stranded={median_iter_stranded},"
            f"mean_weighted_stake={mean_weighted_stake},"
            f"median_weighted_stake={median_weighted_stake} ")
        self.append_timestamp()

    def create_histogram_point(self, data_type: str, histogram):
        for bucket, count in histogram.items():
            bucket_max = histogram.min_entry + (bucket + 1) * histogram.bucket_range - 1
            self.datapoint += f"{data_type} bucket={bucket_max},count={count} "
            self.set_and_append_timestamp()

    def create_delivery_point(self, delivered, dropped, suppressed,
                              failed_count):
        """Degraded-delivery counters under impairments (faults.py):
        per-iteration on the single-origin path, run-level means on the
        all-origins aggregate path."""
        self.datapoint += (
            f"delivery,simulation_iter={self.simulation_iteration},"
            f"start_time={self.start_timestamp} "
            f"delivered={delivered},dropped={dropped},"
            f"suppressed={suppressed},failed={failed_count} ")
        self.append_timestamp()

    def create_recovery_point(self, origins, mean_iters, max_iters,
                              unrecovered):
        """Iterations-to-recover coverage after a partition heal.

        mean/max cover origins that DID recover; when none did they are
        0 and ``unrecovered == origins`` disambiguates from an instant
        recovery (same convention on the single-origin and aggregate
        paths, and never a NaN on the wire)."""
        self.datapoint += (
            f"coverage_recovery,simulation_iter={self.simulation_iteration},"
            f"start_time={self.start_timestamp} "
            f"origins={origins},mean_iters={mean_iters},"
            f"max_iters={max_iters},unrecovered={unrecovered} ")
        self.append_timestamp()

    def create_sim_node_health_point(self, block: int, values: dict):
        """Node-health observatory series (obs/health.py): one point per
        measured harvest block with the flattened digest: per-metric
        totals, hot-node (id, count) pairs and load-imbalance Gini.  The
        series exists only under ``--health``, so
        :func:`deterministic_wire_lines` drops it."""
        parts = []
        for k, v in sorted(values.items()):
            parts.append(f"{k}={float(v)}" if isinstance(v, float)
                         else f"{k}={int(v)}")
        self.datapoint += (
            f"sim_node_health,simulation_iter={self.simulation_iteration},"
            f"start_time={self.start_timestamp} "
            f"block={int(block)}," + ",".join(parts) + " ")
        self.append_timestamp()

    def create_sim_perf_point(self, round_wall_s, origin_iters_per_sec,
                              queue_depth, iters):
        """Wall time and throughput of one measured round block plus the
        sender queue depth at emission time: the live "is the sim keeping
        up / is the sink backed up" signal."""
        self.datapoint += (
            f"sim_perf,simulation_iter={self.simulation_iteration},"
            f"start_time={self.start_timestamp} "
            f"round_wall_s={round_wall_s},"
            f"origin_iters_per_sec={origin_iters_per_sec},"
            f"queue_depth={queue_depth},iters={iters} ")
        self.append_timestamp()

    def create_sim_pull_point(self, requests, responses, misses, dropped,
                              suppressed, rescued):
        """Pull-phase series (pull.py): request/response/miss message
        counts, loss and partition casualties, and the nodes a pull
        response rescued; per iteration on the single-origin path, run-level
        means on the all-origins aggregate path."""
        self.datapoint += (
            f"sim_pull,simulation_iter={self.simulation_iteration},"
            f"start_time={self.start_timestamp} "
            f"requests={requests},responses={responses},"
            f"misses={misses},dropped={dropped},"
            f"suppressed={suppressed},rescued={rescued} ")
        self.append_timestamp()

    def create_sim_adaptive_point(self, it, values: dict):
        """Adaptive push-pull series (adaptive.py): one point per measured
        round, on the single-origin path the 0/1 direction bit and the
        switch flag."""
        fields = ",".join(f"{k}={int(v)}" for k, v in sorted(values.items()))
        self.datapoint += (
            f"sim_adaptive,simulation_iter={self.simulation_iteration},"
            f"start_time={self.start_timestamp} "
            f"iteration={int(it)},{fields} ")
        self.append_timestamp()

    def create_sim_trace_point(self, rounds, delivered_edges, prunes,
                               bytes_written):
        """Flight-recorder series (obs/trace.py): one point per trace
        segment flush — rounds captured, delivered edges and prune pairs
        recorded, and the compressed bytes written to --trace-dir."""
        self.datapoint += (
            f"sim_trace,simulation_iter={self.simulation_iteration},"
            f"start_time={self.start_timestamp} "
            f"rounds={rounds},delivered_edges={delivered_edges},"
            f"prunes={prunes},bytes_written={bytes_written} ")
        self.append_timestamp()

    def create_sim_traffic_point(self, it, values: dict):
        """Concurrent-traffic series (traffic.py): one point per measured
        round with the round's ``stats.traffic.ROUND_FIELDS`` counts
        (deterministic: the line joins the parity surface)."""
        fields = ",".join(f"{k}={int(v)}" for k, v in sorted(values.items()))
        self.datapoint += (
            f"sim_traffic,simulation_iter={self.simulation_iteration},"
            f"start_time={self.start_timestamp} "
            f"iteration={int(it)},{fields} ")
        self.append_timestamp()

    def create_sim_traffic_summary_point(self, summary: dict):
        """End-of-run traffic aggregate (``TrafficStats.summary()``):
        per-value latency, coverage and RMR aggregates and queue totals."""
        parts = []
        for k, v in sorted(summary.items()):
            parts.append(f"{k}={float(v)}" if isinstance(v, float)
                         else f"{k}={int(v)}")
        self.datapoint += (
            f"sim_traffic_summary,simulation_iter="
            f"{self.simulation_iteration},"
            f"start_time={self.start_timestamp} " + ",".join(parts) + " ")
        self.append_timestamp()

    def create_messages_point(self, messages_direction: str, messages,
                              simulation_iter_val: int):
        for bucket, count in messages.items():
            self.datapoint += (
                f"{messages_direction},simulation_iter={simulation_iter_val},"
                f"start_time={self.start_timestamp} "
                f"bucket={bucket},count={count} ")
            self.set_and_append_timestamp()


class InfluxDB:
    """HTTP POST of line protocol to /write?db=... with basic auth
    (influx_db.rs:36-97,205-250)."""

    def __init__(self, endpoint: str, username: str, password: str,
                 database: str, tracker: Tracker | None = None,
                 timeout: float = 10.0, max_retries: int = 3,
                 retry_base: float = 0.5, max_queue: int = 1024,
                 spool_path: str = ""):
        self.url = endpoint.rstrip("/") + "/write"
        self.database = database
        self.username = username
        self.password = password
        self.tracker = tracker
        self.timeout = timeout
        self.max_retries = max_retries
        self.retry_base = retry_base
        self.max_queue = max_queue
        self.spool_path = spool_path  # durable on-disk line-protocol spool
        self.dropped_points = 0   # points lost after retries / queue overflow
        self.spooled_points = 0   # points diverted to the spool file
        self.points_sent = 0      # points acknowledged 2xx by the endpoint
        self.retry_count = 0      # transient-failure retries attempted
        self._send_q = None
        self._send_lock = threading.Lock()
        self._spool_lock = threading.Lock()

    def _count_dropped(self, body: str | None = None):
        """A point exhausted its retries (or the queue overflowed): spool
        it durably when --influx-spool is configured (the point keeps its
        original per-point timestamps, so a replay sends exactly what the
        run would have written), else count it lost."""
        if body and self.spool_path and self._spool(body):
            with self._send_lock:
                self.spooled_points += 1
            return
        with self._send_lock:
            self.dropped_points += 1

    def _spool(self, body: str) -> bool:
        """Append one point's line-protocol body to the spool file.
        Append-mode writes of a single buffered payload are atomic enough
        for line protocol (the replayer skips any torn final line).
        Returns False — falling back to the dropped count — if the spool
        itself is unwritable."""
        try:
            with self._spool_lock:
                with open(self.spool_path, "a") as f:
                    f.write(body if body.endswith("\n") else body + "\n")
            return True
        except OSError as err:
            log.error("influx spool %s unwritable (%s); counting point "
                      "as dropped", self.spool_path, err)
            return False

    def sender_stats(self) -> dict:
        """Delivery accounting for end-of-run logging."""
        with self._send_lock:
            return {
                "points_sent": self.points_sent,
                "dropped_points": self.dropped_points,
                "spooled_points": self.spooled_points,
                "retries": self.retry_count,
            }

    def _post(self, body: str):
        """POST one line-protocol body; retry transient failures with
        exponential backoff + jitter, then count the point as dropped.  The
        tracker is marked sent exactly once either way so the drain loop
        (InfluxThread) terminates instead of hanging on lost points."""
        import random

        url = f"{self.url}?{urllib.parse.urlencode({'db': self.database})}"
        auth = base64.b64encode(
            f"{self.username}:{self.password}".encode()).decode()
        req = urllib.request.Request(
            url, data=body.encode(),
            headers={"Authorization": f"Basic {auth}"})
        try:
            delay = self.retry_base
            for attempt in range(self.max_retries + 1):
                err = None
                retryable = True
                try:
                    with urllib.request.urlopen(
                            req, timeout=self.timeout) as resp:
                        if 200 <= resp.status < 300:
                            with self._send_lock:
                                self.points_sent += 1
                            return
                        err = f"HTTP status {resp.status}"
                except urllib.error.HTTPError as exc:
                    err = f"HTTP status {exc.code}"
                    # permanent client errors (bad auth, malformed body)
                    # never succeed on retry — fail fast so a config error
                    # can't back-pressure the whole send queue
                    retryable = exc.code >= 500 or exc.code in (408, 429)
                except (urllib.error.URLError, OSError) as exc:
                    err = exc
                if retryable and attempt < self.max_retries:
                    with self._send_lock:
                        self.retry_count += 1
                    log.warning("InfluxDB send failed (attempt %s/%s): %s — "
                                "retrying in %.2fs", attempt + 1,
                                self.max_retries + 1, err, delay)
                    time.sleep(delay * (1.0 + 0.5 * random.random()))
                    delay *= 2
                else:
                    self._count_dropped(body)
                    log.error("%s InfluxDB point after %s attempt(s): %s",
                              "Spooling" if self.spool_path else "Dropping",
                              attempt + 1, err)
                    return
        finally:
            if self.tracker is not None:
                self.tracker.add_sent()

    def send_data_points(self, datapoint: InfluxDataPoint):
        # Async send like the reference (one async_std task per point,
        # influx_db.rs:81-96), but through a single persistent worker so a
        # slow endpoint can't accumulate thousands of live sender threads.
        # The queue is bounded: a stalled endpoint sheds points (counted in
        # ``dropped_points``) instead of growing without limit.
        with self._send_lock:
            if self._send_q is None:
                import queue
                self._send_q = queue.Queue(maxsize=self.max_queue)

                def _worker():
                    while True:
                        body = self._send_q.get()
                        try:
                            self._post(body)
                        except Exception as err:  # one bad point must not
                            # kill the drain: _post counts sent in finally,
                            # but anything else raised here would leave the
                            # Tracker unequal and InfluxThread hung forever
                            log.error("influx sender error: %s", err)

                threading.Thread(target=_worker, daemon=True).start()
        import queue
        try:
            self._send_q.put_nowait(datapoint.data())
        except queue.Full:
            self._count_dropped(datapoint.data())
            # still mark it sent: the drain tracker must converge
            if self.tracker is not None:
                self.tracker.add_sent()
            log.error("InfluxDB send queue full (%s); %s point",
                      self.max_queue,
                      "spooling" if self.spool_path else "dropping")


class InfluxThread:
    """Reporter loop (influx_db.rs:146-204).

    Instances are join-able handles that keep the underlying ``InfluxDB``
    reachable after the drain, so end-of-run logging can surface
    dropped-point / retry accounting instead of burying it in the drain
    log."""

    def __init__(self, endpoint: str, username: str, password: str,
                 database: str, datapoint_queue: DatapointQueue,
                 spool_path: str = ""):
        self.tracker = Tracker()
        self.db = InfluxDB(endpoint, username, password, database,
                           self.tracker, spool_path=spool_path)
        self._queue = datapoint_queue
        self._thread: threading.Thread | None = None

    def run(self):
        """The reporter loop body (blocks until the end sentinel drains)."""
        wait_time = 0.1
        rx_last_datapoint = False
        draining_logged = False
        while True:
            dp = self._queue.pop_front()
            if dp is not None:
                if dp.last_datapoint():
                    rx_last_datapoint = True
                elif dp.is_start():
                    wait_time = 0.001
                else:
                    self.db.send_data_points(dp)
                    self.tracker.add_dequeued()
            if rx_last_datapoint:
                if not draining_logged:
                    draining_logged = True
                    log.info("Last simulation datapoint recorded. "
                             "Draining Queue...")
                if self.tracker.equal():
                    if self.db.dropped_points:
                        log.warning("WARNING: %s InfluxDB point(s) dropped "
                                    "(send failures after retries or queue "
                                    "overflow)", self.db.dropped_points)
                    if self.db.spooled_points:
                        log.warning("WARNING: %s InfluxDB point(s) spooled "
                                    "to %s",
                                    self.db.spooled_points,
                                    self.db.spool_path)
                    log.info("Queue Drained. Exiting...")
                    break
            time.sleep(wait_time)

    def join(self, timeout: float | None = None):
        if self._thread is not None:
            self._thread.join(timeout)

    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def sender_stats(self) -> dict:
        """points_sent / dropped_points / retries (InfluxDB.sender_stats)."""
        return self.db.sender_stats()

    @staticmethod
    def spawn(endpoint: str, username: str, password: str, database: str,
              datapoint_queue: DatapointQueue,
              spool_path: str = "") -> "InfluxThread":
        """Run the loop in a daemon thread; returns the join-able handle
        (the reference's std::thread::spawn, gossip_main.rs:746-768).
        ``spool_path`` diverts retry-exhausted / overflow points to a
        durable line-protocol spool."""
        it = InfluxThread(endpoint, username, password, database,
                          datapoint_queue, spool_path=spool_path)
        it._thread = threading.Thread(target=it.run, daemon=True)
        it._thread.start()
        return it
