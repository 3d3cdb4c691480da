"""Resilient execution: the run journal, graceful shutdown and the device
supervisor (the port's copy of the reference package's ``resilience.py``).

* :class:`RunJournal`: an append-only JSONL journal next to the checkpoint
  ``.npz`` (``foo.npz`` -> ``foo.journal``).  Each finished unit of a
  multi-unit run (one sim of a serial sweep, one lane batch, one measured
  block of the batched origin-rank sweep, one all-origins batch) commits
  one line: its sims' ``parity_snapshot()``s and the Influx lines it
  pushed.  A commit is flushed and fsynced; a kill mid-append leaves at
  most a partial last line, which the loader drops.  ``--resume`` replays
  the committed units into stats and Influx and restarts at the first
  uncommitted one.  The schema, the run key (:func:`run_key_from_config`)
  and the payloads are the reference's, so a journal written by either
  package resumes in the other.
* Graceful shutdown: SIGTERM/SIGINT set a flag the run loops read at unit
  boundaries; the in-flight unit finishes and commits, and the run exits
  with :data:`RESUMABLE_EXIT_CODE` (75).
* :func:`supervised_call`, the device supervisor (cli.py
  ``_dispatch_supervised`` builds each attempt): a unit runs bounded by
  ``--device-timeout-s`` on a worker thread; transient failures and
  timeouts are retried with exponential backoff; after the retries,
  ``abort`` raises :class:`DeviceDispatchError`, which ``cli.main`` turns
  into exit code 75 with the journal committed, and
  ``--on-device-failure cpu-fallback`` re-runs the unit with
  ``device="cpu"``; the CLI takes it only with ``--device cpu``.

On the card the supervisor differs from the reference's in what it must
rebuild and what it can recover:

* Fresh tensors for each attempt.  The unit's input state is copied to the
  host once, and every attempt (the retries and the CPU arm) builds fresh
  tensors from that copy.  PyTorch donates nothing; the reason is that a
  sticky CUDA error (an illegal address, a launch failure) leaves the
  device copies, and the context itself, unusable: a retry in the same
  process fails again, and only the host copy survives.
* Transient errors (:func:`_is_transient`): ``torch.cuda.OutOfMemoryError``
  and the ``RuntimeError``s the kernel wrappers raise are retried, as the
  reference retries XLA runtime errors; a refusal (``NotImplementedError``,
  ``ValueError``) never is.
* ``--device-timeout-s``: the attempt runs on a worker thread, which
  launches on the caller's device and stream, reaches the kernels' first
  build under ``kernels._build``'s lock, and copies its results to the
  host before it returns.  The first dispatch of a process, which builds
  or loads the kernels, runs inline, as the reference's compile carrier
  does.  A timed-out attempt cannot be cancelled: its kernels keep the
  stream busy, so a retry queues behind them.  Only ``abort`` (exit 75,
  then ``--resume`` in a new process) recovers from a hung kernel.
* ``cpu-fallback`` is refused on the card (``cli.main``'s start-up
  checks; ``cli._dispatch_supervised`` raises): no unit computed on the
  card moves to the CPU after its kernels fail, and the port has no run
  report to record such a unit until ROADMAP A15.  With ``--device cpu``
  it runs only when the user passes it, after the retries.

The reference counts committed, resumed, failed and fallen-back units in
its observability registry and emits telemetry events; the port keeps the
four counts in :data:`COUNTS` and its info sections in :data:`RUN_INFO`
until the registry is ported (ROADMAP A15), and emits no events.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import signal
import threading
import time

log = logging.getLogger(__name__)

#: exit code of a run interrupted resumably (SIGTERM/SIGINT at a unit
#: boundary, or --on-device-failure abort): EX_TEMPFAIL
RESUMABLE_EXIT_CODE = 75

JOURNAL_SCHEMA = "gossip-sim-tpu/journal/v1"

#: Config fields that shape a unit's content: a journal written under one
#: set is never replayed under another
RUN_KEY_FIELDS = (
    "gossip_push_fanout", "gossip_active_set_size", "gossip_iterations",
    "origin_rank", "probability_of_rotation", "prune_stake_threshold",
    "min_ingress_nodes", "filter_zero_staked_nodes", "fraction_to_fail",
    "when_to_fail", "num_simulations", "warm_up_rounds",
    "packet_loss_rate", "churn_fail_rate", "churn_recover_rate",
    "partition_at", "heal_at", "gossip_mode", "pull_fanout",
    "pull_interval", "pull_bloom_fp_rate", "pull_request_cap",
    "backend", "seed", "num_synthetic_nodes", "account_file",
    "sweep_lanes", "origin_batch",
)

#: the run key's ``backend``: the reference's name for its engine path
#: (its default), which this package's engine reproduces; the port has no
#: ``--backend`` flag yet (ROADMAP A18)
ENGINE_BACKEND = "tpu"

#: units committed, replayed on resume, failed device attempts and units
#: re-run on the CPU, since the last :func:`reset_counts` (the reference's
#: registry counters of the same names)
COUNTS = {"resilience/committed_units": 0, "resilience/resumed_units": 0,
          "resilience/device_failures": 0, "resilience/fallback_units": 0}


#: the run's info sections that the reference keeps in its registry
#: (``get_registry().info``): ``node_health``, the final node-health
#: section of a ``--health`` run (cli._publish_node_health)
RUN_INFO: dict = {}


def reset_counts() -> None:
    """Zero :data:`COUNTS` and clear :data:`RUN_INFO` (the reference's
    ``get_registry().reset()``)."""
    for k in COUNTS:
        COUNTS[k] = 0
    RUN_INFO.clear()


class ResumableInterrupt(Exception):
    """A graceful-shutdown request honored at a unit boundary: the journal
    is committed up to the last finished unit and the run should exit with
    :data:`RESUMABLE_EXIT_CODE`."""


class DeviceTimeoutError(RuntimeError):
    """A supervised device dispatch exceeded ``--device-timeout-s``."""


class DeviceDispatchError(Exception):
    """A supervised device dispatch failed beyond its retries under
    ``--on-device-failure abort``; every earlier unit is committed, so
    the run is resumable."""


# --------------------------------------------------------------------------
# run journal
# --------------------------------------------------------------------------

def journal_path(checkpoint_path: str) -> str:
    """The journal a checkpoint path implies (``foo.npz`` or ``foo`` ->
    ``foo.journal``)."""
    base = checkpoint_path
    if base.endswith(".npz"):
        base = base[: -len(".npz")]
    return base + ".journal"


def run_key_from_config(config, kind: str, extra: dict | None = None) -> dict:
    """The journal's run fingerprint: the Config fields that shape unit
    content and the unit ``kind`` (serial-sweep, lane-sweep, origin-rank,
    all-origins); ``extra`` adds inputs outside the Config (the full
    ``--origin-rank`` list).  Equal to the reference's for the same run."""
    key = {f: (getattr(config, f) if f != "backend"
               else getattr(config, f, ENGINE_BACKEND))
           for f in RUN_KEY_FIELDS}
    key["test_type"] = str(config.test_type)
    key["step_size"] = str(config.step_size)
    key["kind"] = kind
    if extra:
        key.update(extra)
    return key


class RunJournal:
    """Append-only unit journal (JSONL, one committed unit per line).

    Line 0 is a header with the schema, the run key and the pubkey
    counter; every later line is ``{"unit": int, "payload": {...}}``.  A
    torn write can only leave a partial last line, which :meth:`_load`
    drops (with a warning) and truncates."""

    def __init__(self, path: str, run_key: dict, resume: bool = False):
        self.path = path
        self.run_key = dict(run_key)
        self.records: dict[int, dict] = {}
        self._fh = None
        existed = os.path.exists(path)
        if resume and existed:
            self._load()
        elif existed:
            log.warning("WARNING: overwriting existing journal %s (no "
                        "--resume given); the prior run's committed units "
                        "are discarded", path)
        if not (resume and existed):
            header = {"schema": JOURNAL_SCHEMA, "run_key": self.run_key,
                      "pubkey_counter": _peek_pubkey_counter()}
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                f.write(json.dumps(header) + "\n")
                f.flush()
                os.fsync(f.fileno())

    def _load(self) -> None:
        with open(self.path) as f:
            lines = f.read().splitlines()
        if not lines:
            raise SystemExit(f"ERROR: journal {self.path} is empty — "
                             f"remove it to start fresh")
        header = self._parse(lines[0])
        if header is None or header.get("schema") != JOURNAL_SCHEMA:
            raise SystemExit(
                f"ERROR: {self.path} is not a "
                f"{JOURNAL_SCHEMA} journal — remove it to start fresh")
        stored_key = header.get("run_key", {})
        drift = {k: (stored_key.get(k), self.run_key[k])
                 for k in self.run_key
                 if stored_key.get(k) != self.run_key[k]}
        if drift:
            raise SystemExit(
                "ERROR: --resume run configuration does not match the "
                "journal's: " + ", ".join(
                    f"{k}: journal={a!r} vs now={b!r}"
                    for k, (a, b) in sorted(drift.items()))
                + f". Remove {self.path} to start fresh.")
        self.header = header
        valid_bytes = len(lines[0].encode()) + 1
        for i, line in enumerate(lines[1:], start=1):
            rec = self._parse(line)
            if rec is None:
                if i != len(lines) - 1:
                    log.warning("WARNING: journal %s line %s is corrupt; "
                                "units from there on are treated as "
                                "uncommitted", self.path, i)
                else:
                    log.warning("WARNING: journal %s ends in a partial "
                                "record (killed mid-commit); the unit is "
                                "treated as uncommitted", self.path)
                # truncate the torn tail so later commits append whole lines
                with open(self.path, "r+") as f:
                    f.truncate(valid_bytes)
                break
            valid_bytes += len(line.encode()) + 1
            self.records[int(rec["unit"])] = rec.get("payload", {})

    @staticmethod
    def _parse(line: str):
        try:
            return json.loads(line)
        except (json.JSONDecodeError, ValueError):
            return None

    def commit(self, unit: int, payload: dict) -> None:
        """Durably commit one finished unit (flush + fsync)."""
        if self._fh is None:
            self._fh = open(self.path, "a")
        rec = {"unit": int(unit), "payload": payload}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self.records[int(unit)] = payload
        COUNTS["resilience/committed_units"] += 1
        note_unit_committed()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def committed_prefix(self) -> int:
        """Units [0, k) committed in a row: resume restarts at unit k."""
        k = 0
        while k in self.records:
            k += 1
        return k

    def header_pubkey_counter(self) -> int | None:
        """The pubkey counter when the journal was created (before the
        first cluster load); resume restores it so synthetic clusters draw
        the same pubkeys."""
        hdr = getattr(self, "header", None)
        if hdr is None:
            return None
        v = hdr.get("pubkey_counter")
        return int(v) if v is not None else None


def _peek_pubkey_counter() -> int:
    from .identity import peek_unique_pubkeys
    return peek_unique_pubkeys()


def restore_pubkey_counter(value) -> None:
    """Put the pubkey counter where the interrupted run had it, so later
    units of a resumed run draw the same pubkeys."""
    if value is None:
        return
    from .identity import reset_unique_pubkeys
    reset_unique_pubkeys(int(value))


# --------------------------------------------------------------------------
# parity snapshots and stats
# --------------------------------------------------------------------------

def snapshot_to_jsonable(snap: dict) -> dict:
    """A ``GossipStats.parity_snapshot()`` in JSON types: pubkeys as base58
    strings, the failed set as a sorted list (exact: json round-trips
    floats by repr and ints unbounded)."""
    out = {}
    for k, v in snap.items():
        if k == "stranded":
            out[k] = {pk.to_string(): [int(s), int(c)]
                      for pk, (s, c) in v.items()}
        elif k in ("egress", "ingress", "prunes"):
            out[k] = {pk.to_string(): int(n) for pk, n in v.items()}
        elif k == "failed_nodes":
            out[k] = sorted(pk.to_string() for pk in v)
        else:
            out[k] = v
    return out


def snapshot_from_jsonable(d: dict) -> dict:
    """Inverse of :func:`snapshot_to_jsonable`."""
    from .identity import Pubkey
    out = {}
    for k, v in d.items():
        if k == "stranded":
            out[k] = {Pubkey.from_string(s): (vals[0], vals[1])
                      for s, vals in v.items()}
        elif k in ("egress", "ingress", "prunes"):
            out[k] = {Pubkey.from_string(s): n for s, n in v.items()}
        elif k == "failed_nodes":
            out[k] = {Pubkey.from_string(s) for s in v}
        else:
            out[k] = v
    return out


def stats_unit_payload(stats) -> dict:
    """One sim's journal payload: the parity snapshot and what else a
    continuation reads (per-round hop maxima for the last-delivery-hop
    stats, the post-heal coverage series, the origin)."""
    return {
        "origin": stats.origin.to_string() if stats.origin else "",
        "snapshot": snapshot_to_jsonable(stats.parity_snapshot()),
        "hops_round_max": [int(s.max)
                           for s in stats.hops_stats.per_round_stats],
        "post_heal": [[it, cov] for it, cov in stats._post_heal_coverage],
    }


def restore_stats(payload: dict, config, stakes):
    """Rebuild a ``GossipStats`` from a journal payload: its
    ``parity_snapshot()`` equals the original's, and every series the
    end-of-run histograms and calculations read is restored.  Per-round
    hop and stranded entries are placeholders with what later consumers
    read (the hop ``max``); their per-round Influx lines replay
    verbatim."""
    from .constants import VALIDATOR_STAKE_DISTRIBUTION_NUM_BUCKETS
    from .identity import Pubkey
    from .stats.gossip_stats import GossipStats
    from .stats.hops import HopsStat
    from .stats.stranded import StrandedNodeStats

    snap = snapshot_from_jsonable(payload["snapshot"])
    stats = GossipStats()
    stats.set_simulation_parameters(config)
    if payload.get("origin"):
        stats.set_origin(Pubkey.from_string(payload["origin"]))
    stats.initialize_message_stats(stakes)
    stats.build_validator_stake_distribution_histogram(
        VALIDATOR_STAKE_DISTRIBUTION_NUM_BUCKETS, stakes)

    stats.coverage_stats.collection = list(snap["coverage"])
    stats.rmr_stats.collection = list(snap["rmr"])
    stats.outbound_branching_factors.collection = list(snap["branching"])
    stats.hops_stats.raw_hop_collection = list(snap["hops"])
    for m in payload.get("hops_round_max", []):
        h = HopsStat()
        h.max = m
        stats.hops_stats.per_round_stats.append(h)
    sc = stats.stranded_node_collection
    sc.stranded_nodes = dict(snap["stranded"])
    sc.total_gossip_iterations = len(snap["coverage"])
    sc.total_nodes = len(stakes)
    sc.per_iter_stats = [StrandedNodeStats()
                         for _ in range(len(snap["coverage"]))]
    stats.egress_messages.counts = dict(snap["egress"])
    stats.ingress_messages.counts = dict(snap["ingress"])
    stats.prune_messages.counts = dict(snap["prunes"])
    stats.delivered_stats.collection = list(snap["delivered"])
    stats.dropped_stats.collection = list(snap["dropped"])
    stats.suppressed_stats.collection = list(snap["suppressed"])
    stats.failed_count_series = list(snap["failed_count_series"])
    stats.failed_nodes = set(snap["failed_nodes"])
    stats.pull_requests_stats.collection = list(snap["pull_requests"])
    stats.pull_responses_stats.collection = list(snap["pull_responses"])
    stats.pull_misses_stats.collection = list(snap["pull_misses"])
    stats.pull_dropped_stats.collection = list(snap["pull_dropped"])
    stats.pull_suppressed_stats.collection = list(snap["pull_suppressed"])
    stats.pull_rescued_stats.collection = list(snap["pull_rescued"])
    # the adaptive series; absent in journals older than the adaptive mode
    stats.adaptive_active_series = list(snap.get("adaptive_active", []))
    stats.adaptive_switched_series = list(snap.get("adaptive_switched", []))
    stats.recovery_iterations = snap["recovery_iterations"]
    stats._post_heal_coverage = [(int(it), float(cov))
                                 for it, cov in payload.get("post_heal", [])]
    return stats


# --------------------------------------------------------------------------
# Influx capture and replay
# --------------------------------------------------------------------------

class InfluxTee:
    """A ``DatapointQueue`` facade that records each pushed point's line
    protocol into the current unit's buffer and forwards it to the real
    queue; ``take_unit_lines`` hands the buffer to the journal commit."""

    def __init__(self, queue):
        self.queue = queue
        self._lines: list[str] = []

    def push_back(self, dp) -> None:
        self._lines.append(dp.data())
        self.queue.push_back(dp)

    def __len__(self):
        return len(self.queue)

    def take_unit_lines(self) -> list:
        lines, self._lines = self._lines, []
        return lines


def replay_influx_lines(dp_queue, lines) -> None:
    """Push journaled line-protocol bodies back onto the live queue
    verbatim, their original timestamps included, so the replayed payload
    is byte-identical to what the interrupted run sent."""
    if dp_queue is None or not lines:
        return
    from .sinks import InfluxDataPoint
    for body in lines:
        dp = InfluxDataPoint()
        dp.datapoint = body
        dp_queue.push_back(dp)


# --------------------------------------------------------------------------
# graceful shutdown
# --------------------------------------------------------------------------

_shutdown_event = threading.Event()
_units_this_run = 0
_kill_after_units = 0

#: send SIGTERM to this process after N journal commits (the test and
#: chip-smoke hook that lands a kill at a unit boundary)
KILL_AFTER_ENV = "GOSSIP_RESILIENCE_KILL_AFTER_UNITS"


def reset_shutdown() -> None:
    """Clear the shutdown state (``cli.main`` calls this on entry, so an
    earlier in-process run's interrupt cannot leak)."""
    global _units_this_run, _kill_after_units
    _shutdown_event.clear()
    _units_this_run = 0
    _kill_after_units = int(os.environ.get(KILL_AFTER_ENV, "0") or 0)


def request_shutdown() -> None:
    """Programmatic SIGTERM equivalent."""
    _shutdown_event.set()


def shutdown_requested() -> bool:
    return _shutdown_event.is_set()


def set_kill_after_units(n: int) -> None:
    """Request shutdown after ``n`` journal commits."""
    global _kill_after_units
    _kill_after_units = int(n)


def note_unit_committed() -> None:
    global _units_this_run
    _units_this_run += 1
    if _kill_after_units and _units_this_run >= _kill_after_units:
        if _handlers_installed.is_set():
            os.kill(os.getpid(), signal.SIGTERM)
        else:
            request_shutdown()


_handlers_installed = threading.Event()


@contextlib.contextmanager
def signal_guard():
    """SIGTERM/SIGINT request a graceful, resumable shutdown while the
    block runs; a second SIGINT raises KeyboardInterrupt.  A no-op off the
    main thread (``signal.signal`` would raise)."""
    prev = {}
    try:
        def _handler(signum, frame):
            if signum == signal.SIGINT and shutdown_requested():
                raise KeyboardInterrupt
            log.warning(
                "received signal %s: finishing the in-flight unit, "
                "committing the journal, and exiting with the resumable "
                "exit code %s", signum, RESUMABLE_EXIT_CODE)
            _shutdown_event.set()

        for sig in (signal.SIGTERM, signal.SIGINT):
            prev[sig] = signal.signal(sig, _handler)
        _handlers_installed.set()
    except ValueError:  # not the main thread: run unguarded
        prev = {}
    try:
        yield
    finally:
        _handlers_installed.clear()
        for sig, h in prev.items():
            try:
                signal.signal(sig, h)
            except ValueError:  # pragma: no cover
                pass


def check_interrupt(journal=None) -> None:
    """At a unit boundary: raise :class:`ResumableInterrupt` when a
    shutdown was requested (the finished units are committed)."""
    if shutdown_requested():
        raise ResumableInterrupt(
            "graceful shutdown at a unit boundary"
            + (f" ({len(journal.records)} unit(s) committed)"
               if journal is not None else ""))


# --------------------------------------------------------------------------
# device supervisor
# --------------------------------------------------------------------------

_fault_hook = None


def set_fault_hook(fn) -> None:
    """Install a fault injector called as ``fn(label, attempt)`` before
    every supervised attempt; raising from it simulates a device failure.
    ``None`` uninstalls.  A hook also turns supervision on."""
    global _fault_hook
    _fault_hook = fn


class DispatchPolicy:
    """The resolved supervisor knobs of one run (the cli flags)."""

    def __init__(self, timeout_s: float = 0.0, retries: int = 2,
                 backoff_s: float = 0.5, on_failure: str = "abort"):
        self.timeout_s = float(timeout_s)
        self.retries = max(0, int(retries))
        self.backoff_s = float(backoff_s)
        self.on_failure = on_failure


def supervision(config) -> DispatchPolicy | None:
    """The dispatch policy a Config opts into, or None (unsupervised, the
    default, which adds no work).  Supervision is on with a watchdog
    timeout, an explicit ``--on-device-failure`` or a fault hook."""
    timeout = getattr(config, "device_timeout_s", 0.0)
    on_failure = getattr(config, "on_device_failure", "")
    if timeout <= 0 and not on_failure and _fault_hook is None:
        return None
    return DispatchPolicy(timeout_s=timeout,
                          retries=getattr(config, "device_retries", 2),
                          # not a flag: tests set it on the Config to skip
                          # the backoff sleeps
                          backoff_s=getattr(config, "device_backoff_s", 0.5),
                          on_failure=on_failure or "abort")


def _is_transient(exc: BaseException) -> bool:
    """Retryable failures: timeouts, ``torch.cuda.OutOfMemoryError`` and the
    other ``RuntimeError``s of the device and the kernel wrappers, and
    ``OSError``s.  Programming errors and refusals (``TypeError``,
    ``ValueError``, ``NotImplementedError``) are not retried."""
    if isinstance(exc, (NotImplementedError, RecursionError)):
        return False
    return isinstance(exc, (DeviceTimeoutError, TimeoutError, OSError,
                            ConnectionError, RuntimeError))


def _call_with_timeout(fn, timeout_s: float, label: str):
    """Run ``fn`` bounded by ``timeout_s`` on a daemon worker thread
    (<= 0: inline).  A hung call cannot be cancelled, only outwaited: the
    thread is abandoned on timeout."""
    if timeout_s <= 0:
        return fn()
    result: list = []
    error: list = []

    def _worker():
        try:
            result.append(fn())
        except BaseException as e:  # noqa: BLE001 - re-raised below
            error.append(e)

    t = threading.Thread(target=_worker, daemon=True,
                         name=f"device-dispatch:{label}")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise DeviceTimeoutError(
            f"device dispatch '{label}' exceeded --device-timeout-s "
            f"{timeout_s}")
    if error:
        raise error[0]
    return result[0]


def supervised_call(label: str, attempt_fn, policy: DispatchPolicy,
                    cpu_fallback=None):
    """Run one unit under the watchdog, retry and fallback policy.

    ``attempt_fn`` must be safe to call again (each attempt builds fresh
    tensors from a host copy).  Transient failures are retried
    ``policy.retries`` times with exponential backoff and counted as
    ``resilience/device_failures``; then ``cpu-fallback`` calls
    ``cpu_fallback`` (counted as ``resilience/fallback_units``) and
    ``abort`` raises :class:`DeviceDispatchError`."""
    delay = policy.backoff_s
    last = None
    for attempt in range(policy.retries + 1):
        try:
            if _fault_hook is not None:
                _fault_hook(label, attempt)
            return _call_with_timeout(attempt_fn, policy.timeout_s, label)
        except BaseException as e:  # noqa: BLE001 - classified below
            if not _is_transient(e):
                raise
            last = e
            COUNTS["resilience/device_failures"] += 1
            if attempt < policy.retries:
                log.warning("device dispatch '%s' failed (attempt %s/%s): "
                            "%s — retrying in %.2fs", label, attempt + 1,
                            policy.retries + 1, e, delay)
                time.sleep(delay)
                delay *= 2
    if policy.on_failure == "cpu-fallback" and cpu_fallback is not None:
        log.warning("device dispatch '%s' failed %s attempt(s); "
                    "re-executing the unit on the CPU fallback path",
                    label, policy.retries + 1)
        COUNTS["resilience/fallback_units"] += 1
        # the fault hook injects device failures; the CPU arm runs clean
        return cpu_fallback()
    raise DeviceDispatchError(
        f"device dispatch '{label}' failed after {policy.retries + 1} "
        f"attempt(s) ({last}); the journal holds every earlier unit — "
        f"re-run with --resume") from last
