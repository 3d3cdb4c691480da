"""The port's run journal, resume and device supervisor
(gossip_sim_tpu_torch/resilience.py and the journal arms of cli.py)
against the JAX package's.

* (a) journal mechanics: round trip, torn tail, run-key drift, overwrite
  without ``--resume``, split checkpoint/resume paths; the port's journal
  read by the reference's ``RunJournal`` and the run keys of both packages
  equal for the same flags;
* (b) ``restore_stats`` of the port and of the reference on one payload:
  equal ``parity_snapshot()``s and end-of-run statistics;
* (c) ``supervised_call``: retry, no retry of a programming error, timeout
  then recovery, ``cpu-fallback``, ``abort``;
* (d) kill and resume, against the reference's uninterrupted run (parity
  snapshots, deterministic Influx lines, aggregates, summaries): the serial
  sweep, the lane sweep, the origin-rank sweep, all-origins, all-origins
  with its sidecar one batch ahead of its journal, and the traffic run;
* (e) one journal crossing each way: all-origins stopped by the reference
  and resumed by the port, a serial sweep stopped by the port and resumed
  by the reference;
* (f) SIGTERM through ``main`` exits 75 with a committed journal, and the
  resumed run completes; ``abort`` exits 75 and ``--resume`` gives the
  uninterrupted aggregate; a failed attempt is retried, and
  ``cpu-fallback`` (``--device cpu``; refused on the card) and
  ``--device-timeout-s`` give the same aggregate;
  ``--checkpoint-every-s`` throttles the block saves.

Tolerance: 0 everywhere (exact equality)."""

import gossip_sim_tpu.engine as je  # noqa: I001  (64-bit types first)
import json
import logging
import os
import time

import jax
import numpy as np
import pytest
import torch

from gossip_sim_tpu import cli as ref_cli
from gossip_sim_tpu import resilience as ref_res
from gossip_sim_tpu.config import Config as RefConfig
from gossip_sim_tpu.config import StepSize as RefStep
from gossip_sim_tpu.config import Testing as RefTesting
from gossip_sim_tpu.identity import reset_unique_pubkeys as ref_reset
from gossip_sim_tpu.obs import get_registry
from gossip_sim_tpu.sinks import DatapointQueue as RefQueue
from gossip_sim_tpu.stats.gossip_stats import \
    GossipStatsCollection as RefCollection
from gossip_sim_tpu.stats.traffic import \
    TrafficStatsCollection as RefTrafficCollection
from gossip_sim_tpu_torch import checkpoint as ckpt
from gossip_sim_tpu_torch import cli, resilience, rng
from gossip_sim_tpu_torch.config import Config, StepSize
from gossip_sim_tpu_torch.config import Testing as PortTesting
from gossip_sim_tpu_torch.identity import reset_unique_pubkeys
from gossip_sim_tpu_torch.resilience import (RESUMABLE_EXIT_CODE,
                                             DeviceDispatchError,
                                             DeviceTimeoutError,
                                             DispatchPolicy, RunJournal,
                                             journal_path, supervised_call)
from gossip_sim_tpu_torch.sinks import DatapointQueue
from gossip_sim_tpu_torch.stats.gossip_stats import GossipStatsCollection
from gossip_sim_tpu_torch.stats.traffic import TrafficStatsCollection
from test_torch_aggregate import assert_state_dicts_equal


@pytest.fixture(scope="module", autouse=True)
def pinned():
    """Both packages on the partitionable threefry layout, the port on
    one CPU thread; restored afterwards."""
    old = jax.config.jax_threefry_partitionable
    old_port = rng.partitionable()
    threads = torch.get_num_threads()
    jax.config.update("jax_threefry_partitionable", True)
    rng.set_partitionable(True)
    torch.set_num_threads(1)
    yield
    jax.config.update("jax_threefry_partitionable", old)
    rng.set_partitionable(old_port)
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean():
    for mod in (resilience, ref_res):
        mod.reset_shutdown()
        mod.set_fault_hook(None)
    resilience.reset_counts()
    yield
    for mod in (resilience, ref_res):
        mod.reset_shutdown()
        mod.set_fault_hook(None)


def _strings(snap: dict) -> dict:
    """Map the two packages' distinct Pubkey classes to base58 strings."""
    def key(k):
        return k.to_string() if hasattr(k, "to_string") else k
    return {name: ({key(k): x for k, x in v.items()} if isinstance(v, dict)
                   else {key(k) for k in v} if isinstance(v, set) else v)
            for name, v in snap.items()}


def _snaps(coll):
    return [_strings(s.parity_snapshot()) for s in coll.collection]


def _assert_same_sweep(want, got):
    (snaps_a, lines_a), (snaps_b, lines_b) = want, got
    assert len(snaps_a) == len(snaps_b) > 0
    for i, (a, b) in enumerate(zip(snaps_a, snaps_b)):
        assert set(a) == set(b)
        for k in a:
            assert a[k] == b[k], f"sim{i}:{k}"
    assert lines_a == lines_b and lines_a


# the reference's resilience test configurations (tests/test_resilience.py),
# cut to one compile of the reference's round each: no warm-up scan in the
# sweeps and the traffic run, and every packet-loss point impaired
SWEEP = dict(num_synthetic_nodes=48, gossip_iterations=6, warm_up_rounds=0,
             test_type="packet-loss", num_simulations=4, step_size="0.1",
             packet_loss_rate=0.05, seed=13)
ALL_ORIGINS = dict(num_synthetic_nodes=40, gossip_iterations=5,
                   warm_up_rounds=2, all_origins=True, origin_batch=16,
                   mesh_devices=1, seed=9)
ORIGIN_RANK = dict(num_synthetic_nodes=40, gossip_iterations=6,
                   warm_up_rounds=0, test_type="origin-rank",
                   num_simulations=3, step_size="1", seed=9)
RANKS = [1, 3, 5]
TRAFFIC = dict(num_synthetic_nodes=48, gossip_iterations=8,
               warm_up_rounds=0, traffic_values=4, traffic_rate=1,
               node_ingress_cap=4, packet_loss_rate=0.05, seed=13)


def _cfg(package, **kw):
    """A Config of ``package`` ("ref" or "port") from common keywords."""
    kw = dict(kw)
    if "test_type" in kw:
        kw["test_type"] = (RefTesting if package == "ref"
                           else PortTesting).parse(kw["test_type"])
    if "step_size" in kw:
        kw["step_size"] = (RefStep if package == "ref"
                           else StepSize).parse(kw["step_size"])
    return RefConfig(**kw) if package == "ref" else Config(device="cpu",
                                                           **kw)


def _fresh_ref():
    ref_reset()
    get_registry().reset()
    ref_res.reset_shutdown()


def _fresh_port():
    reset_unique_pubkeys()
    resilience.reset_shutdown()


# ---- the reference's uninterrupted runs, one per path ---------------------

def _ref_sweep(kw, kill_after=0, ranks=(1,)):
    _fresh_ref()
    if kill_after:
        ref_res.set_kill_after_units(kill_after)
    coll, dq = RefCollection(), RefQueue()
    coll.set_number_of_simulations(kw["num_simulations"])
    ref_cli.dispatch_sweeps(_cfg("ref", **kw), "", list(ranks), coll, dq,
                            "0")
    return _snaps(coll), dq.drain_deterministic_lines()


def _port_sweep(kw, kill_after=0, ranks=(1,)):
    _fresh_port()
    if kill_after:
        resilience.set_kill_after_units(kill_after)
    coll, dq = GossipStatsCollection(), DatapointQueue()
    coll.set_number_of_simulations(kw["num_simulations"])
    cli.dispatch_sweeps(_cfg("port", **kw), "", list(ranks), coll, dq, "0")
    return _snaps(coll), dq.drain_deterministic_lines()


def _ref_all_origins(kw, kill_after=0):
    _fresh_ref()
    if kill_after:
        ref_res.set_kill_after_units(kill_after)
    dq = RefQueue()
    s = ref_cli.run_all_origins(_cfg("ref", **kw), "", dq, "0")
    return s, dq.drain_deterministic_lines()


def _port_all_origins(kw, kill_after=0):
    _fresh_port()
    if kill_after:
        resilience.set_kill_after_units(kill_after)
    dq = DatapointQueue()
    s = cli.run_all_origins(_cfg("port", **kw), dp_queue=dq, start_ts="0")
    return s, dq.drain_deterministic_lines()


@pytest.fixture(scope="module")
def ref_runs():
    """Each path's uninterrupted reference run, computed once, on demand."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = {
                "serial": lambda: _ref_sweep(SWEEP),
                "lanes": lambda: _ref_sweep(dict(SWEEP, num_simulations=5,
                                                 sweep_lanes=2)),
                "origin_rank": lambda: _ref_sweep(ORIGIN_RANK, ranks=RANKS),
                "all_origins": lambda: _ref_all_origins(ALL_ORIGINS),
            }[name]()
        return cache[name]
    return get


def _assert_same_all_origins(want, got):
    (s_a, lines_a), (s_b, lines_b) = want, got
    for k in s_a:
        if k in ("elapsed_s", "origin_iters_per_sec", "stats"):
            continue
        assert s_a[k] == s_b[k], k
    assert_state_dicts_equal(s_a["stats"].state_dict(),
                             s_b["stats"].state_dict())
    assert lines_a == lines_b and lines_a


# --------------------------------------------------------------------------
# (a) journal mechanics
# --------------------------------------------------------------------------

def test_journal_round_trip_torn_tail_drift_and_overwrite(tmp_path, caplog):
    jp = str(tmp_path / "run.journal")
    key = {"seed": 1, "kind": "serial-sweep"}
    j = RunJournal(jp, key)
    j.commit(0, {"x": 1})
    j.commit(1, {"y": [1.5, 2.5]})
    j.close()
    j2 = RunJournal(jp, key, resume=True)
    assert j2.committed_prefix() == 2
    assert j2.records == {0: {"x": 1}, 1: {"y": [1.5, 2.5]}}
    # the reference reads the port's journal as its own
    jr = ref_res.RunJournal(jp, key, resume=True)
    assert jr.records == j2.records and jr.header == j2.header
    # a torn tail: that unit is uncommitted, and later commits append
    with open(jp, "a") as f:
        f.write('{"unit": 2, "payload": {"tor')
    with caplog.at_level(logging.WARNING):
        j3 = RunJournal(jp, key, resume=True)
    assert j3.committed_prefix() == 2
    assert any("partial" in r.message for r in caplog.records)
    j3.commit(2, {"ok": True})
    j3.close()
    assert RunJournal(jp, key, resume=True).committed_prefix() == 3
    assert resilience.COUNTS["resilience/committed_units"] == 3
    # run-key drift
    with pytest.raises(SystemExit, match="seed: journal=1 vs now=2"):
        RunJournal(jp, {"seed": 2, "kind": "serial-sweep"}, resume=True)
    # no --resume: a fresh journal, with a warning
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        j4 = RunJournal(jp, key)
    assert j4.committed_prefix() == 0
    assert any("overwriting" in r.message for r in caplog.records)


def test_run_keys_equal_the_references(tmp_path):
    argv = ["--num-synthetic-nodes", "48", "--iterations", "6",
            "--test-type", "origin-rank", "--num-simulations", "3",
            "--origin-rank", "1", "3", "5", "--sweep-lanes", "2"]
    ref = ref_cli.config_from_args(ref_cli.build_parser().parse_args(argv))
    port = cli.config_from_args(cli.build_parser().parse_args(argv))
    extra = {"origin_ranks": RANKS}
    for kind in ("serial-sweep", "lane-sweep", "origin-rank",
                 "all-origins"):
        want = ref_res.run_key_from_config(ref, kind, extra)
        assert resilience.run_key_from_config(port, kind, extra) == want
    assert want["backend"] == "tpu"


def test_split_checkpoint_and_resume_paths_are_refused(tmp_path):
    with pytest.raises(SystemExit, match="SAME path"):
        _port_sweep(dict(SWEEP, checkpoint_path=str(tmp_path / "a.npz"),
                         resume_path=str(tmp_path / "b.npz")))


# --------------------------------------------------------------------------
# (b) restore_stats
# --------------------------------------------------------------------------

def test_restore_stats_equals_the_references(tmp_path):
    from gossip_sim_tpu.resilience import restore_stats as ref_restore
    kw = dict(num_synthetic_nodes=48, gossip_iterations=14,
              warm_up_rounds=2, packet_loss_rate=0.15, churn_fail_rate=0.02,
              churn_recover_rate=0.3, partition_at=4, heal_at=6, seed=13)
    _fresh_port()
    coll = cli.simulate(_cfg("port", **kw))
    stats = coll.collection[0]
    payload = json.loads(json.dumps(resilience.stats_unit_payload(stats)))
    assert payload["post_heal"] and stats.failed_nodes
    reset_unique_pubkeys()
    accounts, _ = cli.load_cluster_accounts(_cfg("port", **kw))
    mine = resilience.restore_stats(payload, _cfg("port", **kw),
                                    dict(accounts))
    _fresh_ref()
    ref_accounts, _ = ref_cli.load_cluster_accounts(_cfg("ref", **kw), "")
    theirs = ref_restore(payload, _cfg("ref", **kw), dict(ref_accounts))
    want = _strings(stats.parity_snapshot())
    assert _strings(mine.parity_snapshot()) == want
    assert _strings(theirs.parity_snapshot()) == want
    cli._build_final_stats(_cfg("port", **kw), mine, dict(accounts))
    ref_cli._build_final_stats(_cfg("ref", **kw), theirs, dict(ref_accounts))
    for a, b in ((mine, stats), (theirs, stats)):
        assert a.coverage_stats.mean == b.coverage_stats.mean
        assert a.rmr_stats.mean == b.rmr_stats.mean
        assert a.recovery_iterations == b.recovery_iterations
        assert (a.get_last_delivery_hop_stats()
                == b.get_last_delivery_hop_stats())


# --------------------------------------------------------------------------
# (c) the supervisor
# --------------------------------------------------------------------------

def test_supervised_call_policy():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient device flake")
        return "ok"

    assert supervised_call("t", flaky, DispatchPolicy(
        retries=2, backoff_s=0.001)) == "ok"
    assert len(calls) == 3
    assert resilience.COUNTS["resilience/device_failures"] == 2

    def bug():
        calls.append(1)
        raise ValueError("shape mismatch is a bug, not a flake")
    calls.clear()
    with pytest.raises(ValueError):
        supervised_call("t", bug, DispatchPolicy(retries=3,
                                                 backoff_s=0.001))
    assert len(calls) == 1

    calls.clear()

    def hung_once():
        calls.append(1)
        if len(calls) == 1:
            time.sleep(0.5)
        return "ok"
    assert supervised_call("t", hung_once, DispatchPolicy(
        timeout_s=0.05, retries=1, backoff_s=0.001)) == "ok"
    assert len(calls) == 2

    def broken():
        raise torch.cuda.OutOfMemoryError("device out of memory")
    assert supervised_call("t", broken, DispatchPolicy(
        retries=1, backoff_s=0.001, on_failure="cpu-fallback"),
        cpu_fallback=lambda: "cpu") == "cpu"
    assert resilience.COUNTS["resilience/fallback_units"] == 1
    with pytest.raises(DeviceDispatchError, match="--resume"):
        supervised_call("t", broken, DispatchPolicy(
            retries=0, backoff_s=0.001, on_failure="abort"),
            cpu_fallback=lambda: "cpu")
    assert resilience._is_transient(DeviceTimeoutError("x"))
    assert not resilience._is_transient(NotImplementedError("x"))
    assert not resilience._is_transient(TypeError("x"))


# --------------------------------------------------------------------------
# (d) kill and resume against the reference's uninterrupted runs
# --------------------------------------------------------------------------

def test_serial_sweep_kill_and_resume(ref_runs, tmp_path):
    ck = str(tmp_path / "sweep.npz")
    with pytest.raises(resilience.ResumableInterrupt):
        _port_sweep(dict(SWEEP, checkpoint_path=ck), kill_after=2)
    assert os.path.exists(journal_path(ck))
    got = _port_sweep(dict(SWEEP, checkpoint_path=ck, resume_path=ck))
    _assert_same_sweep(ref_runs("serial"), got)
    assert resilience.COUNTS["resilience/resumed_units"] == 2


def test_lane_sweep_kill_and_resume(ref_runs, tmp_path):
    kw = dict(SWEEP, num_simulations=5, sweep_lanes=2)
    ck = str(tmp_path / "lane.npz")
    with pytest.raises(resilience.ResumableInterrupt):
        _port_sweep(dict(kw, checkpoint_path=ck), kill_after=1)
    got = _port_sweep(dict(kw, checkpoint_path=ck, resume_path=ck))
    _assert_same_sweep(ref_runs("lanes"), got)


def test_origin_rank_sweep_kill_and_resume(ref_runs, tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "HARVEST_BLOCK", 2)     # three units a run
    ck = str(tmp_path / "orank.npz")
    with pytest.raises(resilience.ResumableInterrupt):
        _port_sweep(dict(ORIGIN_RANK, checkpoint_path=ck), kill_after=2,
                    ranks=RANKS)
    _, _, meta = ckpt.load_state(ck)
    assert meta["resilience"] == {"journal": "orank.journal",
                                  "committed_units": 2}
    got = _port_sweep(dict(ORIGIN_RANK, checkpoint_path=ck, resume_path=ck),
                      ranks=RANKS)
    _assert_same_sweep(ref_runs("origin_rank"), got)


def test_origin_rank_state_ahead_of_the_journal_is_refused(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(cli, "HARVEST_BLOCK", 2)
    ck = str(tmp_path / "orank.npz")
    with pytest.raises(resilience.ResumableInterrupt):
        _port_sweep(dict(ORIGIN_RANK, checkpoint_path=ck), kill_after=1,
                    ranks=RANKS)
    jp = journal_path(ck)
    lines = open(jp).read().splitlines()
    lines.append(lines[-1].replace('"unit": 0', '"unit": 1'))
    open(jp, "w").write("\n".join(lines) + "\n")
    with pytest.raises(SystemExit, match="died between the state save"):
        _port_sweep(dict(ORIGIN_RANK, checkpoint_path=ck, resume_path=ck),
                    ranks=RANKS)


def test_all_origins_kill_and_resume(ref_runs, tmp_path):
    ck = str(tmp_path / "ao.npz")
    with pytest.raises(resilience.ResumableInterrupt):
        _port_all_origins(dict(ALL_ORIGINS, checkpoint_path=ck),
                          kill_after=1)
    assert os.path.exists(str(tmp_path / "ao.aggstate.npz"))
    got = _port_all_origins(dict(ALL_ORIGINS, checkpoint_path=ck,
                                 resume_path=ck))
    _assert_same_all_origins(ref_runs("all_origins"), got)
    # a journal whose batches were of another width (another mesh, or
    # --origin-batch 0 over another origin count) is refused
    jp = journal_path(ck)
    text = open(jp).read().replace('"batch": 16', '"batch": 8')
    open(jp, "w").write(text)
    with pytest.raises(SystemExit, match="does not match the journal's 8"):
        _port_all_origins(dict(ALL_ORIGINS, checkpoint_path=ck,
                               resume_path=ck))


def test_all_origins_sidecar_ahead_of_its_journal(ref_runs, tmp_path,
                                                  caplog):
    ck = str(tmp_path / "ao.npz")
    with pytest.raises(resilience.ResumableInterrupt):
        _port_all_origins(dict(ALL_ORIGINS, checkpoint_path=ck),
                          kill_after=2)
    # the crash window: the journal lost its last record, the sidecar
    # holds both batches
    jp = journal_path(ck)
    lines = open(jp).read().splitlines()
    open(jp, "w").write("\n".join(lines[:-1]) + "\n")
    with caplog.at_level(logging.WARNING):
        s, _ = _port_all_origins(dict(ALL_ORIGINS, checkpoint_path=ck,
                                      resume_path=ck))
    assert any("one batch ahead" in r.message for r in caplog.records)
    want, _ = ref_runs("all_origins")
    assert s["padded_sims"] == want["padded_sims"]
    assert_state_dicts_equal(want["stats"].state_dict(),
                             s["stats"].state_dict())


def test_traffic_run_stop_and_resume(tmp_path, monkeypatch):
    """A shutdown request stops the traffic run after its first measured
    block with a kind="traffic" file; the resumed run's summary, parity
    snapshot and final state equal the reference's uninterrupted run's."""
    _fresh_ref()
    want_path = str(tmp_path / "ref.npz")
    ref_coll = RefTrafficCollection()
    ref_cli.run_traffic(_cfg("ref", **TRAFFIC, checkpoint_path=want_path),
                        "", None, "0", ref_coll)
    monkeypatch.setattr(cli, "HARVEST_BLOCK", 4)
    ck = str(tmp_path / "traffic.npz")
    _fresh_port()
    resilience.request_shutdown()
    with pytest.raises(resilience.ResumableInterrupt, match="iteration 4"):
        cli.run_traffic(_cfg("port", **TRAFFIC, checkpoint_path=ck), "",
                        None, "0", TrafficStatsCollection())
    _, _, meta = ckpt.load_state(ck)
    assert meta["kind"] == "traffic" and meta["iteration"] == 4
    _fresh_port()
    coll = TrafficStatsCollection()
    report = cli.run_traffic(_cfg("port", **TRAFFIC, checkpoint_path=ck,
                                  resume_path=ck), "", None, "0", coll)
    assert coll.collection[0].parity_snapshot() == \
        ref_coll.collection[0].parity_snapshot()
    assert report["traffic"] == {k: v for k, v in
                                 ref_coll.summaries()[-1].items()
                                 if k != "point"}
    with np.load(want_path) as a, np.load(ck) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            if k != "__meta__":
                assert np.array_equal(a[k], b[k]), k


def test_traffic_sweeps_refuse_checkpoints(tmp_path, caplog):
    kw = dict(TRAFFIC, test_type="traffic-rate", num_simulations=2,
              step_size="1", checkpoint_path=str(tmp_path / "t.npz"))
    with pytest.raises(ValueError, match="cover single traffic runs only"):
        cli.run_traffic(_cfg("port", **kw))
    assert cli._traffic_lane_blocker(_cfg("port", **kw), 2) == \
        "traffic checkpoints cover single runs only"
    argv = ["--num-synthetic-nodes", "48", "--traffic-values", "4",
            "--test-type", "traffic-rate", "--num-simulations", "2",
            "--checkpoint-path", str(tmp_path / "t.npz"), "--device", "cpu"]
    with caplog.at_level(logging.ERROR):
        assert cli.main(argv) == 1
    assert "a traffic sweep has no per-point journal yet" in caplog.text


# --------------------------------------------------------------------------
# (e) journals crossing between the packages
# --------------------------------------------------------------------------

def test_all_origins_stopped_by_the_reference_resumed_by_the_port(
        ref_runs, tmp_path):
    ck = str(tmp_path / "ao.npz")
    with pytest.raises(ref_res.ResumableInterrupt):
        _ref_all_origins(dict(ALL_ORIGINS, checkpoint_path=ck),
                         kill_after=1)
    got = _port_all_origins(dict(ALL_ORIGINS, checkpoint_path=ck,
                                 resume_path=ck))
    _assert_same_all_origins(ref_runs("all_origins"), got)


def test_serial_sweep_stopped_by_the_port_resumed_by_the_reference(
        ref_runs, tmp_path):
    ck = str(tmp_path / "sweep.npz")
    with pytest.raises(resilience.ResumableInterrupt):
        _port_sweep(dict(SWEEP, checkpoint_path=ck), kill_after=2)
    got = _ref_sweep(dict(SWEEP, checkpoint_path=ck, resume_path=ck))
    _assert_same_sweep(ref_runs("serial"), got)


# --------------------------------------------------------------------------
# (f) the CLI: exit code 75, the supervisor, the save throttle
# --------------------------------------------------------------------------

SWEEP_ARGV = ["--num-synthetic-nodes", "48", "--iterations", "6",
              "--warm-up-rounds", "2", "--test-type", "packet-loss",
              "--num-simulations", "3", "--step-size", "0.1", "--seed", "13",
              "--device", "cpu"]


def test_sigterm_exits_75_and_the_resumed_run_completes(tmp_path,
                                                        monkeypatch):
    ck = str(tmp_path / "sig.npz")
    _fresh_port()
    monkeypatch.setenv(resilience.KILL_AFTER_ENV, "1")
    assert cli.main(SWEEP_ARGV + ["--checkpoint-path", ck]) == \
        RESUMABLE_EXIT_CODE == 75
    with open(journal_path(ck)) as f:
        recs = [json.loads(ln) for ln in f.read().splitlines()]
    assert [r["unit"] for r in recs[1:]] == [0]
    monkeypatch.delenv(resilience.KILL_AFTER_ENV)
    _fresh_port()
    assert cli.main(SWEEP_ARGV + ["--checkpoint-path", ck, "--resume",
                                  ck]) == 0
    assert resilience.COUNTS["resilience/resumed_units"] == 1


def test_supervised_all_origins(ref_runs, tmp_path):
    """A failed first attempt of unit 1 is retried; abort exits 75 and the
    resume completes; cpu-fallback (with --device cpu) and a watchdog
    timeout run each unit apart: every aggregate equals the reference's
    uninterrupted one.  On the card cpu-fallback is refused."""
    want = ref_runs("all_origins")
    argv = ["--num-synthetic-nodes", "40", "--iterations", "5",
            "--warm-up-rounds", "2", "--all-origins", "--origin-batch",
            "16", "--seed", "9", "--device", "cpu", "--device-retries", "1"]
    seen = []

    def fail_first_of_unit_1(label, attempt):
        seen.append((label, attempt))
        if label == "origin-batch-1" and attempt == 0:
            raise RuntimeError("injected device failure")

    def run(hook, extra):
        """The aggregate of ``cli.run_all_origins`` under ``hook``."""
        resilience.set_fault_hook(hook)
        try:
            cfg = cli.config_from_args(cli.build_parser().parse_args(
                argv + extra))
            cfg.device_backoff_s = 0.001
            return _port_all_origins_cfg(cfg)
        finally:
            resilience.set_fault_hook(None)

    _assert_same_all_origins(want, run(fail_first_of_unit_1, []))
    assert ("origin-batch-1", 1) in seen
    assert resilience.COUNTS["resilience/device_failures"] == 1

    def dead_from_unit_1(label, attempt):
        if label != "origin-batch-0":
            raise RuntimeError("dead device")

    ck = str(tmp_path / "abort.npz")
    resilience.set_fault_hook(dead_from_unit_1)
    try:
        _fresh_port()
        assert cli.main(argv + ["--on-device-failure", "abort",
                                "--checkpoint-path", ck]) == 75
    finally:
        resilience.set_fault_hook(None)
    got = _port_all_origins(dict(ALL_ORIGINS, checkpoint_path=ck,
                                 resume_path=ck))
    _assert_same_all_origins(want, got)

    def dead_on_unit_1(label, attempt):
        if label == "origin-batch-1":
            raise RuntimeError("dead device")

    resilience.reset_counts()
    _assert_same_all_origins(want, run(dead_on_unit_1,
                                       ["--on-device-failure",
                                        "cpu-fallback"]))
    assert resilience.COUNTS["resilience/fallback_units"] == 1
    _assert_same_all_origins(want, run(None, ["--device-timeout-s", "60"]))
    # on the card a failed unit never moves to the CPU: the start-up checks
    # refuse cpu-fallback before any engine work, and the dispatcher raises
    on_card = [a for a in argv if a not in ("--device", "cpu")]
    ck = str(tmp_path / "fallback.npz")
    _fresh_port()
    assert cli.main(on_card + ["--on-device-failure", "cpu-fallback",
                               "--checkpoint-path", ck]) == 1
    assert not os.path.exists(journal_path(ck))
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        on_card + ["--on-device-failure", "cpu-fallback"]))
    with pytest.raises(ValueError, match="only with --device cpu"):
        cli._dispatch_supervised(cfg, "unit", lambda st, d: st, None,
                                 torch.device("cuda"))


def _port_all_origins_cfg(cfg):
    _fresh_port()
    dq = DatapointQueue()
    s = cli.run_all_origins(cfg, dp_queue=dq, start_ts="0")
    return s, dq.drain_deterministic_lines()


def test_checkpoint_every_s_throttles_block_saves(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "HARVEST_BLOCK", 2)
    saves = []
    real = ckpt.save_state
    monkeypatch.setattr(ckpt, "save_state", lambda *a, **kw: (
        saves.append(kw.get("iteration")), real(*a, **kw)))
    argv = ["--num-synthetic-nodes", "48", "--iterations", "12",
            "--warm-up-rounds", "2", "--seed", "13", "--device", "cpu",
            "--checkpoint-path", str(tmp_path / "c.npz")]
    _fresh_port()
    assert cli.main(argv) == 0
    assert saves == [2, 4, 6, 8, 10, 12, 12]
    saves.clear()
    _fresh_port()
    assert cli.main(argv + ["--checkpoint-every-s", "3600"]) == 0
    assert saves == [2, 12]
