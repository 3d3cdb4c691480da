"""Traffic sweeps with ``--sweep-lanes`` in the port's CLI against the
reference package's, and lane batches of more than 64 lanes (C13).

* ``cli.run_traffic`` on ``device="cpu"`` with ``--sweep-lanes`` gives the
  reference's report (``sweep_lanes`` included), every point's
  ``TrafficStats.parity_snapshot()`` and ``summary()``, and the
  deterministic Influx lines: a 3-point ``traffic-rate`` sweep at 2 lanes
  (a tail batch of one point) under loss and both caps, and a 3-point
  ``adaptive-threshold`` sweep at 3 lanes;
* the traffic runs lanes cannot serve log the reference's reason and run
  serially with the serial results (one point; no measured rounds), and
  the blocker gives the reference's words for each reason;
* a push sweep of 66 points with ``--sweep-lanes 66`` gives the
  reference's lane width, batch count, ``LANE-BATCHED SWEEP`` line and
  every point's ``parity_snapshot()``.

Both threefry layouts are pinned to the partitionable one.  Each reference
run happens once a module.  Tolerance: 0 (exact equality)."""

import gossip_sim_tpu.engine  # noqa: F401,I001  (64-bit types first)
import functools
import logging
import types

import pytest

from gossip_sim_tpu import cli as ref_cli
from gossip_sim_tpu.identity import reset_unique_pubkeys as ref_reset
from gossip_sim_tpu.obs import get_registry
from gossip_sim_tpu.sinks import DatapointQueue as RefQueue
from gossip_sim_tpu.stats.gossip_stats import \
    GossipStatsCollection as RefCollection
from gossip_sim_tpu.stats.traffic import TrafficStatsCollection as RefColl
from gossip_sim_tpu_torch import cli
from gossip_sim_tpu_torch.config import Testing as SweepType
from gossip_sim_tpu_torch.identity import reset_unique_pubkeys
from gossip_sim_tpu_torch.sinks import DatapointQueue
from gossip_sim_tpu_torch.stats.gossip_stats import GossipStatsCollection
from gossip_sim_tpu_torch.stats.traffic import TrafficStatsCollection
from test_torch_sweeps import _strings, partitionable  # noqa: F401

BASE = ["--num-synthetic-nodes", "100", "--iterations", "16",
        "--warm-up-rounds", "6"]
TRAFFIC = ["--traffic-values", "8", "--traffic-rate", "2",
           "--node-ingress-cap", "6", "--node-egress-cap", "10"]
SWEEPS = {
    # 2, 4, 6 values a round: batches of 2 and 1 lanes
    "traffic-rate": TRAFFIC + ["--packet-loss-rate", "0.1", "--test-type",
                               "traffic-rate", "--num-simulations", "3",
                               "--step-size", "2", "--sweep-lanes", "2"],
    "adaptive-threshold": TRAFFIC + [
        "--gossip-mode", "adaptive", "--adaptive-switch-threshold", "0.3",
        "--test-type", "adaptive-threshold", "--num-simulations", "3",
        "--step-size", "0.3", "--sweep-lanes", "3"],
}


def _ref_run(argv):
    ref_reset()
    get_registry().reset()
    cfg = ref_cli.config_from_args(ref_cli.build_parser().parse_args(
        argv + ["--backend", "tpu"]))
    coll, q = RefColl(), RefQueue()
    report = ref_cli.run_traffic(cfg, "u", q, "77", collection=coll)
    return report, coll, q.drain_deterministic_lines()


def _port_run(argv):
    reset_unique_pubkeys()
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    coll, q = TrafficStatsCollection(), DatapointQueue()
    report = cli.run_traffic(cfg, "u", q, "77", collection=coll)
    return report, coll, q.drain_deterministic_lines()


@functools.lru_cache(maxsize=None)
def _ref_cached(name):
    return _ref_run(BASE + SWEEPS[name])


def _assert_runs_equal(got, want):
    (p_rep, p_coll, p_lines), (r_rep, r_coll, r_lines) = got, want
    assert p_rep == r_rep
    assert len(p_coll.collection) == len(r_coll.collection)
    for i, (a, b) in enumerate(zip(p_coll.collection, r_coll.collection)):
        assert a.parity_snapshot() == b.parity_snapshot(), i
        assert a.summary() == b.summary(), i
    assert p_lines == r_lines


@pytest.mark.parametrize("name", list(SWEEPS))
def test_lane_sweep_equals_the_reference(partitionable, caplog, name):
    with caplog.at_level(logging.INFO):
        got = _port_run(BASE + SWEEPS[name])
    _assert_runs_equal(got, _ref_cached(name))
    report = got[0]
    lanes = int(SWEEPS[name][-1])
    assert report["sweep_lanes"] == lanes and report["num_points"] == 3
    batches = -(-3 // lanes)
    assert any(f"TRAFFIC LANE SWEEP: 3 points x {lanes} lanes = {batches} "
               f"batched engine call(s)" in r.message
               for r in caplog.records)
    assert not any("ignored" in r.message for r in caplog.records)
    if name == "adaptive-threshold":
        assert report["adaptive"]["pull_rescued"] > 0
    else:
        assert report["traffic"]["queue_dropped"] > 0


@pytest.mark.parametrize("case,argv,reason", [
    ("one point", ["--packet-loss-rate", "0.1"],
     "nothing to batch (num_simulations < 2)"),
    ("no measured rounds", ["--iterations", "6", "--test-type",
                            "traffic-rate", "--num-simulations", "2",
                            "--step-size", "2"],
     "no measured rounds (iterations <= warm-up-rounds)")])
def test_runs_lanes_cannot_serve_run_serially(partitionable, caplog, case,
                                              argv, reason):
    """The reference's warning words, the serial run's results, and the
    reference's results."""
    argv = BASE + TRAFFIC + argv
    with caplog.at_level(logging.WARNING):
        got = _port_run(argv + ["--sweep-lanes", "2"])
    assert any("--sweep-lanes 2 ignored" in r.message and reason in
               r.message and "running the serial traffic sweep" in r.message
               for r in caplog.records), case
    assert got[0]["sweep_lanes"] == 0
    _assert_runs_equal(got, _port_run(argv))
    if case == "one point":
        _assert_runs_equal(got, _ref_run(argv + ["--sweep-lanes", "2"]))


@pytest.mark.parametrize("test_type,n_points", [
    ("traffic-rate", 1), ("packet-loss", 3), ("push-fanout", 3),
    ("churn", 2)])
@pytest.mark.parametrize("iterations", [16, 6])
def test_blocker_reasons_are_the_references(test_type, n_points,
                                            iterations):
    """Each reason the port can meet, in the reference's words and order
    (the reference's backend, trace and checkpoint reasons need flags the
    port does not have yet)."""
    cfg = types.SimpleNamespace(
        backend="tpu", test_type=SweepType(test_type), trace_dir=None,
        checkpoint_path=None, resume_path=None, gossip_iterations=iterations,
        warm_up_rounds=6)
    ref_cfg = types.SimpleNamespace(**{
        **vars(cfg), "test_type": ref_cli.Testing(test_type)})
    got = cli._traffic_lane_blocker(cfg, n_points)
    assert got == ref_cli._traffic_lane_blocker(ref_cfg, n_points)
    assert (got is None) == (n_points > 1 and test_type != "push-fanout"
                             and iterations > 6)


#: C13: a sweep of more than 64 points at one batch of 66 lanes
WIDE = ["--num-synthetic-nodes", "32", "--iterations", "4",
        "--warm-up-rounds", "2", "--seed", "13", "--test-type",
        "packet-loss", "--num-simulations", "66", "--step-size", "0.01",
        "--sweep-lanes", "66"]


def test_more_than_64_lanes_equal_the_reference(partitionable, caplog):
    ref_reset()
    get_registry().reset()
    args = ref_cli.build_parser().parse_args(WIDE + ["--backend", "tpu"])
    coll = RefCollection()
    with caplog.at_level(logging.INFO):
        ref_cli.dispatch_sweeps(ref_cli.config_from_args(args), "u",
                                args.origin_rank, coll, None, "77")
    want_lines = [r.message for r in caplog.records
                  if "LANE-BATCHED SWEEP" in r.message]
    want_batches = get_registry().info("lane_batches")
    want_lanes = get_registry().info("sweep_lanes")
    caplog.clear()
    reset_unique_pubkeys()
    args = cli.build_parser().parse_args(WIDE + ["--device", "cpu"])
    pcoll = GossipStatsCollection()
    with caplog.at_level(logging.INFO):
        times = cli.dispatch_sweeps(cli.config_from_args(args), "u",
                                    args.origin_rank, pcoll, None, "77")
    got_lines = [r.message for r in caplog.records
                 if "LANE-BATCHED SWEEP" in r.message]
    assert not any("at most" in r.message for r in caplog.records)
    assert (times["lanes"], times["batches"]) == (want_lanes,
                                                  want_batches) == (66, 1)
    assert got_lines == want_lines and len(got_lines) == 1
    assert "66 sims x 66 lanes = 1 batched" in got_lines[0]
    assert len(pcoll.collection) == len(coll.collection) == 66
    for i, (a, b) in enumerate(zip(pcoll.collection, coll.collection)):
        assert _strings(a.parity_snapshot()) == _strings(
            b.parity_snapshot()), i
