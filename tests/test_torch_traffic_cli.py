"""The port's traffic run path against the reference package's.

* ``cli.run_traffic`` on ``device="cpu"`` and the reference's (JAX on the
  CPU) give equal reports, equal ``TrafficStats.parity_snapshot()`` and
  ``summary()`` for every point, and equal ``drain_deterministic_lines()``:
  for one run under loss with both caps on, and for 3-point
  ``traffic-rate`` and ``node-ingress-cap`` sweeps;
* ``cli.main`` dispatches a traffic run and logs its TRAFFIC SUMMARY;
* the gate: ``--traffic-values 1`` with both caps off is the single-value
  run, line for line and series for series;
* adaptive traffic (``--gossip-mode adaptive``, the per-value pull
  rescue) through ``run_traffic``, one run and a 3-point
  ``adaptive-threshold`` sweep, equal to the reference's: reports (their
  ``adaptive`` section included), snapshots, summaries and the
  deterministic Influx lines (``sim_adaptive`` included);
* the refusals give the reference's exit codes and messages (all-origins
  with traffic, a pull mode with traffic, a traffic sweep without traffic,
  a negative rate, a stall window below 1, a test type traffic cannot
  sweep, an ingress cap of 16384 or more with adaptive traffic, also at
  the last point of a node-ingress-cap sweep).

The points share one cluster size and iteration count, so the reference
compiles its rounds once.  Tolerance: 0 (exact equality)."""

import gossip_sim_tpu.engine  # noqa: F401,I001  (64-bit types first)
import logging

import pytest
import torch

from gossip_sim_tpu import cli as ref_cli
from gossip_sim_tpu.identity import reset_unique_pubkeys as ref_reset
from gossip_sim_tpu.obs import get_registry
from gossip_sim_tpu.sinks import DatapointQueue as RefQueue
from gossip_sim_tpu.stats.traffic import TrafficStatsCollection as RefColl
from gossip_sim_tpu_torch import cli
from gossip_sim_tpu_torch.identity import reset_unique_pubkeys
from gossip_sim_tpu_torch.sinks import DatapointQueue
from gossip_sim_tpu_torch.stats.gossip_stats import GossipStatsCollection
from gossip_sim_tpu_torch.stats.traffic import TrafficStatsCollection

BASE = ["--num-synthetic-nodes", "100", "--iterations", "16",
        "--warm-up-rounds", "6"]
TRAFFIC = ["--traffic-values", "8", "--traffic-rate", "2",
           "--node-ingress-cap", "6", "--node-egress-cap", "10"]
RUNS = {
    "single": ["--packet-loss-rate", "0.1"],
    "traffic-rate": ["--test-type", "traffic-rate", "--num-simulations",
                     "3", "--step-size", "2"],
    "node-ingress-cap": ["--test-type", "node-ingress-cap",
                         "--num-simulations", "3", "--step-size", "3"],
}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


@pytest.mark.parametrize("run", list(RUNS))
def test_run_traffic_equals_reference(run):
    argv = BASE + TRAFFIC + RUNS[run]
    want_report, want_coll, want_lines = _ref_run(argv)
    got_report, got_coll, got_lines = _port_run(argv)
    assert got_report == want_report
    assert got_coll.points == want_coll.points
    assert len(got_coll.collection) == (1 if run == "single" else 3)
    for got, want in zip(got_coll.collection, want_coll.collection):
        assert got.parity_snapshot() == want.parity_snapshot()
        assert got.summary() == want.summary()
    assert got_lines == want_lines
    assert any(ln.startswith("sim_traffic,") for ln in got_lines)
    assert any(ln.startswith("sim_traffic_summary,") for ln in got_lines)
    s = got_report["traffic"]
    assert s["queue_deferred"] > 0 and s["queue_dropped"] > 0
    if run != "single":
        key = "values_injected" if run == "traffic-rate" else "queue_dropped"
        assert len({p[key] for p in got_report["traffic_points"]}) == 3


def test_main_runs_traffic_and_logs_the_summary(caplog):
    with caplog.at_level(logging.INFO):
        assert cli.main(BASE + TRAFFIC + ["--device", "cpu"]) == 0
    assert "TRAFFIC SUMMARY: " in caplog.text
    assert "values injected" in caplog.text


def _single_value_run(argv):
    reset_unique_pubkeys()
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    coll, q = GossipStatsCollection(), DatapointQueue()
    cli.dispatch_sweeps(cfg, "u", [1], coll, q, "77")
    return coll.collection[0].parity_snapshot(), q.drain_deterministic_lines()


def test_one_value_slot_without_caps_is_the_single_value_run():
    argv = BASE + ["--packet-loss-rate", "0.1"]
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        argv + ["--traffic-values", "1"]))
    assert not cfg.traffic_on
    assert not cli._engine_params(cfg, 100).has_traffic
    want = _single_value_run(argv)
    got = _single_value_run(argv + ["--traffic-values", "1",
                                    "--traffic-rate", "5"])
    assert got[0] == want[0] and got[1] == want[1]


class _Errors(logging.Handler):
    def __init__(self):
        super().__init__()
        self.msgs = []

    def emit(self, record):
        if record.levelno >= logging.ERROR:
            self.msgs.append(record.getMessage())


def _refusal(main, argv):
    h = _Errors()
    root = logging.getLogger()
    root.addHandler(h)
    try:
        rc = main(argv)
    finally:
        root.removeHandler(h)
    return rc, h.msgs


@pytest.mark.parametrize("extra", [
    ["--traffic-values", "4", "--all-origins"],
    ["--traffic-values", "4", "--gossip-mode", "pull"],
    ["--node-egress-cap", "3", "--gossip-mode", "push-pull"],
    ["--test-type", "traffic-rate"],
    ["--test-type", "node-ingress-cap", "--num-simulations", "2"],
    ["--traffic-values", "4", "--traffic-rate", "-1"],
    ["--traffic-values", "4", "--traffic-stall-rounds", "0"],
    ["--traffic-values", "0"],
    ["--traffic-values", "4", "--test-type", "push-fanout"],
    ["--node-ingress-cap", "16384", "--gossip-mode", "adaptive"],
    ["--node-ingress-cap", "16000", "--gossip-mode", "adaptive",
     "--test-type", "node-ingress-cap", "--num-simulations", "3",
     "--step-size", "200"],
], ids=["all-origins", "pull", "push-pull", "rate-sweep-off",
        "cap-sweep-off", "negative-rate", "stall-0", "values-0",
        "fanout-sweep", "adaptive-cap-16384", "adaptive-cap-sweep-past"])
def test_traffic_refusals_match_reference(extra):
    argv = ["--num-synthetic-nodes", "50", "--iterations", "4",
            "--warm-up-rounds", "2"] + extra
    want_rc, want = _refusal(ref_cli.main, argv)
    got_rc, got = _refusal(cli.main, argv + ["--device", "cpu"])
    assert want_rc == got_rc == 1
    assert got == want and got


#: adaptive traffic: one run under loss, and a 3-point sweep of the switch
#: threshold (0.3, 0.5, 0.7)
ADAPTIVE_RUNS = {
    "single": ["--adaptive-switch-threshold", "0.3", "--packet-loss-rate",
               "0.1"],
    "adaptive-threshold": ["--adaptive-switch-threshold", "0.3",
                           "--test-type", "adaptive-threshold",
                           "--num-simulations", "3", "--step-size", "0.2"],
}


@pytest.mark.parametrize("run", list(ADAPTIVE_RUNS))
def test_adaptive_run_traffic_equals_reference(run):
    argv = BASE + TRAFFIC + ["--gossip-mode", "adaptive"] + ADAPTIVE_RUNS[
        run]
    want_report, want_coll, want_lines = _ref_run(argv)
    got_report, got_coll, got_lines = _port_run(argv)
    assert got_report == want_report
    assert got_coll.points == want_coll.points
    assert len(got_coll.collection) == (1 if run == "single" else 3)
    for got, want in zip(got_coll.collection, want_coll.collection):
        assert got.parity_snapshot() == want.parity_snapshot()
        assert "adaptive_rounds" in got.parity_snapshot()
        assert got.summary() == want.summary()
    assert got_lines == want_lines
    assert any(ln.startswith("sim_adaptive,") for ln in got_lines)
    ad = got_report["adaptive"]
    assert ad["switched_to_pull"] > 0 and ad["pull_rescued"] > 0
    assert ad["pull_deferred"] > 0 and ad["pull_queue_dropped"] > 0
    if run != "single":
        assert len({p["adaptive_switched_to_pull"]
                    for p in got_report["traffic_points"]}) > 1


def test_main_logs_the_adaptive_summary(caplog):
    with caplog.at_level(logging.INFO):
        assert cli.main(BASE + TRAFFIC + ["--gossip-mode", "adaptive",
                                          "--adaptive-switch-threshold",
                                          "0.3", "--device", "cpu"]) == 0
    assert "TRAFFIC SUMMARY: " in caplog.text
    assert "ADAPTIVE SUMMARY: " in caplog.text
