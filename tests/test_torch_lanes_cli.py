"""``--sweep-lanes`` in the port's CLI against the reference package's.

* ``dispatch_sweeps`` with ``--sweep-lanes`` gives the ``parity_snapshot()``s
  and deterministic Influx lines of the reference's lane dispatch, and of
  the port's serial sweep run point by point on one cluster (the pubkey
  counter reset before each point, as the reference's serial arm does):
  a packet-loss sweep of 5 points at 2 lanes (the last batch padded), and
  churn, pull-fanout (push-pull) and adaptive-threshold sweeps;
* the sweeps lanes cannot serve (a shape sweep, no measured rounds, one
  simulation) run serially with the reference's warning words;
* ``sweep-lanes must be >= 0``, and a traffic sweep with ``--sweep-lanes``
  raises ``NotImplementedError`` naming ROADMAP A9b.

Both threefry layouts are pinned to the partitionable one.  Tolerance: 0."""

import logging

import pytest

from gossip_sim_tpu_torch import cli
from gossip_sim_tpu_torch.identity import reset_unique_pubkeys
from gossip_sim_tpu_torch.sinks import DatapointQueue
from gossip_sim_tpu_torch.stats.gossip_stats import GossipStatsCollection
from test_torch_sweeps import (_port_sweep, _ref_sweep, _strings,  # noqa
                               partitionable)

BASE = ["--num-synthetic-nodes", "64", "--iterations", "7",
        "--warm-up-rounds", "3", "--seed", "13"]
SWEEPS = {
    # 0.0 .. 0.4: three batches at 2 lanes, the last one padded
    "packet-loss": (["--num-simulations", "5", "--step-size", "0.1"], 2),
    "churn": (["--churn-fail-rate", "0.01", "--churn-recover-rate", "0.2",
               "--num-simulations", "3", "--step-size", "0.05"], 3),
    "pull-fanout": (["--gossip-mode", "push-pull", "--num-simulations", "3",
                     "--step-size", "3"], 3),
    "adaptive-threshold": (["--gossip-mode", "adaptive",
                            "--adaptive-switch-threshold", "0.5",
                            "--num-simulations", "3", "--step-size", "0.2"],
                           2),
}


def _serial_per_point(argv):
    """The port's serial sweep with the pubkey counter reset before each
    point, so that every point runs on the lane sweep's one cluster."""
    args = cli.build_parser().parse_args(argv + ["--device", "cpu"])
    cfg = cli.config_from_args(args)
    coll, q = GossipStatsCollection(), DatapointQueue()
    for i in range(cfg.num_simulations):
        reset_unique_pubkeys()
        c, start = cli._stepped_sweep_config(cfg, i, args.origin_rank)
        cli.run_simulation(c, "u", coll, q, i, "77", start)
    return ([_strings(s.parity_snapshot()) for s in coll.collection],
            q.drain_deterministic_lines())


@pytest.mark.parametrize("test_type", list(SWEEPS))
def test_lane_sweep_equals_the_reference_and_serial(partitionable, test_type):
    flags, lanes = SWEEPS[test_type]
    argv = BASE + ["--test-type", test_type] + flags
    lane_argv = argv + ["--sweep-lanes", str(lanes)]
    want = _ref_sweep(lane_argv)
    got = _port_sweep(lane_argv)
    n_sims = int(flags[flags.index("--num-simulations") + 1])
    assert len(got[0]) == len(want[0]) == n_sims
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert _serial_per_point(argv) == got
    if test_type == "packet-loss":
        # the padded lane of the last batch feeds nothing
        assert not any("simulation_iter=5" in ln for ln in got[1])


@pytest.mark.parametrize("case,extra,reason", [
    ("shape sweep", ["--test-type", "push-fanout", "--num-simulations", "2",
                     "--step-size", "2"], "does not step a traced engine "
                                          "knob"),
    ("no measured rounds", ["--test-type", "packet-loss", "--iterations",
                            "3", "--num-simulations", "2"],
     "no measured rounds (iterations <= warm-up-rounds)"),
    ("one simulation", ["--test-type", "packet-loss", "--num-simulations",
                        "1"], "nothing to batch (num_simulations < 2)")])
def test_sweeps_lanes_cannot_serve_run_serially(partitionable, caplog, case,
                                                 extra, reason):
    argv = BASE + extra
    with caplog.at_level(logging.WARNING):
        got = _port_sweep(argv + ["--sweep-lanes", "2"])
    assert any("--sweep-lanes 2 ignored" in r.message
               and reason in r.message and "running the serial sweep"
               in r.message for r in caplog.records), case
    assert got == _port_sweep(argv)


def test_sweep_lanes_flag_and_its_bound():
    parse = lambda argv: cli.config_from_args(
        cli.build_parser().parse_args(argv))
    assert parse(["--sweep-lanes", "8"]).sweep_lanes == 8
    assert parse([]).sweep_lanes == 0
    with pytest.raises(SystemExit, match="sweep-lanes must be >= 0"):
        parse(["--sweep-lanes", "-1"])


def test_traffic_sweep_lanes_are_refused():
    argv = BASE + ["--traffic-values", "4", "--test-type", "traffic-rate",
                   "--num-simulations", "2", "--step-size", "1",
                   "--sweep-lanes", "2", "--device", "cpu"]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    with pytest.raises(NotImplementedError, match="A9b"):
        cli.run_traffic(cfg)
