"""The port's ``--test-type`` sweeps against the reference package's.

* For each of the nine push-mode test types, the port's
  ``dispatch_sweeps`` on ``device="cpu"`` and the reference's
  (``--backend tpu``, JAX on the CPU) give equal ``parity_snapshot()``s
  for every simulation, and equal ``drain_deterministic_lines()``;
  the points step the active set to S=24 and the fanout to F=12 (K=24),
  clamp a loss rate at 1.0, and run an origin-rank sweep batched;
* the port's batched origin-rank sweep equals its own serial runs, one
  per rank (the reference's tests/test_cli.py:174-211);
* the two traffic sweeps, which raised in adaptive mode until adaptive
  traffic was ported (ROADMAP A11b), equal the reference's there: report,
  snapshots and deterministic Influx lines (the push-mode traffic sweeps
  and the adaptive-threshold sweep are held against the reference in
  tests/test_torch_traffic_cli.py, the pull and adaptive sweeps in
  tests/test_torch_pull.py and tests/test_torch_adaptive.py).

Every serial point loads its cluster anew, so the synthetic pubkey counter
runs on between points in both packages (both counters are reset first).
Both threefry layouts are pinned to the partitionable one.  Tolerance: 0
(exact equality of every snapshot series and wire line)."""

import gossip_sim_tpu.engine  # noqa: F401  (64-bit types first)
import jax
import pytest
import torch

from gossip_sim_tpu import cli as ref_cli
from gossip_sim_tpu.identity import reset_unique_pubkeys as ref_reset
from gossip_sim_tpu.sinks import DatapointQueue as RefQueue
from gossip_sim_tpu.stats.gossip_stats import \
    GossipStatsCollection as RefCollection
from gossip_sim_tpu_torch import cli, rng
from gossip_sim_tpu_torch.identity import reset_unique_pubkeys
from gossip_sim_tpu_torch.sinks import DatapointQueue
from gossip_sim_tpu_torch.stats.gossip_stats import GossipStatsCollection

BASE = ["--num-synthetic-nodes", "100", "--iterations", "16",
        "--warm-up-rounds", "8"]
SWEEPS = {
    "active-set-size": ["--num-simulations", "2", "--step-size", "12"],
    # F = 6 and 12; the second point bumps S from 8 to 12
    "push-fanout": ["--active-set-size", "8", "--num-simulations", "2",
                    "--step-size", "6"],
    "min-ingress-nodes": ["--num-simulations", "2", "--step-size", "3"],
    "prune-stake-threshold": ["--num-simulations", "3", "--step-size",
                              "0.05"],
    "origin-rank": ["--origin-rank", "1", "4", "7", "--num-simulations",
                    "3"],
    "fail-nodes": ["--when-to-fail", "10", "--num-simulations", "2",
                   "--step-size", "0.2"],
    "rotate-probability": ["--num-simulations", "2", "--step-size", "0.2"],
    # 0.5, then 1.1 clamped to 1.0
    "packet-loss": ["--packet-loss-rate", "0.5", "--num-simulations", "2",
                    "--step-size", "0.6"],
    "churn": ["--churn-fail-rate", "0.01", "--churn-recover-rate", "0.2",
              "--num-simulations", "2", "--step-size", "0.05"],
}


@pytest.fixture
def partitionable():
    """Both packages in the partitionable threefry layout; the port on one
    CPU thread (its tensors are small, and the suite's workers share the
    cores)."""
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


def _strings(snap: dict) -> dict:
    """Map the two packages' distinct Pubkey classes to base58 strings."""
    def key(k):
        return k.to_string() if hasattr(k, "to_string") else k
    return {name: ({key(k): x for k, x in v.items()} if isinstance(v, dict)
                   else {key(k) for k in v} if isinstance(v, set) else v)
            for name, v in snap.items()}


def _ref_sweep(argv, queue=True):
    """The reference package's sweep of ``argv``: (snapshots, lines)."""
    ref_reset()
    args = ref_cli.build_parser().parse_args(argv + ["--backend", "tpu"])
    cfg = ref_cli.config_from_args(args)
    coll = RefCollection()
    q = RefQueue() if queue else None
    ref_cli.dispatch_sweeps(cfg, "u", args.origin_rank, coll, q, "77")
    return ([_strings(s.parity_snapshot()) for s in coll.collection],
            q.drain_deterministic_lines() if queue else None)


def _port_sweep(argv, queue=True):
    """The port's sweep of ``argv`` on the CPU: (snapshots, lines)."""
    reset_unique_pubkeys()
    args = cli.build_parser().parse_args(argv + ["--device", "cpu"])
    cfg = cli.config_from_args(args)
    coll = GossipStatsCollection()
    q = DatapointQueue() if queue else None
    cli.dispatch_sweeps(cfg, "u", args.origin_rank, coll, q, "77")
    return ([_strings(s.parity_snapshot()) for s in coll.collection],
            q.drain_deterministic_lines() if queue else None)


@pytest.mark.parametrize("test_type", list(SWEEPS))
def test_sweep_parity_snapshots_and_influx_lines(partitionable, test_type):
    argv = BASE + ["--test-type", test_type] + SWEEPS[test_type]
    want_snaps, want_lines = _ref_sweep(argv)
    got_snaps, got_lines = _port_sweep(argv)
    n_sims = int(argv[argv.index("--num-simulations") + 1])
    assert len(got_snaps) == len(want_snaps) == n_sims
    for i, (got, want) in enumerate(zip(got_snaps, want_snaps)):
        assert set(got) == set(want)
        for k in want:
            assert got[k] == want[k], (i, k)
        assert len(got["coverage"]) == 8
    assert len(got_lines) == len(want_lines)
    for n, (got, want) in enumerate(zip(got_lines, want_lines)):
        assert got == want, n


def test_stepped_points_reach_the_wide_kernel_shapes():
    """The sweeps above drive S=24 and F=12 (K=24) through every kernel's
    plain version, and clamp the loss rate at 1.0."""
    def points(test_type):
        args = cli.build_parser().parse_args(
            BASE + ["--test-type", test_type] + SWEEPS[test_type])
        cfg = cli.config_from_args(args)
        return [cli._stepped_sweep_config(cfg, i, args.origin_rank)[0]
                for i in range(cfg.num_simulations)]
    s = points("active-set-size")
    assert [c.gossip_active_set_size for c in s] == [12, 24]
    f = points("push-fanout")
    assert [(c.gossip_push_fanout, c.gossip_active_set_size)
            for c in f] == [(6, 8), (12, 12)]
    assert cli._engine_params(f[1], 100).split()[0].k_inbound == 24
    assert [c.packet_loss_rate for c in points("packet-loss")] == [0.5, 1.0]


def test_batched_origin_rank_sweep_equals_serial_runs(partitionable):
    ranks = ["1", "4", "7"]
    batched, _ = _port_sweep(BASE + ["--test-type", "origin-rank",
                                     "--num-simulations", "3",
                                     "--origin-rank", *ranks], queue=False)
    assert len(batched) == 3
    for rank, col in zip(ranks, batched):
        serial, _ = _port_sweep(BASE + ["--origin-rank", rank], queue=False)
        assert serial == [col]


@pytest.mark.parametrize("test_type,item", [
    ("traffic-rate", "ROADMAP A11"), ("node-ingress-cap", "ROADMAP A11")])
def test_unported_test_types_raise(test_type, item):
    """The two traffic sweeps of adaptive traffic (``item``b, once refused
    with NotImplementedError) run, equal to the reference's."""
    from gossip_sim_tpu.stats.traffic import TrafficStatsCollection as RefT
    from gossip_sim_tpu_torch.stats.traffic import TrafficStatsCollection
    argv = BASE + ["--test-type", test_type, "--num-simulations", "2",
                   "--traffic-values", "4", "--gossip-mode", "adaptive",
                   "--adaptive-switch-threshold", "0.3"]
    out = {}
    for name, mod, coll, queue, reset, dev in (
            ("ref", ref_cli, RefT(), RefQueue(), ref_reset,
             ["--backend", "tpu"]),
            ("port", cli, TrafficStatsCollection(), DatapointQueue(),
             reset_unique_pubkeys, ["--device", "cpu"])):
        reset()
        cfg = mod.config_from_args(mod.build_parser().parse_args(argv + dev))
        report = mod.run_traffic(cfg, "u", queue, "77", collection=coll)
        out[name] = (report, [st.parity_snapshot() for st in coll.collection],
                     queue.drain_deterministic_lines())
    assert out["port"] == out["ref"], f"{test_type} ({item}b)"
    report, snaps, _ = out["port"]
    assert report["num_points"] == 2 and len(snaps) == 2
    assert all("adaptive_rounds" in snap for snap in snaps)
