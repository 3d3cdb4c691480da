"""The flight recorder's CLI paths (``--trace-dir``, ``--trace-origins``,
``--trace-prune-cap``; ROADMAP A13) against the reference package's.

For the single run (push under loss + churn + a partition, and push-pull
at request cap 1), a serial sweep (one ``simNNN`` directory per point),
the batched origin-rank sweep (one origin column per rank) and the
all-origins replay (``--trace-origins 2``):

* every segment array equals the reference's, and the manifests are equal
  key for key, apart from ``config``, whose shared fields are equal;
* the reference's ``load_trace``/``validate_trace_dir`` accept the port's
  trace and the port's accept the reference's;
* ``tools/trace_report.py`` prints the same report for both directories;
* the deterministic Influx lines, ``sim_trace`` points among them, equal
  the reference's.

A single run stopped after its first block and resumed writes the straight
run's segments; the lane sweep and the traffic run refuse ``--trace-dir``
(the reference's words; ROADMAP A13b), and ``--trace-origins 0`` writes
nothing.  The harvest block is cut to 8 rounds in both packages, so the
single runs span two segments.  Tolerance: 0 (exact equality)."""

import gossip_sim_tpu.engine  # noqa: F401,I001  (64-bit types first)
import contextlib
import functools
import importlib.util
import io
import json
import logging
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gossip_sim_tpu import cli as ref_cli
from gossip_sim_tpu import resilience as ref_res
from gossip_sim_tpu.identity import reset_unique_pubkeys as ref_reset
from gossip_sim_tpu.obs import get_registry
from gossip_sim_tpu.obs import trace as ref_trace
from gossip_sim_tpu.sinks import DatapointQueue as RefQueue
from gossip_sim_tpu.stats.gossip_stats import \
    GossipStatsCollection as RefColl
from gossip_sim_tpu_torch import cli, resilience, rng
from gossip_sim_tpu_torch.identity import reset_unique_pubkeys
from gossip_sim_tpu_torch.obs import trace as port_trace
from gossip_sim_tpu_torch.sinks import (DatapointQueue,
                                        deterministic_wire_lines)
from gossip_sim_tpu_torch.stats.gossip_stats import GossipStatsCollection

ROOT = Path(__file__).resolve().parent.parent
BLOCK = 8
SINGLE = ["--num-synthetic-nodes", "100", "--iterations", "26",
          "--warm-up-rounds", "10", "--packet-loss-rate", "0.1",
          "--churn-fail-rate", "0.02", "--churn-recover-rate", "0.3",
          "--partition-at", "14", "--heal-at", "20"]
CASES = {
    "single push": ("single", SINGLE),
    "single push-pull": ("single", SINGLE[:6] + [
        "--gossip-mode", "push-pull", "--pull-request-cap", "1",
        "--pull-fanout", "3", "--trace-prune-cap", "30"]),
    "serial sweep": ("sweep", ["--num-synthetic-nodes", "60",
                                "--iterations", "14", "--warm-up-rounds",
                                "6", "--test-type", "min-ingress-nodes",
                                "--num-simulations", "2", "--step-size",
                                "1"]),
    "origin-rank sweep": ("sweep", ["--num-synthetic-nodes", "60",
                                     "--iterations", "14",
                                     "--warm-up-rounds", "6", "--test-type",
                                     "origin-rank", "--num-simulations",
                                     "2", "--origin-rank", "1", "3"]),
    "all-origins": ("all-origins", ["--num-synthetic-nodes", "40",
                                    "--iterations", "10",
                                    "--warm-up-rounds", "3",
                                    "--all-origins", "--origin-batch", "16",
                                    "--mesh-devices", "1", "--trace-origins",
                                    "2"]),
}


@pytest.fixture(autouse=True)
def setup(monkeypatch):
    old = jax.config.jax_threefry_partitionable
    old_port = rng.partitionable()
    threads = torch.get_num_threads()
    jax.config.update("jax_threefry_partitionable", True)
    rng.set_partitionable(True)
    torch.set_num_threads(1)
    monkeypatch.setattr(ref_cli, "HARVEST_BLOCK", BLOCK)
    monkeypatch.setattr(cli, "HARVEST_BLOCK", BLOCK)
    yield
    jax.config.update("jax_threefry_partitionable", old)
    rng.set_partitionable(old_port)
    torch.set_num_threads(threads)
    for mod in (resilience, ref_res):
        mod.reset_shutdown()


def _lines(q):
    raw = []
    while len(q):
        raw.extend(q.pop_front().data().splitlines())
    return deterministic_wire_lines(raw)


def _ranks(argv):
    if "--origin-rank" not in argv:
        return [1]
    i = argv.index("--origin-rank") + 1
    return [int(v) for v in argv[i:i + 2]]


def _ref(kind, argv, trace_dir):
    ref_reset()
    get_registry().reset()
    ref_res.reset_shutdown()
    cfg = ref_cli.config_from_args(ref_cli.build_parser().parse_args(
        argv + ["--backend", "tpu", "--trace-dir", str(trace_dir)]))
    q = RefQueue()
    if kind == "single":
        ref_cli.run_simulation(cfg, "", RefColl(), q, 0, "0", 0.0)
    elif kind == "sweep":
        ref_cli.dispatch_sweeps(cfg, "", _ranks(argv), RefColl(), q, "0")
    else:
        ref_cli.run_all_origins(cfg, "", q, "0")
    return _lines(q)


def _port(kind, argv, trace_dir, influx=True):
    reset_unique_pubkeys()
    resilience.reset_counts()
    resilience.reset_shutdown()
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        argv + ["--device", "cpu", "--trace-dir", str(trace_dir)]))
    q = DatapointQueue()
    if kind == "single":
        cli.run_simulation(cfg, "", GossipStatsCollection(),
                           q if influx else None, 0, "0", 0.0)
    elif kind == "sweep":
        cli.dispatch_sweeps(cfg, "", _ranks(argv), GossipStatsCollection(),
                            q, "0")
    else:
        cli.run_all_origins(cfg, dp_queue=q, start_ts="0")
    return _lines(q)


@functools.lru_cache(maxsize=None)
def _case(case, root):
    """The reference's and the port's traced runs of a case: (their trace
    directories, their deterministic lines)."""
    kind, argv = CASES[case]
    ref_dir, port_dir = Path(root) / "ref", Path(root) / "port"
    return (ref_dir, port_dir), (_ref(kind, argv, ref_dir),
                                 _port(kind, argv, port_dir))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("traces"))


def trace_dirs(top: Path) -> list:
    return sorted(p.parent.relative_to(top)
                  for p in top.rglob(ref_trace.MANIFEST_NAME))


def assert_same_trace(a: Path, b: Path, paths=("trace_dir",)):
    """Every segment array equal; the manifests equal but for ``config``,
    whose shared fields are equal (but for the ``paths`` fields)."""
    ma = json.loads((a / "manifest.json").read_text())
    mb = json.loads((b / "manifest.json").read_text())
    assert set(ma) == set(mb)
    for k in ma:
        if k == "config":
            shared = set(ma[k]) & set(mb[k])
            assert len(shared) > 40
            assert ({f: ma[k][f] for f in shared if f not in paths}
                    == {f: mb[k][f] for f in shared if f not in paths})
        else:
            assert ma[k] == mb[k], k
    assert ma["segments"]
    for seg in ma["segments"]:
        with np.load(a / seg["file"]) as za, np.load(b / seg["file"]) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for name in za.files:
                assert za[name].dtype == zb[name].dtype, name
                assert np.array_equal(za[name], zb[name]), (seg, name)


@functools.lru_cache(maxsize=None)
def _trace_report():
    spec = importlib.util.spec_from_file_location(
        "trace_report", ROOT / "tools" / "trace_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def report(trace_dir: Path, *argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = _trace_report().main([argv[0], str(trace_dir), *argv[1:]])
    return f"rc={rc}\n" + out.getvalue().replace(str(trace_dir), "DIR")


@pytest.mark.parametrize("case", list(CASES))
def test_trace_dirs_equal_reference(case, root):
    (ref_dir, port_dir), (ref_lines, port_lines) = _case(case, root + case)
    dirs = trace_dirs(ref_dir)
    assert dirs and dirs == trace_dirs(port_dir)
    if case == "serial sweep":
        assert dirs == [Path("sim000"), Path("sim001")]
    for d in dirs:
        a, b = ref_dir / d, port_dir / d
        assert_same_trace(a, b)
        # each package reads the other's trace
        assert ref_trace.validate_trace_dir(str(b)) == []
        assert port_trace.validate_trace_dir(str(a)) == []
        ta, tb = ref_trace.load_trace(str(b)), port_trace.load_trace(str(a))
        assert np.array_equal(ta.rounds, tb.rounds)
        for name, arr in tb.arrays.items():
            assert np.array_equal(arr, ta.arrays[name]), name
    origins = json.loads((port_dir / dirs[0] / "manifest.json")
                         .read_text())["origins"]
    assert len(origins) == {"origin-rank sweep": 2, "all-origins": 2}.get(
        case, 1)
    trace_lines = [ln for ln in port_lines if ln.startswith("sim_trace")]
    assert trace_lines and port_lines == ref_lines


@pytest.mark.parametrize("cmd", [("info",), ("tree",),
                                 ("explain-stranded",),
                                 ("attribute-rmr", "--top", "5"),
                                 ("hot-nodes", "--top", "5")])
def test_trace_report_reads_both_alike(cmd, root):
    (ref_dir, port_dir), _ = _case("single push", root + "single push")
    assert report(port_dir, *cmd) == report(ref_dir, *cmd)
    assert report(port_dir, *cmd).startswith("rc=0")


def test_resumed_trace_equals_the_straight_run(root, tmp_path):
    """Stopped after its first block (a shutdown request) and resumed, the
    single run's trace holds the straight run's segments.  The resumed run
    goes without a queue: a resumed single run indexes its Influx
    iteration points from the run's start."""
    (ref_dir, _), _ = _case("single push", root + "single push")
    ck = str(tmp_path / "run.npz")
    trace = tmp_path / "trace"
    kind, argv = CASES["single push"]
    resilience.reset_shutdown()
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        argv + ["--device", "cpu", "--trace-dir", str(trace),
                "--checkpoint-path", ck]))
    reset_unique_pubkeys()
    resilience.request_shutdown()
    with pytest.raises(resilience.ResumableInterrupt):
        cli.run_simulation(cfg, "", GossipStatsCollection(), None, 0, "0",
                           0.0)
    first = json.loads((trace / "manifest.json").read_text())["segments"]
    assert [(s["start_round"], s["end_round"]) for s in first] == [(10, 18)]
    resilience.reset_shutdown()
    _port(kind, argv + ["--checkpoint-path", ck, "--resume", ck], trace,
          influx=False)
    assert_same_trace(ref_dir, trace,
                      ("trace_dir", "checkpoint_path", "resume_path"))


def test_refusals(tmp_path, caplog):
    lane = ["--num-synthetic-nodes", "60", "--iterations", "12",
            "--warm-up-rounds", "4", "--test-type", "packet-loss",
            "--num-simulations", "2", "--step-size", "0.1", "--sweep-lanes",
            "2", "--device", "cpu", "--trace-dir", str(tmp_path / "l")]
    with pytest.raises(SystemExit, match="not supported with --sweep-lanes"):
        cli.dispatch_sweeps(
            cli.config_from_args(cli.build_parser().parse_args(lane)), "",
            [1, 1], GossipStatsCollection())
    traffic = ["--num-synthetic-nodes", "60", "--iterations", "12",
               "--traffic-values", "4", "--device", "cpu", "--trace-dir",
               str(tmp_path / "t")]
    with caplog.at_level(logging.ERROR):
        assert cli.main(traffic) == 1
    assert "ROADMAP A13b" in caplog.text
    assert not os.path.exists(tmp_path / "t")
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        traffic + ["--test-type", "traffic-rate", "--num-simulations", "2"]))
    assert cli._traffic_lane_blocker(cfg, 2) == (
        "--trace-dir captures one sim's event stream")
    with pytest.raises(SystemExit, match="A13b"):
        cli.run_traffic(cfg, "u")
    none = CASES["all-origins"][1][:-1] + ["0", "--device", "cpu",
                                           "--trace-dir",
                                           str(tmp_path / "a")]
    assert cli.main(none) == 0
    assert not os.path.exists(tmp_path / "a" / "manifest.json")
