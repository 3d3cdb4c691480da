"""The port's CLI main path against the reference package's, and the
port's isolation and device rules.

* ``run_simulation`` of the port on ``device="cpu"`` and of the reference
  package (``--backend tpu``, JAX on the CPU) give equal
  ``parity_snapshot()``s at 300 nodes, unimpaired and impaired;
* asking for the default device without a GPU raises;
* ``--all-origins`` runs through ``main`` on the CPU and logs its summary,
  and more than one mesh device or node shard raises naming ROADMAP A6b;
* the parser holds 60 of the reference's 76 options and ``--device``;
* a fresh interpreter that imports every port module (the sinks, the
  ``write_accounts`` binary, ``checkpoint``, ``resilience``, the flight
  recorder's ``obs/trace.py`` and ``stats/edges.py`` among them, and the
  chip smoke script) has no
  ``jax``, no ``gossip_sim_tpu``/``gossip_sim_tpu.*`` and no ``yaml``
  module loaded.

Tolerance: 0 everywhere (exact equality of every snapshot series)."""

import logging
import os
import subprocess
import sys
from pathlib import Path

import gossip_sim_tpu.engine  # noqa: F401  (64-bit types first)
import jax
import numpy as np
import pytest
import torch

from gossip_sim_tpu import cli as ref_cli
from gossip_sim_tpu.identity import reset_unique_pubkeys as ref_reset
from gossip_sim_tpu.stats.gossip_stats import GossipStatsCollection
from gossip_sim_tpu_torch import cli, rng
from gossip_sim_tpu_torch.engine import core
from gossip_sim_tpu_torch.identity import reset_unique_pubkeys

ROOT = Path(__file__).resolve().parents[1]
BASE = ["--num-synthetic-nodes", "300", "--iterations", "45",
        "--warm-up-rounds", "15"]


@pytest.fixture
def partitionable():
    old = jax.config.jax_threefry_partitionable
    old_port = rng.partitionable()
    jax.config.update("jax_threefry_partitionable", True)
    rng.set_partitionable(True)
    yield
    jax.config.update("jax_threefry_partitionable", old)
    rng.set_partitionable(old_port)


def _strings(snap: dict) -> dict:
    """Map the two packages' distinct Pubkey classes to base58 strings."""
    def key(k):
        return k.to_string() if hasattr(k, "to_string") else k
    return {name: ({key(k): x for k, x in v.items()} if isinstance(v, dict)
                   else {key(k) for k in v} if isinstance(v, set) else v)
            for name, v in snap.items()}


@pytest.mark.parametrize("extra", [
    [],
    ["--packet-loss-rate", "0.1", "--churn-fail-rate", "0.01",
     "--churn-recover-rate", "0.2", "--partition-at", "20", "--heal-at",
     "30", "--test-type", "fail-nodes", "--when-to-fail", "25",
     "--fraction-to-fail", "0.2"],
], ids=["unimpaired", "impaired_fail_nodes"])
def test_run_simulation_parity_snapshot(partitionable, extra):
    argv = BASE + extra
    ref_reset()
    ref_cfg = ref_cli.config_from_args(ref_cli.build_parser().parse_args(
        argv + ["--backend", "tpu"]))
    ref_coll = GossipStatsCollection()
    ref_cli.run_simulation(ref_cfg, "", ref_coll, None, 0, "0", 0.0)
    reset_unique_pubkeys()
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    coll = cli.simulate(cfg)
    want = _strings(ref_coll.collection[0].parity_snapshot())
    got = _strings(coll.collection[0].parity_snapshot())
    assert set(want) == set(got)
    for k in want:
        assert got[k] == want[k], k
    assert len(got["coverage"]) == 30


def test_default_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stakes = np.arange(1, 41, dtype=np.int64) * 10**9
    with pytest.raises(RuntimeError, match="no CUDA device"):
        core.make_cluster_tables(stakes)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.simulate(cli.config_from_args(cli.build_parser().parse_args(
            BASE)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run_all_origins(cli.config_from_args(
            cli.build_parser().parse_args(BASE + ["--all-origins"])))
    assert core.make_cluster_tables(stakes, device="cpu").stakes.device.type \
        == "cpu"


def test_unported_flags_are_rejected():
    for argv in (["--backend", "oracle"], ["--run-report", "report.json"],
                 ["--telemetry-port", "0"]):
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args(BASE + argv)


def test_parser_holds_60_of_the_reference_options():
    """The port's parser: 60 of the reference's 76 options (``-h``
    counted), and ``--device`` beside them."""
    flags = lambda p: {s for a in p._actions for s in a.option_strings
                       if s.startswith("--") or s == "-h"}
    ref = {a.option_strings[0] for a in ref_cli.build_parser()._actions}
    ours = {a.option_strings[0] for a in cli.build_parser()._actions}
    assert len(ref) == 76
    assert len(ours & ref) == 60 and ours - ref == {"--device"}
    assert {"--trace-dir", "--trace-origins",
            "--trace-prune-cap"} <= flags(cli.build_parser())


def test_all_origins_main_logs_its_summary(caplog):
    argv = ["--num-synthetic-nodes", "40", "--iterations", "12",
            "--warm-up-rounds", "4", "--all-origins", "--origin-batch", "16",
            "--device", "cpu", "--print-stats"]
    with caplog.at_level(logging.INFO):
        assert cli.main(argv) == 0
    text = caplog.text
    assert "ALL-ORIGINS SUMMARY" in text
    assert "'num_origins': 40" in text and "'padded_sims': 8" in text
    assert "ALL-ORIGINS AGGREGATE: 40 origins x 320 measured points" in text


def test_all_origins_never_arms_the_fail_event():
    """A FAIL_NODES run arms the one-shot fail event on the single-origin
    path only (reference cli.py:1841-1853)."""
    fail = cli.config_from_args(cli.build_parser().parse_args(
        BASE + ["--test-type", "fail-nodes", "--when-to-fail", "20"]))
    assert cli._engine_params(fail, 300).fail_at == 20
    assert cli.all_origins_params(fail, 300) == cli._engine_params(
        cli.config_from_args(cli.build_parser().parse_args(BASE)), 300)


@pytest.mark.parametrize("flag", ["--mesh-devices", "--mesh-node-shards"])
def test_all_origins_refuses_more_than_one_device(flag):
    argv = BASE + ["--all-origins", "--device", "cpu", flag, "2"]
    with pytest.raises(NotImplementedError, match="ROADMAP A6b"):
        cli.main(argv)


def test_imports_no_jax_and_nothing_of_the_reference_package():
    code = """
import importlib, pkgutil, runpy, sys
import gossip_sim_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
runpy.run_path("chip_smoke.py", run_name="chip_smoke_import_only")
# a traffic round, on the CPU
import numpy as np
from gossip_sim_tpu_torch.engine import EngineParams, make_cluster_tables
from gossip_sim_tpu_torch.engine.traffic import (
    device_traffic_tables, init_traffic_state, run_traffic_rounds)
st = np.arange(1, 41, dtype=np.int64) * 10**9
p = EngineParams(num_nodes=40, traffic_values=4, node_ingress_cap=3)
_, rows = run_traffic_rounds(
    p, make_cluster_tables(st, device="cpu"),
    device_traffic_tables(st, device="cpu"),
    init_traffic_state(st, p, 1, device="cpu"), 3)
assert int(rows["delivered"].sum()) > 0
for m in ("gossip_sim_tpu_torch.sinks", "gossip_sim_tpu_torch.sinks.influx",
          "gossip_sim_tpu_torch.write_accounts",
          "gossip_sim_tpu_torch.checkpoint",
          "gossip_sim_tpu_torch.resilience",
          "gossip_sim_tpu_torch.obs.trace", "gossip_sim_tpu_torch.obs.report",
          "gossip_sim_tpu_torch.stats.edges"):
    assert m in sys.modules, m
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "gossip_sim_tpu" or m.startswith("gossip_sim_tpu.")
             or m == "yaml")
print("LOADED", len([m for m in sys.modules
                     if m.startswith("gossip_sim_tpu_torch")]))
print("BAD", bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert int(out.stdout.split("LOADED")[1].split()[0]) >= 20
