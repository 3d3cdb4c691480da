"""The port's Influx series against the reference package's, and the
``--influx`` sender lifecycle of the port's ``main``.

* ``run_all_origins`` with a datapoint queue: the port's
  ``drain_deterministic_lines()`` equal the reference's line for line, on
  an impaired run (delivery and coverage-recovery series) of a full and a
  padded origin batch;
* ``main --influx l`` streams a two-point sweep through ``InfluxThread``
  to a capture server on 127.0.0.1: every point the run queued arrives, in
  order, the sentinels stay behind, and none is dropped (the serial and
  the batched origin-rank sweeps' lines are held against the reference in
  tests/test_torch_sweeps.py);
* ``drain_deterministic_lines`` drops the wall-clock ``sim_perf`` series
  and each line's timestamp.

Both threefry layouts are pinned to the partitionable one.  Tolerance: 0
(exact equality of every wire line)."""

import http.server
import threading

import gossip_sim_tpu.engine  # noqa: F401  (64-bit types first)
import jax
import numpy as np
import pytest
import torch

from gossip_sim_tpu import cli as ref_cli
from gossip_sim_tpu.config import Config as RefConfig
from gossip_sim_tpu.identity import reset_unique_pubkeys as ref_reset
from gossip_sim_tpu.sinks import DatapointQueue as RefQueue
from gossip_sim_tpu_torch import cli, rng
from gossip_sim_tpu_torch.config import Config
from gossip_sim_tpu_torch.identity import reset_unique_pubkeys
from gossip_sim_tpu_torch.sinks import (DatapointQueue, InfluxDataPoint,
                                        deterministic_wire_lines)

AO = dict(num_synthetic_nodes=40, gossip_iterations=16, warm_up_rounds=6,
          all_origins=True, origin_batch=16, packet_loss_rate=0.1,
          partition_at=4, heal_at=9)


@pytest.fixture
def partitionable():
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


def test_all_origins_influx_lines_equal_reference(partitionable):
    origins = np.arange(0, 40, 2, dtype=np.int32)      # 16 + 4 valid
    ref_reset()
    ref_cfg = RefConfig(**AO, mesh_devices=1)
    accounts, _ = ref_cli.load_cluster_accounts(ref_cfg, "")
    ref_q = RefQueue()
    ref_cli.run_all_origins(ref_cfg, "", dp_queue=ref_q, start_ts="55",
                            accounts=accounts, origin_indices=origins)
    want = ref_q.drain_deterministic_lines()
    reset_unique_pubkeys()
    q = DatapointQueue()
    summary = cli.run_all_origins(Config(**AO, device="cpu"), dp_queue=q,
                                  start_ts="55", origin_indices=origins)
    assert [b["n_valid"] for b in summary["batches"]] == [16, 4]
    raw = []
    while len(q):
        raw.extend(q.pop_front().data().splitlines())
    assert sum(ln.startswith("sim_perf") for ln in raw) == 2
    got = deterministic_wire_lines(raw)
    for series in ("coverage,", "rmr,", "hops_stat,",
                   "stranded_node_iterations,", "egress_message_count,",
                   "delivery,", "coverage_recovery,"):
        assert any(ln.startswith(series) for ln in got), series
    assert got == want


class _Capture(http.server.BaseHTTPRequestHandler):
    received = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        _Capture.received.append((self.path, body.decode()))
        self.send_response(204)
        self.end_headers()

    def log_message(self, *a):
        pass


def test_main_streams_the_sweep_through_the_sender(partitionable, tmp_path,
                                                   monkeypatch, caplog):
    server = http.server.HTTPServer(("127.0.0.1", 0), _Capture)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    _Capture.received = []
    queued = []
    real_queue = cli.DatapointQueue

    class RecordingQueue(real_queue):
        def push_back(self, dp):
            queued.append(dp.data())
            super().push_back(dp)

    monkeypatch.setattr(cli, "DatapointQueue", RecordingQueue)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    monkeypatch.setattr(cli, "get_influx_url", lambda _: url)
    for k, v in (("USERNAME", "u"), ("PASSWORD", "p"), ("DATABASE", "gsim")):
        monkeypatch.setenv(f"GOSSIP_SIM_INFLUX_{k}", v)
    monkeypatch.chdir(tmp_path)                 # no .env file to read
    argv = ["--num-synthetic-nodes", "60", "--iterations", "12",
            "--warm-up-rounds", "4", "--test-type", "prune-stake-threshold",
            "--num-simulations", "2", "--step-size", "0.05", "--influx", "l",
            "--device", "cpu"]
    try:
        with caplog.at_level("INFO"):
            assert cli.main(argv) == 0
    finally:
        server.shutdown()
    # the start sentinels of the two sims and the end sentinel are not sent
    points = [d for d in queued if d not in ("start", "end")]
    assert queued.count("start") == 2 and queued[-1] == "end"
    assert [b for _, b in _Capture.received] == points
    assert {p for p, _ in _Capture.received} == {"/write?db=gsim"}
    assert (f"influx sender: {len(points)} point(s) sent, 0 dropped"
            in caplog.text)
    lines = deterministic_wire_lines(
        [ln for b in points for ln in b.splitlines()])
    assert sum(ln.startswith("simulation_config,") for ln in lines) == 1
    assert sum(ln.startswith("iteration,") for ln in lines) == 2 * 8 + 2


def test_drain_deterministic_lines_strips_timestamps_and_wall_series():
    q = DatapointQueue()
    dp = InfluxDataPoint("9", 1)
    dp.create_data_point(0.5, "coverage")
    dp.create_sim_perf_point(0.25, 400.0, 3, 10)
    dp.create_rmr_data_point((1.5, 3, 2))
    q.push_back(dp)
    assert q.drain_deterministic_lines() == [
        "coverage,simulation_iter=1,start_time=9 data=0.5",
        "rmr,simulation_iter=1,start_time=9 rmr=1.5,m=3,n=2"]
    assert len(q) == 0
