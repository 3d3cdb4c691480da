"""The port's account sources and Influx sender, without the network.

* Account files: the port's own writer gives PyYAML's bytes for the flat
  ``pubkey: stake`` mapping, and its own reader and PyYAML read each
  other's files into the same dict; with PyYAML missing (as on the card's
  machine) ``write_accounts_yaml``/``load_accounts_yaml`` use the port's
  own, and other shapes raise ``ValueError``; a simulation from the
  written account file equals the synthetic cluster's;
* the JSON-RPC pull (``fetch_vote_accounts_rpc``, ``load_cluster_accounts``
  and ``python -m gossip_sim_tpu_torch.write_accounts``) against a local
  ``http.server`` stub that answers ``getVoteAccounts``;
* the sender (``InfluxDB``, ``InfluxThread``) against local capture
  servers: drain, retry with backoff, fail-fast on 4xx, spool, and the
  bounded queue (the reference's tests/test_influx.py:103-376 for the
  series the port has).

Tolerance: 0 (exact equality)."""

import http.server
import json
import sys
import threading
import time

import pytest
import yaml

from gossip_sim_tpu_torch import cli, write_accounts
from gossip_sim_tpu_torch.config import Config
from gossip_sim_tpu_torch.identity import (Pubkey, pubkey_new_unique,
                                           reset_unique_pubkeys)
from gossip_sim_tpu_torch.ingest import (dump_accounts_text,
                                         fetch_vote_accounts_rpc,
                                         load_accounts_yaml,
                                         parse_accounts_text,
                                         write_accounts_yaml)
from gossip_sim_tpu_torch.sinks import (DatapointQueue, InfluxDataPoint,
                                        InfluxThread)
from gossip_sim_tpu_torch.sinks.influx import InfluxDB, Tracker


def _accounts():
    """Counter pubkeys (long runs of '1'), a key PyYAML would read as an
    int, and stakes from 0 to past 2^63."""
    accounts = {pubkey_new_unique(): s
                for s in (10, 0, 3 * 10**17, 1 << 63, 7)}
    accounts["123456789"] = 5
    accounts["yes"] = 6
    return accounts


def _strings(accounts):
    return {k.to_string() if isinstance(k, Pubkey) else k: v
            for k, v in accounts.items()}


def _as_read(accounts):
    """What ``load_accounts_yaml`` gives for ``accounts``: each key as a
    32-byte Pubkey (a short key gains its leading '1's)."""
    return {Pubkey.from_string(k).to_string(): v
            for k, v in _strings(accounts).items()}


def test_own_yaml_writer_and_reader_match_pyyaml():
    accounts = _accounts()
    text = dump_accounts_text(accounts)
    assert text == yaml.safe_dump(_strings(accounts),
                                  default_flow_style=False)
    assert "'123456789': 5\n" in text and "'yes': 6\n" in text
    assert parse_accounts_text(text) == yaml.safe_load(text) \
        == _strings(accounts)
    assert dump_accounts_text({}) == yaml.safe_dump({}) == "{}\n"
    assert parse_accounts_text("{}\n") == {}


def test_account_file_round_trip_without_pyyaml(tmp_path, monkeypatch):
    accounts = _accounts()
    with_yaml = tmp_path / "a.yaml"
    write_accounts_yaml(str(with_yaml), accounts)
    monkeypatch.setitem(sys.modules, "yaml", None)     # import yaml fails
    own = tmp_path / "b.yaml"
    write_accounts_yaml(str(own), accounts)
    assert own.read_bytes() == with_yaml.read_bytes()
    assert _strings(load_accounts_yaml(str(with_yaml))) == _as_read(accounts)
    monkeypatch.delitem(sys.modules, "yaml")
    assert _strings(load_accounts_yaml(str(own))) == _as_read(accounts)


@pytest.mark.parametrize("text", [
    "- 1111111QLbz7JHiBTspS962RLKV8GndWFwiEaqKM\n",
    "1111111QLbz7JHiBTspS962RLKV8GndWFwiEaqKM: 1.5\n",
    "a: {b: 1}\n", "# a comment\nabc: 1\n", "abc0: 1\n"])
def test_own_yaml_reader_refuses_other_shapes(text):
    with pytest.raises(ValueError):
        parse_accounts_text(text)


def test_own_yaml_writer_refuses_keys_that_are_not_base58():
    with pytest.raises(ValueError):
        dump_accounts_text({"not base58": 1})


def test_simulation_from_account_file_equals_synthetic(tmp_path,
                                                       monkeypatch):
    """The written synthetic cluster, read back by the port's own reader,
    gives the synthetic run's parity snapshot."""
    base = ["--iterations", "12", "--warm-up-rounds", "6", "--device", "cpu"]
    reset_unique_pubkeys()
    want = cli.simulate(cli.config_from_args(cli.build_parser().parse_args(
        base + ["--num-synthetic-nodes", "60"]))).collection[0]
    reset_unique_pubkeys()
    accounts, _ = cli.load_cluster_accounts(Config(num_synthetic_nodes=60))
    path = tmp_path / "cluster.yaml"
    write_accounts_yaml(str(path), accounts)
    monkeypatch.setitem(sys.modules, "yaml", None)
    got = cli.simulate(cli.config_from_args(cli.build_parser().parse_args(
        base + ["--account-file", str(path), "--accounts-from-yaml"])))
    assert got.collection[0].parity_snapshot() == want.parity_snapshot()


def test_accounts_from_yaml_needs_an_account_file():
    with pytest.raises(SystemExit):
        cli.load_cluster_accounts(Config(accounts_from_file=True))


# --------------------------------------------------------------------------
# JSON-RPC
# --------------------------------------------------------------------------

VOTE_ACCOUNTS = {
    "current": [
        {"nodePubkey": "1111111QLbz7JHiBTspS962RLKV8GndWFwiEaqKM",
         "activatedStake": 500},
        {"nodePubkey": "1111111ogCyDbaRMvkdsHB3qfdyFYaG1WtRUAfdh",
         "activatedStake": 0},
        # a second vote account of the first node: stakes add up
        {"nodePubkey": "1111111QLbz7JHiBTspS962RLKV8GndWFwiEaqKM",
         "activatedStake": 25}],
    "delinquent": [
        {"nodePubkey": "11111112D1oxKts8YPdTJRG5FzxTNpMtWmq8hkVx3",
         "activatedStake": 9}],
}


class _Rpc(http.server.BaseHTTPRequestHandler):
    requests = []

    def do_POST(self):
        body = json.loads(self.rfile.read(
            int(self.headers.get("Content-Length", 0))))
        _Rpc.requests.append(body)
        out = json.dumps({"jsonrpc": "2.0", "id": body["id"],
                          "result": VOTE_ACCOUNTS}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *a):
        pass


@pytest.fixture
def rpc_url():
    _Rpc.requests = []
    server = http.server.HTTPServer(("127.0.0.1", 0), _Rpc)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()


WANT = {"1111111QLbz7JHiBTspS962RLKV8GndWFwiEaqKM": 525,
        "1111111ogCyDbaRMvkdsHB3qfdyFYaG1WtRUAfdh": 0,
        "11111112D1oxKts8YPdTJRG5FzxTNpMtWmq8hkVx3": 9}


def test_fetch_vote_accounts_aggregates_stake_per_node(rpc_url):
    assert _strings(fetch_vote_accounts_rpc(rpc_url)) == WANT
    (req,) = _Rpc.requests
    assert req["method"] == "getVoteAccounts"
    assert req["params"] == [{"commitment": "finalized",
                              "keepUnstakedDelinquents": True}]


def test_load_cluster_accounts_from_rpc_filters_zero_stakes(rpc_url):
    accounts, label = cli.load_cluster_accounts(
        Config(filter_zero_staked_nodes=True), rpc_url)
    assert label == rpc_url
    assert _strings(accounts) == {k: v for k, v in WANT.items() if v}


@pytest.mark.parametrize("extra,want", [
    ([], WANT),
    (["--num-nodes", "1"], {"1111111QLbz7JHiBTspS962RLKV8GndWFwiEaqKM": 525}),
    (["--zero-stakes"], {"1111111ogCyDbaRMvkdsHB3qfdyFYaG1WtRUAfdh": 0}),
    (["-f"], {k: v for k, v in WANT.items() if v})])
def test_write_accounts_main(rpc_url, tmp_path, extra, want):
    path = tmp_path / "accounts.yaml"
    assert write_accounts.main(["--url", rpc_url, "--account-file",
                                str(path)] + extra) == 0
    assert _strings(load_accounts_yaml(str(path))) == want
    assert write_accounts.main(["--url", rpc_url]) == 1     # no file given


# --------------------------------------------------------------------------
# the Influx sender
# --------------------------------------------------------------------------

class _Capture(http.server.BaseHTTPRequestHandler):
    received = []
    failures = 0
    status = 500

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        if _Capture.failures > 0:
            _Capture.failures -= 1
            self.send_response(_Capture.status)
            self.end_headers()
            return
        _Capture.received.append((self.path, body.decode(),
                                  self.headers.get("Authorization")))
        self.send_response(204)
        self.end_headers()

    def log_message(self, *a):
        pass


@pytest.fixture
def capture():
    _Capture.received, _Capture.failures, _Capture.status = [], 0, 500
    server = http.server.HTTPServer(("127.0.0.1", 0), _Capture)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()


def test_reporter_thread_posts_in_order_and_drains(capture):
    q = DatapointQueue()
    start = InfluxDataPoint()
    start.set_start()
    q.push_back(start)
    for i in range(3):
        dp = InfluxDataPoint("77", i)
        dp.create_data_point(float(i), "coverage")
        q.push_back(dp)
    end = InfluxDataPoint()
    end.set_last_datapoint()
    q.push_back(end)
    t = InfluxThread.spawn(capture, "user", "pass", "testdb", q)
    t.join(timeout=15)
    assert not t.is_alive(), "reporter thread failed to drain and exit"
    assert [b.split(" ")[0] for _, b, _ in _Capture.received] == [
        f"coverage,simulation_iter={i},start_time=77" for i in range(3)]
    assert {p for p, _, _ in _Capture.received} == {"/write?db=testdb"}
    assert all(a.startswith("Basic ") for _, _, a in _Capture.received)
    assert t.sender_stats() == {"points_sent": 3, "dropped_points": 0,
                                "spooled_points": 0, "retries": 0}


def test_post_retries_transient_failures_with_backoff(capture):
    _Capture.failures = 2
    db = InfluxDB(capture, "u", "p", "db", retry_base=0.01)
    db._post("coverage data=1.0 1\n")
    assert [b for _, b, _ in _Capture.received] == ["coverage data=1.0 1\n"]
    assert db.sender_stats()["retries"] == 2
    assert db.dropped_points == 0


def test_post_fails_fast_on_permanent_client_error(capture):
    _Capture.failures, _Capture.status = 5, 400
    db = InfluxDB(capture, "u", "p", "db", max_retries=3, retry_base=0.01)
    db._post("coverage data=1.0 1\n")
    assert db.dropped_points == 1
    assert _Capture.failures == 4, "a 4xx must not be retried"


def test_retry_exhaustion_spools_point_durably(tmp_path):
    spool = tmp_path / "points.spool"
    db = InfluxDB("http://127.0.0.1:9", "u", "p", "db", max_retries=1,
                  retry_base=0.01, spool_path=str(spool))
    db._post("coverage data=1.0 123456789\n")
    db._post("rmr rmr=5.0,m=1,n=2 123456790")
    stats = db.sender_stats()
    assert (stats["spooled_points"], stats["dropped_points"]) == (2, 0)
    assert spool.read_text().splitlines() == [
        "coverage data=1.0 123456789", "rmr rmr=5.0,m=1,n=2 123456790"]


@pytest.mark.parametrize("spooled", [False, True])
def test_bounded_send_queue_sheds_points_and_tracker_converges(tmp_path,
                                                                spooled):
    spool = str(tmp_path / "overflow.spool") if spooled else ""
    tracker = Tracker()
    db = InfluxDB("http://127.0.0.1:9", "u", "p", "db", tracker=tracker,
                  max_retries=0, retry_base=0.01, max_queue=2,
                  spool_path=spool)
    for i in range(8):
        dp = InfluxDataPoint("1", 0)
        dp.create_data_point(float(i), "coverage")
        db.send_data_points(dp)
        tracker.add_dequeued()
    deadline = time.time() + 30
    while not tracker.equal() and time.time() < deadline:
        time.sleep(0.05)
    assert tracker.equal(), "drain tracker failed to converge"
    stats = db.sender_stats()
    lost = stats["spooled_points"] if spooled else stats["dropped_points"]
    assert lost >= 6, "overflow past max_queue=2 must be shed"
    if spooled:
        assert stats["dropped_points"] == 0
        assert len(open(spool).read().splitlines()) == lost


def test_reporter_thread_survives_unreachable_endpoint():
    q = DatapointQueue()
    dp = InfluxDataPoint("1", 0)
    dp.create_data_point(1.0, "coverage")
    q.push_back(dp)
    end = InfluxDataPoint()
    end.set_last_datapoint()
    q.push_back(end)
    t = InfluxThread.spawn("http://127.0.0.1:9", "u", "p", "db", q)
    t.join(timeout=60)
    assert not t.is_alive()
    assert t.sender_stats()["dropped_points"] == 1
