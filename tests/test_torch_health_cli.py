"""The node-health observatory's CLI paths (``--health``, ``--health-topk``)
against the reference package's.

* the single run, all-origins (a padded tail batch) and the traffic run
  emit ``sim_node_health`` points (timestamp stripped) and build the final
  ``node_health`` section (the reference's ``get_registry().info``, the
  port's ``resilience.RUN_INFO``) equal to the reference's, field for
  field, over several harvest blocks;
* ``--health`` moves no deterministic Influx line and no
  ``parity_snapshot()`` series: the gated-on runs' equal the gated-off
  runs' (``sim_node_health`` stays off the deterministic lines);
* an all-origins ``--health`` run stopped after one batch and resumed
  equals the straight run (the sidecar's ``node_health_stack`` restored);
* a ``--health`` checkpoint of the single run crosses between the
  packages both ways and finishes with the straight run's section and
  last block's point;
* the lane sweep and the batched origin-rank sweep emit no
  ``sim_node_health`` point (the reference's sweeps emit none);
* ``--health-topk 0`` is refused with the reference's words.

The harvest block is cut to 8 rounds in both packages, so every run spans
more than one block.  Tolerance: 0 (exact equality)."""

import gossip_sim_tpu.engine  # noqa: F401,I001  (64-bit types first)
import functools

import jax
import pytest
import torch

from gossip_sim_tpu import cli as ref_cli
from gossip_sim_tpu import resilience as ref_res
from gossip_sim_tpu.identity import reset_unique_pubkeys as ref_reset
from gossip_sim_tpu.obs import get_registry
from gossip_sim_tpu.sinks import DatapointQueue as RefQueue
from gossip_sim_tpu.stats.gossip_stats import \
    GossipStatsCollection as RefColl
from gossip_sim_tpu.stats.traffic import TrafficStatsCollection as RefTColl
from gossip_sim_tpu_torch import cli, resilience, rng
from gossip_sim_tpu_torch.identity import reset_unique_pubkeys
from gossip_sim_tpu_torch.sinks import (DatapointQueue,
                                        deterministic_wire_lines)
from gossip_sim_tpu_torch.stats.gossip_stats import GossipStatsCollection
from gossip_sim_tpu_torch.stats.traffic import TrafficStatsCollection

BLOCK = 8
SINGLE = ["--num-synthetic-nodes", "100", "--iterations", "26",
          "--warm-up-rounds", "10", "--packet-loss-rate", "0.1",
          "--health-topk", "5"]
ALL_ORIGINS = ["--num-synthetic-nodes", "40", "--iterations", "8",
               "--warm-up-rounds", "3", "--all-origins", "--origin-batch",
               "16", "--mesh-devices", "1", "--seed", "9"]
TRAFFIC = ["--num-synthetic-nodes", "100", "--iterations", "22",
           "--warm-up-rounds", "6", "--traffic-values", "8",
           "--traffic-rate", "2", "--node-ingress-cap", "6",
           "--node-egress-cap", "10", "--packet-loss-rate", "0.1"]


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


def _strings(snap: dict) -> dict:
    def key(k):
        return k.to_string() if hasattr(k, "to_string") else k
    return {name: ({key(k): x for k, x in v.items()} if isinstance(v, dict)
                   else {key(k) for k in v} if isinstance(v, set) else v)
            for name, v in snap.items()}


def _drain(q):
    """(the sim_node_health lines without their timestamps, the
    deterministic lines) of a queue."""
    raw = []
    while len(q):
        raw.extend(q.pop_front().data().splitlines())
    health = [ln.rsplit(" ", 1)[0] for ln in raw
              if ln.startswith("sim_node_health")]
    return health, deterministic_wire_lines(raw)


def _ref(kind, argv, kill_after=0, influx=True):
    """The reference's run: (health lines, deterministic lines, section,
    parity snapshots or the all-origins summary); ``influx`` False runs it
    without a queue."""
    ref_reset()
    get_registry().reset()
    ref_res.reset_shutdown()
    if kill_after:
        ref_res.set_kill_after_units(kill_after)
    cfg = ref_cli.config_from_args(ref_cli.build_parser().parse_args(
        argv + ["--backend", "tpu"]))
    q = RefQueue()
    if kind == "single":
        coll = RefColl()
        ref_cli.run_simulation(cfg, "", coll, q if influx else None, 0, "0",
                               0.0)
        out = [_strings(s.parity_snapshot()) for s in coll.collection]
    elif kind == "traffic":
        coll = RefTColl()
        ref_cli.run_traffic(cfg, "u", q, "0", collection=coll)
        out = [s.parity_snapshot() for s in coll.collection]
    else:
        out = ref_cli.run_all_origins(cfg, "", q, "0")
    return (*_drain(q), get_registry().info("node_health"), out)


def _port(kind, argv, kill_after=0, influx=True):
    reset_unique_pubkeys()
    resilience.reset_counts()
    resilience.reset_shutdown()
    if kill_after:
        resilience.set_kill_after_units(kill_after)
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    q = DatapointQueue()
    if kind == "single":
        coll = GossipStatsCollection()
        cli.run_simulation(cfg, "", coll, q if influx else None, 0, "0",
                           0.0)
        out = [_strings(s.parity_snapshot()) for s in coll.collection]
    elif kind == "traffic":
        coll = TrafficStatsCollection()
        cli.run_traffic(cfg, "u", q, "0", collection=coll)
        out = [s.parity_snapshot() for s in coll.collection]
    else:
        out = cli.run_all_origins(cfg, dp_queue=q, start_ts="0")
    return (*_drain(q), resilience.RUN_INFO.get("node_health"), out)


@functools.lru_cache(maxsize=None)
def _runs(kind):
    """The reference's --health run, the port's, and the port's without
    --health, of one path."""
    argv = {"single": SINGLE, "all_origins": ALL_ORIGINS,
            "traffic": TRAFFIC}[kind]
    kind = "all-origins" if kind == "all_origins" else kind
    return (_ref(kind, argv + ["--health"]), _port(kind, argv + ["--health"]),
            _port(kind, argv))


@pytest.mark.parametrize("kind", ["single", "all_origins", "traffic"])
def test_health_points_and_section_equal_reference(kind):
    want, got, off = _runs(kind)
    health, lines, section, out = got
    assert health == want[0]
    assert section == want[2]
    assert lines == want[1] == off[1]
    assert off[0] == [] and off[2] is None
    blocks = {"single": 2, "all_origins": 3, "traffic": 2}[kind]
    assert len(health) == blocks
    assert section["enabled"] and section["metrics"]
    assert section["source"] == {"single": "sim", "traffic": "traffic",
                                 "all_origins": "all-origins"}[kind]
    if kind == "all_origins":
        assert out["padded_sims"] == 8 == want[3]["padded_sims"]
        assert section["metrics"]["egress"]["total"] > 0
    else:
        assert out == want[3] == off[3]
        assert section["metrics"]["delivered"]["total"] > 0
        if kind == "single":
            assert section["metrics"]["prunes_recv"]["total"] > 0
        else:
            assert section["metrics"]["lat_sum"]["total"] > 0


def test_all_origins_health_stopped_and_resumed(tmp_path):
    _, straight, _ = _runs("all_origins")
    ck = ["--checkpoint-path", str(tmp_path / "ao.npz")]
    argv = ALL_ORIGINS + ["--health"] + ck
    with pytest.raises(resilience.ResumableInterrupt):
        _port("all-origins", argv, kill_after=1)
    resumed = _port("all-origins", argv + ["--resume", ck[1]])
    assert resumed[:3] == straight[:3]


@pytest.mark.parametrize("first", ["reference", "port"])
def test_health_checkpoint_crosses_the_packages(tmp_path, first):
    """The single run checkpointed at iteration 18 by one package (its
    file's meta says ``health``, its first-round plane is not zero; its
    pruners first fire in round 19) and resumed to
    26 by the other ends with the straight run's section.  The resumed
    runs go without a queue: both packages' resumed single runs index
    their Influx iteration points from the run's start."""
    from gossip_sim_tpu_torch.checkpoint import load_state
    want, _, _ = _runs("single")
    ck = str(tmp_path / "run.npz")
    stop = list(SINGLE)
    stop[stop.index("--iterations") + 1] = "18"
    runs = {"reference": functools.partial(_ref, "single"),
            "port": functools.partial(_port, "single")}
    second = "port" if first == "reference" else "reference"
    runs[first](stop + ["--health", "--checkpoint-path", ck])
    arrays, _, meta = load_state(ck)
    assert meta["health"] == {"health": True}
    assert arrays["health_first_round"].any()
    _, _, section, _ = runs[second](SINGLE + ["--health", "--resume", ck],
                                    influx=False)
    assert section == want[2]


def test_sweeps_emit_no_health_point():
    sweep = ["--num-synthetic-nodes", "60", "--iterations", "10",
             "--warm-up-rounds", "4", "--health", "--device", "cpu"]
    for extra, run in (
            (["--test-type", "packet-loss", "--num-simulations", "2",
              "--step-size", "0.1", "--sweep-lanes", "2"],
             cli.run_lane_sweep),
            (["--test-type", "origin-rank", "--num-simulations", "2",
              "--step-size", "1"], cli.run_origin_rank_sweep)):
        reset_unique_pubkeys()
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            sweep + extra))
        q = DatapointQueue()
        coll = GossipStatsCollection()
        coll.set_number_of_simulations(2)
        run(cfg, "", [1, 2], coll, q, "0")
        health, lines = _drain(q)
        assert health == [] and lines, extra


def test_health_topk_below_one_is_refused():
    for module in (ref_cli, cli):
        with pytest.raises(SystemExit) as err:
            module.config_from_args(module.build_parser().parse_args(
                SINGLE + ["--health", "--health-topk", "0"]))
        assert str(err.value) == "health-topk must be >= 1"
