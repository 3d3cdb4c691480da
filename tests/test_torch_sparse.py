"""The sparse layout (``representation="sparse"``,
``--engine-representation sparse``) of the port against the JAX package's
and against the port's own dense layout.

* (a) ``run_rounds`` at N=300, O=2, in both threefry layouts: every row
  and every state field equal to the reference's sparse run (stake planes
  ``[2, 300, 0]``), and every row and every other field equal to the
  port's dense run;
* (b) the same under a fail round, loss, churn and a partition at N=1,000;
* (c) N=40,000 (past the int32 key bounds' threshold), O=1, 3 rounds,
  against the reference's sparse run; one round from a state whose upsert
  counters mix 18, 19 and 20 (fired and unfired rows in one round), in
  both layouts, against the reference's round;
* (d) the single-origin CLI (parity snapshot and deterministic Influx
  lines), all-origins (``AllOriginsStats`` and the summary) and a push
  sweep, each ``--device cpu`` sparse, equal to the reference's sparse run;
* (e) ``rc_merge_prune``'s sparse plain version against the dense one
  given the planes ``shi[rc_src]``/``slo[rc_src]``, on seeded rows with
  empty slots, fired rows and overflow;
* (f) the invariant the sparse layout rests on: every dense state of the
  port carries ``rc_shi == shi[rc_src]`` and ``rc_slo == slo[rc_src]``;
* (g) ``convert`` carries zero-width planes both ways;
* (h) the refusals: sparse with the pull modes and with traffic (the
  reference's words, as ``ValueError``), in the API and the CLI, and a
  dense state in a sparse round;
* the non-partitionable layout reproduces
  ``tests/fixtures/sparse/dense_golden.json`` (the reference's gate 3 of
  ``tools/sparse_smoke.py``) in both representations, with the port alone.

Tolerance: 0 everywhere (exact equality, NaN == NaN in float rows)."""

import gossip_sim_tpu.engine as je  # noqa: I001  (64-bit types first)
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_sim_tpu import cli as ref_cli
from gossip_sim_tpu.config import Config as RefConfig
from gossip_sim_tpu.identity import reset_unique_pubkeys as ref_reset
from gossip_sim_tpu.sinks import DatapointQueue as RefQueue
from gossip_sim_tpu.stats.gossip_stats import \
    GossipStatsCollection as RefCollection
from gossip_sim_tpu_torch import cli, kernels, rng
from gossip_sim_tpu_torch.config import Config
from gossip_sim_tpu_torch.convert import state_from_numpy, state_to_numpy
from gossip_sim_tpu_torch.engine import core as tc
from gossip_sim_tpu_torch.engine.params import EngineParams as PortParams
from gossip_sim_tpu_torch.identity import reset_unique_pubkeys
from gossip_sim_tpu_torch.sinks import DatapointQueue
from gossip_sim_tpu_torch.stats.gossip_stats import GossipStatsCollection
from test_torch_aggregate import assert_state_dicts_equal
from test_torch_kernels_cuda import _merge_inputs

GOLDEN = Path(__file__).resolve().parent / "fixtures" / "sparse" / \
    "dense_golden.json"
PLANES = ("rc_shi", "rc_slo")


@pytest.fixture
def layout(request):
    """Pin both packages to one threefry layout (``request.param``, True
    without one); the port on one CPU thread; restore afterwards."""
    part = getattr(request, "param", True)
    old = jax.config.jax_threefry_partitionable
    old_port = rng.partitionable()
    threads = torch.get_num_threads()
    jax.config.update("jax_threefry_partitionable", part)
    rng.set_partitionable(part)
    torch.set_num_threads(1)
    yield part
    jax.config.update("jax_threefry_partitionable", old)
    rng.set_partitionable(old_port)
    torch.set_num_threads(threads)


def _stakes(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        1, 1 << 45, size=n).astype(np.int64)


def _assert_state_equal(want, got, where="", skip=()):
    """Every field of two states of numpy arrays equal, dtype and shape
    included (but the fields ``skip``)."""
    for f in want._fields:
        if f in skip:
            continue
        a, b = np.asarray(getattr(want, f)), np.asarray(getattr(got, f))
        assert a.dtype == b.dtype and a.shape == b.shape, (where, f)
        assert np.array_equal(a, b), (where, f)


def _assert_rows_equal(want, got, where=""):
    assert set(want) == set(got), where
    for k, v in want.items():
        a, b = np.asarray(v), np.asarray(got[k])
        assert a.dtype == b.dtype, (where, k)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), (where, k)


def _three_runs(n, origins, rounds, seed=7, **kw):
    """The reference's sparse run, the port's sparse run and the port's
    dense run of ``rounds`` rounds from ``init_state``: (states, rows) as
    numpy, the port's sparse ``init_state`` held against the reference's
    first."""
    stakes = _stakes(n)
    o = np.asarray(origins, dtype=np.int32)
    jt = je.make_cluster_tables(stakes)
    tt = tc.make_cluster_tables(stakes, device="cpu")
    jp = je.EngineParams(num_nodes=n, representation="sparse", **kw)
    js = je.init_state(jax.random.PRNGKey(seed), jt, jnp.asarray(o), jp)
    out = {}
    for rep in ("sparse", "dense"):
        tp = PortParams(num_nodes=n, representation=rep, **kw)
        ts = tc.init_state(rng.prng_key(seed), tt, torch.as_tensor(o), tp)
        if rep == "sparse":
            _assert_state_equal(js, state_to_numpy(ts), "init")
        ts, rows = tc.run_rounds(tp, tt, torch.as_tensor(o), ts, rounds,
                                 detail=True)
        out[rep] = (state_to_numpy(ts), {k: v.numpy()
                                         for k, v in rows.items()})
    js, jrows = je.run_rounds(jp, jt, jnp.asarray(o), js, rounds,
                              detail=True)
    out["jax"] = (js, jrows)
    return out


def _check_three(out, o, n, where):
    (js, jrows), (ss, srows), (ds, drows) = (out["jax"], out["sparse"],
                                             out["dense"])
    _assert_state_equal(js, ss, f"{where}: port sparse vs reference")
    _assert_rows_equal(jrows, srows, f"{where}: port sparse vs reference")
    _assert_state_equal(ss, ds, f"{where}: sparse vs dense", skip=PLANES)
    _assert_rows_equal(drows, srows, f"{where}: sparse vs dense")
    for f in PLANES:
        assert getattr(ss, f).shape == (o, n, 0), f
        assert getattr(ds, f).shape == (o, n, ds.rc_src.shape[-1]), f
    return srows


# ---- (a)-(c) the engine ----------------------------------------------------

@pytest.mark.parametrize("layout", [True, False], indirect=True,
                         ids=["partitionable", "original"])
def test_rounds_equal_reference_and_dense(layout):
    rows = _check_three(_three_runs(300, [0, 151], 22, warm_up_rounds=5),
                        2, 300, "N=300")
    assert int(rows["prunes_sent"].sum()) > 0


def test_rounds_equal_under_fail_loss_churn_partition(layout):
    kw = dict(warm_up_rounds=5, fail_at=6, fail_fraction=0.1,
              packet_loss_rate=0.1, churn_fail_rate=0.02,
              churn_recover_rate=0.25, partition_at=8, heal_at=17,
              impair_seed=11)
    rows = _check_three(_three_runs(1000, [3, 500], 22, **kw), 2, 1000,
                        "impaired")
    for k in ("prunes_sent", "dropped", "suppressed"):
        assert int(rows[k].sum()) > 0, k
    assert int(rows["failed_count"][6].min()) >= 100


def test_rounds_equal_reference_at_40000_nodes(layout):
    n = 40_000
    stakes = _stakes(n)
    o = np.zeros(1, dtype=np.int32)
    jt = je.make_cluster_tables(stakes)
    tt = tc.make_cluster_tables(stakes, device="cpu")
    jp = je.EngineParams(num_nodes=n, representation="sparse")
    tp = PortParams(num_nodes=n, representation="sparse")
    js = je.init_state(jax.random.PRNGKey(3), jt, jnp.asarray(o), jp)
    js, jrows = je.run_rounds(jp, jt, jnp.asarray(o), js, 3, detail=True)
    ts = tc.init_state(rng.prng_key(3), tt, torch.as_tensor(o), tp)
    ts, trows = tc.run_rounds(tp, tt, torch.as_tensor(o), ts, 3, detail=True)
    _assert_state_equal(js, state_to_numpy(ts), "N=40,000")
    _assert_rows_equal(jrows, {k: v.numpy() for k, v in trows.items()},
                       "N=40,000")
    assert ts.rc_shi.shape == (1, n, 0)
    assert float(trows["coverage"][-1, 0]) > 0.99


@pytest.mark.parametrize("rep", ["sparse", "dense"])
def test_round_with_fired_and_unfired_rows_equals_reference(layout, rep):
    """One round from a state whose upsert counters are 18, 19 and 20
    across rows, so the round fires some rows (20, and 19 with an inbound
    source) and not others (18): every state field and row equal to the
    JAX package's round, the state carried across with ``convert``
    (``rc_merge_prune`` orders only the rows that fire)."""
    n, o = 300, np.array([0, 151], dtype=np.int32)
    stakes = _stakes(n, 3)
    jt = je.make_cluster_tables(stakes)
    tt = tc.make_cluster_tables(stakes, device="cpu")
    kw = dict(num_nodes=n, warm_up_rounds=0, representation=rep)
    jp, tp = je.EngineParams(**kw), PortParams(**kw)
    js = je.init_state(jax.random.PRNGKey(5), jt, jnp.asarray(o), jp)
    js, _ = je.run_rounds(jp, jt, jnp.asarray(o), js, 8)
    ups = np.random.default_rng(1).choice(
        np.array([18, 19, 20], np.int32), size=(2, n))
    js = js._replace(rc_upserts=jnp.asarray(ups))
    ts = state_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    _assert_state_equal(js, state_to_numpy(ts), "carried")
    want_state, want_rows = je.run_rounds(jp, jt, jnp.asarray(o), js, 1,
                                          start_it=8, detail=True)
    got_state, got_rows = tc.round_step(tp, tt, torch.as_tensor(o), ts, 8,
                                        detail=True)
    _assert_state_equal(want_state, state_to_numpy(got_state), rep)
    _assert_rows_equal({k: np.asarray(v)[0] for k, v in want_rows.items()},
                       {k: v.numpy() for k, v in got_rows.items()}, rep)
    after = got_state.rc_upserts
    assert bool((after == 0).any()) and bool((after > 0).any())
    assert int(got_rows["prunes_sent"].sum()) > 0


# ---- (d) the entry points --------------------------------------------------

def _strings(snap: dict) -> dict:
    """Map the two packages' distinct Pubkey classes to base58 strings."""
    def key(k):
        return k.to_string() if hasattr(k, "to_string") else k
    return {name: ({key(k): x for k, x in v.items()} if isinstance(v, dict)
                   else {key(k) for k in v} if isinstance(v, set) else v)
            for name, v in snap.items()}


def _ref_runs(argv):
    """The reference's single-origin run or sweep of ``argv``:
    (snapshots, deterministic lines)."""
    ref_reset()
    args = ref_cli.build_parser().parse_args(argv + ["--backend", "tpu"])
    cfg = ref_cli.config_from_args(args)
    coll, q = RefCollection(), RefQueue()
    coll.set_number_of_simulations(cfg.num_simulations)
    ref_cli.dispatch_sweeps(cfg, "u", args.origin_rank, coll, q, "77")
    return ([_strings(s.parity_snapshot()) for s in coll.collection],
            q.drain_deterministic_lines())


def _port_runs(argv):
    reset_unique_pubkeys()
    args = cli.build_parser().parse_args(argv + ["--device", "cpu"])
    cfg = cli.config_from_args(args)
    coll, q = GossipStatsCollection(), DatapointQueue()
    coll.set_number_of_simulations(cfg.num_simulations)
    cli.dispatch_sweeps(cfg, "u", args.origin_rank, coll, q, "77")
    return ([_strings(s.parity_snapshot()) for s in coll.collection],
            q.drain_deterministic_lines())


@pytest.mark.parametrize("extra", [
    ["--packet-loss-rate", "0.1", "--churn-fail-rate", "0.01",
     "--churn-recover-rate", "0.2", "--partition-at", "12", "--heal-at",
     "20"],
    ["--test-type", "prune-stake-threshold", "--num-simulations", "2",
     "--step-size", "0.05"],
], ids=["single_origin_impaired", "prune_stake_threshold_sweep"])
def test_cli_runs_equal_reference(layout, extra):
    argv = ["--num-synthetic-nodes", "150", "--iterations", "28",
            "--warm-up-rounds", "8", "--engine-representation",
            "sparse"] + extra
    want_snaps, want_lines = _ref_runs(argv)
    got_snaps, got_lines = _port_runs(argv)
    assert len(got_snaps) == len(want_snaps) >= 1
    for got, want in zip(got_snaps, want_snaps):
        assert set(got) == set(want)
        for k in want:
            assert got[k] == want[k], k
        assert len(got["coverage"]) == 20
    assert got_lines == want_lines and len(got_lines) > 20


def test_batched_origin_rank_sweep_sparse_equals_dense(layout):
    """The batched origin-rank sweep (one engine call for the three ranks)
    carries the representation: sparse equals dense."""
    argv = ["--num-synthetic-nodes", "150", "--iterations", "24",
            "--warm-up-rounds", "8", "--test-type", "origin-rank",
            "--origin-rank", "1", "4", "7", "--num-simulations", "3",
            "--engine-representation"]
    sparse = _port_runs(argv + ["sparse"])
    assert len(sparse[0]) == 3
    assert sparse == _port_runs(argv + ["dense"])


def test_all_origins_equal_reference(layout):
    """18 origins of 50 nodes at batch 16: a full batch and a tail of 2
    valid origins padded with 14 copies of origin 0."""
    base = dict(num_synthetic_nodes=50, gossip_iterations=30,
                warm_up_rounds=10, all_origins=True, origin_batch=16,
                engine_representation="sparse")
    origins = np.arange(0, 36, 2, dtype=np.int32)
    ref_reset()
    ref_cfg = RefConfig(**base, mesh_devices=1)
    accounts, _ = ref_cli.load_cluster_accounts(ref_cfg, "")
    ref = ref_cli.run_all_origins(ref_cfg, "", accounts=accounts,
                                  origin_indices=origins)
    reset_unique_pubkeys()
    port = cli.run_all_origins(Config(**base, device="cpu"),
                               origin_indices=origins)
    assert_state_dicts_equal(ref["stats"].state_dict(),
                             port["stats"].state_dict())
    keys = set(ref) - {"stats", "elapsed_s", "origin_iters_per_sec"}
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}
    assert port["padded_sims"] == 14


# ---- (e)-(g) the kernel's plain version, the invariant, convert -----------

@pytest.mark.parametrize("c,k", [(16, 4), (64, 16), (128, 64)])
def test_rc_merge_prune_sparse_plain_equals_dense_plain(c, k):
    rc_src, rc_score, rc_shi, rc_slo, ups, inb, shi, slo, stakes, origins = \
        [torch.as_tensor(a) for a in _merge_inputs(c + k, c, k)]
    assert torch.equal(rc_shi, shi[rc_src.long()])
    assert torch.equal(rc_slo, slo[rc_src.long()])
    for cap in (50, c + k):
        kw = dict(received_cap=cap, min_num_upserts=20, min_ingress_nodes=2,
                  prune_stake_threshold=0.15)
        kernels.reset_launch_counts()
        got = kernels.rc_merge_prune(rc_src, rc_score, None, None, ups, inb,
                                     shi, slo, stakes, origins, **kw)
        assert kernels.LAUNCHES["rc_merge_prune_sparse"] == 0  # CPU tensors
        want = kernels.rc_merge_prune_plain(rc_src, rc_score, rc_shi, rc_slo,
                                            ups, inb, shi, slo, stakes,
                                            origins, **kw)
        for f in got._fields:
            if f in PLANES:
                assert getattr(got, f).shape == rc_src.shape[:2] + (0,)
                assert torch.equal(getattr(want, f),
                                   (shi if f == "rc_shi" else slo)[
                                       want.rc_src.long()])
            else:
                assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert bool((rc_src == rc_src.shape[1]).any())          # empty slots
        assert int(want.n_pruned.sum()) > 0
        assert bool((want.rc_upserts == 0).any())              # fired rows
        if cap == c + k:
            assert int(want.rc_overflow.sum()) > 0


def test_dense_states_carry_the_table_stakes(layout):
    """After every round, fired rows and the pad included: the dense
    planes equal the gather the sparse layout makes."""
    n = 400
    tt = tc.make_cluster_tables(_stakes(n, 5), device="cpu")
    tp = PortParams(num_nodes=n, warm_up_rounds=0, packet_loss_rate=0.05,
                    churn_fail_rate=0.02, churn_recover_rate=0.2,
                    impair_seed=3)
    o = torch.tensor([0, 7, 399], dtype=torch.int32)
    ts = tc.init_state(rng.prng_key(9), tt, o, tp)
    fired = 0
    for it in range(24):
        ts, rows = tc.round_step(tp, tt, o, ts, it)
        src = ts.rc_src.long()
        assert torch.equal(ts.rc_shi, tt.shi[src]), it
        assert torch.equal(ts.rc_slo, tt.slo[src]), it
        fired += int(rows["prunes_sent"].sum())
    assert fired > 0
    assert int(tt.shi[n]) == int(tt.slo[n]) == 0
    assert bool((ts.rc_src == n).any())


def test_convert_carries_zero_width_planes(layout):
    n = 120
    stakes = _stakes(n, 2)
    o = np.array([0, 60], dtype=np.int32)
    jp = je.EngineParams(num_nodes=n, representation="sparse")
    js = je.init_state(jax.random.PRNGKey(4), je.make_cluster_tables(stakes),
                       jnp.asarray(o), jp)
    ts = state_from_numpy(js, device="cpu")
    for f in PLANES:
        assert getattr(ts, f).shape == (2, n, 0)
        assert getattr(ts, f).dtype == torch.int32
    back = state_to_numpy(ts)
    _assert_state_equal(js, back, "round trip")
    tp = PortParams(num_nodes=n, representation="sparse")
    ts2, _ = tc.round_step(tp, tc.make_cluster_tables(stakes, device="cpu"),
                           torch.as_tensor(o), ts, 0)
    assert state_to_numpy(ts2).rc_shi.shape == (2, n, 0)


# ---- (h) the refusals ------------------------------------------------------

def _ref_refusal(**kw) -> str:
    with pytest.raises(AssertionError) as e:
        je.EngineParams(num_nodes=40, representation="sparse",
                        **kw).validate()
    return str(e.value)


@pytest.mark.parametrize("kw", [
    dict(gossip_mode="push-pull"), dict(gossip_mode="pull"),
    dict(gossip_mode="adaptive"), dict(traffic_values=4),
    dict(node_ingress_cap=8)],
    ids=["push_pull", "pull", "adaptive", "traffic", "ingress_cap"])
def test_params_refuse_what_the_reference_refuses(kw):
    want = _ref_refusal(**kw)
    with pytest.raises(ValueError) as got:
        PortParams(num_nodes=40, representation="sparse", **kw).validate()
    assert str(got.value) == want
    with pytest.raises(ValueError, match="unknown representation"):
        PortParams(num_nodes=40, representation="csr").validate()


@pytest.mark.parametrize("extra", [
    ["--gossip-mode", "push-pull"], ["--gossip-mode", "adaptive"],
    ["--traffic-values", "4"]], ids=["push_pull", "adaptive", "traffic"])
def test_cli_refuses_sparse_with_pull_and_traffic(extra):
    argv = ["--num-synthetic-nodes", "40", "--iterations", "4",
            "--warm-up-rounds", "2", "--engine-representation",
            "sparse"] + extra
    want = _ref_refusal(**({"traffic_values": 4} if "--traffic-values" in
                           extra else {"gossip_mode": extra[1]}))
    with pytest.raises(ValueError) as got:
        cli.main(argv + ["--device", "cpu"])
    assert str(got.value) == want


def test_round_refuses_a_state_of_the_other_layout():
    n = 40
    tt = tc.make_cluster_tables(_stakes(n), device="cpu")
    o = torch.zeros(1, dtype=torch.int32)
    dense = PortParams(num_nodes=n)
    sparse = dense._replace(representation="sparse")
    for made, run, want, have in ((dense, sparse, 0, 64),
                                  (sparse, dense, 64, 0)):
        ts = tc.init_state(rng.prng_key(1), tt, o, made)
        with pytest.raises(ValueError, match=(
                f"representation='{run.representation}' carries rc_shi "
                f"{want} wide, but the state's rc_shi is {have} wide")):
            tc.round_step(run, tt, o, ts, 0)


# ---- ROADMAP C6: the reference's dense golden, both representations --------

def _jsonable(snap: dict) -> dict:
    """A parity snapshot in the fixture's JSON form: pubkeys as base58
    strings, the failed set a sorted list."""
    out = {}
    for k, v in snap.items():
        if k == "stranded":
            out[k] = {pk.to_string(): [int(s), int(c)]
                      for pk, (s, c) in v.items()}
        elif k in ("egress", "ingress", "prunes"):
            out[k] = {pk.to_string(): int(x) for pk, x in v.items()}
        elif k == "failed_nodes":
            out[k] = sorted(pk.to_string() for pk in v)
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("layout", [False], indirect=True, ids=["original"])
@pytest.mark.parametrize("representation", ["dense", "sparse"])
def test_reproduces_the_dense_golden(layout, representation):
    """The settings of the reference's gate 3 (N=300, 10 iterations, 2
    warm-up, seed 7, loss 0.05, churn 0.02 / 0.2), in the
    non-partitionable threefry layout the fixture pins."""
    golden = json.loads(GOLDEN.read_text())
    reset_unique_pubkeys()
    cfg = Config(num_synthetic_nodes=300, gossip_iterations=10,
                 warm_up_rounds=2, seed=7, packet_loss_rate=0.05,
                 churn_fail_rate=0.02, churn_recover_rate=0.2,
                 engine_representation=representation, device="cpu")
    coll, q = GossipStatsCollection(), DatapointQueue()
    coll.set_number_of_simulations(1)
    cli.run_simulation(cfg, "", coll, q, 0, "0", 0.0)
    assert _jsonable(coll.collection[0].parity_snapshot()) == \
        golden["snapshot"]
    assert q.drain_deterministic_lines() == golden["lines"]
