"""The port's checkpoints (gossip_sim_tpu_torch/checkpoint.py) against the
JAX package's: the v9 ``.npz`` crosses between the packages both ways.

* (a) a state after 4 rounds at N=64, O=2 (a fail round, churn and loss),
  written by each package, dense and sparse, is restored by each package,
  dense and sparse (the representation switch both ways), and continued 4
  rounds: every state field and row of the four continuations equal;
* (b) the reference's committed v1-v8 fixtures restore in the port to the
  reference's fields, stored params and meta, and continue 2 rounds equal;
* (c) ``kind="traffic"`` files both ways, push and adaptive: every
  ``TrafficState`` field, 3 rounds on, and the ``TrafficStats`` restored;
* (d) the refusals in the reference's words: the wrong kind both ways, a
  shape mismatch and an unreadable version;
* (e) the single-origin CLI: a port file and the reference's of the same
  20-round run have the same meta (all but ``config``) and arrays, key for
  key; each package resumes the other's file to 30 rounds, equal to the
  reference's straight 30-round run.

Tolerance: 0 everywhere (exact equality, dtype and shape included)."""

import gossip_sim_tpu.engine as je  # noqa: I001  (64-bit types first)
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_sim_tpu import checkpoint as ref_ckpt
from gossip_sim_tpu import cli as ref_cli
from gossip_sim_tpu.engine import traffic as ref_traffic
from gossip_sim_tpu.identity import reset_unique_pubkeys as ref_reset
from gossip_sim_tpu.stats.traffic import TrafficStats as RefTrafficStats
from gossip_sim_tpu_torch import checkpoint as ckpt
from gossip_sim_tpu_torch import cli, rng
from gossip_sim_tpu_torch.convert import (state_to_numpy,
                                          traffic_state_to_numpy)
from gossip_sim_tpu_torch.engine import core as tc
from gossip_sim_tpu_torch.engine import traffic as tt
from gossip_sim_tpu_torch.engine.params import EngineParams as PortParams
from gossip_sim_tpu_torch.identity import reset_unique_pubkeys
from gossip_sim_tpu_torch.stats.traffic import TrafficStats

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "checkpoints"
N, O, SEED, K1, K2 = 64, 2, 7, 4, 4
KW = dict(warm_up_rounds=2, fail_at=2, fail_fraction=0.2,
          churn_fail_rate=0.02, churn_recover_rate=0.3,
          packet_loss_rate=0.1, impair_seed=3)
REPS = ("dense", "sparse")


@pytest.fixture(scope="module")
def pinned():
    """Both packages on the partitionable threefry layout, the port on
    one CPU thread; restored afterwards."""
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


def _stakes(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        1, 1 << 45, size=n).astype(np.int64)


def _np_state(state):
    """A state of either package as a dict of numpy arrays."""
    if isinstance(state, tc.SimState):
        state = state_to_numpy(state)
    elif isinstance(state, tt.TrafficState):
        state = traffic_state_to_numpy(state)
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def _np_rows(rows):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in rows.items()}


def _assert_arrays_equal(want: dict, got: dict, where=""):
    assert set(want) == set(got), where
    for k, a in want.items():
        b = got[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (where, k)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), (where, k)


# --------------------------------------------------------------------------
# (a) sim files across the packages and the representations
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def crossing(pinned, tmp_path_factory):
    """Each package's file of each representation after K1 rounds, and
    every (written, restored) representation pair continued K2 rounds by
    each package from each package's file."""
    d = tmp_path_factory.mktemp("crossing")
    stakes = _stakes(N)
    o = np.arange(O, dtype=np.int32)
    jt = je.make_cluster_tables(stakes)
    ptab = tc.make_cluster_tables(stakes, device="cpu")
    jp = {r: je.EngineParams(num_nodes=N, representation=r, **KW)
          for r in REPS}
    tp = {r: PortParams(num_nodes=N, representation=r, **KW) for r in REPS}
    files, at_k1 = {}, {}
    for r in REPS:
        js = je.init_state(jax.random.PRNGKey(SEED), jt, jnp.asarray(o),
                           jp[r])
        # detail=True with K1 == K2: the continuations reuse this compile
        js, _ = je.run_rounds(jp[r], jt, jnp.asarray(o), js, K1, detail=True)
        ts = tc.init_state(rng.prng_key(SEED), ptab, torch.as_tensor(o),
                           tp[r])
        ts, _ = tc.run_rounds(tp[r], ptab, torch.as_tensor(o), ts, K1)
        at_k1[r] = (_np_state(js), _np_state(ts))
        files[("ref", r)] = str(d / f"ref_{r}.npz")
        files[("port", r)] = str(d / f"port_{r}.npz")
        ref_ckpt.save_state(files[("ref", r)], js, jp[r], iteration=K1)
        ckpt.save_state(files[("port", r)], ts, tp[r], iteration=K1)
    out = {}
    for w in REPS:
        for r in REPS:
            runs = {}
            for writer in ("ref", "port"):
                path = files[(writer, w)]
                js, _, jm = ref_ckpt.restore_sim_state(path, jp[r], jt)
                js, jrows = je.run_rounds(jp[r], jt, jnp.asarray(o), js, K2,
                                          start_it=jm["iteration"],
                                          detail=True)
                runs[("ref", writer)] = (_np_state(js), _np_rows(jrows))
                ts, _, tm = ckpt.restore_sim_state(path, tp[r], ptab,
                                                   device="cpu")
                ts, trows = tc.run_rounds(tp[r], ptab, torch.as_tensor(o),
                                          ts, K2, start_it=tm["iteration"],
                                          detail=True)
                runs[("port", writer)] = (_np_state(ts), _np_rows(trows))
            out[(w, r)] = runs
    return at_k1, out


@pytest.mark.parametrize("rep", REPS)
def test_both_packages_write_the_same_state(crossing, rep):
    at_k1, _ = crossing
    want, got = at_k1[rep]
    _assert_arrays_equal(want, got, rep)
    if rep == "sparse":
        assert want["rc_shi"].shape == (O, N, 0)


@pytest.mark.parametrize("written,restored", [(w, r) for w in REPS
                                              for r in REPS])
def test_files_cross_between_the_packages_and_representations(
        crossing, written, restored):
    """The reference's continuation of its own file is the bar: the
    reference continuing the port's file, and the port continuing either
    package's file, give every field and row equal to it."""
    runs = crossing[1][(written, restored)]
    want_state, want_rows = runs[("ref", "ref")]
    assert want_state["failed"].any()       # the fail round and churn ran
    if restored == "sparse":
        assert want_state["rc_shi"].shape == (O, N, 0)
    else:
        assert want_state["rc_shi"].shape[-1] > 0
    for who in (("ref", "port"), ("port", "ref"), ("port", "port")):
        got_state, got_rows = runs[who]
        _assert_arrays_equal(want_state, got_state, who)
        _assert_arrays_equal(want_rows, got_rows, who)


# --------------------------------------------------------------------------
# (b) the reference's v1-v8 fixtures
# --------------------------------------------------------------------------

@pytest.mark.parametrize("version", range(1, 9))
def test_fixture_restores_to_the_references_fields(pinned, version):
    path = str(FIXTURES / f"v{version}.npz")
    with np.load(path) as z:
        stakes = z["fixture.stakes"].astype(np.int64)
    jp = je.EngineParams(num_nodes=16, warm_up_rounds=0)
    tp = PortParams(num_nodes=16, warm_up_rounds=0)
    jt = je.make_cluster_tables(stakes)
    ptab = tc.make_cluster_tables(stakes, device="cpu")
    js, jstored, jmeta = ref_ckpt.restore_sim_state(path, jp, jt)
    ts, tstored, tmeta = ckpt.restore_sim_state(path, tp, ptab, device="cpu")
    assert tstored == jstored
    assert tmeta == jmeta
    _assert_arrays_equal(_np_state(js), _np_state(ts), f"v{version}")
    it = int(jmeta.get("iteration", 3))
    js, jrows = je.run_rounds(jp, jt, jnp.arange(1, dtype=jnp.int32), js,
                              2, start_it=it, detail=True)
    ts, trows = tc.run_rounds(tp, ptab, torch.arange(1, dtype=torch.int32),
                              ts, 2, start_it=it, detail=True)
    _assert_arrays_equal(_np_state(js), _np_state(ts), f"v{version} +2")
    _assert_arrays_equal(_np_rows(jrows), _np_rows(trows), f"v{version}")


# --------------------------------------------------------------------------
# (c) traffic files
# --------------------------------------------------------------------------

TRAFFIC_KW = {
    "push": dict(traffic_values=4, traffic_rate=1, node_ingress_cap=4,
                 warm_up_rounds=0, packet_loss_rate=0.05, impair_seed=2),
    "adaptive": dict(traffic_values=4, traffic_rate=2, node_ingress_cap=6,
                     warm_up_rounds=0, gossip_mode="adaptive",
                     adaptive_switch_threshold=0.3, impair_seed=2),
}


@pytest.mark.parametrize("mode", list(TRAFFIC_KW))
def test_traffic_files_cross_both_ways(pinned, tmp_path, mode):
    n, rounds = 48, 3
    stakes = _stakes(n, 5)
    jp = je.EngineParams(num_nodes=n, **TRAFFIC_KW[mode]).validate()
    tp = PortParams(num_nodes=n, **TRAFFIC_KW[mode]).validate()
    jt, jtt = je.make_cluster_tables(stakes), \
        ref_traffic.device_traffic_tables(stakes)
    ptab = tc.make_cluster_tables(stakes, device="cpu")
    ptt = tt.device_traffic_tables(stakes, "cpu")
    js = ref_traffic.init_traffic_state(stakes, jp, seed=3)
    js, _ = ref_traffic.run_traffic_rounds(jp, jt, jtt, js, rounds)
    ts = tt.init_traffic_state(stakes, tp, 3, "cpu")
    ts, trows = tt.run_traffic_rounds(tp, ptab, ptt, ts, rounds)
    _assert_arrays_equal(_np_state(js), _np_state(ts), mode)
    stats = TrafficStats()
    cli._feed_traffic_rows(stats, None, 0, "0", _np_rows(trows), 0, rounds,
                           n)
    stats.feed_final(cli._traffic_final_from_state(ts))
    ref_path, port_path = str(tmp_path / "r.npz"), str(tmp_path / "p.npz")
    ref_ckpt.save_traffic_state(ref_path, js, jp, iteration=rounds,
                                traffic_stats=stats.state_dict())
    ckpt.save_traffic_state(port_path, ts, tp, iteration=rounds,
                            traffic_stats=stats.state_dict())
    want = stats.parity_snapshot()
    # the reference restores the port's file, the port the reference's
    jr, _, jm = ref_ckpt.restore_traffic_state(port_path, jp)
    pr, _, pm = ckpt.restore_traffic_state(ref_path, tp, device="cpu")
    for meta in (jm, pm):
        assert meta["kind"] == "traffic" and meta["iteration"] == rounds
    ref_stats, port_stats = RefTrafficStats(), TrafficStats()
    ref_stats.load_state_dict(jm["traffic_stats"])
    port_stats.load_state_dict(pm["traffic_stats"])
    assert ref_stats.parity_snapshot() == want
    assert port_stats.parity_snapshot() == want
    # each continued 3 rounds, against the reference's own continuation
    cont = {}
    for who, st in (("ref own", js), ("ref from port", jr)):
        st, rows = ref_traffic.run_traffic_rounds(jp, jt, jtt, st, rounds,
                                                  start_it=rounds)
        cont[who] = (_np_state(st), _np_rows(rows))
    st, rows = tt.run_traffic_rounds(tp, ptab, ptt, pr, rounds,
                                     start_it=rounds)
    cont["port from ref"] = (_np_state(st), _np_rows(rows))
    for who in ("ref from port", "port from ref"):
        _assert_arrays_equal(cont["ref own"][0], cont[who][0], who)
        _assert_arrays_equal(cont["ref own"][1], cont[who][1], who)


# --------------------------------------------------------------------------
# (d) refusals
# --------------------------------------------------------------------------

def _message(fn, *args, **kw) -> str:
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


def test_refusals_in_the_references_words(tmp_path):
    n = 16
    stakes = _stakes(n, 1)
    prm = PortParams(num_nodes=n, warm_up_rounds=0)
    st = tc.init_state(rng.prng_key(1), tc.make_cluster_tables(
        stakes, device="cpu"), torch.arange(1, dtype=torch.int32), prm)
    sim = str(tmp_path / "sim.npz")
    ckpt.save_state(sim, st, prm, iteration=1)
    tprm = PortParams(num_nodes=n, traffic_values=3,
                      warm_up_rounds=0).validate()
    traffic = str(tmp_path / "traffic.npz")
    ckpt.save_traffic_state(traffic, tt.init_traffic_state(
        stakes, tprm, 3, "cpu"), tprm, iteration=0)
    jprm = je.EngineParams(num_nodes=n)
    # the wrong kind, both ways
    want = _message(ref_ckpt.restore_sim_state, traffic, jprm)
    assert "'traffic'-kind state" in want
    assert _message(ckpt.restore_sim_state, traffic, prm,
                    device="cpu") == want
    want = _message(ref_ckpt.restore_traffic_state, sim)
    assert "'sim'-kind state" in want
    assert _message(ckpt.restore_traffic_state, sim, device="cpu") == want
    # a shape mismatch
    want = _message(ref_ckpt.restore_sim_state, sim,
                    jprm._replace(num_nodes=n + 1))
    assert want == f"checkpoint num_nodes={n} != current {n + 1}"
    assert _message(ckpt.restore_sim_state, sim,
                    prm._replace(num_nodes=n + 1), device="cpu") == want
    # an unreadable version
    with np.load(sim) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays.pop("__meta__")).decode())
    meta["format_version"] = 99
    bad = str(tmp_path / "v99.npz")
    np.savez_compressed(bad, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    want = _message(ref_ckpt.load_state, bad)
    assert want == "unsupported checkpoint version 99"
    assert _message(ckpt.load_state, bad) == want


# --------------------------------------------------------------------------
# (e) the single-origin CLI
# --------------------------------------------------------------------------

CLI_BASE = ["--num-synthetic-nodes", "100", "--warm-up-rounds", "10",
            "--seed", "5", "--test-type", "fail-nodes", "--when-to-fail",
            "12", "--fraction-to-fail", "0.1", "--churn-fail-rate", "0.02",
            "--churn-recover-rate", "0.3", "--packet-loss-rate", "0.05"]


def _ref_main(argv):
    ref_reset()
    assert ref_cli.main(CLI_BASE + argv + ["--backend", "tpu"]) == 0


def _port_main(argv):
    reset_unique_pubkeys()
    assert cli.main(CLI_BASE + argv + ["--device", "cpu"]) == 0


def _npz(path):
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        return meta, {k: z[k] for k in z.files if k != "__meta__"}


def test_cli_files_cross_and_resume_to_the_straight_run(pinned, tmp_path,
                                                        monkeypatch):
    # measured blocks of 10 in both packages: one compile of the
    # reference's measured scan serves every run
    monkeypatch.setattr(ref_cli, "HARVEST_BLOCK", 10)
    monkeypatch.setattr(cli, "HARVEST_BLOCK", 10)
    p = lambda name: str(tmp_path / name)
    _ref_main(["--iterations", "30", "--checkpoint-path", p("r30.npz")])
    _ref_main(["--iterations", "20", "--checkpoint-path", p("r20.npz")])
    _port_main(["--iterations", "20", "--checkpoint-path", p("p20.npz")])
    ref_meta, ref_arrays = _npz(p("r20.npz"))
    port_meta, port_arrays = _npz(p("p20.npz"))
    # the same meta, key for key, but the config block (each package's own
    # Config fields)
    ref_meta.pop("config")
    port_cfg = port_meta.pop("config")
    assert port_meta == ref_meta
    assert port_meta["iteration"] == 20
    assert port_cfg["device"] == "cpu" and port_cfg["when_to_fail"] == 12
    _assert_arrays_equal(ref_arrays, port_arrays, "20 rounds")
    # each package resumes the other's file to the straight run's state
    _ref_main(["--iterations", "30", "--resume", p("p20.npz"),
               "--checkpoint-path", p("ref_from_port.npz")])
    _port_main(["--iterations", "30", "--resume", p("r20.npz"),
                "--checkpoint-path", p("port_from_ref.npz")])
    _, want = _npz(p("r30.npz"))
    for name in ("ref_from_port.npz", "port_from_ref.npz"):
        meta, got = _npz(p(name))
        assert meta["iteration"] == 30
        _assert_arrays_equal(want, got, name)
