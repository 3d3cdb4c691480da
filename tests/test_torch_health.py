"""The node-health planes and digest (ROADMAP A12, B14) against the
reference package's.

* ``SimState``'s health planes (and every other field and row) with
  ``health=True`` equal the reference's after the rounds of push dense and
  sparse, push-pull and adaptive, each under loss + churn + partition with
  prunes firing; 3 push lanes with differing knobs (``run_rounds_lanes``)
  and ``run_rounds_lanes_dyn`` at differing start iterations;
* ``TrafficState``'s four planes in push and adaptive traffic (prunes and
  rescues firing) and on 2 traffic lanes;
* the gate off: the planes stay zero and every other field and row equals
  the gated-on run's, with no ``health_round`` call;
* ``health_round_plain``'s row skip: a round's pairs come only from rows
  whose ``n_pruned`` is above 0 (the kernel's phase 2 reads nothing else);
* ``digest_stack`` (the plain path) against the reference's
  ``digest_stack_np`` and its JAX ``digest_stack`` on the CPU, with ties,
  a k above N and i64-range values; the kernel's counting schedule
  (``csrc/health_digest.cu``: per entry the entries below, equal and equal
  at a lower id, in tiles) transcribed in numpy against the plain version.

Each reference case runs once (cached) and is shared across its asserts.
Tolerance: 0 (exact equality of every array)."""

import gossip_sim_tpu.engine as je  # noqa: I001  (64-bit types first)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_sim_tpu.engine import lanes as jlanes
from gossip_sim_tpu.engine import traffic as jtraffic
from gossip_sim_tpu.obs import health as ref_health
from gossip_sim_tpu_torch import kernels, rng
from gossip_sim_tpu_torch.convert import (state_from_numpy, state_to_numpy,
                                          traffic_state_to_numpy)
from gossip_sim_tpu_torch.engine import core as tc
from gossip_sim_tpu_torch.engine import merge_lane_statics
from gossip_sim_tpu_torch.engine import lanes as tl
from gossip_sim_tpu_torch.engine import traffic as tt
from gossip_sim_tpu_torch.engine.params import EngineParams as PortParams
from gossip_sim_tpu_torch.obs import health

N, ORIGINS, ROUNDS = 120, (0, 37), 16
IMPAIRED = dict(packet_loss_rate=0.1, churn_fail_rate=0.02,
                churn_recover_rate=0.25, partition_at=6, heal_at=12,
                impair_seed=11)
#: sim cases: knobs over warm-up 4 and upsert threshold 6 (rounds 5, 11
#: and 17 fire)
SIM_CASES = {
    "push_dense": dict(IMPAIRED),
    "push_sparse": dict(IMPAIRED, representation="sparse"),
    "push_pull": dict(IMPAIRED, gossip_mode="push-pull"),
    "adaptive": dict(IMPAIRED, gossip_mode="adaptive",
                     adaptive_switch_threshold=0.5),
}
SIM_BASE = dict(warm_up_rounds=4, min_num_upserts=6, health=True)
#: traffic cases (N_T nodes, V_T values, 14 rounds)
N_T, V_T, T_ROUNDS = 100, 8, 14
TRAFFIC_BASE = dict(num_nodes=N_T, traffic_values=V_T, traffic_rate=2,
                    warm_up_rounds=3, probability_of_rotation=0.2,
                    impair_seed=7, min_num_upserts=4, health=True)
TRAFFIC_CASES = {
    "push": dict(packet_loss_rate=0.1, churn_fail_rate=0.02,
                 churn_recover_rate=0.3, node_ingress_cap=6,
                 node_egress_cap=9),
    "adaptive": dict(gossip_mode="adaptive", adaptive_switch_threshold=0.3,
                     node_ingress_cap=12, node_egress_cap=16),
}


@pytest.fixture(autouse=True)
def pinned():
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


def _stakes(n=N, seed=0):
    return np.random.default_rng(seed).integers(1, 1 << 45,
                                                n).astype(np.int64)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_fields_equal(got, want, what, skip=()):
    for f in want._fields:
        if f in skip:
            continue
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        assert np.array_equal(a, b), (what, f)


def assert_rows_equal(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), (what, k)


def _health_calls(fn):
    """``fn()`` with the port's ``health_round`` calls recorded."""
    calls = []
    real = kernels.health_round

    def rec(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    kernels.health_round = rec
    try:
        return fn(), calls
    finally:
        kernels.health_round = real


@functools.lru_cache(maxsize=None)
def _sim_case(case):
    """The reference's and the port's run of a sim case (health on), and
    the port's with the gate off, from one initial state."""
    kw = dict(SIM_BASE, **SIM_CASES[case])
    stakes = _stakes()
    o = np.asarray(ORIGINS, np.int32)
    jp = je.EngineParams(num_nodes=N, **kw)
    jt = je.make_cluster_tables(stakes)
    js0 = je.init_state(jax.random.PRNGKey(5), jt, jnp.asarray(o), jp)
    # the reference's run_rounds donates its input state
    ts0 = state_from_numpy(_np(js0), device="cpu")
    js, jrows = je.run_rounds(jp, jt, jnp.asarray(o), js0, ROUNDS,
                              detail=True)
    tables = tc.make_cluster_tables(stakes, device="cpu")
    org = torch.as_tensor(o)
    (on, calls) = _health_calls(lambda: tc.run_rounds(
        PortParams(num_nodes=N, **kw), tables, org, ts0, ROUNDS,
        detail=True))
    off, off_calls = _health_calls(lambda: tc.run_rounds(
        PortParams(num_nodes=N, **dict(kw, health=False)), tables, org,
        ts0, ROUNDS, detail=True))
    assert not off_calls
    return (_np(js), _np(jrows)), on, off, calls


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_sim_health_planes_equal_reference(case):
    (js, jrows), (ts, trows), (off, off_rows), calls = _sim_case(case)
    got = state_to_numpy(ts)
    assert_fields_equal(got, js, case)
    assert_rows_equal({k: v.numpy() for k, v in trows.items()}, jrows, case)
    assert len(calls) == ROUNDS
    assert int(js.health_prune_recv.sum()) > 0
    assert int((js.health_first_round > 0).sum()) > 0
    if case in ("push_pull", "adaptive"):
        assert int(js.pull_rescued_acc.sum()) > 0
    # the gate off: zero planes, every other field and row unchanged
    off_np = state_to_numpy(off)
    for f in ("health_prune_recv", "health_first_round"):
        assert not getattr(off_np, f).any(), f
    assert_fields_equal(off_np, got, case + " off",
                        skip=("health_prune_recv", "health_first_round"))
    assert_rows_equal({k: v.numpy() for k, v in off_rows.items()},
                      {k: v.numpy() for k, v in trows.items()}, case + " off")


def test_health_round_reads_only_firing_rows():
    """The pairs of a round come only from the rows whose ``n_pruned`` is
    above 0: dropping every other row's slots changes no plane (the
    kernel's phase 2 skips them), and ``n_pruned`` counts each row's
    pruned slots."""
    _, _, _, calls = _sim_case("push_dense")
    fired = 0
    for args in calls:
        prune, first, n_pruned, src, slot, reached, its, gates = args
        assert torch.equal(slot.sum(-1, dtype=torch.int32), n_pruned)
        live = slot & (n_pruned > 0)[..., None]
        fired += int(live.any())
        want = kernels.health_round_plain(*args)
        got = kernels.health_round_plain(prune, first, n_pruned,
                                         torch.where(live, src, -1), live,
                                         reached, its, gates)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert 0 < fired < len(calls)


LANES = ({"packet_loss_rate": 0.0}, {"packet_loss_rate": 0.2,
                                     "warm_up_rounds": 9},
         {"min_ingress_nodes": 3, "prune_stake_threshold": 0.3,
          "probability_of_rotation": 0.3})


@functools.lru_cache(maxsize=None)
def _lane_case(dyn):
    base = dict(SIM_BASE)
    rps = [je.EngineParams(num_nodes=N, **dict(base, **kw)) for kw in LANES]
    pps = [PortParams(num_nodes=N, **dict(base, **kw)) for kw in LANES]
    r_static = je.merge_lane_statics([p.static_part() for p in rps])
    p_static = merge_lane_statics([p.static_part() for p in pps])
    stakes = _stakes()
    jt = je.make_cluster_tables(stakes)
    tables = tc.make_cluster_tables(stakes, device="cpu")
    o = jnp.asarray(ORIGINS, jnp.int32)
    st0 = je.init_state(jax.random.PRNGKey(3), jt, o, rps[0])
    pst0 = state_from_numpy(_np(st0), device="cpu")
    rk = je.stack_knobs([p.knob_values() for p in rps])
    pk = tl.stack_knobs([p.knob_values() for p in pps])
    if dyn:
        origins = [[0, 37], [5, 9], [77, 1]]
        its0 = [0, 7, 3]
        r_states, r_rows = jlanes.run_rounds_lanes_dyn(
            r_static, jt, jlanes.stack_origins(origins),
            je.broadcast_state(st0, 3), rk, ROUNDS, its0, detail=True)
        states, rows = tl.run_rounds_lanes_dyn(
            p_static, tables, tl.stack_origins(origins),
            tl.broadcast_state(pst0, 3), pk, ROUNDS, its0, detail=True)
    else:
        r_states, r_rows = je.run_rounds_lanes(
            r_static, jt, o, je.broadcast_state(st0, 3), rk, ROUNDS,
            detail=True)
        states, rows = tl.run_rounds_lanes(
            p_static, tables, torch.as_tensor(ORIGINS, dtype=torch.int32),
            tl.broadcast_state(pst0, 3), pk, ROUNDS, detail=True)
    return (_np(r_states), _np(r_rows)), (states, rows)


@pytest.mark.parametrize("dyn", [False, True], ids=["lanes", "dyn_lanes"])
def test_lane_health_planes_equal_reference(dyn):
    (r_states, r_rows), (states, rows) = _lane_case(dyn)
    assert_fields_equal(state_to_numpy(states), r_states, "lanes")
    assert_rows_equal({k: v.numpy() for k, v in rows.items()}, r_rows,
                      "lanes")
    prune = r_states.health_prune_recv.sum(axis=(1, 2))
    assert (prune > 0).all() and len(set(prune.tolist())) == 3


@functools.lru_cache(maxsize=None)
def _traffic_case(case):
    kw = dict(TRAFFIC_BASE, **TRAFFIC_CASES[case])
    stakes = _stakes(N_T, 3)
    jp = je.EngineParams(**kw)
    js = jtraffic.init_traffic_state(stakes, jp, 5)
    js, jrows = jtraffic.run_traffic_rounds(
        jp, je.make_cluster_tables(stakes),
        jtraffic.device_traffic_tables(stakes), js, T_ROUNDS)
    tables = tc.make_cluster_tables(stakes, device="cpu")
    ttables = tt.device_traffic_tables(stakes, device="cpu")
    runs = []
    for gate in (True, False):
        pp = PortParams(**dict(kw, health=gate))
        ps = tt.init_traffic_state(stakes, pp, 5, device="cpu")
        runs.append(tt.run_traffic_rounds(pp, tables, ttables, ps,
                                          T_ROUNDS))
    return (_np(js), _np(jrows)), runs[0], runs[1]


@pytest.mark.parametrize("case", list(TRAFFIC_CASES))
def test_traffic_health_planes_equal_reference(case):
    (js, jrows), (ts, trows), (off, off_rows) = _traffic_case(case)
    got = traffic_state_to_numpy(ts)
    assert_fields_equal(got, js, case)
    assert_rows_equal({k: v.numpy() for k, v in trows.items()}, jrows, case)
    assert int(js.health_del_acc.sum()) > 0
    assert int(js.health_lat_acc.sum()) > int(js.health_del_acc.sum())
    if case == "push":
        assert int(js.health_prune_recv.sum()) > 0
    else:
        assert int(js.health_rescued_acc.sum()) > 0
    planes = ("health_prune_recv", "health_lat_acc", "health_del_acc",
              "health_rescued_acc")
    off_np = traffic_state_to_numpy(off)
    for f in planes:
        assert not getattr(off_np, f).any(), f
    assert_fields_equal(off_np, got, case + " off", skip=planes)
    assert_rows_equal({k: v.numpy() for k, v in off_rows.items()},
                      {k: v.numpy() for k, v in trows.items()}, case + " off")


def test_traffic_lane_health_planes_equal_reference():
    """Two push traffic lanes with their own loss, caps and warm-up."""
    lanes = (dict(TRAFFIC_CASES["push"]),
             dict(TRAFFIC_CASES["push"], packet_loss_rate=0.2,
                  node_ingress_cap=4, warm_up_rounds=8))
    rps = [je.EngineParams(**dict(TRAFFIC_BASE, **kw)) for kw in lanes]
    pps = [PortParams(**dict(TRAFFIC_BASE, **kw)) for kw in lanes]
    stakes = _stakes(N_T, 3)
    js = jtraffic.broadcast_traffic_state(
        jtraffic.init_traffic_state(stakes, rps[0], 5), 2)
    r_states, _ = jtraffic.run_traffic_lanes(
        je.merge_lane_statics([p.static_part() for p in rps]),
        je.make_cluster_tables(stakes),
        jtraffic.device_traffic_tables(stakes), js,
        je.stack_knobs([p.knob_values() for p in rps]), T_ROUNDS)
    ps = tt.broadcast_traffic_state(
        tt.init_traffic_state(stakes, pps[0], 5, device="cpu"), 2)
    states, _ = tt.run_traffic_lanes(
        merge_lane_statics([p.static_part() for p in pps]),
        tc.make_cluster_tables(stakes, device="cpu"),
        tt.device_traffic_tables(stakes, device="cpu"), ps,
        tl.stack_knobs([p.knob_values() for p in pps]), T_ROUNDS)
    r_states = _np(r_states)
    assert_fields_equal(traffic_state_to_numpy(states), r_states,
                        "traffic lanes")
    prune = r_states.health_prune_recv.sum(-1)
    assert (prune > 0).all() and prune[0] != prune[1]


# ---- the digest -----------------------------------------------------------

def _digest_inputs(seed, p, n, lo, hi):
    r = np.random.default_rng(seed)
    stack = r.integers(lo, hi, (p, n), dtype=np.int64)
    dec = ref_health.stake_decile_ids(r.integers(1, 1 << 40, n))
    return stack, dec


#: (P, N, k, low, high): ties everywhere, a k above N, i64-range values
#: (negative too), the sim and traffic widths
DIGEST_CASES = {
    "ties": (8, 300, 10, 0, 4),
    "k_above_n": (9, 40, 60, 0, 1000),
    "i64_range": (3, 257, 12, -(1 << 40), 1 << 40),
    "one_node": (2, 1, 10, 0, 9),
    "sim_width": (8, 1000, 10, 0, 300),
}


def _assert_digest_equal(got, want, what):
    assert set(got) == set(want), what
    for key in want:
        assert got[key].dtype == want[key].dtype, (what, key)
        assert np.array_equal(got[key], want[key]), (what, key)


@pytest.mark.parametrize("case", list(DIGEST_CASES))
def test_digest_stack_equals_reference(case):
    p, n, k, lo, hi = DIGEST_CASES[case]
    stack, dec = _digest_inputs(len(case), p, n, lo, hi)
    want = ref_health.digest_stack_np(stack, dec, min(k, n))
    _assert_digest_equal(
        ref_health.digest_stack(jnp.asarray(stack), jnp.asarray(dec), k),
        want, case + " (reference jax)")
    got = health.digest_stack(torch.as_tensor(stack), torch.as_tensor(dec),
                              k)
    _assert_digest_equal(got, want, case)
    _assert_digest_equal(health.digest_stack_np(stack, dec, min(k, n)),
                         want, case + " (numpy twin)")
    if hi <= 1 << 31 and lo >= -(1 << 31):
        _assert_digest_equal(
            health.digest_stack(torch.as_tensor(stack, dtype=torch.int32),
                                torch.as_tensor(dec), k), want,
            case + " int32")
    if case == "ties":
        assert (want["top_val"][:, 0] == want["top_val"][:, -1]).all()


def kernel_schedule(stack, dec, k, tile=2048):
    """csrc/health_digest.cu in numpy: per entry the row's entries below
    (L), equal (E) and equal at a lower id (B), counted tile by tile; the
    Gini numerator sum x (L - G), G = n - L - E; the entry's place G + B
    in the descending order, ties toward the lower id; 64-bit sums that
    wrap."""
    stack = np.asarray(stack, np.int64)
    p, n = stack.shape
    acc = np.zeros((p, 12), np.uint64)
    top_idx = np.full((p, k), -1, np.int32)
    top_val = np.zeros((p, k), np.int64)
    ids = np.arange(n)
    for r in range(p):
        x = stack[r]
        lt = np.zeros(n, np.int64)
        eq = np.zeros(n, np.int64)
        before = np.zeros(n, np.int64)
        for t0 in range(0, n, tile):
            y, yid = x[t0:t0 + tile], ids[t0:t0 + tile]
            lt += (y[None, :] < x[:, None]).sum(1)
            same = y[None, :] == x[:, None]
            eq += same.sum(1)
            before += (same & (yid[None, :] < ids[:, None])).sum(1)
        gt = n - lt - eq
        with np.errstate(over="ignore"):
            acc[r, 10] = np.sum(x.astype(np.uint64)
                                * (lt - gt).astype(np.uint64))
            acc[r, 11] = np.sum(np.uint64(n) * x.astype(np.uint64))
            np.add.at(acc[r], dec, x.astype(np.uint64))
        place = gt + before
        hit = place < k
        top_idx[r, place[hit]] = ids[hit]
        top_val[r, place[hit]] = x[hit]
    acc = acc.view(np.int64)
    return {"deciles": acc[:, :10], "top_idx": top_idx, "top_val": top_val,
            "gini_num": acc[:, 10], "gini_den": acc[:, 11]}


@pytest.mark.parametrize("case", list(DIGEST_CASES))
def test_digest_kernel_schedule_equals_plain(case):
    p, n, k, lo, hi = DIGEST_CASES[case]
    stack, dec = _digest_inputs(len(case), p, n, lo, hi)
    k = min(k, n)
    got = kernel_schedule(stack, dec, k, tile=64)
    want = kernels.health_digest_plain(torch.as_tensor(stack),
                                       torch.as_tensor(dec), k)
    _assert_digest_equal(got, {f: getattr(want, f).numpy()
                               for f in want._fields}, case)
