"""Traffic lanes (engine/traffic.py ``run_traffic_lanes``) against the
reference package's.

* ``run_traffic_lanes`` equals the reference's on the CPU, every
  ``TrafficState`` field of every lane and every row of every round, in
  both threefry layouts: three push lanes (loss 0, 0.1 and 0.2, different
  ingress and egress caps, churn in one lane, a partition in another, rates
  2, 3 and 5) and two adaptive lanes (switch thresholds 0.5 and 0.9, one
  capped);
* each lane equals the port's serial ``run_traffic_rounds`` with its knobs;
* each traffic kernel's lane call in those runs (the plain versions here)
  equals its one-lane calls, lane by lane;
* lane states cross ``convert`` both ways unchanged;
* more than 64 lanes run in groups of at most 64, traffic and push lanes
  alike, each lane equal to its serial run.

N = 200 nodes, M = 8 value slots, 16 rounds.  Each reference case runs once
a module and layout (most of its time is JAX compiling the lane scan).
Tolerance: 0 (exact equality)."""

import gossip_sim_tpu.engine as je  # noqa: I001  (64-bit types first)
import functools

import jax
import numpy as np
import pytest
import torch

from gossip_sim_tpu.engine import traffic as jtraffic
from gossip_sim_tpu.engine.lanes import stack_knobs as ref_stack
from gossip_sim_tpu_torch import kernels, rng
from gossip_sim_tpu_torch.convert import (traffic_state_from_numpy,
                                          traffic_state_to_numpy)
from gossip_sim_tpu_torch.engine import (EngineParams, broadcast_state,
                                         init_state, lane_state,
                                         make_cluster_tables,
                                         merge_lane_statics, run_rounds,
                                         run_rounds_lanes, stack_knobs)
from gossip_sim_tpu_torch.engine import traffic as tt
from gossip_sim_tpu_torch.kernels import _lanes

N, M, ROUNDS = 200, 8, 16
BASE = dict(num_nodes=N, traffic_values=M, warm_up_rounds=3,
            probability_of_rotation=0.2, impair_seed=7, min_num_upserts=6)
#: case -> the lanes' knobs beyond BASE
CASES = {
    "push": [
        dict(traffic_rate=2, node_ingress_cap=6, node_egress_cap=9),
        dict(traffic_rate=3, packet_loss_rate=0.1, node_ingress_cap=3,
             churn_fail_rate=0.02, churn_recover_rate=0.3),
        dict(traffic_rate=5, packet_loss_rate=0.2, node_egress_cap=4,
             partition_at=4, heal_at=12, impair_seed=11),
    ],
    "adaptive": [
        dict(traffic_rate=2, gossip_mode="adaptive",
             adaptive_switch_threshold=0.5),
        dict(traffic_rate=2, gossip_mode="adaptive",
             adaptive_switch_threshold=0.9, node_ingress_cap=10,
             node_egress_cap=12),
    ],
}
#: the kernels a lane round calls, and the one only adaptive lanes call
LANE_KERNELS = ("traffic_send", "traffic_admit", "rank_inbound",
                "rc_merge_prune", "prune_apply")


def _pinned(flag: bool):
    """Both packages in one threefry layout; the port on one CPU thread."""
    old = jax.config.jax_threefry_partitionable
    old_port = rng.partitionable()
    threads = torch.get_num_threads()
    jax.config.update("jax_threefry_partitionable", flag)
    rng.set_partitionable(flag)
    torch.set_num_threads(1)
    yield flag
    jax.config.update("jax_threefry_partitionable", old)
    rng.set_partitionable(old_port)
    torch.set_num_threads(threads)


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def layout(request):
    yield from _pinned(request.param)


@pytest.fixture
def partitionable():
    yield from _pinned(True)


def _stakes(n=N, seed=3):
    r = np.random.default_rng(seed)
    return r.choice(np.arange(1, 50 * n), size=n,
                    replace=False).astype(np.int64) * 10**6


def _params(case):
    return [EngineParams(**{**BASE, **kw}) for kw in CASES[case]]


@functools.lru_cache(maxsize=None)
def _reference(case, flag):
    """The reference's lane run of ``case`` (numpy states and rows), once
    per case and layout."""
    rps = [je.EngineParams(**{**BASE, **kw}) for kw in CASES[case]]
    static = je.merge_lane_statics([p.static_part() for p in rps])
    stakes = _stakes()
    st0 = jtraffic.init_traffic_state(stakes, rps[0], 5)
    states, rows = jtraffic.run_traffic_lanes(
        static, je.make_cluster_tables(stakes),
        jtraffic.device_traffic_tables(stakes),
        jtraffic.broadcast_traffic_state(st0, len(rps)),
        ref_stack([p.knob_values() for p in rps]), ROUNDS, detail=True)
    return (jax.tree_util.tree_map(np.asarray, states),
            {k: np.asarray(v) for k, v in rows.items()})


def _port_setup(case):
    pps = _params(case)
    static = merge_lane_statics([p.static_part() for p in pps])
    stakes = _stakes()
    tables = make_cluster_tables(stakes, device="cpu")
    ttables = tt.device_traffic_tables(stakes, device="cpu")
    st0 = tt.init_traffic_state(stakes, pps[0], 5, device="cpu")
    return pps, static, tables, ttables, st0


@functools.lru_cache(maxsize=None)
def _port(case):
    """The port's lane run of ``case`` with every traffic kernel's calls
    recorded: (states, rows, calls)."""
    pps, static, tables, ttables, st0 = _port_setup(case)
    names = LANE_KERNELS + (("traffic_rescue",) if case == "adaptive"
                            else ())
    calls = {name: [] for name in names}
    real = {name: getattr(kernels, name) for name in names}

    def recorder(name):
        def rec(*args, **kw):
            calls[name].append((args, kw))
            return real[name](*args, **kw)
        return rec

    for name in names:
        setattr(kernels, name, recorder(name))
    try:
        states, rows = tt.run_traffic_lanes(
            static, tables, ttables,
            tt.broadcast_traffic_state(st0, len(pps)),
            stack_knobs([p.knob_values() for p in pps]), ROUNDS,
            detail=True)
    finally:
        for name in names:
            setattr(kernels, name, real[name])
    return states, rows, calls


def assert_state_equal(got, want, what):
    for f in want._fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.shape == b.shape and a.dtype == b.dtype, (what, f)
        assert np.array_equal(a, b), (what, f)


def assert_rows_equal(got: dict, want: dict, what):
    assert set(got) == set(want), what
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (what, k)
        assert np.array_equal(a, b), (what, k)


@pytest.mark.parametrize("case", list(CASES))
def test_lanes_equal_the_reference(layout, case):
    """Every state field of every lane and every row, tolerance 0."""
    want_states, want_rows = _reference(case, layout)
    states, rows, _ = _port(case)
    assert_state_equal(traffic_state_to_numpy(states), want_states, case)
    assert_rows_equal({k: v.numpy() for k, v in rows.items()}, want_rows,
                      case)
    k = len(CASES[case])
    assert rows["delivered"].shape == (ROUNDS, k)
    assert int(rows["delivered"].sum()) > 0
    if case == "push":
        per_lane = lambda name: rows[name].sum(0).tolist()
        assert per_lane("dropped")[0] == 0 < per_lane("dropped")[2]
        assert per_lane("suppressed")[2] > 0 == per_lane("suppressed")[0]
        assert per_lane("queue_dropped")[1] > 0
        assert per_lane("deferred")[2] > 0
        assert int(states.failed[1].sum()) > 0 == int(states.failed[0].sum())
    else:
        assert int(rows["switched_to_pull"].sum()) > 0
        assert int(rows["pull_rescued"].sum()) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_each_lane_equals_the_serial_run(partitionable, case):
    """Lane j of the lane run equals the port's serial run under lane j's
    parameters: its final state and every row."""
    states, rows, _ = _port(case)
    pps, _, tables, ttables, st0 = _port_setup(case)
    for j, p in enumerate(pps):
        s1, r1 = tt.run_traffic_rounds(p, tables, ttables, st0, ROUNDS,
                                       detail=True)
        assert_state_equal(tt.traffic_lane_state(states, j), s1,
                           f"{case} lane {j}")
        assert_rows_equal({k: v[:, j] for k, v in rows.items()}, r1,
                          f"{case} lane {j}")


@pytest.mark.parametrize("name", LANE_KERNELS + ("traffic_rescue",))
def test_kernel_lane_calls_equal_one_lane_calls(partitionable, name):
    """Each kernel's lane calls in the lane runs (the plain version on the
    CPU) equal, lane by lane, its one-lane calls on that lane's inputs and
    knobs."""
    case = "adaptive" if name == "traffic_rescue" else "push"
    _, _, calls = _port(case)
    assert len(calls[name]) == ROUNDS
    fn = getattr(kernels, name)
    for r in (4, ROUNDS - 1):
        args, kw = calls[name][r]
        got = fn(*args, **kw)
        for j in range(len(CASES[case])):
            a1, k1 = _lanes.one_lane_call(name, args, kw, j, M)
            want = fn(*a1, **k1)
            part = _lanes.lane_part(name, got, j, M)
            for x, y in zip(part if isinstance(part, tuple) else (part,),
                            want if isinstance(want, tuple) else (want,)):
                assert torch.equal(x, y), (name, r, j)


def test_lane_states_cross_convert(partitionable):
    """A [K, ...] lane state crosses convert both ways unchanged, and one
    lane of it is the state of that lane."""
    states, _, _ = _port("push")
    back = traffic_state_from_numpy(traffic_state_to_numpy(states),
                                    device="cpu")
    assert_state_equal(back, states, "convert")
    assert_state_equal(tt.traffic_lane_state(back, 2),
                       tt.traffic_lane_state(states, 2), "lane 2")


#: a batch of more than 64 lanes (a kernel's per-launch records)
WIDE = 66


def test_more_than_64_traffic_lanes_run_in_groups(partitionable):
    """66 traffic lanes (every third with the ingress cap, every fifth
    lossy) run in groups of at most 64; the lanes at both ends of the
    groups equal their serial runs."""
    base = dict(num_nodes=40, traffic_values=3, warm_up_rounds=0,
                min_num_upserts=3, traffic_rate=2,
                probability_of_rotation=0.3)
    pps = [EngineParams(**base, node_ingress_cap=2 if j % 3 == 0 else 0,
                        packet_loss_rate=0.1 if j % 5 == 0 else 0.0)
           for j in range(WIDE)]
    static = merge_lane_statics([p.static_part() for p in pps])
    stakes = _stakes(40)
    tables = make_cluster_tables(stakes, device="cpu")
    ttables = tt.device_traffic_tables(stakes, device="cpu")
    st0 = tt.init_traffic_state(stakes, pps[0], 5, device="cpu")
    states, rows = tt.run_traffic_lanes(
        static, tables, ttables, tt.broadcast_traffic_state(st0, WIDE),
        stack_knobs([p.knob_values() for p in pps]), 4, detail=True)
    assert rows["delivered"].shape == (4, WIDE)
    for j in (0, 63, 64, 65):
        s1, r1 = tt.run_traffic_rounds(pps[j], tables, ttables, st0, 4,
                                       detail=True)
        assert_state_equal(tt.traffic_lane_state(states, j), s1, f"lane {j}")
        assert_rows_equal({k: v[:, j] for k, v in rows.items()}, r1,
                          f"lane {j}")


def test_more_than_64_push_lanes_run_in_groups(partitionable):
    """``run_rounds_lanes`` takes 66 lanes (in groups of at most 64); the
    lanes at both ends of the groups equal their serial runs."""
    base = dict(num_nodes=48, warm_up_rounds=0)
    pps = [EngineParams(**base, packet_loss_rate=0.01 * (j % 7))
           for j in range(WIDE)]
    static = merge_lane_statics([p.static_part() for p in pps])
    tables = make_cluster_tables(_stakes(48), device="cpu")
    org = torch.tensor([0, 5], dtype=torch.int32)
    st0 = init_state(rng.prng_key(3, "cpu"), tables, org, pps[0])
    states, rows = run_rounds_lanes(static, tables, org,
                                    broadcast_state(st0, WIDE),
                                    stack_knobs([p.knob_values()
                                                 for p in pps]), 3,
                                    detail=True)
    assert rows["coverage"].shape == (3, WIDE, 2)
    for j in (0, 63, 64, 65):
        s1, r1 = run_rounds(pps[j], tables, org, st0, 3, detail=True)
        assert_state_equal(lane_state(states, j), s1, f"lane {j}")
        assert_rows_equal({k: v[:, j] for k, v in rows.items()}, r1,
                          f"lane {j}")
