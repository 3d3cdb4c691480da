"""Sweep lanes (engine/lanes.py) against the reference package's.

* ``merge_lane_statics`` ORs the gates, takes the widest ``pull_slots`` and
  refuses a difference of shape, as the reference's does for the same
  parameter lists;
* a batch of one lane is the port's serial run;
* ``run_rounds_lanes`` equals the reference's on the CPU, rows and final
  states, for the reference's four divergent lanes (clean, heavy loss,
  churn, loss + churn) in both threefry layouts, and for fail-fraction,
  partition-window and knob (min-ingress, prune threshold, rotation)
  lanes, pull-fanout, adaptive-threshold and sparse lanes; each lane also
  equals the port's serial run with its knobs;
* ``run_rounds_lanes_dyn`` equals the reference's with ``[K, O]`` origins
  and per-lane start iterations, in both layouts; ``splice_lane_state``
  leaves the other lanes' bits and rows as they were;
* lane states cross ``convert`` both ways unchanged;
* each of the four kernels' plain versions with per-lane knobs equals its
  one-lane calls, and the per-lane struct refuses what it cannot hold.

N = 96 nodes, 6 rounds.  Tolerance: 0 (exact equality; NaN rows equal
NaN)."""

import gossip_sim_tpu.engine  # noqa: F401  (64-bit types first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_sim_tpu.engine import EngineParams as RefParams
from gossip_sim_tpu.engine import broadcast_state as ref_broadcast
from gossip_sim_tpu.engine import init_state as ref_init
from gossip_sim_tpu.engine import make_cluster_tables as ref_tables
from gossip_sim_tpu.engine import merge_lane_statics as ref_merge
from gossip_sim_tpu.engine import run_rounds_lanes as ref_lanes
from gossip_sim_tpu.engine import stack_knobs as ref_stack
from gossip_sim_tpu.engine.lanes import run_rounds_lanes_dyn as ref_dyn
from gossip_sim_tpu.engine.lanes import stack_origins as ref_origins
from gossip_sim_tpu_torch import kernels, rng
from gossip_sim_tpu_torch.convert import state_from_numpy, state_to_numpy
from gossip_sim_tpu_torch.engine import (EngineParams, broadcast_state,
                                         lane_state, make_cluster_tables,
                                         merge_lane_statics, run_rounds,
                                         run_rounds_lanes,
                                         run_rounds_lanes_dyn,
                                         splice_lane_state, stack_knobs,
                                         stack_origins)
from gossip_sim_tpu_torch.faults import rate_threshold

N = 96
ROUNDS = 6


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


def _stakes(n=N):
    return np.random.default_rng(1).integers(1, 1 << 40, n).astype(np.int64)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_rows_equal(got: dict, want: dict, what=""):
    assert set(got) == set(want), what
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (what, k)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), (what, k)


def assert_states_equal(got, want, what=""):
    for f in want._fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.shape == b.shape and np.array_equal(a, b), (what, f)


def _torch_rows(rows: dict) -> dict:
    return {k: v.numpy() for k, v in rows.items()}


def _both_lanes(lanes, base, origins=(0, 1), rounds=ROUNDS):
    """The reference's and the port's lane runs of ``lanes`` (parameter
    dicts over ``base``) from one initial state: (port static, port knob
    list, port initial state, port tables, port origins, reference
    (states, rows) as numpy, port (states, rows))."""
    rps = [RefParams(num_nodes=N, **base, **kw) for kw in lanes]
    pps = [EngineParams(num_nodes=N, **base, **kw) for kw in lanes]
    r_static = ref_merge([p.static_part() for p in rps])
    static = merge_lane_statics([p.static_part() for p in pps])
    r_org = jnp.asarray(origins, jnp.int32)
    st0 = ref_init(jax.random.PRNGKey(3), ref_tables(_stakes()), r_org,
                   rps[0])
    pst0 = state_from_numpy(_np(st0), device="cpu")
    r_states, r_rows = ref_lanes(r_static, ref_tables(_stakes()), r_org,
                                 ref_broadcast(st0, len(rps)),
                                 ref_stack([p.knob_values() for p in rps]),
                                 rounds, detail=True)
    tables = make_cluster_tables(_stakes(), device="cpu")
    org = torch.as_tensor(origins, dtype=torch.int32)
    knob_list = [p.knob_values() for p in pps]
    states, rows = run_rounds_lanes(static, tables, org,
                                    broadcast_state(pst0, len(pps)),
                                    stack_knobs(knob_list), rounds,
                                    detail=True)
    return (static, knob_list, pst0, tables, org, (_np(r_states),
                                                   _np(r_rows)),
            (states, rows))


def _assert_lanes(lanes, base, serial=True, origins=(0, 1)):
    static, knob_list, pst0, tables, org, (r_states, r_rows), \
        (states, rows) = _both_lanes(lanes, base, origins)
    assert_rows_equal(_torch_rows(rows), r_rows, "rows")
    assert_states_equal(state_to_numpy(states), r_states, "states")
    for k in rows.values():
        assert k.shape[:3] == (ROUNDS, len(lanes), len(origins))
    if serial:
        for j, kn in enumerate(knob_list):
            s1, r1 = run_rounds(static, tables, org, pst0, ROUNDS,
                                detail=True, knobs=kn)
            assert_rows_equal(_torch_rows(r1),
                              {k: v[:, j].numpy() for k, v in rows.items()},
                              f"lane {j} serial")
            assert_states_equal(s1, lane_state(states, j), f"lane {j}")
    return rows


class TestMergeLaneStatics:
    def test_gate_union_and_pull_slots_max_equal_the_reference(self):
        lists = [
            [dict(), dict(packet_loss_rate=0.2), dict(churn_fail_rate=0.1)],
            [dict(fail_at=3, fail_fraction=0.1), dict(partition_at=2)],
            [dict(gossip_mode="push-pull", pull_fanout=f)
             for f in (2, 6, 12)],
        ]
        for kws in lists:
            want = ref_merge([RefParams(num_nodes=32, **kw).static_part()
                              for kw in kws])
            got = merge_lane_statics(
                [EngineParams(num_nodes=32, **kw).static_part()
                 for kw in kws])
            for f in got._fields:
                assert getattr(got, f) == getattr(want, f), (kws, f)
        merged = merge_lane_statics(
            [EngineParams(num_nodes=32, **kw).static_part()
             for kw in lists[0]])
        assert merged.has_loss and merged.has_churn
        assert not merged.has_fail and not merged.has_partition
        assert merge_lane_statics(
            [EngineParams(num_nodes=32, **kw).static_part()
             for kw in lists[2]]).pull_slots == 12

    @pytest.mark.parametrize("field,kw", [
        ("push_fanout", dict(push_fanout=9)),
        ("gossip_mode", dict(gossip_mode="push-pull")),
        ("representation", dict(representation="sparse"))])
    def test_shape_divergence_raises(self, field, kw):
        base = EngineParams(num_nodes=32)
        with pytest.raises(ValueError, match=field):
            merge_lane_statics([base.static_part(),
                                base._replace(**kw).static_part()])
        with pytest.raises(ValueError, match=field):
            ref_merge([RefParams(num_nodes=32).static_part(),
                       RefParams(num_nodes=32, **kw).static_part()])


def test_single_lane_equals_serial(partitionable):
    p = EngineParams(num_nodes=N, warm_up_rounds=0, packet_loss_rate=0.15,
                     impair_seed=5)
    tables = make_cluster_tables(_stakes(), device="cpu")
    org = torch.arange(2, dtype=torch.int32)
    st0 = state_from_numpy(_np(ref_init(
        jax.random.PRNGKey(3), ref_tables(_stakes()),
        jnp.arange(2, dtype=jnp.int32), RefParams(num_nodes=N))), "cpu")
    states, rows = run_rounds_lanes(p.static_part(), tables, org,
                                    broadcast_state(st0, 1),
                                    stack_knobs([p.knob_values()]), ROUNDS,
                                    start_it=4, detail=True)
    s1, r1 = run_rounds(p, tables, org, st0, ROUNDS, start_it=4,
                        detail=True)
    assert_rows_equal(_torch_rows(r1),
                      {k: v[:, 0].numpy() for k, v in rows.items()}, "K=1")
    assert_states_equal(s1, lane_state(states, 0), "K=1")


DIVERGENT = [dict(), dict(packet_loss_rate=0.6),
             dict(churn_fail_rate=0.2, churn_recover_rate=0.05),
             dict(packet_loss_rate=0.3, churn_fail_rate=0.05,
                  churn_recover_rate=0.5)]


def test_divergent_lanes_equal_the_reference_and_serial(layout):
    _assert_lanes(DIVERGENT, dict(warm_up_rounds=2, impair_seed=9),
                  origins=(0,))


LANE_CASES = {
    # fail rounds, partition windows and the three knob kernels' knobs
    "fail_partition_knobs": (dict(warm_up_rounds=1, impair_seed=4), [
        dict(fail_at=2, fail_fraction=0.1, partition_at=1, heal_at=4),
        dict(fail_at=3, fail_fraction=0.3), dict(partition_at=2),
        dict(fail_at=2, fail_fraction=0.5, min_ingress_nodes=4,
             prune_stake_threshold=0.3, probability_of_rotation=0.2)]),
    "pull_fanout": (dict(warm_up_rounds=2, impair_seed=7,
                         gossip_mode="push-pull", packet_loss_rate=0.1), [
        dict(pull_fanout=2), dict(pull_fanout=5, pull_bloom_fp_rate=0.3),
        dict(pull_fanout=8, pull_request_cap=2, partition_at=1),
        dict(pull_fanout=3, pull_interval=2)]),
    "adaptive_threshold": (dict(warm_up_rounds=2, gossip_mode="adaptive"), [
        dict(adaptive_switch_threshold=0.5),
        dict(adaptive_switch_threshold=0.7),
        dict(adaptive_switch_threshold=0.9,
             adaptive_switch_hysteresis=0.1)]),
    "sparse": (dict(warm_up_rounds=2, representation="sparse",
                    impair_seed=3), [
        dict(prune_stake_threshold=0.05),
        dict(prune_stake_threshold=0.4, packet_loss_rate=0.2),
        dict(churn_fail_rate=0.1)]),
}


@pytest.mark.parametrize("case", list(LANE_CASES))
def test_lanes_equal_the_reference_and_serial(partitionable, case):
    base, lanes = LANE_CASES[case]
    rows = _assert_lanes(lanes, base)
    if case == "fail_partition_knobs":
        # the lanes fail different node counts at different rounds
        counts = rows["failed_count"][-1, :, 0].tolist()
        assert len(set(counts)) == len(counts)
        assert int(rows["suppressed"][:, 0].sum()) > 0
    if case == "adaptive_threshold":
        assert "adaptive_pull_active" in rows


def _dyn_lanes():
    base = dict(warm_up_rounds=3, impair_seed=9, churn_fail_rate=0.05,
                churn_recover_rate=0.2, fail_at=4, fail_fraction=0.1,
                packet_loss_rate=0.1, partition_at=2, heal_at=6)
    return [dict(base), dict(base, packet_loss_rate=0.3),
            dict(base, churn_fail_rate=0.0, churn_recover_rate=0.0),
            dict(base, fail_at=7)]


DYN_ORIGINS = [[0, 5], [7, 1], [3, 3], [90, 2]]
DYN_STARTS = [0, 3, 1, 5]


def _dyn_states(rps, tables):
    sts = [ref_init(jax.random.PRNGKey(3 + i), tables,
                    jnp.asarray(o, jnp.int32), rps[i])
           for i, o in enumerate(DYN_ORIGINS)]
    return jax.tree_util.tree_map(lambda *x: jnp.stack(x), *sts)


def test_dyn_lanes_equal_the_reference(layout):
    lanes = _dyn_lanes()
    rps = [RefParams(num_nodes=N, **kw) for kw in lanes]
    pps = [EngineParams(num_nodes=N, **kw) for kw in lanes]
    r_tables = ref_tables(_stakes())
    r_states = _dyn_states(rps, r_tables)
    pstates = state_from_numpy(_np(r_states), device="cpu")
    r_out, r_rows = ref_dyn(ref_merge([p.static_part() for p in rps]),
                            r_tables, ref_origins(DYN_ORIGINS), r_states,
                            ref_stack([p.knob_values() for p in rps]), 5,
                            jnp.asarray(DYN_STARTS, jnp.int32), detail=True)
    states, rows = run_rounds_lanes_dyn(
        merge_lane_statics([p.static_part() for p in pps]),
        make_cluster_tables(_stakes(), device="cpu"),
        stack_origins(DYN_ORIGINS), pstates,
        stack_knobs([p.knob_values() for p in pps]), 5, DYN_STARTS,
        detail=True)
    assert_rows_equal(_torch_rows(rows), _np(r_rows), "dyn rows")
    assert_states_equal(state_to_numpy(states), _np(r_out), "dyn states")


def test_splice_leaves_the_other_lanes_unchanged(partitionable):
    lanes = _dyn_lanes()
    pps = [EngineParams(num_nodes=N, **kw) for kw in lanes]
    static = merge_lane_statics([p.static_part() for p in pps])
    kstack = stack_knobs([p.knob_values() for p in pps])
    r_tables = ref_tables(_stakes())
    states0 = state_from_numpy(_np(_dyn_states(
        [RefParams(num_nodes=N, **kw) for kw in lanes], r_tables)),
        device="cpu")
    tables = make_cluster_tables(_stakes(), device="cpu")
    org = stack_origins(DYN_ORIGINS)
    states, _ = run_rounds_lanes_dyn(static, tables, org, states0, kstack,
                                     3, DYN_STARTS)
    fresh = lane_state(states0, 2)
    spliced = splice_lane_state(states, 2, fresh)
    for j in (0, 1, 3):
        assert_states_equal(lane_state(spliced, j), lane_state(states, j),
                            f"survivor {j}")
    assert_states_equal(lane_state(spliced, 2), fresh, "admitted")
    # the survivors run on as if nothing was admitted
    starts = [s + 3 for s in DYN_STARTS]
    _, rows_a = run_rounds_lanes_dyn(static, tables, org, states, kstack, 3,
                                     starts, detail=True)
    _, rows_b = run_rounds_lanes_dyn(static, tables, org, spliced, kstack,
                                     3, starts, detail=True)
    for j in (0, 1, 3):
        assert_rows_equal({k: v[:, j].numpy() for k, v in rows_b.items()},
                          {k: v[:, j].numpy() for k, v in rows_a.items()},
                          f"survivor {j} rows")


def test_lane_states_cross_convert_both_ways():
    p = RefParams(num_nodes=N, representation="sparse")
    tables = ref_tables(_stakes())
    org = jnp.arange(3, dtype=jnp.int32)
    st = _np(ref_broadcast(ref_init(jax.random.PRNGKey(5), tables, org, p),
                           4))
    port = state_from_numpy(st, device="cpu")
    assert port.key.shape == (4, 3, 2) and port.key.dtype == torch.int64
    assert port.rc_shi.shape == (4, 3, N, 0)
    back = state_to_numpy(port)
    assert_states_equal(back, st, "round trip")
    for f in st._fields:
        assert getattr(back, f).dtype == getattr(st, f).dtype, f


# ---- the four plain versions: per-lane knobs = per-lane scalar calls ----

K, O_LANE, NP = 4, 3, 200


def _slices():
    return [(j, slice(j * O_LANE, (j + 1) * O_LANE)) for j in range(K)]


def _cat_equal(got, ones, what):
    got = [t for t in (got if isinstance(got, tuple) else (got,))
           if t is not None]
    for i, t in enumerate(got):
        want = torch.cat([[x for x in o if x is not None][i] for o in ones])
        assert torch.equal(t, want), (what, i)


def _rows(r):
    active = torch.as_tensor(r.integers(0, NP + 1, (K * O_LANE, NP, 12)),
                             dtype=torch.int32)
    return (active, torch.as_tensor(r.random(active.shape) < 0.2),
            torch.as_tensor(r.random(active.shape) < 0.1),
            torch.as_tensor(r.choice(NP, K * O_LANE), dtype=torch.int32))


def test_push_targets_plain_lanes_equal_one_lane_calls():
    r = np.random.default_rng(0)
    active, pruned, tfail, origins = _rows(r)
    side = torch.as_tensor(r.integers(0, 2, NP + 1), dtype=torch.int32)
    part = [True, False, True, True]
    loss = ([11, 12, 13, 14], [rate_threshold(x) for x in (0, .2, .4, .8)])
    got = kernels.push_targets_plain(active, pruned, tfail, origins, side, 6,
                                     part, loss)
    _cat_equal(got, [kernels.push_targets_plain(
        active[s], pruned[s], tfail[s], origins[s], side, 6, part[j],
        (loss[0][j], loss[1][j])) for j, s in _slices()], "push_targets")
    assert bool(got[1].any()) and bool(got[2].any())


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_rc_merge_prune_plain_lanes_equal_one_lane_calls(sparse):
    from test_torch_kernels_cuda import _merge_inputs
    args = [torch.as_tensor(a) for a in _merge_inputs(5, 16, 4,
                                                      o=K * O_LANE)]
    if sparse:
        args[2] = args[3] = None
    mi, thr = [1, 2, 3, 4], [0.05, 0.15, 0.25, 0.4]
    got = kernels.rc_merge_prune_plain(
        *args, received_cap=50, min_num_upserts=20, min_ingress_nodes=mi,
        prune_stake_threshold=thr)
    rows = args[0].shape[0]
    ones = []
    for j, s in _slices():
        a = [t if t is None or t.shape[0] != rows else t[s] for t in args]
        ones.append(kernels.rc_merge_prune_plain(
            *a, received_cap=50, min_num_upserts=20,
            min_ingress_nodes=mi[j], prune_stake_threshold=thr[j]))
    _cat_equal(tuple(got), [tuple(o) for o in ones], "rc_merge_prune")
    if sparse:
        return
    with pytest.raises(ValueError, match="one lane"):
        kernels.rc_merge_prune_plain(
            *args, received_cap=50, min_num_upserts=20, min_ingress_nodes=mi,
            prune_stake_threshold=0.15,
            live=torch.ones(rows, dtype=torch.bool))


def test_rotate_plain_lanes_equal_one_lane_calls():
    from gossip_sim_tpu_torch.engine.sampler import build_sampler_tables
    r = np.random.default_rng(2)
    active, pruned, tfail, origins = _rows(r)
    buckets = r.integers(0, 25, NP).astype(np.int32)
    sm = build_sampler_tables(buckets, "cpu")
    failed = torch.as_tensor(r.random((K * O_LANE, NP)) < 0.2)
    key = torch.as_tensor(r.integers(0, 1 << 32, (K * O_LANE, 2)))
    its, probs = [5, 9, 9, 2**32 + 1], [0.5, 0.1, 0.9, 0.3]
    tail = (torch.as_tensor(buckets), sm.perm, sm.class_start,
            sm.class_count, sm.class_cdf)
    got = kernels.rotate_plain(active, pruned, tfail, failed, key, its,
                               origins, *tail, probs, 4)
    _cat_equal(got, [kernels.rotate_plain(
        active[s], pruned[s], tfail[s], failed[s], key[s], its[j],
        origins[s], *tail, probs[j], 4) for j, s in _slices()], "rotate")


def test_pull_exchange_plain_lanes_equal_one_lane_calls():
    r = np.random.default_rng(3)
    tables = make_cluster_tables(_stakes(NP), device="cpu")
    sm = tables.sampler
    rows = K * O_LANE
    args = (torch.as_tensor(r.random((rows, NP)) < 0.6),
            torch.as_tensor(r.integers(0, 9, (rows, NP)), dtype=torch.int32),
            torch.as_tensor(r.random((rows, NP)) < 0.05), tables.side,
            sm.perm, sm.class_start, sm.class_count, sm.class_cdf[-1],
            torch.as_tensor(r.random(rows) < 0.7))
    lanes = dict(fanout=[2, 8, 5, 1], pull_on=[True, True, False, True],
                 bases=([1, 2, 3, 4], [5, 6, 7, 8], [9, 9, 9, 9]),
                 bloom_threshold=[rate_threshold(x) for x in (.1, 0, .5, .2)],
                 cap=[0, 2, 1, 0], partition=[True, False, True, False],
                 loss=([3, 3, 4, 4], [rate_threshold(x)
                                      for x in (0, .1, .3, .6)]))
    got = kernels.pull_exchange_plain(*args, slots=8, **lanes)
    ones = []
    for j, s in _slices():
        a = [t[s] if torch.is_tensor(t) and t.shape[0] == rows else t
             for t in args]
        ones.append(tuple(kernels.pull_exchange_plain(
            *a, slots=8, fanout=lanes["fanout"][j],
            pull_on=lanes["pull_on"][j],
            bases=tuple(b[j] for b in lanes["bases"]),
            bloom_threshold=lanes["bloom_threshold"][j], cap=lanes["cap"][j],
            partition=lanes["partition"][j],
            loss=(lanes["loss"][0][j], lanes["loss"][1][j]))))
    _cat_equal(tuple(got), ones, "pull_exchange")


def test_lane_counts_the_struct_refuses():
    r = np.random.default_rng(4)
    active, pruned, tfail, origins = _rows(r)
    side = torch.zeros(NP + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="do not split"):
        kernels.push_targets_plain(active, pruned, tfail, origins, side, 6,
                                   [True] * 5)
    with pytest.raises(ValueError, match="lanes"):
        kernels.push_targets_plain(active, pruned, tfail, origins, side, 6,
                                   [True] * 4, ([1, 2, 3], [0, 0, 0]))
    big = torch.zeros((65, 4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 64"):
        kernels.push_targets_plain(big, big.bool(), big.bool(),
                                   torch.zeros(65, dtype=torch.int32),
                                   torch.zeros(5, dtype=torch.int32), 2,
                                   [True] * 65)


def test_traffic_lanes_are_refused():
    p = EngineParams(num_nodes=N, traffic_values=4)
    static = merge_lane_statics([p.static_part()])
    with pytest.raises(NotImplementedError, match="A9b"):
        run_rounds_lanes(static, None, torch.zeros(1, dtype=torch.int32),
                         None, stack_knobs([p.knob_values()]), 1)
