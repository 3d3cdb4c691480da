"""The port's engine (plain kernel versions, CPU tensors) is bit-exact
against the reference JAX engine: ``init_state`` field by field, and >= 25
rounds of ``run_rounds`` with ``detail=True`` — every ``SimState`` field and
every row — unimpaired, under loss + churn + partition, and under the
one-shot node failure; with ``edge_detail=True`` the per-edge targets and
hops too.  Past 32,767 nodes both engines refuse inbound keys that would
overflow int32, with the same ``ValueError``, before any round's work.

Tolerance: 0 everywhere (exact equality, NaN == NaN in float rows)."""

import gossip_sim_tpu.engine as je  # noqa: I001  (64-bit types first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_sim_tpu_torch import rng
from gossip_sim_tpu_torch.convert import state_to_numpy
from gossip_sim_tpu_torch.engine import core as tc
from gossip_sim_tpu_torch.engine.params import EngineParams as PortParams

ROUNDS = 26


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def layout(request):
    """Pin both packages to one threefry layout; restore afterwards."""
    old = jax.config.jax_threefry_partitionable
    old_port = rng.partitionable()
    jax.config.update("jax_threefry_partitionable", request.param)
    rng.set_partitionable(request.param)
    yield request.param
    jax.config.update("jax_threefry_partitionable", old)
    rng.set_partitionable(old_port)


def _stakes(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        1, 1 << 45, size=n).astype(np.int64)


def _assert_state_equal(jstate, tstate, where=""):
    got = state_to_numpy(tstate)
    for f in jstate._fields:
        want = np.asarray(getattr(jstate, f))
        have = getattr(got, f)
        assert want.dtype == have.dtype, (where, f, want.dtype, have.dtype)
        assert np.array_equal(want, have), (where, f)


def _assert_rows_equal(jrows, trows):
    assert set(jrows) == set(trows)
    for k, v in jrows.items():
        want, have = np.asarray(v), trows[k].numpy()
        assert want.dtype == have.dtype, (k, want.dtype, have.dtype)
        assert np.array_equal(want, have, equal_nan=want.dtype.kind == "f"), k


def _both(n, origins, seed=7, **kw):
    stakes = _stakes(n)
    o = np.asarray(origins, dtype=np.int32)
    jt = je.make_cluster_tables(stakes)
    tt = tc.make_cluster_tables(stakes, device="cpu")
    jp, tp = je.EngineParams(num_nodes=n, **kw), PortParams(num_nodes=n, **kw)
    js = je.init_state(jax.random.PRNGKey(seed), jt, jnp.asarray(o), jp)
    ts = tc.init_state(rng.prng_key(seed), tt, torch.as_tensor(o), tp)
    return (jt, jp, jnp.asarray(o), js), (tt, tp, torch.as_tensor(o), ts)


@pytest.mark.parametrize("n", [40, 1000])
@pytest.mark.parametrize("n_origins", [1, 4])
def test_init_state_equal(layout, n, n_origins):
    origins = np.arange(n_origins) * (n // 8)
    (_, _, _, js), (_, _, _, ts) = _both(n, origins)
    _assert_state_equal(js, ts, "init")


SCENARIOS = {
    "unimpaired": dict(warm_up_rounds=5),
    "loss_churn_partition": dict(
        warm_up_rounds=5, packet_loss_rate=0.1, churn_fail_rate=0.02,
        churn_recover_rate=0.25, partition_at=8, heal_at=17, impair_seed=11),
    "fail_nodes": dict(warm_up_rounds=5, fail_at=6, fail_fraction=0.2),
}


@pytest.mark.parametrize("scenario,layout", [
    ("unimpaired", True), ("unimpaired", False),
    ("loss_churn_partition", True), ("fail_nodes", True)],
    indirect=["layout"])
def test_run_rounds_equal(scenario, layout):
    """Both threefry layouts on the unimpaired round (the layout only moves
    the draws); the impairment gates under the default layout."""
    kw = SCENARIOS[scenario]
    (jt, jp, jo, js), (tt, tp, to, ts) = _both(150, [0, 37, 101], **kw)
    js, jrows = je.run_rounds(jp, jt, jo, js, ROUNDS, start_it=0,
                              detail=True)
    ts, trows = tc.run_rounds(tp, tt, to, ts, ROUNDS, start_it=0,
                              detail=True)
    _assert_state_equal(js, ts, scenario)
    _assert_rows_equal(jrows, trows)
    assert int(np.asarray(jrows["prunes_sent"]).sum()) > 0
    if scenario == "loss_churn_partition":
        assert int(np.asarray(jrows["dropped"]).sum()) > 0
        assert int(np.asarray(jrows["suppressed"]).sum()) > 0
        assert int(np.asarray(jrows["failed_count"]).sum()) > 0
    if scenario == "fail_nodes":
        assert int(np.asarray(jrows["failed_count"])[-1].sum()) == 3 * 30


def test_run_rounds_equal_at_rc_slots_128(layout):
    """rc_slots = 128 with the default k_inbound of 16: rows of C + K = 144
    entries, which the kernel's former fixed row width refused."""
    kw = dict(warm_up_rounds=5, rc_slots=128)
    (jt, jp, jo, js), (tt, tp, to, ts) = _both(150, [0, 37, 101], **kw)
    assert tp.rc_slots + tp.k_inbound == 144
    js, jrows = je.run_rounds(jp, jt, jo, js, 22, start_it=0, detail=True)
    ts, trows = tc.run_rounds(tp, tt, to, ts, 22, start_it=0, detail=True)
    _assert_state_equal(js, ts, "rc_slots=128")
    _assert_rows_equal(jrows, trows)
    assert int(np.asarray(jrows["prunes_sent"]).sum()) > 0


def test_run_rounds_equal_at_inbound_cap_128():
    """inbound_cap = 128, twice the former 64-entry limit of the
    rank_inbound kernel (the plain version has none)."""
    kw = dict(warm_up_rounds=5, inbound_cap=128)
    (jt, jp, jo, js), (tt, tp, to, ts) = _both(300, [0, 151], **kw)
    assert tp.k_inbound == jp.k_inbound == 128
    js, jrows = je.run_rounds(jp, jt, jo, js, 20, start_it=0, detail=True)
    ts, trows = tc.run_rounds(tp, tt, to, ts, 20, start_it=0, detail=True)
    _assert_state_equal(js, ts, "inbound_cap=128")
    _assert_rows_equal(jrows, trows)
    assert int(np.asarray(jrows["prunes_sent"]).sum()) > 0


def test_unported_features_raise():
    tt = tc.make_cluster_tables(_stakes(40), device="cpu")
    o = torch.zeros(1, dtype=torch.int32)
    for kw in UNPORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tc.init_state(rng.prng_key(1), tt, o, PortParams(40, **kw))
    for kw in PORTED:
        PortParams(40, **kw).validate()


#: every EngineParams selector of the reference is ported, and the flight
#: recorder (round_step's trace=True) too: it refuses the sparse layout
UNPORTED = ()
#: once refused, now ported: adaptive traffic (ROADMAP A11b), the sparse
#: representation (ROADMAP A7) and the node-health planes (ROADMAP A12)
PORTED = (dict(traffic_values=2, gossip_mode="adaptive"),
          dict(node_egress_cap=4, gossip_mode="adaptive"),
          dict(representation="sparse"), dict(health=True))


def test_round_step_refuses_unported_features():
    """The round refuses what ``init_state`` refuses, and the flight
    recorder in the sparse layout (the reference's words), before it
    touches the state (here a dense one)."""
    tt = tc.make_cluster_tables(_stakes(40), device="cpu")
    o = torch.zeros(1, dtype=torch.int32)
    ts = tc.init_state(rng.prng_key(1), tt, o, PortParams(40))
    for kw in UNPORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tc.round_step(PortParams(40, **kw), tt, o, ts, 0)
    with pytest.raises(ValueError, match="the flight recorder requires "
                       "representation='dense'"):
        tc.round_step(PortParams(40, representation="sparse"), tt, o, ts, 0,
                      trace=True)


@pytest.mark.parametrize("scenario,layout", [
    ("unimpaired", True), ("unimpaired", False),
    ("loss_partition", True), ("loss_partition", False)],
    indirect=["layout"])
def test_run_rounds_edge_detail_equal(scenario, layout):
    """``edge_detail`` exports ``push_targets`` and ``edge_hops`` [O, N, F]
    per round (-1 where nothing was delivered), equal to the reference's."""
    kw = dict(warm_up_rounds=5)
    if scenario == "loss_partition":
        kw.update(packet_loss_rate=0.1, partition_at=6, heal_at=15,
                  impair_seed=11)
    (jt, jp, jo, js), (tt, tp, to, ts) = _both(150, [0, 37, 101], **kw)
    js, jrows = je.run_rounds(jp, jt, jo, js, 20, start_it=0, detail=True,
                              edge_detail=True)
    ts, trows = tc.run_rounds(tp, tt, to, ts, 20, start_it=0, detail=True,
                              edge_detail=True)
    _assert_state_equal(js, ts, scenario)
    _assert_rows_equal(jrows, trows)
    assert trows["push_targets"].shape == (20, 3, 150, 6)
    sent = trows["push_targets"] >= 0
    assert bool(sent.any()) and not bool(sent.all())
    assert bool((trows["edge_hops"][sent] >= 1).all())
    if scenario == "loss_partition":
        assert int(np.asarray(jrows["dropped"]).sum()) > 0
        assert int(np.asarray(jrows["suppressed"]).sum()) > 0


@pytest.mark.parametrize("kw", [dict(hist_bins=32768),
                                dict(inbound_cap=26844)],
                         ids=["hist_bins", "inbound_cap"])
def test_key_bounds_past_32767_nodes_raise(kw):
    """N = 40,000 (pack 2^16): hist_bins * pack = 2^31, or 2 * N * K past
    2^31.  Both engines raise the same ValueError before reading the state
    (passed as None), so no round's work runs."""
    n = 40_000
    stakes = _stakes(n)
    jt = je.make_cluster_tables(stakes)
    tt = tc.make_cluster_tables(stakes, device="cpu")
    o = np.zeros(1, dtype=np.int32)
    with pytest.raises(ValueError, match="overflow i32") as want:
        je.round_step(je.EngineParams(num_nodes=n, **kw), jt,
                      jnp.asarray(o), None, 0)
    with pytest.raises(ValueError, match="overflow i32") as got:
        tc.round_step(PortParams(num_nodes=n, **kw), tt, torch.as_tensor(o),
                      None, 0)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="overflow i32"):
        tc.run_rounds(PortParams(num_nodes=n, **kw), tt, torch.as_tensor(o),
                      None, 3)
    # one bin less, or one inbound slot less, is within both bounds
    ok = {k: v - 1 for k, v in kw.items()}
    tc._check_key_bounds(n, ok.get("hist_bins", 64),
                         PortParams(num_nodes=n, **ok).k_inbound)
