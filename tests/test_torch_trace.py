"""The flight recorder's engine rows (ROADMAP A13) against the reference
package's.

* every trace row and ``detail`` row of ``run_rounds(..., trace=True)``
  equals the reference's, for push under loss + partition + churn over a
  fail round (with ``inbound_cap`` 2, below the ingress, so
  ``trace_first`` is checked where K is exceeded, and a
  ``trace_prune_cap`` that truncates some rounds' pairs and not others),
  push-pull with ``pull_request_cap`` 1 (``capped`` codes occur), pull,
  and adaptive with rows that switch; rounds with prunes and without;
* trace on leaves every state field and non-trace row equal to trace off;
* ``trace_prune_pairs_plain`` against the kernel's schedule
  (``csrc/trace_prune_pairs.cu``: per chunk of pruners an exclusive scan
  of ``n_pruned``, the firing pruners' slots at their offsets, the walk
  stopped where the total reaches the cap, -1 fill) transcribed in numpy;
* the refusals: the sparse layout (the reference's words), the lane
  runners, and the traffic engine naming ROADMAP A13b.

Both packages run in the partitionable threefry layout, and the push case
also in the other.  Each reference case runs once per layout (cached) and
is shared across its asserts.
Tolerance: 0 (exact equality of every array)."""

import gossip_sim_tpu.engine as je  # noqa: I001  (64-bit types first)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_sim_tpu_torch import kernels, rng
from gossip_sim_tpu_torch.convert import state_from_numpy, state_to_numpy
from gossip_sim_tpu_torch.engine import core as tc
from gossip_sim_tpu_torch.engine import lanes as tl
from gossip_sim_tpu_torch.engine import traffic as tt
from gossip_sim_tpu_torch.engine.params import EngineParams as PortParams
from gossip_sim_tpu_torch.obs.trace import (TRACE_DROPPED,
                                            TRACE_FAILED_TARGET,
                                            TRACE_SUPPRESSED)
from gossip_sim_tpu_torch.pull import PULL_MISS_CAPPED, PULL_RESPONSE

N, ORIGINS, ROUNDS = 120, (0, 37), 18
IMPAIRED = dict(packet_loss_rate=0.1, churn_fail_rate=0.02,
                churn_recover_rate=0.25, partition_at=6, heal_at=12,
                impair_seed=11)
#: knobs over warm-up 4 and upsert threshold 6 (rounds 5, 11 and 17 fire)
BASE = dict(warm_up_rounds=4, min_num_upserts=6)
CASES = {
    "push": dict(IMPAIRED, fail_at=8, fail_fraction=0.1, inbound_cap=2,
                 trace_prune_cap=40),
    "push_pull_cap1": dict(IMPAIRED, gossip_mode="push-pull",
                           pull_request_cap=1, pull_fanout=3),
    "pull": dict(gossip_mode="pull", packet_loss_rate=0.1, impair_seed=3),
    "adaptive": dict(IMPAIRED, gossip_mode="adaptive",
                     adaptive_switch_threshold=0.5),
}


@pytest.fixture(autouse=True)
def pinned(request):
    """Both packages in one threefry layout: partitionable unless a test
    asks for the other (``indirect`` parametrization); yields it."""
    layout = getattr(request, "param", True)
    old = jax.config.jax_threefry_partitionable
    old_port = rng.partitionable()
    threads = torch.get_num_threads()
    jax.config.update("jax_threefry_partitionable", layout)
    rng.set_partitionable(layout)
    torch.set_num_threads(1)
    yield layout
    jax.config.update("jax_threefry_partitionable", old)
    rng.set_partitionable(old_port)
    torch.set_num_threads(threads)


def _stakes(n=N, seed=0):
    return np.random.default_rng(seed).integers(1, 1 << 45,
                                                n).astype(np.int64)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_rows_equal(got, want, what):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k, a.dtype,
                                                           b.dtype)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), (what, k)


@functools.lru_cache(maxsize=None)
def _case(case, layout):
    """The reference's traced run of a case, and the port's traced and
    untraced runs, from one initial state, in the threefry ``layout`` the
    ``pinned`` fixture set."""
    kw = dict(BASE, **CASES[case])
    stakes = _stakes()
    o = np.asarray(ORIGINS, np.int32)
    jp = je.EngineParams(num_nodes=N, **kw)
    jt = je.make_cluster_tables(stakes)
    js0 = je.init_state(jax.random.PRNGKey(5), jt, jnp.asarray(o), jp)
    # the reference's run_rounds donates its input state
    ts0 = state_from_numpy(_np(js0), device="cpu")
    js, jrows = je.run_rounds(jp, jt, jnp.asarray(o), js0, ROUNDS,
                              trace=True)
    tables = tc.make_cluster_tables(stakes, device="cpu")
    org = torch.as_tensor(o)
    pp = PortParams(num_nodes=N, **kw)
    on = tc.run_rounds(pp, tables, org, ts0, ROUNDS, trace=True)
    off = tc.run_rounds(pp, tables, org, ts0, ROUNDS, detail=True)
    return (_np(js), _np(jrows)), on, off


@pytest.mark.parametrize("case", list(CASES))
def test_trace_rows_equal_reference(case, pinned):
    _check_rows(case, pinned)


@pytest.mark.parametrize("pinned", [False], indirect=True)
@pytest.mark.parametrize("case", ["push"])
def test_trace_rows_equal_reference_unpartitioned(case, pinned):
    """The push case's rows in the other threefry layout, whose draws
    (the rotations, and with them ``trace_rot``) differ; the pull codes
    come from hashes that no layout changes."""
    _check_rows(case, pinned)


def _check_rows(case, layout):
    (js, jrows), (ts, trows), _ = _case(case, layout)
    got = {k: v.numpy() for k, v in trows.items()}
    assert_rows_equal(got, jrows, case)
    for f in js._fields:
        assert np.array_equal(getattr(state_to_numpy(ts), f),
                              getattr(js, f)), (case, f)
    pull = case != "push"
    assert ("trace_pull_peers" in got) == pull
    # prunes fire in some rounds and not in others (pull mode pushes
    # nothing, so nothing is pruned)
    fired = (jrows["prunes_sent"] > 0).any(-1)
    assert fired.any() != (case == "pull") and not fired.all(), case
    code = jrows["trace_code"]
    if case == "push":
        for c in (TRACE_FAILED_TARGET, TRACE_SUPPRESSED, TRACE_DROPPED):
            assert (code == c).any(), c
        # K = 2 is exceeded, and trace_first still names the least edge
        assert (jrows["inb_dropped"] > 0).any()
        assert (jrows["trace_first"] >= 0).any()
        # the cap truncates some rounds' pairs, not all firing rounds'
        captured = (jrows["trace_prune_src"] >= 0).sum(-1)
        assert jrows["trace_prune_src"].shape[-1] == 40
        trunc = jrows["prunes_sent"] > captured
        assert trunc.any() and ((jrows["prunes_sent"] > 0) & ~trunc).any()
        assert (jrows["trace_rot"] >= 0).any()
    if case == "push_pull_cap1":
        assert (jrows["trace_pull_code"] == PULL_MISS_CAPPED).any()
        assert (jrows["trace_pull_code"] == PULL_RESPONSE).any()
    if case == "pull":
        assert not (code > 0).any()
        assert (jrows["trace_pull_code"] == PULL_RESPONSE).any()
    if case == "adaptive":
        assert jrows["adaptive_switched"].any()
        on = jrows["adaptive_pull_active"]
        assert on.any() and not on.all()


@pytest.mark.parametrize("case", list(CASES))
def test_trace_leaves_the_round_unchanged(case, pinned):
    """Trace on: every state field and every non-trace row equal the
    untraced run's (which asks for the detail rows the trace adds)."""
    _, (ts, trows), (off, off_rows) = _case(case, pinned)
    for f in ts._fields:
        assert torch.equal(getattr(ts, f), getattr(off, f)), (case, f)
    plain = {k: v for k, v in trows.items() if not k.startswith("trace_")}
    assert set(plain) == set(off_rows)
    for k, v in off_rows.items():
        assert torch.equal(plain[k], v) or (
            v.dtype.is_floating_point and torch.equal(
                torch.nan_to_num(plain[k]), torch.nan_to_num(v))), (case, k)


def _kernel_schedule(n_pruned, pruned_slot, src_sorted, cap, chunk):
    """csrc/trace_prune_pairs.cu transcribed: per row, chunks of ``chunk``
    pruners, an exclusive scan of their counts plus the total before,
    the firing pruners' slots written at their offsets while below the
    cap, the walk stopped where the total reaches the cap, -1 fill."""
    R, N_, C = pruned_slot.shape
    src = np.full((R, cap), 7777, np.int32)
    dst = np.full((R, cap), 7777, np.int32)
    for r in range(R):
        total = 0
        base = 0
        while base < N_ and total < cap:
            v = n_pruned[r, base:base + chunk]
            offs = total + np.concatenate([[0], np.cumsum(v)[:-1]])
            for j in np.nonzero((v > 0) & (offs < cap))[0]:
                k = offs[j]
                for s in range(C):
                    if k >= cap:
                        break
                    if pruned_slot[r, base + j, s]:
                        src[r, k], dst[r, k] = base + j, src_sorted[
                            r, base + j, s]
                        k += 1
            total += int(v.sum())
            base += chunk
        src[r, min(total, cap):] = -1
        dst[r, min(total, cap):] = -1
    return src, dst


@pytest.mark.parametrize("cap", [1, 5, 37, 4000])
def test_prune_pairs_kernel_schedule(cap):
    """The kernel's chunked scan against the plain flat definition, on
    rows that fire densely, sparsely and not at all (chunks of 16 here,
    kThreads on the card: the schedule does not depend on the width)."""
    r = np.random.default_rng(cap)
    R, N_, C = 4, 70, 9
    slot = r.random((R, N_, C)) < np.array([0.3, 0.02, 0.0, 0.5])[
        :, None, None]
    slot &= r.random((R, N_, 1)) < 0.4
    src_sorted = r.integers(0, N_, (R, N_, C)).astype(np.int32)
    n_pruned = slot.sum(-1).astype(np.int32)
    want = kernels.trace_prune_pairs_plain(
        torch.as_tensor(n_pruned), torch.as_tensor(slot),
        torch.as_tensor(src_sorted), cap)
    for chunk in (16, 1024):
        got = _kernel_schedule(n_pruned, slot, src_sorted, cap, chunk)
        assert np.array_equal(got[0], want[0].numpy())
        assert np.array_equal(got[1], want[1].numpy())
    # the wrapper on CPU tensors is the plain version
    via = kernels.trace_prune_pairs(torch.as_tensor(n_pruned),
                                    torch.as_tensor(slot),
                                    torch.as_tensor(src_sorted), cap)
    assert all(torch.equal(a, b) for a, b in zip(via, want))
    assert (want[0][2] == -1).all()


def test_refusals():
    stakes = _stakes()
    tables = tc.make_cluster_tables(stakes, device="cpu")
    org = torch.as_tensor(np.asarray(ORIGINS, np.int32))
    sp = PortParams(num_nodes=N, representation="sparse")
    st = tc.init_state(rng.prng_key(1, "cpu"), tables, org, sp)
    with pytest.raises(ValueError, match="flight recorder requires "
                       "representation='dense'"):
        tc.run_rounds(sp, tables, org, st, 1, trace=True)
    with pytest.raises(ValueError, match="flight recorder requires"):
        tc.round_step(sp, tables, org, st, 0, trace=True)
    pp = PortParams(num_nodes=N)
    st = tc.init_state(rng.prng_key(1, "cpu"), tables, org, pp)
    knobs = tl.stack_knobs([pp.knob_values()] * 2)
    with pytest.raises(ValueError, match=tl.LANE_TRACE_REASON):
        tl.run_rounds_lanes(pp.static_part(), tables, org,
                            tl.broadcast_state(st, 2), knobs, 1, trace=True)
    with pytest.raises(ValueError, match=tl.LANE_TRACE_REASON):
        tl.run_rounds_lanes_dyn(pp.static_part(), tables,
                                tl.stack_origins([ORIGINS, ORIGINS]),
                                tl.broadcast_state(st, 2), knobs, 1, [0, 0],
                                trace=True)
    tp = PortParams(num_nodes=N, traffic_values=4)
    ts = tt.init_traffic_state(stakes, tp, 5, device="cpu")
    ttables = tt.device_traffic_tables(stakes, device="cpu")
    for fn in (lambda: tt.run_traffic_rounds(tp, tables, ttables, ts, 1,
                                             trace=True),
               lambda: tt.traffic_round_step(tp, tables, ttables, ts, 0,
                                             trace=True)):
        with pytest.raises(NotImplementedError, match="A13b"):
            fn()
    with pytest.raises(ValueError, match=tl.LANE_TRACE_REASON):
        tt.run_traffic_lanes(tp.static_part(), tables, ttables,
                             tt.broadcast_traffic_state(ts, 2),
                             tl.stack_knobs([tp.knob_values()] * 2), 1,
                             trace=True)


def test_checkpoint_carries_trace_prune_cap(tmp_path):
    """A port checkpoint records the port's own ``trace_prune_cap``, and
    the reference's ``load_state`` reads it (``pa_slots`` keeps the
    reference's default)."""
    from gossip_sim_tpu import checkpoint as ref_checkpoint
    from gossip_sim_tpu_torch import checkpoint
    pp = PortParams(num_nodes=N, trace_prune_cap=7)
    tables = tc.make_cluster_tables(_stakes(), device="cpu")
    st = tc.init_state(rng.prng_key(1, "cpu"), tables,
                       torch.as_tensor(np.asarray(ORIGINS, np.int32)), pp)
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, st, pp)
    _, stored, _ = ref_checkpoint.load_state(path)
    assert stored["trace_prune_cap"] == 7 and stored["pa_slots"] == 8
    assert pp.prune_cap == 7
    assert PortParams(num_nodes=N).prune_cap == 16 * N
    assert PortParams(num_nodes=N, rc_slots=8).prune_cap == 8 * N
