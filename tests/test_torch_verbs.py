"""The plain versions of the verb 1 and verb 5 kernels against the
reference package.

* ``push_targets_plain`` equals the reference's verb-1 block, read off its
  flight recorder (``round_step(..., trace=True)``: ``trace_peers`` and
  ``trace_code`` per fanout slot), on a state carried across from the
  reference engine: unimpaired, under loss + churn + partition, and with
  every delivery lost (loss rate 1.0); the rows hold pruned, failed and
  origin slots, and rows with fewer than F valid slots;
* ``sample_members_plain`` equals the reference's ``_sample_fast`` on
  uniforms placed at 0.0, at each CDF boundary and one ulp below it, and on
  member uniforms of 0.0 and one ulp below 1.0;
* ``rotate_plain``, which draws its uniforms from the origins' keys and
  the iteration, equals one reference round's new ``active``/``pruned``/
  ``tfail`` and its ``rot_failed`` row, on a state built so that full rows
  shift, rows that are not full append, rows find no new peer in their
  tries, and chosen peers are failed, at an even and an odd N.

Both threefry layouts are pinned in turn.  The kernels themselves are held
against these plain versions on the card by tests/test_torch_kernels_cuda.py
and chip_smoke.py.

Tolerance: 0 everywhere (exact equality)."""

import gossip_sim_tpu.engine as je  # noqa: I001  (64-bit types first)
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_sim_tpu.engine.core import _sample_fast
from gossip_sim_tpu.obs.trace import (TRACE_CANDIDATE, TRACE_DROPPED,
                                      TRACE_EMPTY, TRACE_FAILED_TARGET,
                                      TRACE_SUPPRESSED)
from gossip_sim_tpu_torch import kernels, rng
from gossip_sim_tpu_torch.convert import state_from_numpy, tables_from_numpy
from gossip_sim_tpu_torch.engine import core as tc
from gossip_sim_tpu_torch.engine.params import EngineParams as PortParams

rot_mod = importlib.import_module("gossip_sim_tpu_torch.kernels.rotate")


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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _capture(name, params, tables, origins, state, it):
    """Run one port round and return the arguments of its call of kernel
    ``name``."""
    seen = []
    real = getattr(kernels, name)

    def rec(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    setattr(kernels, name, rec)
    try:
        tc.round_step(params, tables, origins, state, it)
    finally:
        setattr(kernels, name, real)
    assert len(seen) == 1
    return seen[0]


#: Full rotation and a tiny insert cap make rows prune many peers at round
#: 19, so at round 20 rows hold pruned slots, and with a fanout of 10 of
#: the 12 slots some rows have fewer than F valid ones.
PRUNING = dict(warm_up_rounds=0, received_cap=2, rc_slots=16,
               probability_of_rotation=1.0, push_fanout=10)
VERB1 = {
    "unimpaired": PRUNING,
    "loss_churn_partition": dict(
        PRUNING, packet_loss_rate=0.2, churn_fail_rate=0.05,
        churn_recover_rate=0.2, partition_at=15, heal_at=30, impair_seed=9),
    # nothing is delivered, so nothing is pruned either
    "loss_all": dict(warm_up_rounds=0, packet_loss_rate=1.0,
                     churn_fail_rate=0.05, churn_recover_rate=0.2,
                     impair_seed=4),
}
VERB1_N, VERB1_AT = 150, 20


@pytest.mark.parametrize("scenario", list(VERB1))
def test_push_targets_plain_matches_reference_verb1(layout, scenario):
    n, it = VERB1_N, VERB1_AT
    kw = VERB1[scenario]
    stakes = np.random.default_rng(0).integers(1, 1 << 45,
                                               size=n).astype(np.int64)
    origins = np.array([0, 37, 101], np.int32)
    jo = jnp.asarray(origins)
    jt = je.make_cluster_tables(stakes)
    jp = je.EngineParams(num_nodes=n, **kw)
    js = je.init_state(jax.random.PRNGKey(5), jt, jo, jp)
    js, _ = je.run_rounds(jp, jt, jo, js, it)
    tt = tables_from_numpy(_np(jt), "cpu")
    ts = state_from_numpy(_np(js), "cpu")    # before run_rounds donates it
    _, rows = je.run_rounds(jp, jt, jo, js, 1, start_it=it, trace=True)
    peers = np.asarray(rows["trace_peers"])[0]                    # [O, N, F]
    code = np.asarray(rows["trace_code"])[0]
    args, kwargs = _capture("push_targets", PortParams(num_nodes=n, **kw),
                            tt, torch.as_tensor(origins), ts, it)
    tgt, sup, drop = kernels.push_targets_plain(*args, **kwargs)
    assert np.array_equal(tgt.numpy(),
                          np.where(code == TRACE_CANDIDATE, peers, n))
    if scenario == "loss_all":
        assert sup is None
        assert np.array_equal(drop.numpy(), code == TRACE_DROPPED)
        assert (code == TRACE_DROPPED).any()
        assert (code == TRACE_FAILED_TARGET).any()
        assert not (code == TRACE_CANDIDATE).any()
        return
    active, pruned = args[0].numpy(), args[1].numpy()
    # the rows hold every kind of slot the scan skips or gates
    assert (pruned & (active < n)).any()
    assert (active == origins[:, None, None]).any()
    assert (code == TRACE_EMPTY).any()                 # < F valid slots
    if scenario == "unimpaired":
        assert sup is None and drop is None
        return
    assert np.array_equal(drop.numpy(), code == TRACE_DROPPED)
    assert np.array_equal(sup.numpy(), code == TRACE_SUPPRESSED)
    for c in (TRACE_FAILED_TARGET, TRACE_SUPPRESSED, TRACE_DROPPED,
              TRACE_CANDIDATE):
        assert (code == c).any(), c


def _sampler_uniforms(cdf_rows, t_extra, seed):
    """u_class [O, N, T] at 0.0, at each of a row's 24 CDF boundaries and
    one ulp below it, one ulp below 1.0, and ``t_extra`` random values;
    u_member at 0.0, one ulp below 1.0 and random values in turn."""
    r = np.random.default_rng(seed)
    f32 = np.float32
    bounds = cdf_rows[..., :-1].astype(f32)                        # [O,N,24]
    below = np.nextafter(bounds, f32(0))
    top = np.nextafter(f32(1), f32(0))
    O, N = cdf_rows.shape[:2]
    extra = r.random((O, N, t_extra), dtype=f32)
    u_class = np.concatenate([
        np.zeros((O, N, 1), f32), bounds, below,
        np.full((O, N, 1), top, f32), extra], -1)
    T = u_class.shape[-1]
    u_member = r.random((O, N, T), dtype=f32)
    u_member[..., 0::3] = 0.0
    u_member[..., 1::3] = top
    return u_class, u_member


def test_sampler_plain_matches_reference_sample_fast():
    n = 400
    r = np.random.default_rng(1)
    # stakes spread over every log2 bucket: 2^28 to 2^56 lamports
    stakes = (2.0 ** r.uniform(28, 56, size=n)).astype(np.int64)
    jt = je.make_cluster_tables(stakes)
    tt = tc.make_cluster_tables(stakes, device="cpu")
    buckets = tt.buckets.numpy()
    origins = np.array([int(np.argmin(buckets)), int(np.argmax(buckets)),
                        int(np.argsort(buckets)[n // 2])], np.int32)
    assert len(set(buckets[origins].tolist())) == 3
    k = np.minimum(buckets[None, :], buckets[origins][:, None])
    cdf_rows = tt.sampler.class_cdf.numpy()[k]                     # [O,N,25]
    u_class, u_member = _sampler_uniforms(cdf_rows, 4, seed=2)
    want = np.asarray(_sample_fast(jt, jnp.asarray(origins),
                                   jnp.asarray(u_class),
                                   jnp.asarray(u_member)))
    sm = tt.sampler
    got = rot_mod.sample_members_plain(
        tt.buckets, torch.as_tensor(origins), sm.class_cdf, sm.class_start,
        sm.class_count, torch.as_tensor(u_class), torch.as_tensor(u_member))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # members reach both ends of classes of several members
    starts, counts = sm.class_start.numpy(), sm.class_count.numpy()
    wide = counts > 1
    assert np.isin(got.numpy(), starts[wide]).any()
    assert np.isin(got.numpy(), (starts + counts - 1)[wide]).any()


ROT_HEAVY, ROT_AT = 12, 7


def _rotation_state(jt, jp, origins, seed):
    """A reference state whose rows exercise every arm of verb 5.

    Nodes 0..11 hold nearly all stake (bucket 24), the rest less than one
    SOL (bucket 0).  A heavy node's row is full with the other 11 heavy
    nodes and one light one, so its tries almost never find a new peer
    (``rot_failed``); light nodes' rows are full (they shift) or hold 3-9
    peers (they append).  A fifth of the nodes are failed, heavy ones
    among them, and the tfail bits agree."""
    r = np.random.default_rng(seed)
    n, S = jp.num_nodes, jp.active_set_size
    js = je.init_state(jax.random.PRNGKey(seed), jt, jnp.asarray(origins), jp)
    O = len(origins)
    active = np.full((O, n, S), n, np.int32)
    heavy = np.arange(ROT_HEAVY)
    for o in range(O):
        for v in range(n):
            if v < ROT_HEAVY:
                row = np.concatenate([heavy[heavy != v],
                                      [ROT_HEAVY + (v + o) % (n - ROT_HEAVY)]])
            else:
                others = r.permutation(np.delete(np.arange(n), v))
                m = S if v % 3 == 0 else int(r.integers(3, 10))
                row = others[:m]
            active[o, v, :len(row)] = r.permutation(row)
    failed = np.zeros((O, n), bool)
    failed[:, r.choice(n, size=n // 5, replace=False)] = True
    failed[:, [2, 5]] = True
    member = active < n
    tfail = failed[np.arange(O)[:, None, None], np.minimum(active, n - 1)]
    pruned = member & (r.random(active.shape) < 0.15)
    return js._replace(active=jnp.asarray(active), pruned=jnp.asarray(pruned),
                       tfail=jnp.asarray(tfail & member),
                       failed=jnp.asarray(failed))


@pytest.mark.parametrize("n", [40, 41])
@pytest.mark.parametrize("prob", [1.0, 0.6])
def test_rotate_plain_matches_one_reference_round(layout, prob, n):
    """N = 41 is odd: in the original layout the rotation uniforms' last
    counter pair takes the zero pad (the tries' 2N-word draws are even)."""
    stakes = np.concatenate([
        np.full(ROT_HEAVY, 1 << 60) + np.arange(ROT_HEAVY),
        100_000 + np.arange(n - ROT_HEAVY)]).astype(np.int64)
    origins = np.array([0, 7], np.int32)
    kw = dict(warm_up_rounds=0, probability_of_rotation=prob)
    jt = je.make_cluster_tables(stakes)
    jp = je.EngineParams(num_nodes=n, **kw)
    js = _rotation_state(jt, jp, origins, seed=3)
    tt = tables_from_numpy(_np(jt), "cpu")
    ts = state_from_numpy(_np(js), "cpu")    # before run_rounds donates it
    want, rows = je.run_rounds(jp, jt, jnp.asarray(origins), js, 1,
                               start_it=ROT_AT)
    args, kwargs = _capture("rotate", PortParams(num_nodes=n, **kw), tt,
                            torch.as_tensor(origins), ts, ROT_AT)
    # the round hands rotate the state's keys and the iteration, not draws
    assert args[4] is ts.key and args[5] == ROT_AT
    new_active, new_pruned, new_tfail, rot_failed = kernels.rotate_plain(
        *args, **kwargs)
    assert np.array_equal(new_active.numpy(), np.asarray(want.active))
    assert np.array_equal(new_pruned.numpy(), np.asarray(want.pruned))
    assert np.array_equal(new_tfail.numpy(), np.asarray(want.tfail))
    assert np.array_equal(rot_failed.numpy(),
                          np.asarray(rows["rot_failed"])[0])

    # every arm of the verb ran
    active = args[0].numpy()
    full = (active < n).sum(-1) == active.shape[-1]
    moved = (new_active.numpy() != active).any(-1)
    assert (moved & full).any() and (moved & ~full).any()   # shift, append
    assert int(rot_failed.sum()) > 0
    new_slot = np.where(full, active.shape[-1] - 1, (active < n).sum(-1))
    new_slot = np.minimum(new_slot, active.shape[-1] - 1)
    chosen_failed = np.take_along_axis(new_tfail.numpy(),
                                       new_slot[..., None], -1)[..., 0]
    assert (moved & chosen_failed).any()
    if prob < 1.0:
        assert not moved.all()
