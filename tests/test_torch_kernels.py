"""Each kernel module's plain version against the reference package.

* ``bfs_relax_plain`` and ``rank_inbound_plain`` equal the reference's
  ``engine.sparse.bfs_reach`` / ``rank_inbound`` on seeded-numpy inputs;
* ``rc_merge_prune_plain`` and ``prune_apply_plain`` equal one reference
  ``round_step`` on a state carried across from the reference engine, built
  so that rows fire, the received cache overflows, and a row prunes more
  than ``pa_slots`` = 8 peers (the reference's budget-fallback arm).

The kernels themselves are held against these plain versions on the card
by tests/test_torch_kernels_cuda.py and chip_smoke.py.

Tolerance: 0 everywhere (exact integer equality)."""

import gossip_sim_tpu.engine as je  # noqa: I001  (64-bit types first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_sim_tpu.engine import sparse as ref_sparse
from gossip_sim_tpu_torch import kernels, rng
from gossip_sim_tpu_torch.convert import (state_from_numpy, state_to_numpy,
                                          tables_from_numpy)
from gossip_sim_tpu_torch.engine import core as tc
from gossip_sim_tpu_torch.engine.params import EngineParams as PortParams

INF = 1 << 20


@pytest.fixture
def partitionable():
    old = jax.config.jax_threefry_partitionable
    old_port = rng.partitionable()
    jax.config.update("jax_threefry_partitionable", True)
    rng.set_partitionable(True)
    yield
    jax.config.update("jax_threefry_partitionable", old)
    rng.set_partitionable(old_port)


def _edges(seed, O=3, N=300, F=6, p_none=0.25):
    """Seeded push targets: distinct per source, none to itself, N = none."""
    r = np.random.default_rng(seed)
    tgt = np.empty((O, N, F), np.int32)
    for o in range(O):
        for n in range(N):
            peers = r.choice(N - 1, size=F, replace=False)
            tgt[o, n] = peers + (peers >= n)
    tgt[r.random((O, N, F)) < p_none] = N
    origins = r.choice(N, size=O, replace=False).astype(np.int32)
    return tgt, origins


def _reference_bfs(tgt, origins):
    """The reference's hop-1 seed (core.py:627-633) + ``bfs_reach``."""
    O, N, F = tgt.shape
    o1 = jnp.arange(O)
    jt, jo = jnp.asarray(tgt), jnp.asarray(origins)
    org_tgts = jt[o1[:, None], jo[:, None], jnp.arange(F)[None, :]]
    dist0 = jnp.full((O, N), INF, jnp.int32).at[o1, jo].set(0)
    dist0 = dist0.at[o1[:, None], org_tgts].min(1, mode="drop")
    frontier1 = jnp.zeros((O, N), bool).at[o1[:, None], org_tgts].set(
        True, mode="drop")
    reached1 = frontier1.at[o1, jo].set(True)
    return ref_sparse.bfs_reach(jt, frontier1, reached1, dist0, N)


@pytest.mark.parametrize("seed", [1, 2])
def test_bfs_relax_plain_matches_reference(seed):
    tgt, origins = _edges(seed, p_none=0.55)
    want_r, want_d = _reference_bfs(tgt, origins)
    got_r, got_d = kernels.bfs_relax_plain(torch.as_tensor(tgt),
                                           torch.as_tensor(origins))
    assert np.array_equal(np.asarray(want_r), got_r.numpy())
    assert np.array_equal(np.asarray(want_d), got_d.numpy())
    assert int(got_d[got_r].max()) >= 3            # several hops ran


@pytest.mark.parametrize("seed,k", [(3, 16), (4, 4), (5, 128)])
def test_rank_inbound_plain_matches_reference(seed, k):
    tgt, _ = _edges(seed)
    O, N, F = tgt.shape
    r = np.random.default_rng(seed + 100)
    reached = r.random((O, N)) < 0.8
    hop1 = r.integers(1, 64, size=(O, N)).astype(np.int32)
    delivered = (tgt < N) & reached[:, :, None]
    pb = 14
    want = ref_sparse.rank_inbound(jnp.asarray(delivered), jnp.asarray(tgt),
                                   jnp.asarray(hop1), pb, 1 << pb, k, N)
    got = kernels.rank_inbound_plain(torch.as_tensor(tgt),
                                     torch.as_tensor(delivered),
                                     torch.as_tensor(hop1), pb, k)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    if k == 4:
        assert int(got[2].sum()) > 0                # truncation happened


#: Full rotation plus a tiny insert cap fills the 16 cache slots with new
#: sources two per round, so by round 19 (the upsert counters fire) caches
#: overflow and rows prune up to 14 peers at once.
CARRY = dict(warm_up_rounds=0, received_cap=2, rc_slots=16,
             probability_of_rotation=1.0)
CARRY_N, CARRY_AT = 60, 19


def test_merge_prune_and_apply_match_one_reference_round(partitionable):
    n = CARRY_N
    stakes = np.random.default_rng(0).integers(1, 1 << 45,
                                               size=n).astype(np.int64)
    origins = np.array([0, 1], np.int32)
    jt = je.make_cluster_tables(stakes)
    jp = je.EngineParams(num_nodes=n, **CARRY)
    js = je.init_state(jax.random.PRNGKey(3), jt, jnp.asarray(origins), jp)
    js, _ = je.run_rounds(jp, jt, jnp.asarray(origins), js, CARRY_AT)
    # carry the reference's state and tables across
    tt = tables_from_numpy(jax.tree_util.tree_map(np.asarray, jt), "cpu")
    ts = state_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    want_state, want_rows = je.run_rounds(jp, jt, jnp.asarray(origins), js,
                                          1, start_it=CARRY_AT, detail=True)

    seen = {}
    real = kernels.rc_merge_prune

    def recorder(*args, **kw):
        seen["mp"] = real(*args, **kw)
        return seen["mp"]

    kernels.rc_merge_prune = recorder
    try:
        got_state, got_rows = tc.round_step(
            PortParams(num_nodes=n, **CARRY), tt, torch.as_tensor(origins),
            ts, CARRY_AT, detail=True)
    finally:
        kernels.rc_merge_prune = real
    mp = seen["mp"]
    assert int(mp.rc_overflow.sum()) > 0                  # cache overflowed
    assert bool((mp.rc_upserts == 0).any())               # rows fired
    assert int(mp.n_pruned.max()) > jp.pa_slots           # > pa_slots prunes

    got = state_to_numpy(got_state)
    for f in want_state._fields:
        assert np.array_equal(np.asarray(getattr(want_state, f)),
                              getattr(got, f)), f
    for k, v in want_rows.items():
        assert np.array_equal(np.asarray(v)[0], got_rows[k].numpy(),
                              equal_nan=True), k
