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
  a k above N and i64-range values; the kernel's sort schedule
  (``csrc/health_digest.cu``: tile stats, radix passes of a histogram, a
  digit-major scan and a stable scatter ranked per warp, then the sorted
  row read off) transcribed in numpy against the plain version, with runs
  of equal values across tiles;
* ``health_round``'s traffic form in numpy (the split value sums in
  uint32 that wraps, the pair walk by 16-byte words or bytes) against
  ``health_round_traffic_plain``.

Each reference case runs once (cached) and is shared across its asserts.
Tolerance: 0 (exact equality of every array)."""

import gossip_sim_tpu.engine as je  # noqa: I001  (64-bit types first)
import functools
import importlib

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


def _warp_ranks(d, warp):
    """Per entry of one round of a tile (digits ``d``, ``kBins`` where
    the entry is past the tile): (its rank among the equal digits of its
    warp at lower lanes, the warp's count of each digit) as
    ``__match_any_sync`` and the leaders' writes give them."""
    rank = np.zeros(d.size, np.int64)
    counts = np.zeros((-(-d.size // warp), BINS), np.int64)
    for w in range(counts.shape[0]):
        seg = d[w * warp:(w + 1) * warp]
        for lane, dig in enumerate(seg):
            if dig < BINS:
                rank[w * warp + lane] = int((seg[:lane] == dig).sum())
                counts[w, dig] += 1
    return rank, counts


BINS = 256


def kernel_schedule(stack, dec, k, tile=1024, threads=256, warp=32):
    """csrc/health_digest.cu in numpy: per tile the min, max, sum and
    decile sums (phase A) met per row (B); the key max - x and the row's
    passes of 8 bits; per pass each tile's digit histogram (H), the
    digit-major exclusive scan of the counts over the row's tiles (S) and
    the stable scatter in rounds of ``threads`` entries, ranked within
    each warp of ``warp`` lanes and across the round's warps (X); then the
    sorted row's Gini numerator sum (n - 1 - 2 d) x_d and its first k
    entries (F).  64-bit sums wrap.  Also checks the sorted row against
    the counts of the reference's definition: each entry's position d is
    G + B (entries above it; equal entries at a lower id), each run of
    equal values holds ids ascending, and sum x (L - G) is the numerator
    (L below, E equal, G = n - L - E)."""
    stack = np.asarray(stack, np.int64)
    p, n = stack.shape
    tpr = -(-n // tile)
    u64 = np.uint64
    acc = np.zeros((p, 12), u64)
    top_idx = np.full((p, k), -1, np.int32)
    top_val = np.zeros((p, k), np.int64)
    with np.errstate(over="ignore"):
        for r in range(p):
            x = stack[r]
            # A, B
            lo_hi = [(x[t * tile:(t + 1) * tile].min(),
                      x[t * tile:(t + 1) * tile].max()) for t in range(tpr)]
            mn = min(a for a, _ in lo_hi)
            mx = max(b for _, b in lo_hi)
            np.add.at(acc[r], dec, x.astype(u64))
            acc[r, 11] = u64(n) * x.astype(u64).sum(dtype=u64)
            rng_ = int(u64(mx) - u64(mn))
            passes = -(-rng_.bit_length() // 8)
            key = u64(mx) - x.astype(u64)
            ids = np.arange(n, dtype=np.int64)
            for ps in range(passes):
                dig = ((key >> u64(8 * ps)) & u64(BINS - 1)).astype(np.int64)
                counts = np.zeros((BINS, tpr), np.int64)           # H
                for t in range(tpr):
                    counts[:, t] = np.bincount(dig[t * tile:(t + 1) * tile],
                                               minlength=BINS)
                flat = counts.reshape(-1)                           # S
                offs = (np.cumsum(flat) - flat).reshape(BINS, tpr)
                new_key = np.empty_like(key)                        # X
                new_ids = np.empty_like(ids)
                for t in range(tpr):
                    run = offs[:, t].copy()
                    for q0 in range(t * tile, (t + 1) * tile, threads):
                        j = np.arange(q0, q0 + threads)
                        d = np.where(j < n, dig[np.minimum(j, n - 1)], BINS)
                        rank, wc = _warp_ranks(d, warp)
                        wbase = run[None, :] + np.cumsum(wc, 0) - wc
                        run += wc.sum(0)
                        ok = j < n
                        pos = (wbase[np.arange(threads) // warp, np.minimum(
                            d, BINS - 1)] + rank)[ok]
                        new_key[pos] = key[j[ok]]
                        new_ids[pos] = ids[j[ok]]
                key, ids = new_key, new_ids
            xs = (u64(mx) - key).astype(np.int64)                   # F
            d = np.arange(n)
            acc[r, 10] = np.sum(xs.astype(u64)
                                * (n - 1 - 2 * d).astype(u64), dtype=u64)
            top_idx[r] = ids[:k]
            top_val[r] = xs[:k]
            # the sorted row against the counts of the definition
            asc = np.sort(x)
            lt = np.searchsorted(asc, xs, "left")
            eq = np.searchsorted(asc, xs, "right") - lt
            gt = n - lt - eq
            first = np.searchsorted(-xs, -xs, "left")      # the run's start
            assert np.array_equal(first, gt)
            assert np.array_equal(d, gt + (d - first))
            same = xs[1:] == xs[:-1]
            assert (ids[1:][same] > ids[:-1][same]).all()
            assert acc[r, 10] == np.sum(xs.astype(u64)
                                        * (lt - gt).astype(u64), dtype=u64)
    acc = acc.view(np.int64)
    return {"deciles": acc[:, :10], "top_idx": top_idx, "top_val": top_val,
            "gini_num": acc[:, 10], "gini_den": acc[:, 11]}


#: the digest cases, and runs of equal values that straddle the tiles of
#: the schedule test (tile 64): 40 entries of each of 9 values
SCHEDULE_CASES = dict(DIGEST_CASES, straddle=(3, 360, 30, 0, 9))


@pytest.mark.parametrize("case", list(SCHEDULE_CASES))
def test_digest_kernel_schedule_equals_plain(case):
    p, n, k, lo, hi = SCHEDULE_CASES[case]
    stack, dec = _digest_inputs(len(case), p, n, lo, hi)
    if case == "straddle":
        stack = np.repeat(np.arange(lo, hi), n // (hi - lo))[None, :]
        stack = np.stack([stack[0], stack[0][::-1], 7 - stack[0] * 5])
        assert all(len(set(stack[r, 63:65])) == 1 for r in range(p))
    k = min(k, n)
    got = kernel_schedule(stack, dec, k, tile=64, threads=16, warp=8)
    want = kernels.health_digest_plain(torch.as_tensor(stack),
                                       torch.as_tensor(dec), k)
    _assert_digest_equal(got, {f: getattr(want, f).numpy()
                               for f in want._fields}, case)


# ---- health_round's traffic form: the split value sums ---------------------

def traffic_sums_schedule(planes, new_del, pull_del, v_birth, it, gates,
                          tile_nodes=32, word=4, slices=32, age_chunk=256):
    """Phase 1 of csrc/health_round.cu's traffic form in numpy: a block
    per (lane, ``tile_nodes`` nodes), its threads as words of ``word``
    nodes x ``slices`` value slices; a thread sums its values' packed
    bytes (del + resc, each 0-2) times the chunk's staged age it - v_birth
    + 1, and the slices meet per node, all in uint32 that wraps; then each
    plane is its input plus the sum (the lane gated out: its input)."""
    _, lat, dels, resc = (np.asarray(a, np.int64).astype(np.uint32)
                          for a in planes)
    K, V, N = new_del.shape
    d8 = new_del.astype(np.uint32)
    r8 = (pull_del.astype(np.uint32) if pull_del is not None
          else np.zeros_like(d8))
    out = [lat.copy(), dels.copy(), resc.copy()]
    with np.errstate(over="ignore"):
        for lane in range(K):
            if not gates[lane]:
                continue
            for node0 in range(0, N, tile_nodes):
                part = np.zeros((3, slices, tile_nodes), np.uint32)
                for v0 in range(0, V, age_chunk):
                    age = (np.uint32(it)
                           - v_birth[lane, v0:v0 + age_chunk].astype(
                               np.uint32) + np.uint32(1))
                    for j in range(v0, min(V, v0 + age_chunk)):
                        s = (j - v0) % slices
                        for w0 in range(0, tile_nodes, word):
                            nodes = np.arange(node0 + w0, node0 + w0 + word)
                            ok = nodes < N
                            a = np.zeros(word, np.uint32)
                            rr = np.zeros(word, np.uint32)
                            a[ok] = d8[lane, j, nodes[ok]] + r8[lane, j,
                                                                nodes[ok]]
                            rr[ok] = r8[lane, j, nodes[ok]]
                            sl = slice(w0, w0 + word)
                            part[0, s, sl] += a * age[j - v0]
                            part[1, s, sl] += a
                            part[2, s, sl] += rr
                tot = part.sum(1, dtype=np.uint32)
                hi = min(N, node0 + tile_nodes)
                for q in range(3):
                    out[q][lane, node0:hi] += tot[q, :hi - node0]
    return [o.view(np.int32) for o in out]


def pair_schedule(n_pruned, src, slot, row_gate, per, group=32):
    """Phase 2 of both forms in numpy: a warp per ``group`` pruner rows;
    where a row fires (n_pruned above 0, its lane gated in) its C slot
    bytes as 16-byte words (C / 16 lanes a row; bytes one by one where C
    is not a multiple of 16), src_sorted read at the set bytes, one count
    per pair on the prune plane of the row's group of ``per`` rows."""
    rows, n, c = slot.shape[0] * slot.shape[1], slot.shape[1], slot.shape[2]
    flat_slot = np.asarray(slot, np.uint8).reshape(-1)
    flat_src = np.asarray(src, np.int64).reshape(-1)
    npr = np.asarray(n_pruned).reshape(-1)
    cnt = np.zeros((slot.shape[0] // per, n), np.uint32)
    width = 16 if c % 16 == 0 else 1
    for g0 in range(0, rows, group):
        for i in range(g0, min(rows, g0 + group)):
            row = i // n
            if npr[i] <= 0 or not row_gate[row]:
                continue
            for w0 in range(i * c, (i + 1) * c, width):
                for b in np.flatnonzero(flat_slot[w0:w0 + width]):
                    u = flat_src[w0 + b]
                    if 0 <= u < n:
                        cnt[row // per, u] += np.uint32(1)
    return cnt


@pytest.mark.parametrize("c", [64, 12])
def test_traffic_split_sums_equal_plain(c):
    """The traffic form's split value sums and its pair walk, in numpy,
    equal ``health_round_traffic_plain``: 3 lanes (one gated out), V = 300
    values (two age chunks), N = 45 nodes (a ragged tile and word), the
    planes near 2^31 and ages near 2^22 so that the int32 sums wrap; the
    prune pairs with C = 64 (16-byte words) and C = 12 (bytes)."""
    r = np.random.default_rng(c)
    K, V, N = 3, 300, 45
    it = 5_000_000
    planes = [r.integers(2**31 - 4000, 2**31 - 1, (K, N)).astype(np.int32)
              for _ in range(4)]
    new_del = r.random((K, V, N)) < 0.4
    pull_del = (r.random((K, V, N)) < 0.3) & ~new_del
    v_birth = r.integers(0, 1_000, (K, V)).astype(np.int32)
    gates = np.array([1, 0, 1], np.int32)
    n_pruned_rows = K * V
    slot = r.random((n_pruned_rows, N, c)) < 0.05
    slot[r.random((n_pruned_rows, N)) < 0.7] = False
    n_pruned = slot.sum(-1).astype(np.int32)
    src = r.integers(0, N, (n_pruned_rows, N, c)).astype(np.int32)
    t = torch.as_tensor
    want = kernels.health_round_traffic_plain(
        *(t(a) for a in planes), t(new_del), t(pull_del), t(v_birth), it,
        t(n_pruned), t(src), t(slot), gates)
    sums = traffic_sums_schedule(planes, new_del, pull_del, v_birth, it,
                                 gates)
    pairs = pair_schedule(n_pruned, src, slot, np.repeat(gates, V), V)
    with np.errstate(over="ignore"):
        prune = (planes[0].view(np.uint32) + pairs).view(np.int32)
    got = [prune] + sums
    assert (want[1].numpy()[0] < planes[1][0]).any()     # the sums wrapped
    for name, g, w in zip(("prune", "lat", "del", "resc"), got, want):
        assert np.array_equal(g, w.numpy()), name
    assert pairs.sum() > 0 and not pairs[1].any()


def round_schedule(prune, first, n_pruned, src, slot, reached, its, gates,
                   geo):
    """csrc/health_round.cu's round form in numpy: a cluster of ``geo.cs``
    CTAs per row, CTA k owning nodes [k chunk, (k + 1) chunk) as pruners and
    as prunees; each CTA walks its firing pruners (gated lanes) by groups
    of 32, their slots by 16-byte words (bytes where C is not a multiple
    of 16), and adds one per pair to a count of its own (PLANE: a whole
    row's plane a CTA) or to the row's output plane (DEVICE); then each
    CTA writes its nodes' prune counts, summed over the cluster's planes
    (uint32 that wraps), and first-delivery stamps."""
    R, N, C = slot.shape
    k = np.asarray(its).size
    per = R // k
    out_prune = np.asarray(prune).astype(np.int64).astype(np.uint32)
    out_first = np.asarray(first).copy()
    width = 16 if C % 16 == 0 else 1
    for r in range(R):
        lane = r // per
        counts = np.zeros((geo.cs, geo.cs * geo.chunk), np.uint32)
        for cta in range(geo.cs):
            lo, hi = cta * geo.chunk, min(N, (cta + 1) * geo.chunk)
            if not gates[lane]:
                continue
            for g0 in range(lo, hi, 32):
                for t in range(g0, min(hi, g0 + 32)):
                    if n_pruned[r, t] <= 0:
                        continue
                    for w0 in range(0, C, width):
                        for b in np.flatnonzero(slot[r, t, w0:w0 + width]):
                            u = int(src[r, t, w0 + b])
                            if 0 <= u < N:
                                counts[cta if geo.mode == hr_mod.PLANE
                                       else 0, u] += 1
        with np.errstate(over="ignore"):
            out_prune[r] += counts.sum(0, dtype=np.uint32)[:N]
        stamp = np.int32(its[lane] + 1)
        hit = (out_first[r] == 0) & reached[r]
        out_first[r] = np.where(hit, stamp, out_first[r])
    return out_prune.view(np.int32), out_first


hr_mod = importlib.import_module("gossip_sim_tpu_torch.kernels.health_round")


@pytest.mark.parametrize("c,smem", [(64, 1024), (12, 1024), (64, 100)])
def test_round_cluster_schedule_equals_plain(c, smem):
    """The round form's clusters in numpy equal ``health_round_plain``: 3
    lanes x 2 origins (the middle lane gated out) of N = 45 nodes in
    clusters of 6 CTAs of 8 nodes, each CTA a whole plane (and, at 100
    bytes of shared memory, 8 CTAs of 6 nodes counting in the output
    plane; the last CTA's range ragged in both), prune planes near 2^31
    so that they wrap, C = 64 and 12."""
    r = np.random.default_rng(100 + c)
    R, N = 6, 45
    geo = hr_mod.round_geometry(R, N, 132, smem)
    assert (geo.cs, geo.chunk) == ((6, 8) if smem == 1024 else (8, 6))
    assert geo.mode == (hr_mod.PLANE if smem == 1024 else hr_mod.DEVICE)
    prune = r.integers(2**31 - 3, 2**31, (R, N)).astype(np.int32)
    first = np.where(r.random((R, N)) < 0.5, 0,
                     r.integers(1, 9, (R, N))).astype(np.int32)
    slot = r.random((R, N, c)) < 0.2
    slot[r.random((R, N)) < 0.3] = False
    n_pruned = slot.sum(-1).astype(np.int32)
    src = r.integers(0, N, (R, N, c)).astype(np.int32)
    reached = r.random((R, N)) < 0.6
    its = np.array([11, 12, 2**31 + 5], np.int64)
    gates = np.array([1, 0, 1], np.int32)
    t = torch.as_tensor
    want = kernels.health_round_plain(t(prune), t(first), t(n_pruned),
                                      t(src), t(slot), t(reached), its, gates)
    got = round_schedule(prune, first, n_pruned, src, slot, reached, its,
                         gates, geo)
    for name, g, w in zip(("prune", "first"), got, want):
        assert np.array_equal(g, w.numpy()), name
    assert (got[0][2:4] == prune[2:4]).all()
    assert (got[0] < 0).any()
