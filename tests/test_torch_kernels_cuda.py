"""On a CUDA device, each hand-written kernel equals its plain PyTorch
version on the inputs real engine rounds (and traffic rounds) give it.

Marked ``cuda``: without a device every test here skips (the CUDA kernels
have no CPU mode; their plain versions are held against the reference
package by tests/test_torch_kernels.py).  This file imports no JAX, so it
also runs on a machine with the card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerance: 0 everywhere (exact equality of every output tensor)."""

import importlib

import numpy as np
import pytest
import torch

from gossip_sim_tpu_torch import kernels, rng
from gossip_sim_tpu_torch.engine import (EngineParams, init_state,
                                         make_cluster_tables, round_step,
                                         run_rounds)
from gossip_sim_tpu_torch.engine.sampler import build_sampler_tables
from gossip_sim_tpu_torch.faults import edge_u32, rate_threshold
from gossip_sim_tpu_torch.pull import PULL_MISS_CAPPED

bfs_mod = importlib.import_module("gossip_sim_tpu_torch.kernels.bfs_relax")
rank_mod = importlib.import_module(
    "gossip_sim_tpu_torch.kernels.rank_inbound")
tf_mod = importlib.import_module("gossip_sim_tpu_torch.kernels.threefry")
pt_mod = importlib.import_module("gossip_sim_tpu_torch.kernels.push_targets")
rot_mod = importlib.import_module("gossip_sim_tpu_torch.kernels.rotate")
px_mod = importlib.import_module(
    "gossip_sim_tpu_torch.kernels.pull_exchange")
hr_mod = importlib.import_module("gossip_sim_tpu_torch.kernels.health_round")

pytestmark = pytest.mark.cuda

NAMES = ("bfs_relax", "rank_inbound", "rc_merge_prune", "prune_apply",
         "threefry", "push_targets", "rotate", "pull_exchange")
CONFIGS = {
    # full rotation + tiny insert cap: caches overflow and rows prune
    # more than 8 peers at round 19
    "overflow": (60, 2, 21, dict(warm_up_rounds=0, received_cap=2,
                                 rc_slots=16, probability_of_rotation=1.0)),
    "impaired": (2000, 4, 22, dict(
        warm_up_rounds=0, packet_loss_rate=0.1, churn_fail_rate=0.01,
        churn_recover_rate=0.2, partition_at=3, heal_at=12, impair_seed=5)),
    # a narrow inbound width so the ranking truncates
    "truncated": (3000, 3, 21, dict(warm_up_rounds=0, inbound_cap=4)),
    # an inbound width past the former 64-entry limit of rank_inbound
    "wide_inbound": (1500, 2, 21, dict(warm_up_rounds=0, inbound_cap=128)),
    # the one-shot failure draws one more uniform in its round
    "fail_nodes": (800, 2, 12, dict(warm_up_rounds=0, fail_at=6,
                                    fail_fraction=0.2)),
    # the widest shapes of the experiment harness's sweeps, at the batched
    # origin-rank sweep's O=16: an active set of 24, and a fanout of 12
    # (K = 24 inbound ranks, rc_merge_prune rows of C + K = 88)
    "wide_active_set": (2000, 16, 21, dict(warm_up_rounds=0,
                                           active_set_size=24)),
    "wide_fanout": (2000, 16, 21, dict(warm_up_rounds=0, push_fanout=12)),
    # the pull modes: push-pull with the request cap binding under loss +
    # partition + churn, pull alone, and adaptive (its bit turns on)
    "push_pull_capped": (2000, 4, 21, dict(
        warm_up_rounds=0, gossip_mode="push-pull", pull_fanout=4,
        pull_request_cap=2, packet_loss_rate=0.1, churn_fail_rate=0.01,
        churn_recover_rate=0.2, partition_at=3, heal_at=12, impair_seed=5)),
    "pull": (2000, 2, 21, dict(warm_up_rounds=0, gossip_mode="pull",
                               pull_interval=2)),
    "adaptive": (2000, 3, 21, dict(warm_up_rounds=0, gossip_mode="adaptive",
                                   adaptive_switch_threshold=0.5)),
    # the sparse layout (rc_merge_prune's sparse variant) under loss +
    # partition + churn
    "sparse_impaired": (2000, 4, 22, dict(
        warm_up_rounds=0, representation="sparse", packet_loss_rate=0.1,
        churn_fail_rate=0.01, churn_recover_rate=0.2, partition_at=3,
        heal_at=12, impair_seed=5)),
}


def _launches_per_run(params, rounds):
    """Kernel launches of ``rounds`` rounds: one per kernel and round, and
    ``threefry`` only in the fail round (the round key, its sub keys and
    sub key 0's uniforms: three draws); ``rotate`` draws verb 5's
    uniforms itself; ``pull_exchange`` runs in the pull modes only, and
    the sparse layout launches ``rc_merge_prune``'s sparse variant (its own
    count) in place of the dense kernel."""
    want = {name: rounds for name in NAMES}
    want["pull_exchange"] = rounds if params.has_pull else 0
    sparse = params.representation == "sparse"
    want["rc_merge_prune"] = 0 if sparse else rounds
    want["rc_merge_prune_sparse"] = rounds if sparse else 0
    n_fail = int(np.floor(np.float64(params.fail_fraction)
                          * params.num_nodes))
    fail_round = 0 <= params.fail_at < rounds and n_fail > 0
    want["threefry"] = 3 * int(fail_round)
    return want


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _outputs(x):
    """The output tensors of a kernel call (a gate's mask that is off is
    None in both versions, and left out)."""
    outs = tuple(x) if isinstance(x, tuple) else (x,)
    return tuple(t for t in outs if t is not None)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_kernels_equal_plain_on_engine_rounds(cuda, config):
    n, n_origins, rounds, kw = CONFIGS[config]
    stakes = np.random.default_rng(0).integers(1, 1 << 45,
                                               size=n).astype(np.int64)
    params = EngineParams(num_nodes=n, **kw)
    tables = make_cluster_tables(stakes, device=cuda)
    origins = torch.arange(n_origins, dtype=torch.int32, device=cuda)
    state = init_state(rng.prng_key(3, cuda), tables, origins, params)
    calls = {name: [] for name in NAMES}
    real = {name: getattr(kernels, name) for name in NAMES}

    def recorder(name):
        def rec(*args, **kw):
            calls[name].append((args, kw))
            return real[name](*args, **kw)
        return rec

    kernels.reset_launch_counts()
    for name in NAMES:
        setattr(kernels, name, recorder(name))
    try:
        _, rows = run_rounds(params, tables, origins, state, rounds)
    finally:
        for name in NAMES:
            setattr(kernels, name, real[name])
    assert {name: kernels.LAUNCHES[name]
            for name in NAMES + ("rc_merge_prune_sparse",)} == \
        _launches_per_run(params, rounds)
    for name in NAMES:
        plain = getattr(kernels, f"{name}_plain")
        for args, kw in calls[name]:
            _assert_equal(real[name](*args, **kw), plain(*args, **kw), name)
    if config == "overflow":
        assert int(rows["rc_overflow"].sum()) > 0
    if config == "truncated":
        assert int(rows["inb_dropped"].sum()) > 0
    if config == "wide_inbound":
        assert all(args[4] == 128 for args, _ in calls["rank_inbound"])
    if config == "wide_active_set":
        assert all(args[0].shape[-1] == 24 for args, _ in calls["rotate"])
    if config == "wide_fanout":
        assert all(args[4] == 24 for args, _ in calls["rank_inbound"])
        assert all(args[0].shape[-1] + args[5].shape[-1] == 88
                   for args, _ in calls["rc_merge_prune"])
    if config == "fail_nodes":
        assert int(rows["failed_count"][-1].sum()) > 0
    if config == "sparse_impaired":
        assert all(args[2] is None and args[3] is None
                   for args, _ in calls["rc_merge_prune"])
        assert int(rows["prunes_sent"].sum()) > 0


def test_only_the_fail_round_launches_threefry(cuda):
    """Round by round: an unimpaired round, and a churn, loss and
    partition round, launch no ``threefry`` kernel; the fail round
    launches three (its round key, sub keys and uniforms)."""
    n = 500
    stakes = np.random.default_rng(2).integers(1, 1 << 45,
                                               size=n).astype(np.int64)
    tables = make_cluster_tables(stakes, device=cuda)
    origins = torch.arange(3, dtype=torch.int32, device=cuda)
    for kw, fail_at in ((dict(), -1),
                        (dict(packet_loss_rate=0.1, churn_fail_rate=0.01,
                              churn_recover_rate=0.2, partition_at=1,
                              heal_at=4, impair_seed=3), -1),
                        (dict(fail_at=2, fail_fraction=0.2), 2)):
        params = EngineParams(num_nodes=n, warm_up_rounds=0, **kw)
        state = init_state(rng.prng_key(1, cuda), tables, origins, params)
        for it in range(4):
            kernels.reset_launch_counts()
            state, _ = round_step(params, tables, origins, state, it)
            assert kernels.LAUNCHES["threefry"] == (3 if it == fail_at
                                                     else 0), (kw, it)
            assert kernels.LAUNCHES["rotate"] == 1


def test_wrappers_check_their_inputs(cuda):
    tgt = torch.zeros((2, 10, 3), dtype=torch.int32, device=cuda)
    org = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        kernels.bfs_relax(tgt.long(), org)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.bfs_relax(tgt.transpose(1, 2).contiguous().transpose(1, 2),
                          org)
    with pytest.raises(ValueError, match="device"):
        kernels.bfs_relax(tgt, org.cpu())


def _assert_equal(got, want, what):
    got, want = _outputs(got), _outputs(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        assert torch.equal(g, w), what


def _random_edges(seed, o, n, f, p_none=0.3):
    """Seeded push targets: none to itself, a repeated peer of a source
    dropped to N (none), and a share ``p_none`` of the slots N."""
    r = np.random.default_rng(seed)
    peers = r.integers(0, n - 1, size=(o, n, f))
    src = np.arange(n)[None, :, None]
    tgt = (peers + (peers >= src)).astype(np.int32)
    srt = np.sort(tgt, axis=-1)
    dup = np.zeros_like(tgt, dtype=bool)
    dup[..., 1:] = srt[..., 1:] == srt[..., :-1]
    tgt = np.where(dup, n, srt).astype(np.int32)
    tgt[r.random((o, n, f)) < p_none] = n
    origins = r.choice(n, size=o, replace=o > n).astype(np.int32)
    return tgt, origins


def _path_edges(seed, o, n):
    """F = 1: each origin's graph is one path through a random order of
    the nodes, starting at the origin, so the BFS runs n - 1 hops."""
    r = np.random.default_rng(seed)
    tgt = np.full((o, n, 1), n, np.int32)
    origins = np.empty(o, np.int32)
    for i in range(o):
        order = r.permutation(n)
        tgt[i, order[:-1], 0] = order[1:]
        origins[i] = order[0]
    return tgt, origins


def _lane_edges(seed, n, f):
    """Eight rows (a lane batch of 8 x O=1) whose BFS runs unequal hop
    counts: rows 0-3 random edges with more and more slots empty, rows 4-7
    a path in slot 0 through the first 50, 200, 1000 and n nodes of a
    random order (the other slots empty)."""
    r = np.random.default_rng(seed)
    tgts, origins = [], []
    for p_none in (0.3, 0.6, 0.75, 0.8):
        t, o = _random_edges(int(r.integers(1 << 30)), 1, n, f, p_none)
        tgts.append(t[0])
        origins.append(o[0])
    for m in (50, 200, 1000, n):
        t = np.full((n, f), n, np.int32)
        order = r.permutation(n)[:m]
        t[order[:-1], 0] = order[1:]
        tgts.append(t)
        origins.append(order[0])
    return np.stack(tgts), np.asarray(origins, np.int32)


BFS_CASES = {
    # name: (edges, O, N, F, cluster size on a 132-SM card)
    "o1": ("random", 1, 1000, 6, 8),
    "o3_ragged": ("random", 3, 1001, 6, 8),
    "o32": ("random", 32, 2000, 6, 4),
    "o200": ("random", 200, 500, 6, 1),
    "n_below_threads": ("random", 3, 40, 6, 8),
    # state over the 48 KB default: ~160 KB of opt-in shared memory per CTA
    "opt_in_smem": ("random", 67, 200_000, 2, 1),
    "path_600_hops": ("path", 2, 600, 1, 8),
    # past the 16-bit hop counts of an earlier design, in shared memory
    "n_100k": ("random", 1, 100_000, 6, 8),
    "n_70k_o32": ("random", 32, 70_000, 6, 4),
    # the sparse layout's shape: O = 41 (the auto batch) at N = 100,000, in
    # clusters of 3
    "n_100k_o41": ("random", 41, 100_000, 6, 3),
    # the fanout sweep's widest F
    "f12_o16": ("random", 16, 10_000, 12, 8),
    # a lane batch of 8 rows with unequal hop counts
    "lanes_unequal_hops": ("lanes", 8, 10_000, 6, 8),
    # past a block's shared memory: the state goes to device memory
    "n_1m_scratch": ("random", 1, 1_000_000, 6, 8),
    "n_600k_o67_scratch": ("random", 67, 600_000, 2, 1),
}


def _bfs_edges(case, seed):
    kind, o, n, f, _ = BFS_CASES[case]
    if kind == "random":
        return _random_edges(seed, o, n, f)
    if kind == "lanes":
        return _lane_edges(seed, n, f)
    return _path_edges(seed, o, n)


@pytest.mark.parametrize("case", list(BFS_CASES))
def test_bfs_relax_equals_plain(cuda, case):
    kind, o, n, f, cs = BFS_CASES[case]
    assert bfs_mod.launch_geometry(o, n, 132, 232_448).cs == cs
    tgt, origins = _bfs_edges(case, 7)
    if case == "o3_ragged":
        tgt[1, origins[1]] = n                  # an origin with no targets
    t, org = torch.as_tensor(tgt, device=cuda), torch.as_tensor(
        origins, device=cuda)
    kernels.reset_launch_counts()
    got = kernels.bfs_relax(t, org)
    assert kernels.LAUNCHES["bfs_relax"] == 1
    want = kernels.bfs_relax_plain(t, org)
    _assert_equal(got, want, case)
    reached, dist = got
    if kind == "path":
        assert int(dist[reached].max()) == n - 1   # > 255 hops
    if kind == "lanes":
        hops = [int(dist[i][reached[i]].max()) for i in range(o)]
        assert len(set(hops)) >= 5 and max(hops) == n - 1, hops
    if case == "o3_ragged":
        assert int(reached[1].sum()) == 1 and int(dist[1, origins[1]]) == 0
    g = bfs_mod.geometry_for(o, n, cuda)
    assert g.cs <= cs and (o * g.cs <= 132 or g.cs == 1)
    assert (g.scratch_words > 0) == case.endswith("_scratch")


@pytest.mark.parametrize("case", ["o1", "o3_ragged", "o32", "o200",
                                  "path_600_hops", "n_100k_o41", "f12_o16",
                                  "lanes_unequal_hops"])
def test_bfs_relax_state_in_device_memory_equals_plain(cuda, case):
    """The device-memory variant of the kernel: the same launch with no
    shared memory for the state (the frontier list stays in shared
    memory)."""
    o, n = BFS_CASES[case][1:3]
    tgt, origins = _bfs_edges(case, 11)
    t, org = torch.as_tensor(tgt, device=cuda), torch.as_tensor(
        origins, device=cuda)
    g = bfs_mod.launch_geometry(o, n, torch.cuda.get_device_properties(
        cuda).multi_processor_count, 0, bfs_mod.max_clusters)
    assert g.smem == bfs_mod.list_bytes(n, g.cs) and g.scratch_words > 0
    kernels.reset_launch_counts()
    _assert_equal(bfs_mod._launch(t, org, g),
                  kernels.bfs_relax_plain(t, org), case)
    assert kernels.LAUNCHES["bfs_relax"] == 1


@pytest.mark.parametrize("case", ["o1", "n_100k_o41", "n_1m_scratch"])
def test_bfs_relax_latency_floor_reaches_nothing(cuda, case):
    """The latency floor (a measurement aid) runs the geometry's hops with
    an empty frontier: nothing reached, every dist 1 << 20, no launch
    counted."""
    o, n = BFS_CASES[case][1:3]
    tgt, origins = _bfs_edges(case, 5)
    t, org = torch.as_tensor(tgt, device=cuda), torch.as_tensor(
        origins, device=cuda)
    kernels.reset_launch_counts()
    reached, dist = bfs_mod._latency_floor(t, org, 12)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bfs_relax"] == 0
    assert not bool(reached.any())
    assert bool((dist == bfs_mod.INF).all())


def _merge_inputs(seed, c, k, o=2):
    """Seeded adversarial rc_merge_prune rows that keep the cache invariant
    (members sorted ascending and unique, then N; inbound sources unique
    per row).  Rows cycle through 0, C-1 and C members with no, all-new,
    all-member and mixed inbound sources, so merged rows hold 0, C-1, C and
    C+K entries; ranks 0/1 hit members (score bumps); upsert counters fire
    about half the rows; stakes take three `shi` values and repeat one
    `slo`, so ties fall through to `slo` and `src`."""
    r = np.random.default_rng(seed)
    n = 2 * (c + k) + 50
    hi = r.integers(0, 3, size=n)
    lo = r.integers(0, 1 << 31, size=n)
    lo[r.random(n) < 0.25] = 12345
    stakes = np.concatenate([(hi << 31) | lo, [0]]).astype(np.int64)
    shi = (stakes >> 31).astype(np.int32)
    slo = (stakes & 0x7FFFFFFF).astype(np.int32)
    rows = o * n
    rc_src = np.full((rows, c), n, np.int32)
    rc_score = np.zeros((rows, c), np.int32)
    rc_shi = np.zeros((rows, c), np.int32)
    rc_slo = np.zeros((rows, c), np.int32)
    inb = np.full((rows, k), n, np.int32)
    fills = (0, max(c - 1, 0), c)
    modes = ("none", "new", "hits", "mixed")
    for i in range(rows):
        mc = fills[i % 3] if i % 7 else int(r.integers(0, c + 1))
        mem = np.sort(r.choice(n, size=mc, replace=False))
        rc_src[i, :mc] = mem
        rc_score[i, :mc] = r.integers(0, 6, size=mc)
        rc_shi[i, :mc] = shi[mem]
        rc_slo[i, :mc] = slo[mem]
        mode = modes[(i // 3) % 4]
        if mode == "none":
            continue
        if mode == "hits":
            pool = mem
        elif mode == "new":
            pool = np.setdiff1d(np.arange(n), mem)
        else:
            pool = np.arange(n)
        nin = min(len(pool), k if i % 2 else int(r.integers(1, k + 1)))
        inb[i, :nin] = r.permutation(pool)[:nin]
    ups = r.choice([0, 18, 19, 20], size=rows).astype(np.int32)
    origins = r.choice(n, size=o, replace=False).astype(np.int32)
    planes = [x.reshape(o, n, -1) for x in (rc_src, rc_score, rc_shi,
                                            rc_slo)]
    return (*planes, ups.reshape(o, n), inb.reshape(o, n, k), shi, slo,
            stakes, origins)


@pytest.mark.parametrize("k", [4, 16, 64])
@pytest.mark.parametrize("c", [16, 64, 128, 256])
def test_rc_merge_prune_equals_plain_on_adversarial_rows(cuda, c, k):
    args = [torch.as_tensor(a, device=cuda) for a in _merge_inputs(c + k, c,
                                                                  k)]
    for cap in (50, c + k):
        kw = dict(received_cap=cap, min_num_upserts=20, min_ingress_nodes=2,
                  prune_stake_threshold=0.15)
        kernels.reset_launch_counts()
        got = kernels.rc_merge_prune(*args, **kw)
        assert kernels.LAUNCHES["rc_merge_prune"] == 1
        want = kernels.rc_merge_prune_plain(*args, **kw)
        _assert_equal(got, want, (c, k, cap))
        assert int(want.n_pruned.sum()) > 0
        assert bool((want.rc_upserts == 0).any())
        if cap == c + k:
            assert int(want.rc_overflow.sum()) > 0


def test_engine_runs_at_rc_slots_128(cuda):
    """rc_slots = 128 with the default k_inbound of 16 (a row of 144)."""
    n, n_origins, rounds = 600, 2, 22
    stakes = np.random.default_rng(1).integers(1, 1 << 45,
                                               size=n).astype(np.int64)
    params = EngineParams(num_nodes=n, warm_up_rounds=0, rc_slots=128)
    assert params.rc_slots + params.k_inbound == 144
    tables = make_cluster_tables(stakes, device=cuda)
    origins = torch.arange(n_origins, dtype=torch.int32, device=cuda)
    state = init_state(rng.prng_key(5, cuda), tables, origins, params)
    calls = []
    real = kernels.rc_merge_prune

    def recorder(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    kernels.rc_merge_prune = recorder
    try:
        run_rounds(params, tables, origins, state, rounds)
    finally:
        kernels.rc_merge_prune = real
    assert len(calls) == rounds
    for args, kw in calls:
        _assert_equal(real(*args, **kw),
                      kernels.rc_merge_prune_plain(*args, **kw), "rc128")


def test_rc_merge_prune_refuses_rows_beyond_shared_memory(cuda):
    c = 8192
    rc = torch.full((1, 4, c), 4, dtype=torch.int32, device=cuda)
    z = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    inb = torch.full((1, 4, 16), 4, dtype=torch.int32, device=cuda)
    tab = torch.zeros(5, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        kernels.rc_merge_prune(rc, rc, rc, rc, z, inb, tab, tab, tab.long(),
                               torch.zeros(1, dtype=torch.int32, device=cuda),
                               received_cap=50, min_num_upserts=20,
                               min_ingress_nodes=2, prune_stake_threshold=0.15)


# ---- rc_merge_prune, the sparse layout's variant --------------------------

def _sparse_merge_inputs(cuda, seed, o, n, c, k):
    """Seeded rc_merge_prune rows of the sparse layout (no stake planes),
    made on the card: each row keeps the cache invariant with 0 to C
    members (even node ids, sorted, unique) and takes no inbound source,
    members only (score bumps at ranks 0 and 1), new sources only (odd
    ids) or both in turn, 1 to K of them; upsert counters fire about half
    the rows; stakes take three ``shi`` values and repeat one ``slo``."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    i32 = torch.int32
    rnd = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=g,
                                              device=cuda, dtype=i32)
    hi = rnd(0, 3, (n,)).long()
    lo = rnd(0, 2**31 - 1, (n,)).long()
    lo = torch.where(rnd(0, 4, (n,)) == 0, 12345, lo)
    stakes = torch.cat([(hi << 31) | lo, lo.new_zeros(1)])
    shi = (stakes >> 31).to(i32)
    slo = (stakes & 0x7FFFFFFF).to(i32)
    rows = o * n
    m = rnd(0, c + 1, (rows,))
    m = torch.where(rnd(0, 3, (rows,)) == 0, c, m)        # full rows
    slot = torch.arange(c, device=cuda, dtype=i32)
    gaps = rnd(1, max(2, n // (2 * c) + 1), (rows, c))
    members = 2 * (torch.cumsum(gaps, -1, dtype=i32) - 1)
    rc_src = torch.where(slot < m[:, None], members, n).to(i32)
    del gaps, members
    rc_score = torch.where(rc_src < n, rnd(0, 6, (rows, c)), 0).to(i32)
    ranks = torch.arange(k, device=cuda, dtype=i32)
    start, step = rnd(0, n // 2, (rows, 1)), rnd(1, max(2, n // (2 * k)),
                                                (rows, 1))
    new = 2 * ((start + ranks * step) % (n // 2)) + 1     # odd, unique

    def member(j):  # the j-th member of each row (N past the row)
        got = rc_src.gather(1, j.clamp(max=c - 1)[None, :].expand(
            rows, -1).long())
        return torch.where((j < c)[None, :], got, n)

    mode = torch.arange(rows, device=cuda) % 4
    inb = torch.where((mode == 2)[:, None], new,
                      torch.where((ranks % 2 == 0)[None, :],
                                  member(ranks // 2), new))
    inb = torch.where((mode == 1)[:, None], member(ranks), inb)
    inb = torch.where((mode == 0)[:, None], n, inb)
    nin = rnd(1, k + 1, (rows, 1))
    inb = torch.where(ranks[None, :] < nin, inb, n)
    # the ranked sources first, then N (a rank past a row's members reads
    # its N)
    inb = inb.gather(1, torch.sort((inb >= n).to(torch.int8), dim=1,
                                   stable=True).indices)
    ups = torch.tensor([0, 18, 19, 20], device=cuda,
                       dtype=i32)[rnd(0, 4, (rows,)).long()]
    origins = torch.randperm(n, generator=g, device=cuda)[:o].to(i32)
    return (rc_src.reshape(o, n, c), rc_score.reshape(o, n, c),
            ups.reshape(o, n), inb.to(i32).reshape(o, n, k).contiguous(),
            shi, slo, stakes, origins)


SPARSE_MERGE_SHAPES = [(o, n) for n in (10_000, 100_000) for o in (1, 32, 41)]


@pytest.mark.parametrize("c,k", [(64, 16), (128, 16), (64, 128), (128, 128)])
@pytest.mark.parametrize("o,n", SPARSE_MERGE_SHAPES)
def test_rc_merge_prune_sparse_equals_plain_and_dense(cuda, o, n, c, k):
    """The sparse variant on rows that fire, at N = 10,000 and 100,000 and
    O = 1, 32 and 41 (up to 5.2e8 slots in a plane): equal to its plain
    version on the first, a middle and the last origin (the plain version
    holds an [N, K, C] comparison per origin), and on every origin to the
    dense kernel given the planes shi[rc_src] and slo[rc_src]."""
    rc_src, rc_score, ups, inb, shi, slo, stakes, origins = \
        _sparse_merge_inputs(cuda, o * 7 + c + k, o, n, c, k)
    kw = dict(received_cap=50, min_num_upserts=20, min_ingress_nodes=2,
              prune_stake_threshold=0.15)
    kernels.reset_launch_counts()
    got = kernels.rc_merge_prune(rc_src, rc_score, None, None, ups, inb, shi,
                                 slo, stakes, origins, **kw)
    assert kernels.LAUNCHES["rc_merge_prune_sparse"] == 1
    assert kernels.LAUNCHES["rc_merge_prune"] == 0
    assert got.rc_shi.shape == got.rc_slo.shape == (o, n, 0)
    src = rc_src.long()
    dense = kernels.rc_merge_prune(rc_src, rc_score, shi[src], slo[src], ups,
                                   inb, shi, slo, stakes, origins, **kw)
    del src
    for f in got._fields:
        if f not in ("rc_shi", "rc_slo"):
            assert torch.equal(getattr(got, f), getattr(dense, f)), f
    new_src = dense.rc_src.long()
    assert torch.equal(dense.rc_shi, shi[new_src])
    assert torch.equal(dense.rc_slo, slo[new_src])
    del dense, new_src
    assert int(got.n_pruned.sum()) > 0
    assert bool((got.rc_upserts == 0).any())
    for i in sorted({0, o // 2, o - 1}):
        one = lambda t: t[i:i + 1]
        want = kernels.rc_merge_prune_plain(
            one(rc_src), one(rc_score), None, None, one(ups), one(inb), shi,
            slo, stakes, one(origins), **kw)
        for f in got._fields:
            if f == "rc_overflow":
                assert torch.equal(got.rc_overflow[i:i + 1], want.rc_overflow)
            else:
                assert torch.equal(one(getattr(got, f)), getattr(want, f)), \
                    (i, f)
        del want


def test_rc_merge_prune_sparse_refuses_live_and_half_planes(cuda):
    """The sparse variant takes no live mask (the sparse layout has no
    traffic round), and a call passes both stake planes or neither."""
    rc_src, rc_score, ups, inb, shi, slo, stakes, origins = \
        _sparse_merge_inputs(cuda, 1, 2, 500, 16, 4)
    kw = dict(received_cap=50, min_num_upserts=20, min_ingress_nodes=2,
              prune_stake_threshold=0.15)
    live = torch.ones(2, dtype=torch.bool, device=cuda)
    kernels.reset_launch_counts()
    for fn in (kernels.rc_merge_prune, kernels.rc_merge_prune_plain):
        with pytest.raises(ValueError, match="no live mask"):
            fn(rc_src, rc_score, None, None, ups, inb, shi, slo, stakes,
               origins, live=live, **kw)
        with pytest.raises(ValueError, match="neither"):
            fn(rc_src, rc_score, rc_score, None, ups, inb, shi, slo, stakes,
               origins, **kw)
    assert kernels.LAUNCHES["rc_merge_prune_sparse"] == 0


# ---- threefry ------------------------------------------------------------

def _keys(cuda, seed, shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 1 << 32, (*shape, 2), generator=g,
                         dtype=torch.int64).to(cuda)


#: (op, arg): sizes below, at and past the 256-thread block, odd and even
TF_OPS = [("split", 1), ("split", 10), ("split", 257), ("bits", 1),
          ("bits", 7), ("bits", 256), ("bits", 1001), ("uniform", 2),
          ("uniform", 255), ("uniform", 20_001), ("fold_in", 0),
          ("fold_in", 0x696E6974)]


@pytest.mark.parametrize("part", [True, False],
                         ids=["partitionable", "original"])
def test_threefry_equals_plain(cuda, part):
    base = _keys(cuda, 1, (5, 10))
    batches = {
        "one_key": base[0, 0],
        "o_keys": base[:, 0],
        "o_t_slice": base[:, 2:2 + 6],          # subs[:, 2:2+T], in place
        "broadcast": base[1, 1][None, :].expand(4, 2),
        "three_dims": base.reshape(5, 2, 5, 2)[:, :, 1:4],
    }
    for what, keys in batches.items():
        for op, arg in TF_OPS:
            kernels.reset_launch_counts()
            got = kernels.threefry(keys, op, arg, part)
            assert kernels.LAUNCHES["threefry"] == 1
            _assert_equal(got, tf_mod.threefry_plain(keys, op, arg, part),
                          (what, op, arg))
    # a per-key fold_in counter, as init_state folds in the origins
    keys = base[:, 3]
    data = torch.arange(5, dtype=torch.int32, device=cuda) * 977 + 3
    _assert_equal(kernels.threefry(keys, "fold_in", data, part),
                  tf_mod.threefry_plain(keys, "fold_in", data, part),
                  "per-key counter")
    inner = torch.arange(6, device=cuda) * 31
    _assert_equal(kernels.threefry(base[:, 2:8], "fold_in", inner, part),
                  tf_mod.threefry_plain(base[:, 2:8], "fold_in", inner,
                                        part), "broadcast counter")


def test_threefry_past_the_grid_of_keys(cuda):
    """More keys than a grid's 65,535 rows of blocks: the kernel walks the
    rest of the keys in a loop."""
    keys = _keys(cuda, 2, (70_000,))
    for part in (True, False):
        for op, arg in (("uniform", 3), ("split", 2), ("fold_in", 5)):
            _assert_equal(kernels.threefry(keys, op, arg, part),
                          tf_mod.threefry_plain(keys, op, arg, part),
                          (op, part))


def test_rng_routes_every_draw_to_the_kernel(cuda):
    from gossip_sim_tpu_torch import rng as trng
    key = trng.prng_key(11, cuda)
    kernels.reset_launch_counts()
    k2 = trng.fold_in(key, 3)
    subs = trng.split(k2[None, :], 4)
    trng.uniform(subs[:, 1:3], (7, 2))
    trng.random_bits(subs[:, 0], 9)
    assert kernels.LAUNCHES["threefry"] == 4


# ---- rank_inbound ----------------------------------------------------------

def _skewed_edges(seed, o, n, f, p_none=0.1):
    """Seeded push targets skewed towards low node ids, so some targets
    take segments far longer than a warp; none to itself, repeats of a
    source dropped to N."""
    r = np.random.default_rng(seed)
    peers = (r.random((o, n, f)) ** 4 * (n - 1)).astype(np.int64)
    src = np.arange(n)[None, :, None]
    tgt = (peers + (peers >= src)).astype(np.int32)
    srt = np.sort(tgt, axis=-1)
    dup = np.zeros_like(tgt, dtype=bool)
    dup[..., 1:] = srt[..., 1:] == srt[..., :-1]
    tgt = np.where(dup, n, srt).astype(np.int32)
    tgt[r.random((o, n, f)) < p_none] = n
    reached = r.random((o, n)) < 0.9
    hop1 = r.integers(1, 64, size=(o, n)).astype(np.int32)
    return tgt, (tgt < n) & reached[:, :, None], hop1


RANK_CASES = {
    # name: (O, N, K); the counts of every case up to n_300k fit shared
    # memory, the last two do not (see the geometry assertion)
    "o1_k4": (1, 3000, 4),
    "o3_k16": (3, 5000, 16),
    "o32_k16": (32, 10_000, 16),
    "o2_k128": (2, 4000, 128),
    "o5_k256": (5, 4000, 256),
    "o200_k16": (200, 300, 16),
    "tiny_n": (3, 5, 16),
    # N * F not a multiple of 4: edges read one at a time, not four
    "odd_edges": (3, 3001, 16),
    "n_300k_scratch": (1, 300_000, 16),
    "n_150k_o32_k128_scratch": (32, 150_000, 128),
}


def _rank_inputs(cuda, seed, o, n, f=6):
    tgt, delivered, hop1 = _skewed_edges(seed, o, n, f)
    return (torch.as_tensor(tgt, device=cuda),
            torch.as_tensor(delivered, device=cuda),
            torch.as_tensor(hop1, device=cuda))


@pytest.mark.parametrize("case", list(RANK_CASES))
def test_rank_inbound_equals_plain(cuda, case):
    o, n, k = RANK_CASES[case]
    t, d, h = _rank_inputs(cuda, 5, o, n)
    pb = max(n - 1, 1).bit_length()
    kernels.reset_launch_counts()
    got = kernels.rank_inbound(t, d, h, pb, k)
    assert kernels.LAUNCHES["rank_inbound"] == 1
    want = kernels.rank_inbound_plain(t, d, h, pb, k)
    _assert_equal(got, want, case)
    if n > 100:
        assert int(want[1].max()) > 32             # a segment past a warp
    g = rank_mod.launch_geometry(o, n, k, 132, 232_448)
    assert (g.scratch_words > 0) == case.endswith("_scratch")


@pytest.mark.parametrize("cs", range(1, 9))
def test_rank_inbound_every_cluster_size_equals_plain(cuda, cs):
    """Any number of CTAs per origin (the wrapper takes the most whose
    clusters the card holds in one wave, not only powers of two)."""
    o, n, k = RANK_CASES["o3_k16"]
    t, d, h = _rank_inputs(cuda, 9, o, n)
    pb = max(n - 1, 1).bit_length()
    g = rank_mod.shape(o, n, k, cs, 232_448)
    _assert_equal(rank_mod._launch(t, d, h, pb, k, g),
                  kernels.rank_inbound_plain(t, d, h, pb, k), cs)


@pytest.mark.parametrize("case", ["o1_k4", "o3_k16", "o2_k128", "o5_k256",
                                  "o200_k16", "tiny_n", "odd_edges"])
def test_rank_inbound_state_in_device_memory_equals_plain(cuda, case):
    """The device-memory variant at small shapes: the launch of a card
    whose shared memory holds the selection buffers only."""
    o, n, k = RANK_CASES[case]
    t, d, h = _rank_inputs(cuda, 6, o, n)
    pb = max(n - 1, 1).bit_length()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    limit = 4 * (rank_mod.MISC_WORDS + 4 * rank_mod.warp_buffer_words(k))
    g = rank_mod.launch_geometry(o, n, k, sms, limit)
    assert g.scratch_words > 0 and g.threads == 128
    _assert_equal(rank_mod._launch(t, d, h, pb, k, g),
                  kernels.rank_inbound_plain(t, d, h, pb, k), case)


@pytest.mark.parametrize("case", ["o1_k4", "o3_k16", "o32_k16", "o5_k256"])
def test_rank_inbound_csr_past_shared_memory_equals_plain(cuda, case):
    """Slices whose keys do not fit the CSR room of shared memory keep them
    in device memory: no room at all, and a room that the slices of the
    skewed targets outgrow while the others fit."""
    o, n, k = RANK_CASES[case]
    t, d, h = _rank_inputs(cuda, 8, o, n)
    pb = max(n - 1, 1).bit_length()
    g = rank_mod.launch_geometry(o, n, k, 132, 232_448)
    want = kernels.rank_inbound_plain(t, d, h, pb, k)
    per_slice = int(want[1].sum()) // (o * g.cs)
    for cap in (0, per_slice):
        small = g._replace(csr_cap=cap, smem=g.smem - 4 * (g.csr_cap - cap))
        _assert_equal(rank_mod._launch(t, d, h, pb, k, small), want,
                      (case, cap))


def _device_kernels(fn):
    """Names of the device activities (kernels, memsets, copies) that one
    call of ``fn`` records under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def test_rank_inbound_is_one_launch_per_call(cuda):
    t, d, h = _rank_inputs(cuda, 7, 4, 2000)
    names = _device_kernels(lambda: kernels.rank_inbound(t, d, h, 11, 16))
    assert len(names) == 1 and "rank_inbound_kernel" in names[0], names
    keys = _keys(cuda, 3, (4, 8))
    names = _device_kernels(
        lambda: kernels.threefry(keys[:, 2:6], "uniform", 1000, True))
    assert len(names) == 1 and "threefry_kernel" in names[0], names


# Defined here, right after the first profiler test: with torch 2.11 on an
# H100, a process's torch.profiler sessions stopped recording device events
# some 45 s after its first session, and the large-shape tests below take
# longer than that.
def test_verb_kernels_are_one_launch_and_a_memset(cuda):
    r = np.random.default_rng(9)
    active, pruned, tfail, origins = _active_rows(r, 4, 3000, 12, cuda)
    side = torch.zeros(3001, dtype=torch.int32, device=cuda)
    names = _device_kernels(lambda: kernels.push_targets(
        active, pruned, tfail, origins, side, 6, True, (5, 1 << 31)))
    assert len(names) == 1 and "push_targets_kernel" in names[0], names
    args = _rotate_inputs(r, 4, 3000, 12, cuda)
    names = _device_kernels(lambda: kernels.rotate(*args, 0.5, 8, True))
    assert len(names) == 2, names
    assert any("memset" in name.lower() for name in names), names
    assert any("rotate_kernel" in name for name in names), names


def test_traffic_send_is_one_launch_and_a_memset_when_capped(cuda):
    """Egress cap off: the kernel alone; on: a memset of the look-back
    scratch and the kernel (one count on the wrapper either way)."""
    args = _send_inputs(cuda, 3, 70, 1000, 12) + (6,)
    for cap, want in ((0, 1), (9, 2)):
        kernels.reset_launch_counts()
        names = _device_kernels(lambda: kernels.traffic_send(
            *args, cap, partition=True, loss=(5, 1 << 30)))
        assert kernels.LAUNCHES["traffic_send"] == 2       # warm-up + one
        assert len(names) == want, names
        assert any("traffic_send_kernel" in name for name in names), names
        if want == 2:
            assert any("memset" in name.lower() for name in names), names


def _active_rows(r, o, n, s, cuda):
    """Seeded active-set rows of any content the kernels take: peers
    (repeats and the node itself included), a tenth of the slots empty
    (N), the origin in some rows, a fifth of the slots pruned and a tenth
    failed."""
    origins = r.choice(n, size=o, replace=o > n).astype(np.int32)
    active = r.integers(0, n, size=(o, n, s)).astype(np.int32)
    active[r.random((o, n, s)) < 0.1] = n
    at_origin = r.random((o, n, s)) < 0.02
    active[at_origin] = np.broadcast_to(origins[:, None, None],
                                        active.shape)[at_origin]
    t = lambda a: torch.as_tensor(a, device=cuda)
    return (t(active), t(r.random((o, n, s)) < 0.2),
            t(r.random((o, n, s)) < 0.1), t(origins))


VERB_SHAPES = [(1, 10_000), (32, 10_000), (1, 100_000), (32, 100_000)]
#: push_targets' tiles against its one-wave grid: fewer tiles than blocks
#: (one each, nothing prefetched), a ragged last tile, and 25,000 tiles
#: (some 20 per block)
PUSH_SHAPES = VERB_SHAPES + [(1, 1000), (3, 10_001)]
#: (partition window, loss rate): None = the gate is off; every pair of
#: gates present or absent (the kernel's four instantiations)
PUSH_GATES = {"none": (None, None), "partition_loss": (True, 0.3),
              "window_off_loss_all": (False, 1.0),
              "partition_only": (True, None), "loss_only": (None, 0.3)}


@pytest.mark.parametrize("gates", list(PUSH_GATES))
@pytest.mark.parametrize("o,n", PUSH_SHAPES)
def test_push_targets_equals_plain(cuda, o, n, gates):
    partition, rate = PUSH_GATES[gates]
    rows, smem = pt_mod.launch_geometry(12, 6, 232_448)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    tiles, grid = pt_mod.persistent_grid(o * n, rows, sms, pt_mod.blocks_per_sm(
        cuda, rows, smem, partition is not None, rate is not None))
    assert tiles % grid != 0 or tiles == grid
    r = np.random.default_rng(o * 7 + n)
    active, pruned, tfail, origins = _active_rows(r, o, n, 12, cuda)
    side = torch.as_tensor(r.integers(0, 2, size=n + 1).astype(np.int32),
                           device=cuda)
    loss = None if rate is None else (0x9E3779B1 + n, rate_threshold(rate))
    kernels.reset_launch_counts()
    got = kernels.push_targets(active, pruned, tfail, origins, side, 6,
                               partition, loss)
    assert kernels.LAUNCHES["push_targets"] == 1
    want = kernels.push_targets_plain(active, pruned, tfail, origins, side,
                                      6, partition, loss)
    _assert_equal(got, want, gates)
    tgt, sup, drop = got
    assert (sup is None) == (partition is None)
    assert (drop is None) == (loss is None)
    if gates == "window_off_loss_all":
        assert not bool((tgt < n).any()) and bool(drop.any())
        assert not bool(sup.any())
    if gates == "partition_loss":
        assert bool(sup.any()) and bool(drop.any()) and bool((tgt < n).any())
    if gates == "loss_only":
        assert bool(drop.any()) and bool((tgt < n).any())


def test_push_targets_push_off_equals_plain(cuda):
    """The pull-only mode: no slot is valid, every target is N."""
    r = np.random.default_rng(9)
    active, pruned, tfail, origins = _active_rows(r, 32, 10_000, 12, cuda)
    side = torch.as_tensor(r.integers(0, 2, size=10_001).astype(np.int32),
                           device=cuda)
    args = (active, pruned, tfail, origins, side, 6, True,
            (123, rate_threshold(0.3)))
    got = kernels.push_targets(*args, push_on=False)
    _assert_equal(got, kernels.push_targets_plain(*args, push_on=False),
                  "push off")
    assert not bool((got[0] < 10_000).any())
    assert not bool(got[1].any()) and not bool(got[2].any())


#: (O, N, knobs) of the pull exchange: the request cap off, binding (1, 2)
#: and loose (64), partition window on and off, loss, the adaptive bit,
#: an off-interval round, O = 1, 16, 32, 64 and 200 at N = 10,000 (one
#: case for each cluster size the launch geometry picks: 16, 8, 4, 2, 1;
#: at O = 200 with the cap on the kept draws take clusters of 2), an N
#: that no cluster size divides, and the per-peer words in device memory
#: (the launch of a card whose shared memory holds the class tables only)
PULL_CASES = {
    "o1": (1, 10_000, dict(cap=0)),
    "o64_cap2_impaired": (64, 10_000, dict(cap=2, partition=True,
                                           loss=0.1)),
    "o8_cap1_window_off": (8, 10_000, dict(cap=1, partition=False,
                                           loss=0.3, fanout=8)),
    "o4_cap64_adaptive": (4, 3000, dict(cap=64, adaptive=True)),
    "o3_off_interval": (3, 3000, dict(pull_on=False)),
    "o2_state_in_device_memory": (2, 40_000, dict(cap=2, loss=0.1)),
    "o5_tiny": (5, 3, dict(cap=1, fanout=8)),
    "o1_cap2_impaired": (1, 10_000, dict(cap=2, partition=True, loss=0.1)),
    "o16_impaired": (16, 10_000, dict(partition=True, loss=0.1)),
    "o32_impaired": (32, 10_000, dict(partition=True, loss=0.1)),
    "o64_impaired": (64, 10_000, dict(partition=True, loss=0.1)),
    "o200": (200, 10_000, dict(loss=0.1)),
    "o200_cap2": (200, 10_000, dict(cap=2, partition=True)),
    "o3_n10007_cap2": (3, 10_007, dict(cap=2, loss=0.1, adaptive=True)),
    "o3_n10007_state_in_device_memory": (3, 10_007, dict(cap=1)),
}
#: the cluster size each case's launch geometry takes on an H100 (1,024
#: threads a CTA, one CTA an SM: it holds 7 clusters of 16, 15 of 8, 30
#: of 4 and 66 of 2)
PULL_CLUSTER = {"o1": 16, "o1_cap2_impaired": 16, "o16_impaired": 4,
                "o32_impaired": 2, "o64_impaired": 2, "o64_cap2_impaired": 2,
                "o200": 1, "o200_cap2": 2}


def _pull_inputs(cuda, o, n, kw):
    r = np.random.default_rng(o * 31 + n)
    stakes = r.integers(1, 1 << 45, size=n).astype(np.int64)
    tables = make_cluster_tables(stakes, device=cuda)
    sm = tables.sampler
    t = lambda a: torch.as_tensor(a, device=cuda)
    reached = t(r.random((o, n)) < 0.6)
    dist = t(r.integers(0, 12, (o, n)).astype(np.int32))
    failed = t(r.random((o, n)) < 0.05)
    adaptive = t(r.random(o) < 0.5) if kw.get("adaptive") else None
    loss = kw.get("loss")
    args = (reached, dist, failed, tables.side, sm.perm, sm.class_start,
            sm.class_count, sm.class_cdf[-1].contiguous(), adaptive)
    knobs = dict(fanout=kw.get("fanout", 2), slots=8,
                 pull_on=kw.get("pull_on", True), bases=(7 + n, 9 + o, 11),
                 bloom_threshold=rate_threshold(0.1), cap=kw.get("cap", 0),
                 partition=kw.get("partition"),
                 loss=None if loss is None else (77, rate_threshold(loss)))
    return args, knobs


@pytest.mark.parametrize("case", list(PULL_CASES))
def test_pull_exchange_equals_plain(cuda, case):
    o, n, kw = PULL_CASES[case]
    args, knobs = _pull_inputs(cuda, o, n, kw)
    kernels.reset_launch_counts()
    if case.endswith("_state_in_device_memory"):
        g = px_mod.launch_geometry(o, n, knobs["fanout"], knobs["cap"], 132,
                                   4 * px_mod.MISC_WORDS)
        assert g.scratch_words > 0
        got = px_mod._launch(*args, g, **knobs)
    else:
        got = kernels.pull_exchange(*args, **knobs)
        g = px_mod.geometry_for(o, n, knobs["fanout"], knobs["cap"], cuda)
        assert g.cs == PULL_CLUSTER.get(case, g.cs)
        assert g.scratch_words == 0
    assert kernels.LAUNCHES["pull_exchange"] == 1
    want = kernels.pull_exchange_plain(*args, **knobs)
    _assert_equal(tuple(got), tuple(want), case)
    if knobs["pull_on"]:
        assert int(got.counts[:, 0].sum()) > 0
    else:
        assert int(got.counts.abs().sum()) == 0


@pytest.mark.parametrize("rising", [True, False])
def test_pull_exchange_class_draw_at_the_cdf_edges(cuda, rising):
    """The class draw's compare u >= cdf[c] (the kernel's integer
    thresholds): a CDF whose entries are the class uniforms of 24 of the
    round's draws (equality), then as many one ulp above, and the same
    CDF shuffled so that it does not rise (the kernel's linear count)."""
    o, n = 3, 5003
    args, knobs = _pull_inputs(cuda, o, n, dict(cap=2, loss=0.1, fanout=4))
    b_cls = knobs["bases"][0]
    ks = sorted({edge_u32(b_cls, node, slot) >> 8
                 for node in range(0, n, 97) for slot in range(4)})
    pick = np.array(ks[::max(1, len(ks) // 24)][:24], dtype=np.float64)
    assert len(pick) == 24
    at = (pick * 2.0 ** -24).astype(np.float32)
    for cdf24 in (at, np.nextafter(at, np.float32(2.0))):
        cdf = np.concatenate([np.sort(cdf24), [1.0]]).astype(np.float32)
        if not rising:
            cdf[:24] = np.random.default_rng(5).permutation(cdf[:24])
        a = args[:7] + (torch.as_tensor(cdf, device=cuda),) + args[8:]
        _assert_equal(tuple(kernels.pull_exchange(*a, **knobs)),
                      tuple(kernels.pull_exchange_plain(*a, **knobs)),
                      rising)


@pytest.mark.parametrize("cs", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("keep", [True, False])
def test_pull_exchange_every_cluster_size_equals_plain(cuda, cs, keep):
    """Every cluster size with the draws kept and drawn again, at an N
    that no size above 1 divides, the cap binding under partition and
    loss."""
    o, n = 3, 5003
    args, knobs = _pull_inputs(cuda, o, n, dict(cap=2, partition=True,
                                                loss=0.1, fanout=4))
    g = px_mod.shape(o, n, 4, 2, cs, keep=keep)
    assert (g.draw_words > 0) == keep
    _assert_equal(tuple(px_mod._launch(*args, g, **knobs)),
                  tuple(kernels.pull_exchange_plain(*args, **knobs)),
                  (cs, keep))


@pytest.mark.parametrize("case", [c for c in PULL_CASES
                                  if c.endswith("_state_in_device_memory")])
def test_traced_pull_exchange_state_in_device_memory_equals_plain(cuda, case):
    """The traced build with the per-peer words in device memory: its
    ``trace_peers`` and ``trace_code`` (the capped codes read back from
    the scratch words) equal the plain version's."""
    o, n, kw = PULL_CASES[case]
    args, knobs = _pull_inputs(cuda, o, n, kw)
    g = px_mod.launch_geometry(o, n, knobs["fanout"], knobs["cap"], 132,
                               4 * px_mod.MISC_WORDS)
    assert g.scratch_words > 0
    kernels.reset_launch_counts()
    got = px_mod._launch(*args, g, trace=True, **knobs)
    assert kernels.LAUNCHES["pull_exchange"] == 1
    want = kernels.pull_exchange_plain(*args, trace=True, **knobs)
    assert got.trace_code is not None and want.trace_code is not None
    _assert_equal(tuple(got), tuple(want), case)
    assert bool((got.trace_code == PULL_MISS_CAPPED).any())


@pytest.mark.parametrize("cs", [1, 4, 16])
@pytest.mark.parametrize("keep", [True, False])
def test_traced_pull_exchange_every_cluster_size_equals_plain(cuda, cs, keep):
    """The traced build with the cap binding, the draws kept and drawn
    again: its trace outputs equal the plain version's."""
    o, n = 3, 5003
    args, knobs = _pull_inputs(cuda, o, n, dict(cap=1, partition=True,
                                                loss=0.1, fanout=4))
    g = px_mod.shape(o, n, 4, 1, cs, keep=keep)
    assert (g.draw_words > 0) == keep
    got = px_mod._launch(*args, g, trace=True, **knobs)
    want = kernels.pull_exchange_plain(*args, trace=True, **knobs)
    _assert_equal(tuple(got), tuple(want), (cs, keep))
    assert bool((got.trace_code == PULL_MISS_CAPPED).any())


@pytest.mark.parametrize("o,n,s", [(20, 700, 1000), (3, 1001, 7)])
def test_push_targets_unaligned_tiles_equal_plain(cuda, o, n, s):
    """Tiles whose slot spans are not 16-byte aligned go byte by byte: 19
    rows of S = 1000 per tile (737 tiles), and S = 7 with a ragged last
    tile of 59 rows."""
    r = np.random.default_rng(o + n + s)
    active, pruned, tfail, origins = _active_rows(r, o, n, s, cuda)
    side = torch.as_tensor(r.integers(0, 2, size=n + 1).astype(np.int32),
                           device=cuda)
    loss = (0x1234567 + n, rate_threshold(0.3))
    for partition in (None, True):
        got = kernels.push_targets(active, pruned, tfail, origins, side, 6,
                                   partition, loss)
        _assert_equal(got, kernels.push_targets_plain(
            active, pruned, tfail, origins, side, 6, partition, loss),
            (s, partition))
    rows, _ = pt_mod.launch_geometry(s, 6, 232_448)
    assert (rows * s) % 16 != 0 or (o * n) % rows != 0


#: (S, T, rotation probability)
ROTATE_CASES = {"s12_t8_p1": (12, 8, 1.0), "s25_t1_p1": (25, 1, 1.0),
                "s12_t8_p0": (12, 8, 0.0), "s25_t8_half": (25, 8, 0.5),
                "s12_t32_p1": (12, 32, 1.0)}
#: (O, N): the engine's shapes, an odd N (the original layout's zero pad),
#: N below the 128 rows of a block, whose blocks span many origins, and an
#: all-origins batch of 64 at N = 500, whose blocks span two
ROTATE_SHAPES = VERB_SHAPES + [(3, 10_001), (5, 40), (40, 1), (7, 127),
                               (64, 500)]


def _rotate_inputs(r, o, n, s, cuda):
    """Seeded verb 5 inputs: active-set rows (_active_rows), stake buckets
    and their class tables, failed nodes and the origins' threefry keys."""
    active, pruned, tfail, origins = _active_rows(r, o, n, s, cuda)
    buckets = r.integers(0, 25, size=n).astype(np.int32)
    sm = build_sampler_tables(buckets, cuda)
    dev = lambda a: torch.as_tensor(a, device=cuda)
    failed = dev(r.random((o, n)) < 0.2)
    key = dev(r.integers(0, 1 << 32, size=(o, 2), dtype=np.int64))
    it = int(r.integers(0, 1000))
    return (active, pruned, tfail, failed, key, it, origins, dev(buckets),
            sm.perm, sm.class_start, sm.class_count, sm.class_cdf)


def _at_the_edges(args, tries, prob, part, r):
    """``_rotate_inputs``' args with the class tables aimed at this call's
    own draws (``draws_plain``), so that the sampler meets its edges: the
    first try's class uniform of up to six rotating rows per entry is made
    a CDF value of the row's entry (the ``u >= cdf[j]`` compare at
    equality), and each class that those tries land in gets the count under
    which one of their member uniforms times the count lies closest below
    an integer (the f32 product that may round up onto it, then the floor
    and the cap at the class's last member).  Returns the args and the
    number of uniforms placed on a CDF value."""
    (active, pruned, tfail, failed, key, it, origins, buckets, perm, start,
     count, cdf) = args
    o, n, _ = active.shape
    rot_u, u_all = rot_mod.draws_plain(key, it, n, tries, part)
    rows = r.permutation(np.flatnonzero(rot_u.cpu().numpy().ravel() < prob))
    if tries == 0 or rows.size == 0:
        return args, 0
    u0 = u_all[:, 0].cpu().numpy().reshape(o * n, 2)   # try 0: (class, member)
    b = buckets.cpu().numpy()
    k = np.minimum(b[None, :], b[origins.cpu().numpy()][:, None]).ravel()
    cdf_np = cdf.cpu().numpy().copy()
    hit = 0
    for kk in np.unique(k[rows]):
        mine = rows[k[rows] == kk][:6]
        cdf_np[kk, r.choice(24, size=mine.size, replace=False)] = u0[mine, 0]
        cdf_np[kk, :24] = np.sort(cdf_np[kk, :24])
        hit += mine.size
    cls = (u0[rows, 0][:, None] >= cdf_np[k[rows], :24]).sum(-1)
    count_np = count.cpu().numpy().copy()
    # exact in f64: a 24-bit significand times a count of at most 18 bits
    counts = np.arange(1, max(n, 2) + 1, dtype=np.float64)
    for c in np.unique(cls):
        prod = np.float64(u0[rows[cls == c][0], 1]) * counts
        below = np.ceil(prod) - prod
        below[below == 0] = 2.0
        count_np[c] = int(counts[np.argmin(below)])
    dev = active.device
    return (args[:10] + (torch.as_tensor(count_np, device=dev),
                         torch.as_tensor(cdf_np, device=dev))), hit


#: every case at every shape, but T = 32 only up to O=32, N=10,000 (the
#: plain version's [O, N, T, 24] class compare grows past 10 GB beyond)
ROTATE_PARAMS = [(o, n, case) for o, n in ROTATE_SHAPES
                 for case in ROTATE_CASES
                 if ROTATE_CASES[case][1] < 32 or o * n <= 320_000]


@pytest.mark.parametrize("part", [True, False],
                         ids=["partitionable", "original"])
@pytest.mark.parametrize("o,n,case", ROTATE_PARAMS)
def test_rotate_equals_plain(cuda, o, n, case, part):
    s, t, prob = ROTATE_CASES[case]
    r = np.random.default_rng(o + n + s + t)
    args, hit = _at_the_edges(_rotate_inputs(r, o, n, s, cuda), t, prob,
                              part, r)
    assert hit > 0 or prob == 0.0
    kernels.reset_launch_counts()
    got = kernels.rotate(*args, prob, t, part)
    assert kernels.LAUNCHES["rotate"] == 1
    _assert_equal(got, kernels.rotate_plain(*args, prob, t, part), case)
    moved = int((got[0] != args[0]).any(-1).sum())
    if n > 1:
        assert moved == 0 if prob == 0.0 else moved > 0
    g = rot_mod.launch_geometry(s, t, n, o, 232_448)
    assert g.key_bytes >= rot_mod.key_origins(g.rows, n, o) * (t + 1) * 8


@pytest.mark.parametrize("it", [2**31 - 1, 2**31 + 5, 2**32 + 3])
def test_rotate_folds_the_iteration_mod_2_32(cuda, it):
    """``fold_in`` takes the iteration's low 32 bits, in both versions."""
    r = np.random.default_rng(4)
    args = list(_rotate_inputs(r, 4, 3001, 12, cuda))
    args[5] = it
    for part in (True, False):
        edge, _ = _at_the_edges(tuple(args), 8, 1.0, part, r)
        _assert_equal(kernels.rotate(*edge, 1.0, 8, part),
                      kernels.rotate_plain(*edge, 1.0, 8, part), (it, part))


def test_rotate_counts_rows_with_no_new_peer(cuda):
    """N = 16 and S = 12: rows full of 12 of the 15 other nodes often find
    no new peer in their tries, so ``rot_failed`` counts them."""
    args = _rotate_inputs(np.random.default_rng(5), 3, 16, 12, cuda)
    r = np.random.default_rng(6)
    rows = np.stack([np.stack([r.permutation(np.delete(np.arange(16), v))[:12]
                               for v in range(16)]) for _ in range(3)])
    args = (torch.as_tensor(rows.astype(np.int32), device=cuda),) + args[1:]
    for part in (True, False):
        edge, _ = _at_the_edges(args, 8, 1.0, part, r)
        got = kernels.rotate(*edge, 1.0, 8, part)
        _assert_equal(got, kernels.rotate_plain(*edge, 1.0, 8, part), "n16")
        assert int(got[3].sum()) > 0


# --------------------------------------------------------------------------
# the traffic round's kernels (engine/traffic.py)
# --------------------------------------------------------------------------

TRAFFIC_NAMES = ("traffic_send", "traffic_admit", "rank_inbound",
                 "rc_merge_prune", "prune_apply")
TRAFFIC_CASES = {
    # caps off, no impairments
    "caps_off": (2000, 16, 12, dict()),
    # both caps binding under loss + churn + a partition window
    "capped_impaired": (2000, 32, 14, dict(
        node_ingress_cap=6, node_egress_cap=9, packet_loss_rate=0.1,
        churn_fail_rate=0.02, churn_recover_rate=0.3, partition_at=3,
        heal_at=10)),
    # the widest set the sweeps reach, with a wide fanout
    "wide_set": (1500, 8, 10, dict(active_set_size=24, push_fanout=12,
                                   node_ingress_cap=12)),
    # N not a multiple of traffic_send's 32 senders, V not of its 32-value
    # chunks; every message lost
    "ragged_all_lost": (333, 9, 8, dict(node_egress_cap=5,
                                        packet_loss_rate=1.0)),
}


def _traffic_run(cuda, case):
    """The case's traffic rounds on the card with each traffic kernel's
    calls recorded; returns (params, calls, rows)."""
    from gossip_sim_tpu_torch.engine.traffic import (device_traffic_tables,
                                                     init_traffic_state,
                                                     run_traffic_rounds)
    n, v, rounds, kw = TRAFFIC_CASES[case]
    stakes = np.random.default_rng(1).integers(1, 1 << 45,
                                               size=n).astype(np.int64)
    params = EngineParams(num_nodes=n, traffic_values=v, traffic_rate=3,
                          warm_up_rounds=0, min_num_upserts=4,
                          probability_of_rotation=0.1, impair_seed=5, **kw)
    tables = make_cluster_tables(stakes, device=cuda)
    ttables = device_traffic_tables(stakes, device=cuda)
    state = init_traffic_state(stakes, params, 3, device=cuda)
    calls = {name: [] for name in TRAFFIC_NAMES}
    real = {name: getattr(kernels, name) for name in TRAFFIC_NAMES}

    def recorder(name):
        def rec(*args, **kw):
            calls[name].append((args, kw))
            return real[name](*args, **kw)
        return rec

    kernels.reset_launch_counts()
    for name in TRAFFIC_NAMES:
        setattr(kernels, name, recorder(name))
    try:
        _, rows = run_traffic_rounds(params, tables, ttables, state, rounds)
    finally:
        for name in TRAFFIC_NAMES:
            setattr(kernels, name, real[name])
    torch.cuda.synchronize()
    return params, rounds, calls, rows


@pytest.mark.parametrize("case", list(TRAFFIC_CASES))
def test_traffic_kernels_equal_plain_on_traffic_rounds(cuda, case):
    """One launch of each of the five kernels a traffic round, none of the
    push round's others; every call equal to its plain version."""
    params, rounds, calls, rows = _traffic_run(cuda, case)
    want = {name: 0 for name in kernels.LAUNCHES}
    want.update({name: rounds for name in TRAFFIC_NAMES})
    assert dict(kernels.LAUNCHES) == want
    for name in TRAFFIC_NAMES:
        plain = getattr(kernels, f"{name}_plain")
        for args, kw in calls[name]:
            _assert_equal(getattr(kernels, name)(*args, **kw),
                          plain(*args, **kw), name)
    total = lambda k: int(rows[k].sum())
    if case == "ragged_all_lost":
        assert total("arrived") == total("delivered") == 0
        assert total("dropped") > 0
        return
    assert total("delivered") > 0
    if case == "capped_impaired":
        for k in ("deferred", "queue_dropped", "failed_target", "suppressed",
                  "dropped", "prunes_sent"):
            assert total(k) > 0, k


def test_traffic_send_gates_at_the_edges_equal_plain(cuda):
    """An egress cap of 1, a partition gate whose window is off, and a
    loss rate of 1.0, each against the plain version on round inputs."""
    _, _, calls, _ = _traffic_run(cuda, "capped_impaired")
    args, kw = calls["traffic_send"][6]
    args = args[:9] + (1,)                           # egress cap 1
    basis = kw["loss"][0]
    for variant in (dict(loss=None, partition=False),
                    dict(loss=(basis, 1 << 32), partition=True),
                    dict(loss=None, partition=None)):
        _assert_equal(kernels.traffic_send(*args, **variant),
                      kernels.traffic_send_plain(*args, **variant),
                      "traffic_send")


def _send_inputs(cuda, seed, v, n, s):
    """Seeded send inputs of any content the kernel takes: peers (the
    sender itself and the values' origins included), a tenth of the slots
    empty, a third pruned, a tenth of the nodes failed, most values live,
    holders at random, two sides."""
    r = np.random.default_rng(seed)
    origin = r.integers(0, n, size=v).astype(np.int32)
    active = r.integers(0, n, size=(n, s)).astype(np.int32)
    active[r.random((n, s)) < 0.05] = origin[r.integers(0, v)]
    active[r.random((n, s)) < 0.1] = n
    t = lambda x: torch.as_tensor(x, device=cuda)
    return (t(active), t(r.random((v, n, s)) < 0.3), t(r.random(n) < 0.1),
            t(r.random(v) < 0.85), t(r.random((v, n)) < 0.6), t(origin),
            t(r.integers(0, 1 << 31, size=v).astype(np.int32)),
            t(r.integers(0, 2, size=n + 1).astype(np.int32)))


def _send_counts(out):
    """[V, N] candidates of each (value, sender), from the slot words."""
    w = out.cand_bits.T.long() & 0xFFFFFFFF
    return ((w[..., None] >> torch.arange(32, device=w.device)) & 1).sum(-1)


#: (V, N, S, fanout): V = 1, 33 and 257 (not multiples of the 32-value
#: chunk), N not a multiple of 32 (70 and 45 take the prune tile's byte
#: path, 76 and 37 its 16-byte vectors), S = 32 with F = S (slot 31, the
#: sign bit), and M = 256 at N = 10,000 (chip_smoke's shape)
SEND_SHAPES = [(1, 70, 12, 6), (33, 45, 12, 6), (257, 76, 12, 6),
               (40, 37, 32, 32), (256, 10_000, 12, 6)]


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("v,n,s,fanout", SEND_SHAPES)
def test_traffic_send_at_its_edges_equals_plain(cuda, v, n, s, fanout,
                                                misaligned):
    """Kernel against plain (tolerance 0) at egress caps off, 1, binding,
    above every sender's candidates and, where there is a second chunk,
    one that a sender's count crosses inside value 32's candidates (the
    first row of chunk 1); with loss and a partition.  ``misaligned``: the
    prune plane one byte past a 16-byte boundary (the byte path).  One
    launch counted per call."""
    args = list(_send_inputs(cuda, v * n + s, v, n, s))
    if misaligned:
        args[1] = _misaligned(args[1])
    kw = dict(partition=True, loss=(0x1234567, 1 << 30))
    plain = kernels.traffic_send_plain(*args, fanout, 0, **kw)
    counts = _send_counts(plain)
    totals = counts.sum(0)
    top = int(totals.max())
    caps = [0, 1, min(int(totals[totals > 1].median()), top - 1), top + 1]
    if v > 32:
        before = counts[:32].sum(0)
        sender = int(torch.argmax(torch.where(counts[32] > 1, before,
                                              -1)))
        assert int(counts[32, sender]) > 1
        caps.append(int(before[sender]) + 1)
    for cap in caps:
        kernels.reset_launch_counts()
        got = kernels.traffic_send(*args, fanout, cap, **kw)
        assert kernels.LAUNCHES["traffic_send"] == 1
        _assert_equal(got, kernels.traffic_send_plain(*args, fanout, cap,
                                                      **kw),
                      f"traffic_send cap {cap}")
        assert bool((got.code == 5).any()) == (0 < cap <= top - 1)


def test_rc_merge_prune_live_mask_and_shared_prune_apply(cuda):
    """``rc_merge_prune`` with a mask of every other value live, and
    ``prune_apply`` on the shared [N, S] set against the same set expanded
    to every value, on round inputs."""
    _, _, calls, _ = _traffic_run(cuda, "capped_impaired")
    for args, kw in calls["rc_merge_prune"][4:8]:
        live = torch.arange(kw["live"].numel(), device=cuda) % 2 == 0
        kw = dict(kw, live=live)
        got = kernels.rc_merge_prune(*args, **kw)
        _assert_equal(got, kernels.rc_merge_prune_plain(*args, **kw),
                      "rc_merge_prune")
        assert int(got.n_pruned[~live].sum()) == 0
    for pruned, active, src, slot in (c[0] for c in
                                      calls["prune_apply"][4:8]):
        # the round passes its lane form, one set per lane: here [1, N, S]
        active = active.reshape(active.shape[-2:])
        v = pruned.shape[0]
        each = active[None].expand(v, -1, -1).contiguous()
        _assert_equal(kernels.prune_apply(pruned, active, src, slot),
                      kernels.prune_apply(pruned, each, src, slot),
                      "prune_apply")


def _merge_calls_19_20(cuda, form):
    """``rc_merge_prune``'s calls in rounds 19 (the first whose upsert
    counters fire) and 20 of a round run at N = 2,000: the push round in
    the dense or the sparse layout (O = 4), or the traffic round (M = 32
    value rows, with the live mask)."""
    n = 2000
    stakes = np.random.default_rng(8).integers(1, 1 << 45,
                                               size=n).astype(np.int64)
    tables = make_cluster_tables(stakes, device=cuda)
    calls = []
    real = kernels.rc_merge_prune

    def rec(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    kernels.rc_merge_prune = rec
    try:
        if form == "traffic":
            from gossip_sim_tpu_torch.engine.traffic import (
                device_traffic_tables, init_traffic_state,
                run_traffic_rounds)
            params = EngineParams(num_nodes=n, traffic_values=32,
                                  traffic_rate=4, warm_up_rounds=0,
                                  node_ingress_cap=24)
            state = init_traffic_state(stakes, params, 3, device=cuda)
            run_traffic_rounds(params, tables,
                               device_traffic_tables(stakes, device=cuda),
                               state, 21)
        else:
            params = EngineParams(num_nodes=n, warm_up_rounds=0,
                                  representation=form)
            origins = torch.arange(4, dtype=torch.int32, device=cuda)
            state = init_state(rng.prng_key(3, cuda), tables, origins,
                               params)
            run_rounds(params, tables, origins, state, 21)
    finally:
        kernels.rc_merge_prune = real
    torch.cuda.synchronize()
    return calls[19], calls[20]


def _fired_rows(args, kw, out):
    """Rows that fired: the counter reached min_num_upserts (and the value
    row was live)."""
    ups = args[4] + (args[5][..., 0] < args[0].shape[1]).to(torch.int32)
    fired = ups >= kw["min_num_upserts"]
    if kw.get("live") is not None:
        fired &= kw["live"][:, None]
    assert torch.equal(out.rc_upserts == 0, fired | (ups == 0))
    return fired


@pytest.mark.parametrize("form", ["dense", "sparse", "traffic"])
def test_rc_merge_prune_forms_on_rounds_19_20_and_mixed(cuda, form):
    """The dense kernel, the sparse variant and the traffic form (live
    mask) on round 19 (rows fire), round 20 (few or none do) and round
    20's inputs with the upsert counters set to 18, 19 and 20 across rows
    (fired and unfired rows in one call): equal to the plain version at
    tolerance 0, an unfired row's src_sorted its new rc_src and its
    pruned bytes 0."""
    r19, r20 = _merge_calls_19_20(cuda, form)
    assert (r19[0][2] is None) == (form == "sparse")
    g = torch.Generator(device=cuda).manual_seed(17)
    args, kw = r20
    ups = torch.tensor([18, 19, 20], device=cuda, dtype=torch.int32)[
        torch.randint(0, 3, args[4].shape, generator=g, device=cuda)]
    mixed = (args[:4] + (ups,) + args[5:], kw)
    fired_at = {}
    for what, (a, k) in (("round 19", r19), ("round 20", r20),
                         ("mixed", mixed)):
        kernels.reset_launch_counts()
        got = kernels.rc_merge_prune(*a, **k)
        assert kernels.LAUNCHES["rc_merge_prune_sparse" if form == "sparse"
                                else "rc_merge_prune"] == 1
        _assert_equal(got, kernels.rc_merge_prune_plain(*a, **k),
                      (form, what))
        fired = _fired_rows(a, k, got)
        fired_at[what] = int(fired.sum())
        unfired = ~fired
        n = a[0].shape[1]
        new_src = torch.where(unfired[..., None], got.rc_src, n)
        assert torch.equal(torch.where(unfired[..., None], got.src_sorted,
                                       n), new_src), what
        assert not bool(got.pruned_slot[unfired].any()), what
        assert not bool(got.n_pruned[unfired].any()), what
    rows = args[0].shape[0] * args[0].shape[1]
    assert 0 < fired_at["mixed"] < rows
    if form != "traffic":  # value rows start on their own rounds
        assert 0 < fired_at["round 19"] and \
            fired_at["round 20"] < fired_at["round 19"]


# --------------------------------------------------------------------------
# traffic_admit and prune_apply at their edges: shapes that do not fill a
# block, a tile or a vector, targets past the in-neighbour bucket, rows
# dense with pairs on any grid, and flat indices past 2^31
# --------------------------------------------------------------------------

def _admit_inputs(seed, n, v, s, f, hubs):
    """A shared set whose first ``hubs`` nodes are in every row (in-degree
    n - 1), the other slots random peers or empty, and slot words of at
    most ``f`` candidates per (sender, value), the arrivals a subset."""
    r = np.random.default_rng(seed)
    active = np.full((n, s), n, np.int32)
    for i in range(n):
        peers = [h for h in range(hubs) if h != i]
        rest = r.permutation(np.setdiff1d(np.arange(n), peers + [i]))
        row = np.concatenate([peers, rest[:s - len(peers)]]).astype(np.int32)
        row[r.random(row.size) < 0.15] = n
        active[i] = r.permutation(row)
    cand = (active < n)[:, None, :] & (r.random((n, v, s)) < 0.7)
    cand &= np.cumsum(cand, -1) <= f
    arr = cand & (r.random((n, v, s)) < 0.8)
    word = lambda b: ((b.astype(np.int64) << np.arange(s)).sum(-1)
                      .astype(np.uint32).view(np.int32))
    return word(cand), word(arr), active


@pytest.mark.parametrize("cap", [0, 1, 7, 60, 1 << 20])
@pytest.mark.parametrize("n,v,s,f,hubs", [(90, 40, 6, 4, 2),
                                          (1000, 70, 12, 6, 0),
                                          (333, 33, 12, 6, 3),
                                          (77, 5, 25, 12, 1)])
def test_traffic_admit_at_its_edges_equals_plain(cuda, n, v, s, f, hubs,
                                                 cap):
    """N not a multiple of a tile's 32 senders nor of a block's 8 warps, V
    not a multiple of 32, S = 6, 12 and 25, hubs with more in-neighbours
    than a bucket holds (the cut kernel's scan of the whole set), and caps
    off, 1, binding and above every target's arrivals."""
    cand, arr, active = (torch.as_tensor(x, device=cuda)
                         for x in _admit_inputs(n * v + s, n, v, s, f, hubs))
    got = kernels.traffic_admit(cand, arr, active, f, cap)
    _assert_equal(got, kernels.traffic_admit_plain(cand, arr, active, f, cap),
                  "traffic_admit")
    if hubs:
        assert int(got.arrived_node[:hubs].min()) > 0


def _prune_inputs(cuda, seed, o, n, s, c, shared, p_live=0.5):
    r = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(x, device=cuda)
    return (t(r.random((o, n, s)) < 0.1),
            t(r.integers(0, n + 1, size=(n, s) if shared else (o, n, s))
              .astype(np.int32)),
            t(r.integers(0, n, size=(o, n, c)).astype(np.int32)),
            t(r.random((o, n, c)) < p_live))


def _misaligned(x):
    """A copy of ``x`` one byte past a 16-byte boundary (contiguous)."""
    buf = torch.empty(x.numel() * x.element_size() + 16, dtype=torch.uint8,
                      device=x.device)
    view = buf[1:1 + x.numel() * x.element_size()].view(x.dtype)
    view.copy_(x.reshape(-1))
    return view.view(x.shape)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("o,n,s,c", [(3, 1001, 12, 10), (2, 777, 7, 64),
                                     (5, 33, 25, 17), (40, 2000, 12, 64)])
def test_prune_apply_at_its_edges_equals_plain(cuda, o, n, s, c, shared):
    """Half the slots live, O * N * C and O * N * S not multiples of 16
    (the bytes past the last vector), C not a multiple of 16, and the
    pruned and pruned-slot planes one byte off a 16-byte boundary (the
    byte-wise copy and scan)."""
    pruned, active, src, slot = _prune_inputs(cuda, o * n + c, o, n, s, c,
                                              shared)
    want = kernels.prune_apply_plain(pruned, active, src, slot)
    _assert_equal(kernels.prune_apply(pruned, active, src, slot), want,
                  "prune_apply")
    _assert_equal(kernels.prune_apply(_misaligned(pruned), active, src,
                                      _misaligned(slot)), want,
                  "prune_apply (misaligned)")


def test_prune_apply_dense_rows_on_any_grid_equals_plain(cuda, monkeypatch):
    """Rows whose every slot is live (512 pairs in a warp's step, taken 32
    at a time), on the one-wave grid and on grids of 1 and 3 blocks (many
    steps a warp)."""
    pa_mod = importlib.import_module(
        "gossip_sim_tpu_torch.kernels.prune_apply")
    pruned, active, src, slot = _prune_inputs(cuda, 5, 8, 3000, 12, 64,
                                              False, p_live=0.05)
    slot[:, 1000:1400] = True
    want = kernels.prune_apply_plain(pruned, active, src, slot)
    real = pa_mod._grid
    for grid in (None, 1, 3):
        if grid is not None:
            monkeypatch.setattr(pa_mod, "_grid", lambda *a, g=grid: g)
        _assert_equal(kernels.prune_apply(pruned, active, src, slot), want,
                      f"prune_apply (grid {grid or 'one wave'})")
        monkeypatch.setattr(pa_mod, "_grid", real)


def test_prune_apply_past_2_31_slots_equals_plain(cuda):
    """O * N * C just past 2^31 (the 64-bit index math): live pairs at the
    first rows, at the rows around flat index 2^31 and at the last row,
    against the pairs applied one by one on the host."""
    o, n, s, c = 1, (1 << 25) + 8, 4, 64
    r = np.random.default_rng(3)
    pruned = torch.zeros((o, n, s), dtype=torch.bool, device=cuda)
    pruned[0, :1000] = True
    active = torch.randint(0, n + 1, (n, s), dtype=torch.int32, device=cuda)
    src = torch.empty((o, n, c), dtype=torch.int32, device=cuda)
    slot = torch.zeros((o, n, c), dtype=torch.bool, device=cuda)
    flat = np.concatenate([np.arange(0, 40), r.integers(0, 1 << 31, 40),
                           np.arange((1 << 31) - 40, (1 << 31) + 40),
                           np.arange(o * n * c - 40, o * n * c)])
    flat = np.unique(flat)
    rows = flat // c
    u = r.integers(0, n, flat.size)
    # each pair's prunee holds its pruner in a known slot
    for i, (row, uu) in enumerate(zip(rows, u)):
        active[uu, i % s] = int(row % n)
    src.view(-1)[torch.as_tensor(flat, device=cuda)] = torch.as_tensor(
        u.astype(np.int32), device=cuda)
    slot.view(-1)[torch.as_tensor(flat, device=cuda)] = True
    want = pruned.clone()
    act = active.cpu()
    for row, uu in zip(rows, u):
        hit = torch.nonzero(act[uu] == int(row % n)).reshape(-1)
        want[0, int(uu), hit.to(cuda)] = True
    got = kernels.prune_apply(pruned, active, src, slot)
    _assert_equal(got, want, "prune_apply (64-bit index)")
    assert o * n * c > 1 << 31


# --------------------------------------------------------------------------
# traffic_rescue: the adaptive traffic round's pull rescue
# --------------------------------------------------------------------------

def _rescue_inputs(cuda, seed, v, n, hub=False, pull="some"):
    """Seeded rescue inputs (tests/test_torch_traffic_adaptive.py's kind):
    values in their pull phase at random, or every one; holders at random
    (a fifth of the values mostly missing), hops past the histogram's last
    bin, a tenth of the nodes failed, push sends and acceptances up to and
    past the caps; ``hub``: one node alone in the top stake class, so that
    it draws a large share of the requests."""
    from gossip_sim_tpu_torch.traffic import traffic_tables
    r = np.random.default_rng(seed)
    stakes = r.integers(1, 10**6, size=n).astype(np.int64) * 1000
    if hub:
        stakes[n // 3] = stakes.sum() * 50
    pull_on = r.random(v) < 0.6 if pull == "some" else np.ones(v, bool)
    holder_pre = r.random((v, n)) < np.where(r.random(v) < 0.2, 0.2,
                                             0.7)[:, None]
    holder = holder_pre | (r.random((v, n)) < 0.2)
    hop_pre = np.where(holder_pre, r.integers(0, 70, size=(v, n)), -1)
    t = lambda x: torch.as_tensor(x, device=cuda)
    return (t(pull_on), t(r.integers(0, 1 << 20, size=v).astype(np.int32)),
            t(holder_pre), t(hop_pre.astype(np.int32)), t(holder),
            t(r.random(n) < 0.1),
            t(r.integers(0, 2, size=n + 1).astype(np.int32)),
            *(t(x) for x in traffic_tables(stakes)),
            t(r.integers(0, 200, size=n).astype(np.int32)),
            t(r.integers(0, 180, size=n).astype(np.int32)))


#: (seed, V, N, fanout, hub, pull-phase values): a short last tile and
#: value chunks of unequal length; the full width of the round (M=256,
#: N=10,000) with every value in its pull phase; a hub peer
RESCUE_SHAPES = [(1, 33, 1001, 3, False, "some"),
                 (2, 256, 10_000, 2, False, "all"),
                 (3, 64, 3000, 4, True, "some")]


@pytest.mark.parametrize("caps", ["off", "one", "binding"])
@pytest.mark.parametrize("seed,v,n,fanout,hub,pull", RESCUE_SHAPES)
def test_traffic_rescue_equals_plain(cuda, seed, v, n, fanout, hub, pull,
                                     caps):
    """The kernel against its plain twin at egress and ingress caps off,
    1 and binding (with loss and the partition on), each call one launch
    of the wrapper."""
    args = _rescue_inputs(cuda, seed, v, n, hub=hub, pull=pull)
    ecap, icap = {"off": (0, 0), "one": (1, 1), "binding": (190, 175)}[caps]
    kw = dict(fanout=fanout, hist_bins=64, pb=14, egress_cap=ecap,
              ingress_cap=icap, draw=(0x1234567, 0x89ABCDEF),
              bloom=(0x2468ACE, rate_threshold(0.1)))
    if caps == "binding":
        kw.update(partition=True, loss=(0x13579BD, rate_threshold(0.15)))
    kernels.reset_launch_counts()
    got = kernels.traffic_rescue(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["traffic_rescue"] == 1
    want = kernels.traffic_rescue_plain(*args, **kw)
    _assert_equal(got, want, "traffic_rescue")
    counts = want.counts.tolist()
    if caps != "one":
        assert counts[9] > 0                    # rescues
    if caps != "off":
        assert counts[1] > 0 and counts[6] > 0  # deferred, queue dropped


@pytest.mark.parametrize("case", ["caps_off", "capped_impaired"])
def test_traffic_rescue_equals_plain_on_adaptive_rounds(cuda, case):
    """Adaptive traffic rounds on the card: one launch of the rescue
    wrapper a round beside the five push kernels, every call equal to its
    plain version, and values switch and get rescued."""
    from gossip_sim_tpu_torch.engine.traffic import (device_traffic_tables,
                                                     init_traffic_state,
                                                     run_traffic_rounds)
    n, v, rounds, kw = TRAFFIC_CASES[case]
    stakes = np.random.default_rng(1).integers(1, 1 << 45,
                                               size=n).astype(np.int64)
    params = EngineParams(num_nodes=n, traffic_values=v, traffic_rate=3,
                          warm_up_rounds=0, min_num_upserts=4,
                          probability_of_rotation=0.1, impair_seed=5,
                          gossip_mode="adaptive",
                          adaptive_switch_threshold=0.5, **kw)
    tables = make_cluster_tables(stakes, device=cuda)
    ttables = device_traffic_tables(stakes, device=cuda)
    state = init_traffic_state(stakes, params, 3, device=cuda)
    calls, real = [], kernels.traffic_rescue

    def rec(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    kernels.reset_launch_counts()
    kernels.traffic_rescue = rec
    try:
        _, rows = run_traffic_rounds(params, tables, ttables, state,
                                     rounds + 6)
    finally:
        kernels.traffic_rescue = real
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["traffic_rescue"] == rounds + 6
    assert all(kernels.LAUNCHES[name] == rounds + 6 for name in TRAFFIC_NAMES)
    for a, k in calls:
        _assert_equal(real(*a, **k), kernels.traffic_rescue_plain(*a, **k),
                      "traffic_rescue")
    assert int(rows["switched_to_pull"].sum()) > 0
    assert int(rows["pull_rescued"].sum()) > 0


# --------------------------------------------------------------------------
# sweep lanes: the four kernels that read a knob take it per lane
# --------------------------------------------------------------------------

LANES, LANE_ORIGINS = 8, 4          # 32 origin rows, lane j's rows 4j..4j+3


def _lane_slices(k=LANES, o=LANE_ORIGINS):
    return [(j, slice(j * o, (j + 1) * o)) for j in range(k)]


def _lane_rows_equal(got, ones, what):
    """Each lane's rows of the lane call equal its one-lane call."""
    for j, rows in _lane_slices():
        _assert_equal(tuple(None if t is None else t[rows]
                            for t in _outputs(got)), ones[j], f"{what} {j}")


@pytest.mark.parametrize("n", [2000, 10_000])
def test_push_targets_lanes_equal_plain_and_one_lane_calls(cuda, n):
    r = np.random.default_rng(n + 8)
    active, pruned, tfail, origins = _active_rows(
        r, LANES * LANE_ORIGINS, n, 12, cuda)
    side = torch.as_tensor(r.integers(0, 2, size=n + 1).astype(np.int32),
                           device=cuda)
    part = [j % 2 == 0 for j in range(LANES)]
    bases = [0x9E3779B1 + 17 * j for j in range(LANES)]
    thr = [rate_threshold(0.05 * j) for j in range(LANES)]
    kernels.reset_launch_counts()
    got = kernels.push_targets(active, pruned, tfail, origins, side, 6, part,
                               (bases, thr))
    assert kernels.LAUNCHES["push_targets"] == 1
    _assert_equal(got, kernels.push_targets_plain(
        active, pruned, tfail, origins, side, 6, part, (bases, thr)), "lanes")
    ones = [kernels.push_targets(active[s], pruned[s], tfail[s], origins[s],
                                 side, 6, part[j], (bases[j], thr[j]))
            for j, s in _lane_slices()]
    _lane_rows_equal(got, ones, "push_targets")
    assert bool(got[1].any()) and bool(got[2].any())


def test_push_targets_at_the_most_lanes(cuda):
    """64 lanes of one origin each, the largest per-launch struct."""
    r = np.random.default_rng(64)
    n = 1000
    active, pruned, tfail, origins = _active_rows(r, 64, n, 12, cuda)
    side = torch.as_tensor(r.integers(0, 2, size=n + 1).astype(np.int32),
                           device=cuda)
    loss = ([j * 977 for j in range(64)],
            [rate_threshold(j / 64) for j in range(64)])
    part = [j % 3 == 0 for j in range(64)]
    got = kernels.push_targets(active, pruned, tfail, origins, side, 6,
                               part, loss)
    _assert_equal(got, kernels.push_targets_plain(
        active, pruned, tfail, origins, side, 6, part, loss), "64 lanes")
    with pytest.raises(ValueError, match="at most 64"):
        kernels.push_targets(*_active_rows(r, 65, n, 12, cuda)[:4], side, 6,
                             [True] * 65, None)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_rc_merge_prune_lanes_equal_plain_and_one_lane_calls(cuda, sparse):
    args = [torch.as_tensor(a, device=cuda)
            for a in _merge_inputs(81, 64, 16, o=LANES * LANE_ORIGINS)]
    if sparse:
        args[2] = args[3] = None
    kw = dict(received_cap=50, min_num_upserts=20,
              min_ingress_nodes=[1 + j % 4 for j in range(LANES)],
              prune_stake_threshold=list(np.linspace(0.05, 0.4, LANES)))
    name = "rc_merge_prune_sparse" if sparse else "rc_merge_prune"
    kernels.reset_launch_counts()
    got = kernels.rc_merge_prune(*args, **kw)
    assert kernels.LAUNCHES[name] == 1
    _assert_equal(got, kernels.rc_merge_prune_plain(*args, **kw), name)
    ones = []
    for j, s in _lane_slices():
        a = [None if t is None else
             (t[s] if t.shape[0] == LANES * LANE_ORIGINS else t)
             for t in args]
        ones.append(_outputs(kernels.rc_merge_prune(
            *a, received_cap=50, min_num_upserts=20,
            min_ingress_nodes=kw["min_ingress_nodes"][j],
            prune_stake_threshold=kw["prune_stake_threshold"][j])))
    _lane_rows_equal(got, ones, name)
    assert len({int(got.n_pruned[s].sum()) for _, s in _lane_slices()}) > 1


@pytest.mark.parametrize("part", [True, False],
                         ids=["partitionable", "original"])
def test_rotate_lanes_equal_plain_and_one_lane_calls(cuda, part):
    r = np.random.default_rng(75)
    args = list(_rotate_inputs(r, LANES * LANE_ORIGINS, 2000, 12, cuda))
    its = [int(args[5]) + 3 * j for j in range(LANES)]
    probs = [float(np.float32(1 / 75 + j * (1 / 5 - 1 / 75) / (LANES - 1)))
             for j in range(LANES)]
    args[5] = its
    kernels.reset_launch_counts()
    got = kernels.rotate(*args, probs, 8, part)
    assert kernels.LAUNCHES["rotate"] == 1
    _assert_equal(got, kernels.rotate_plain(*args, probs, 8, part), "lanes")
    ones = []
    for j, s in _lane_slices():
        a = [t[s] if torch.is_tensor(t) and t.shape[0] == LANES *
             LANE_ORIGINS else t for t in args]
        a[5] = its[j]
        ones.append(_outputs(kernels.rotate(*a, probs[j], 8, part)))
    # rot_failed is per origin row
    _lane_rows_equal(got, ones, "rotate")


@pytest.mark.parametrize("cap", [0, 2])
def test_pull_exchange_lanes_equal_plain_and_one_lane_calls(cuda, cap):
    args, knobs = _pull_inputs(cuda, LANES * LANE_ORIGINS, 2000,
                               dict(adaptive=True))
    lanes = dict(
        fanout=[2 + j % 7 for j in range(LANES)],
        pull_on=[j != 3 for j in range(LANES)],
        bases=([7 + j for j in range(LANES)], [9 + 2 * j for j in
                                               range(LANES)],
               [11 + 3 * j for j in range(LANES)]),
        bloom_threshold=[rate_threshold(0.05 * j) for j in range(LANES)],
        cap=[cap * (j % 2) for j in range(LANES)],
        partition=[j % 2 == 1 for j in range(LANES)],
        loss=([77 + j for j in range(LANES)],
              [rate_threshold(0.04 * j) for j in range(LANES)]))
    knobs.update(lanes)
    kernels.reset_launch_counts()
    got = kernels.pull_exchange(*args, **knobs)
    assert kernels.LAUNCHES["pull_exchange"] == 1
    _assert_equal(tuple(got), tuple(kernels.pull_exchange_plain(
        *args, **knobs)), "lanes")
    ones = []
    for j, s in _lane_slices():
        a = [t[s] if torch.is_tensor(t) and t.shape[0] == LANES *
             LANE_ORIGINS else t for t in args]
        one = dict(knobs, fanout=lanes["fanout"][j],
                   pull_on=lanes["pull_on"][j],
                   bases=tuple(b[j] for b in lanes["bases"]),
                   bloom_threshold=lanes["bloom_threshold"][j],
                   cap=lanes["cap"][j], partition=lanes["partition"][j],
                   loss=(lanes["loss"][0][j], lanes["loss"][1][j]))
        ones.append(tuple(kernels.pull_exchange(*a, **one)))
    _lane_rows_equal(tuple(got), ones, "pull_exchange")
    assert int(got.counts[:, 0].sum()) > 0


LANE_RUNS = {
    "push_impaired": (dict(warm_up_rounds=2, impair_seed=5), [
        dict(), dict(packet_loss_rate=0.3), dict(churn_fail_rate=0.02,
                                                 churn_recover_rate=0.2),
        dict(partition_at=3, heal_at=9, min_ingress_nodes=4,
             prune_stake_threshold=0.3, probability_of_rotation=0.2)]),
    "push_pull": (dict(warm_up_rounds=2, impair_seed=5,
                       gossip_mode="push-pull", packet_loss_rate=0.1), [
        dict(pull_fanout=2), dict(pull_fanout=8, pull_request_cap=2),
        dict(pull_fanout=5, pull_bloom_fp_rate=0.3),
        dict(pull_fanout=3, pull_interval=2)]),
}


@pytest.mark.parametrize("case", list(LANE_RUNS))
def test_lane_runs_equal_serial_runs_on_the_card(cuda, case):
    from gossip_sim_tpu_torch.engine import (broadcast_state,
                                             merge_lane_statics,
                                             run_rounds_lanes, stack_knobs)
    base, lanes = LANE_RUNS[case]
    n = 2000
    stakes = np.random.default_rng(2).integers(1, 1 << 45,
                                               size=n).astype(np.int64)
    plist = [EngineParams(num_nodes=n, **base, **kw) for kw in lanes]
    static = merge_lane_statics([p.static_part() for p in plist])
    tables = make_cluster_tables(stakes, device=cuda)
    origins = torch.arange(2, dtype=torch.int32, device=cuda)
    st0 = init_state(rng.prng_key(3, cuda), tables, origins, plist[0])
    kernels.reset_launch_counts()
    states, rows = run_rounds_lanes(
        static, tables, origins, broadcast_state(st0, len(plist)),
        stack_knobs([p.knob_values() for p in plist]), 21, detail=True)
    lane_launches = dict(kernels.LAUNCHES)
    for j, p in enumerate(plist):
        kernels.reset_launch_counts()
        s1, r1 = run_rounds(static, tables, origins, st0, 21, detail=True,
                            knobs=p.knob_values())
        assert dict(kernels.LAUNCHES) == lane_launches, j
        for k in r1:
            assert torch.equal(torch.nan_to_num(rows[k][:, j]),
                               torch.nan_to_num(r1[k])), (j, k)
        for f in s1._fields:
            assert torch.equal(getattr(states, f)[j], getattr(s1, f)), (j, f)


# --------------------------------------------------------------------------
# traffic lanes: the six traffic kernels' lane forms (one launch per call,
# the lane in the grid), against their plain twins and one-lane calls
# --------------------------------------------------------------------------

TRAFFIC_LANE_KERNELS = ("traffic_send", "traffic_admit", "rank_inbound",
                        "rc_merge_prune", "prune_apply", "traffic_rescue")
#: case -> (N, V, rounds, adaptive, the lanes' knobs)
TRAFFIC_LANE_RUNS = {
    # one lane: the serial round's call shapes, capped and impaired
    "k1": (2000, 16, 10, False, [dict(
        node_ingress_cap=6, node_egress_cap=9, packet_loss_rate=0.1,
        churn_fail_rate=0.02, churn_recover_rate=0.3, partition_at=3,
        heal_at=8)]),
    # V = 70 (three 32-value chunks, the last ragged): caps off, 1 and
    # binding (the egress look-back of lane 2 crosses chunks), loss,
    # churn and a partition in different lanes
    "k3_ragged": (1500, 70, 10, False, [
        dict(),
        dict(node_ingress_cap=1, node_egress_cap=1, packet_loss_rate=0.1,
             churn_fail_rate=0.02, churn_recover_rate=0.3),
        dict(node_ingress_cap=12, node_egress_cap=40, partition_at=3,
             heal_at=8, impair_seed=9, traffic_rate=6)]),
    # the most lanes a launch takes, every knob varied
    "k64": (300, 5, 6, False, [dict(
        node_ingress_cap=j % 4, node_egress_cap=(3 * j) % 7,
        packet_loss_rate=0.05 * (j % 3), traffic_rate=1 + j % 3,
        impair_seed=j, probability_of_rotation=0.1 * (j % 4))
        for j in range(64)]),
    # adaptive lanes: thresholds 0.3-0.9, caps off, 1 and binding, and
    # pull fanouts 2-4 (the draws sized for the widest)
    "adaptive_k3": (1500, 40, 16, True, [
        dict(adaptive_switch_threshold=0.3, pull_fanout=2),
        dict(adaptive_switch_threshold=0.6, node_ingress_cap=1,
             node_egress_cap=1, packet_loss_rate=0.1, pull_fanout=4),
        dict(adaptive_switch_threshold=0.9, node_ingress_cap=20,
             node_egress_cap=30, partition_at=4, heal_at=10, pull_fanout=3)]),
}


def _traffic_lanes_run(cuda, n, v, rounds, adaptive, lanes, record=True):
    """The lanes' traffic rounds on the card (each kernel's calls recorded
    with ``record``); returns (params, states, rows, calls, launches)."""
    from gossip_sim_tpu_torch.engine import merge_lane_statics, stack_knobs
    from gossip_sim_tpu_torch.engine import traffic as tt
    stakes = np.random.default_rng(1).integers(1, 1 << 45,
                                               size=n).astype(np.int64)
    base = dict(num_nodes=n, traffic_values=v, traffic_rate=3,
                warm_up_rounds=0, min_num_upserts=4,
                probability_of_rotation=0.1, impair_seed=5)
    if adaptive:
        base["gossip_mode"] = "adaptive"
    plist = [EngineParams(**{**base, **kw}) for kw in lanes]
    static = merge_lane_statics([p.static_part() for p in plist])
    tables = make_cluster_tables(stakes, device=cuda)
    ttables = tt.device_traffic_tables(stakes, device=cuda)
    st0 = tt.init_traffic_state(stakes, plist[0], 3, device=cuda)
    calls = {name: [] for name in TRAFFIC_LANE_KERNELS}
    real = {name: getattr(kernels, name) for name in TRAFFIC_LANE_KERNELS}

    def recorder(name):
        def rec(*args, **kw):
            calls[name].append((args, kw))
            return real[name](*args, **kw)
        return rec

    kernels.reset_launch_counts()
    if record:
        for name in TRAFFIC_LANE_KERNELS:
            setattr(kernels, name, recorder(name))
    try:
        states, rows = tt.run_traffic_lanes(
            static, tables, ttables, tt.broadcast_traffic_state(
                st0, len(plist)),
            stack_knobs([p.knob_values() for p in plist]), rounds)
    finally:
        for name in TRAFFIC_LANE_KERNELS:
            setattr(kernels, name, real[name])
    torch.cuda.synchronize()
    return (plist, static, tables, ttables, st0, states, rows, calls,
            dict(kernels.LAUNCHES))


@pytest.mark.parametrize("case", list(TRAFFIC_LANE_RUNS))
def test_traffic_lane_kernels_equal_plain_and_one_lane_calls(cuda, case):
    """One launch of each lane kernel a round for all the lanes; each
    lane call equals its plain lane form and, lane by lane, the kernel's
    one-lane calls (tolerance 0); each lane equals its serial run."""
    from gossip_sim_tpu_torch.engine import traffic as tt
    from gossip_sim_tpu_torch.kernels import _lanes
    n, v, rounds, adaptive, lanes = TRAFFIC_LANE_RUNS[case]
    (plist, _, tables, ttables, st0, states, rows, calls,
     launches) = _traffic_lanes_run(cuda, n, v, rounds, adaptive, lanes)
    names = TRAFFIC_LANE_KERNELS[:5 + int(adaptive)]
    for name in TRAFFIC_LANE_KERNELS:
        assert launches[name] == (rounds if name in names else 0), name
    for name in names:
        fn, plain = getattr(kernels, name), getattr(kernels, f"{name}_plain")
        for r in (rounds // 2, rounds - 1):
            args, kw = calls[name][r]
            got = fn(*args, **kw)
            _assert_equal(got, plain(*args, **kw), f"{name} round {r}")
            for j in range(len(lanes)):
                a1, k1 = _lanes.one_lane_call(name, args, kw, j, v)
                _assert_equal(_lanes.lane_part(name, got, j, v),
                              fn(*a1, **k1), f"{name} round {r} lane {j}")
    total = lambda k: int(rows[k].sum())
    assert total("delivered") > 0
    if adaptive:
        assert total("pull_rescued") > 0 and total("switched_to_pull") > 0
    for j in {0, len(lanes) - 1}:
        s1, r1 = tt.run_traffic_rounds(plist[j], tables, ttables, st0,
                                       rounds)
        for k in r1:
            assert torch.equal(rows[k][:, j], r1[k]), (case, j, k)
        for f in s1._fields:
            assert torch.equal(getattr(states, f)[j], getattr(s1, f)), \
                (case, j, f)


def test_more_than_64_traffic_lanes_run_in_groups_on_the_card(cuda):
    """66 traffic lanes run as a group of 64 and one of 2 (two launches
    of each kernel a round); the lanes at the groups' ends equal their
    serial runs."""
    from gossip_sim_tpu_torch.engine import traffic as tt
    lanes = [dict(node_ingress_cap=j % 3, packet_loss_rate=0.02 * (j % 4))
             for j in range(66)]
    (plist, _, tables, ttables, st0, states, rows, _,
     launches) = _traffic_lanes_run(cuda, 200, 4, 5, False, lanes,
                                    record=False)
    for name in TRAFFIC_LANE_KERNELS[:5]:
        assert launches[name] == 2 * 5, name
    for j in (0, 63, 64, 65):
        s1, r1 = tt.run_traffic_rounds(plist[j], tables, ttables, st0, 5)
        for k in r1:
            assert torch.equal(rows[k][:, j], r1[k]), (j, k)
        for f in s1._fields:
            assert torch.equal(getattr(states, f)[j], getattr(s1, f)), (j, f)


def test_traffic_lane_wrappers_refuse_more_than_64_lanes(cuda):
    """A launch takes at most 64 lane records; the engine groups more."""
    act = torch.zeros((65, 10, 4), dtype=torch.int32, device=cuda)
    words = torch.zeros((65, 10, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="a launch takes 1 to 64"):
        kernels.traffic_admit(words, words, act, 2, 0)


# --------------------------------------------------------------------------
# checkpoints and the device supervisor on the card (checkpoint.py,
# resilience.py)
# --------------------------------------------------------------------------

FIXTURES = __file__.rsplit("/", 1)[0] + "/fixtures/checkpoints"


def _restored_on(path, params, stakes, device):
    from gossip_sim_tpu_torch import checkpoint
    tables = make_cluster_tables(stakes, device=device)
    state, _, meta = checkpoint.restore_sim_state(path, params, tables,
                                                  device=device)
    return state, meta, tables


@pytest.mark.parametrize("version", range(1, 9))
def test_fixture_restores_equal_on_cuda_and_cpu(cuda, version):
    """The reference package's v1-v8 fixtures restore on the card to the
    CPU's fields, and 5 rounds on stay equal."""
    path = f"{FIXTURES}/v{version}.npz"
    with np.load(path) as z:
        stakes = z["fixture.stakes"].astype(np.int64)
    params = EngineParams(num_nodes=16, warm_up_rounds=0)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        st, meta, tables = _restored_on(path, params, stakes, dev)
        before = [t.cpu() for t in st]
        st, rows = run_rounds(params, tables, torch.zeros(
            1, dtype=torch.int32, device=dev), st, 5,
            start_it=int(meta.get("iteration", 3)), detail=True)
        out[dev.type] = before + [t.cpu() for t in st] + [
            rows[k].cpu() for k in sorted(rows)]
    assert all(torch.equal(a, b) for a, b in zip(out["cuda"], out["cpu"]))


def test_sparse_file_at_n100k_restores_equal_on_cuda_and_cpu(cuda,
                                                             tmp_path):
    """A sparse state at O=41 of N=100,000 (the reference's auto batch
    there), written from the card, restores on the card and on the CPU to
    the same fields."""
    from gossip_sim_tpu_torch import checkpoint
    n, o = 100_000, 41
    stakes = np.random.default_rng(3).integers(
        1, 1 << 45, size=n).astype(np.int64)
    params = EngineParams(num_nodes=n, representation="sparse")
    tables = make_cluster_tables(stakes, device=cuda)
    orgs = torch.arange(o, dtype=torch.int32, device=cuda)
    st = init_state(rng.prng_key(5, cuda), tables, orgs, params)
    st, _ = run_rounds(params, tables, orgs, st, 3)
    path = str(tmp_path / "sparse.npz")
    checkpoint.save_state(path, st, params, iteration=3)
    want = [t.cpu() for t in st]
    del st
    for dev in (cuda, torch.device("cpu")):
        got, meta, _ = _restored_on(path, params, stakes, dev)
        assert meta["iteration"] == 3
        assert got.rc_shi.shape == (o, n, 0)
        assert all(torch.equal(a, b.cpu()) for a, b in zip(want, got))
        del got


def _supervised_case(cuda):
    """N=2,000, O=4 under loss and churn: the tables, origins, a state and
    a unit of 20 rounds from it, as ``cli._dispatch_supervised`` runs one
    (its rows copied to the host), recording the thread it ran on."""
    from gossip_sim_tpu_torch import cli
    stakes = np.random.default_rng(11).integers(
        1, 1 << 45, size=2000).astype(np.int64)
    params = EngineParams(num_nodes=2000, warm_up_rounds=5,
                          packet_loss_rate=0.1, churn_fail_rate=0.01,
                          churn_recover_rate=0.2, impair_seed=4)
    tables = make_cluster_tables(stakes, device=cuda)
    orgs = torch.arange(4, dtype=torch.int32, device=cuda)
    state = init_state(rng.prng_key(9, cuda), tables, orgs, params)
    threads = []

    def unit(st, d):
        import threading
        threads.append(threading.current_thread().name)
        st, rows = run_rounds(params, cli._to_device(tables, d),
                              cli._to_device(orgs, d), st, 20, start_it=5,
                              detail=True)
        return st, {k: v.cpu() for k, v in rows.items()}
    return state, unit, threads


def _clone(state):
    return type(state)(*(t.clone() for t in state))


def _same_unit(a, b):
    (sa, ra), (sb, rb) = a, b
    assert all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(sa, sb))
    assert set(ra) == set(rb)
    assert all(torch.equal(ra[k], rb[k]) for k in ra)


def test_supervised_dispatch_on_a_worker_thread_equals_the_direct_call(
        cuda):
    """Under --device-timeout-s the process's first dispatch (which loads
    the kernels) runs inline and later ones on a worker thread, on the
    caller's stream; a worker thread that loads the kernels first works
    too.  Every result equals the direct call's."""
    from gossip_sim_tpu_torch import cli, resilience
    from gossip_sim_tpu_torch.config import Config
    from gossip_sim_tpu_torch.kernels import _build
    state, unit, threads = _supervised_case(cuda)
    want = unit(_clone(state), cuda)
    cfg = Config(device="cuda", device_timeout_s=60.0)
    libs = dict(_build._LIBS)
    try:
        _build._LIBS.clear()
        _same_unit(want, cli._dispatch_supervised(cfg, "first", unit, state,
                                                  cuda))
        assert _build.loaded() and threads[-1] == "MainThread"
        _same_unit(want, cli._dispatch_supervised(cfg, "second", unit,
                                                  state, cuda))
        assert threads[-1].startswith("device-dispatch:second")
        _build._LIBS.clear()
        copy = _clone(state)
        _same_unit(want, resilience._call_with_timeout(
            lambda: unit(copy, cuda), 60.0, "loads"))
        assert threads[-1].startswith("device-dispatch:loads")
    finally:
        _build._LIBS.update(libs)


def test_fault_hook_retry_on_the_card_gives_the_unfaulted_rows(cuda):
    from gossip_sim_tpu_torch import cli, resilience
    from gossip_sim_tpu_torch.config import Config
    state, unit, _ = _supervised_case(cuda)
    want = unit(_clone(state), cuda)
    cfg = Config(device="cuda")
    cfg.device_backoff_s = 0.001
    resilience.reset_counts()

    def hook(label, attempt):
        if attempt == 0:
            raise RuntimeError("injected device failure")

    resilience.set_fault_hook(hook)
    try:
        got = cli._dispatch_supervised(cfg, "unit", unit, state, cuda)
    finally:
        resilience.set_fault_hook(None)
    _same_unit(want, got)
    assert resilience.COUNTS["resilience/device_failures"] == 1


# ---- the node-health kernels: health_round (both forms), health_digest ----

#: engine runs with the health gate on: (nodes, origins, rounds, knobs);
#: round 19 fires the upsert counters at min_num_upserts 20, round 20 not
HEALTH_CASES = {
    "push_impaired": (2000, 4, 22, dict(
        warm_up_rounds=5, packet_loss_rate=0.1, churn_fail_rate=0.01,
        churn_recover_rate=0.2, partition_at=3, heal_at=12, impair_seed=5)),
    "sparse": (2000, 3, 22, dict(warm_up_rounds=5,
                                 representation="sparse")),
    "push_pull": (2000, 3, 22, dict(warm_up_rounds=5,
                                    gossip_mode="push-pull",
                                    packet_loss_rate=0.1)),
    "adaptive": (1500, 2, 22, dict(warm_up_rounds=5, gossip_mode="adaptive",
                                   adaptive_switch_threshold=0.5)),
}


def _recorded(names, fn):
    """``fn()`` with every call of the kernels ``names`` recorded: (its
    result, {name: [(args, kw), ...]})."""
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
        out = fn()
    finally:
        for name in names:
            setattr(kernels, name, real[name])
    torch.cuda.synchronize()
    return out, calls


@pytest.mark.parametrize("case", list(HEALTH_CASES))
def test_health_round_equals_plain_on_engine_rounds(cuda, case):
    """One ``health_round`` launch a round with the gate on, each call
    equal to its plain version, on rounds where pruners fire and where
    none does; with the gate off no launch and zero planes."""
    n, o, rounds, kw = HEALTH_CASES[case]
    stakes = np.random.default_rng(4).integers(1, 1 << 45,
                                               size=n).astype(np.int64)
    tables = make_cluster_tables(stakes, device=cuda)
    origins = torch.arange(o, dtype=torch.int32, device=cuda)
    for gate in (True, False):
        params = EngineParams(num_nodes=n, health=gate, **kw)
        state = init_state(rng.prng_key(3, cuda), tables, origins, params)
        kernels.reset_launch_counts()
        (state, rows), calls = _recorded(
            ("health_round",),
            lambda: run_rounds(params, tables, origins, state, rounds))
        assert kernels.LAUNCHES["health_round"] == (rounds if gate else 0)
        if not gate:
            assert int(state.health_prune_recv.abs().sum()) == 0
            assert int(state.health_first_round.abs().sum()) == 0
            continue
        fired = [int(args[2].sum()) for args, _ in calls["health_round"]]
        assert max(fired) > 0 and min(fired) == 0, fired
        for args, kw_ in calls["health_round"]:
            _assert_equal(kernels.health_round(*args, **kw_),
                          kernels.health_round_plain(*args, **kw_),
                          "health_round")
        assert int(state.health_prune_recv.sum()) > 0
        assert int((state.health_first_round > 0).sum()) > 0


def test_health_round_equals_plain_on_lane_rounds(cuda):
    """Three lanes of two origins with their own warm-up gates and start
    iterations (``run_rounds_lanes_dyn``): each call of the kernel equal
    to its plain version."""
    from gossip_sim_tpu_torch.engine import (broadcast_state,
                                             merge_lane_statics,
                                             run_rounds_lanes_dyn,
                                             stack_knobs, stack_origins)
    n = 1500
    stakes = np.random.default_rng(5).integers(1, 1 << 45,
                                               size=n).astype(np.int64)
    plist = [EngineParams(num_nodes=n, health=True, warm_up_rounds=w,
                          packet_loss_rate=loss)
             for w, loss in ((0, 0.0), (12, 0.1), (30, 0.2))]
    static = merge_lane_statics([p.static_part() for p in plist])
    tables = make_cluster_tables(stakes, device=cuda)
    org = torch.tensor([0, 9], dtype=torch.int32, device=cuda)
    st = init_state(rng.prng_key(3, cuda), tables, org, plist[0])
    kernels.reset_launch_counts()
    _, calls = _recorded(("health_round",), lambda: run_rounds_lanes_dyn(
        static, tables, stack_origins([[0, 9], [4, 7], [1, 2]]).to(cuda),
        broadcast_state(st, 3), stack_knobs([p.knob_values()
                                             for p in plist]), 24,
        [0, 3, 11]))
    assert kernels.LAUNCHES["health_round"] == 24
    for args, kw_ in calls["health_round"]:
        _assert_equal(kernels.health_round(*args, **kw_),
                      kernels.health_round_plain(*args, **kw_),
                      "health_round lanes")


@pytest.mark.parametrize("mode", ["push", "adaptive"])
def test_health_round_traffic_equals_plain_on_traffic_rounds(cuda, mode):
    """The traffic form: one launch a traffic round, each call equal to
    its plain version (push: loss + caps, prunes firing; adaptive: rescues
    delivering)."""
    from gossip_sim_tpu_torch.engine.traffic import (device_traffic_tables,
                                                     init_traffic_state,
                                                     run_traffic_rounds)
    n = 2000
    stakes = np.random.default_rng(1).integers(1, 1 << 45,
                                               size=n).astype(np.int64)
    kw = (dict(packet_loss_rate=0.1, node_ingress_cap=40,
               node_egress_cap=60) if mode == "push" else
          dict(gossip_mode="adaptive", adaptive_switch_threshold=0.3,
               node_ingress_cap=48, node_egress_cap=64))
    params = EngineParams(num_nodes=n, traffic_values=32, traffic_rate=3,
                          warm_up_rounds=4, min_num_upserts=4,
                          probability_of_rotation=0.1, impair_seed=5,
                          health=True, **kw)
    tables = make_cluster_tables(stakes, device=cuda)
    ttables = device_traffic_tables(stakes, device=cuda)
    state = init_traffic_state(stakes, params, 3, device=cuda)
    kernels.reset_launch_counts()
    (state, _), calls = _recorded(
        ("health_round_traffic",),
        lambda: run_traffic_rounds(params, tables, ttables, state, 24))
    assert kernels.LAUNCHES["health_round_traffic"] == 24
    for args, kw_ in calls["health_round_traffic"]:
        _assert_equal(kernels.health_round_traffic(*args, **kw_),
                      kernels.health_round_traffic_plain(*args, **kw_),
                      "health_round_traffic")
    assert int(state.health_del_acc.sum()) > 0
    assert int(state.health_lat_acc.sum()) > 0
    if mode == "push":
        assert int(state.health_prune_recv.sum()) > 0
    else:
        assert int(state.health_rescued_acc.sum()) > 0


def _digest_stack(seed, p, n, hi, dtype, cuda):
    r = np.random.default_rng(seed)
    x = r.integers(-hi if dtype == torch.int64 else 0, hi, (p, n))
    return torch.as_tensor(x, dtype=dtype, device=cuda)


#: (P, N, k, value range, dtype): the sim stack at N=10,000, the traffic
#: stack, a row of N=100,000 (past one block's shared memory), ties
#: everywhere, i64-range values (negative too), k = N, k above a short
#: row's length clamped by the caller, a ragged N
DIGEST_CASES = {
    "sim_10k": (8, 10_000, 10, 300, torch.int32),
    "traffic_10k": (9, 10_000, 10, 5_000, torch.int32),
    "n_100k": (9, 100_000, 10, 1_000, torch.int64),
    "ties": (3, 4_097, 25, 3, torch.int32),
    "i64_range": (2, 3_000, 12, 1 << 36, torch.int64),
    "k_is_n": (2, 700, 700, 40, torch.int32),
    "one_node": (2, 1, 1, 9, torch.int64),
}


@pytest.mark.parametrize("case", list(DIGEST_CASES))
def test_health_digest_equals_plain(cuda, case):
    p, n, k, hi, dtype = DIGEST_CASES[case]
    stack = _digest_stack(len(case), p, n, hi, dtype, cuda)
    dec = torch.as_tensor(np.random.default_rng(1).integers(0, 10, n),
                          dtype=torch.int32, device=cuda)
    kernels.reset_launch_counts()
    got = kernels.health_digest(stack, dec, k)
    assert kernels.LAUNCHES["health_digest"] == 1
    _assert_equal(got, kernels.health_digest_plain(stack, dec, k),
                  f"health_digest {case}")


def _pair_inputs(r, rows, n, c, cuda):
    """Seeded prune decisions over ``rows`` pruner rows of ``n`` nodes and
    ``c`` slots: about half the rows fire, 5% of their slots pruned."""
    slot = r.random((rows, n, c), dtype=np.float32) < 0.05
    slot[r.random((rows, n)) < 0.5] = False
    src = r.integers(0, n, (rows, n, c), dtype=np.int32)
    t = lambda a: torch.as_tensor(a, device=cuda)
    return (t(slot.sum(-1, dtype=np.int32)), t(src), t(slot))


#: (R rows, lanes, N, C): the round form where each CTA counts a whole
#: plane (C = 12: the slot bytes one by one; N = 58,108: the counts and the
#: busy flag fill the opt-in shared memory exactly) and in device memory
#: (N = 58,112, just past a plane; 60,000; 1,000,000)
ROUND_EDGES = {"plane_c12": (6, 3, 3_000, 12),
               "plane_limit": (2, 1, 58_108, 64),
               "device_past_plane": (2, 1, 58_112, 64),
               "device_60k": (2, 1, 60_000, 64),
               "device": (1, 1, 1_000_000, 16)}


@pytest.mark.parametrize("case", list(ROUND_EDGES))
def test_health_round_equals_plain_on_crafted_rows(cuda, case):
    rows, k, n, c = ROUND_EDGES[case]
    r = np.random.default_rng(len(case))
    n_pruned, src, slot = _pair_inputs(r, rows, n, c, cuda)
    t = lambda a: torch.as_tensor(a, device=cuda)
    prune = t(r.integers(2**31 - 5, 2**31, (rows, n)).astype(np.int32))
    first = t(np.where(r.random((rows, n)) < 0.5, 0,
                       r.integers(1, 9, (rows, n))).astype(np.int32))
    reached = t(r.random((rows, n)) < 0.6)
    its = np.arange(k, dtype=np.int64) + 40
    gates = (np.arange(k) != 1).astype(np.int32)
    args = (prune, first, n_pruned, src, slot, reached, its, gates)
    geo = hr_mod.round_geometry(rows, n, torch.cuda.get_device_properties(
        cuda).multi_processor_count, torch.cuda.get_device_properties(
        cuda).shared_memory_per_block_optin)
    assert geo.mode == (hr_mod.PLANE if case.startswith("plane")
                        else hr_mod.DEVICE)
    kernels.reset_launch_counts()
    got = kernels.health_round(*args)
    assert kernels.LAUNCHES["health_round"] == 1
    _assert_equal(got, kernels.health_round_plain(*args),
                  f"health_round {case}")


def test_health_round_traffic_equals_plain_on_crafted_rows(cuda):
    """The traffic form with N = 1,001 (rows not 4-byte aligned: the
    delivery words byte by byte), C = 12 (slot bytes one by one), V = 300
    (two age chunks), two lanes (the second gated out), rescues on."""
    r = np.random.default_rng(12)
    k, v, n, c = 2, 300, 1_001, 12
    t = lambda a: torch.as_tensor(a, device=cuda)
    planes = [t(r.integers(2**31 - 50_000, 2**31, (k, n)).astype(np.int32))
              for _ in range(4)]
    new_del = t(r.random((k, v, n)) < 0.3)
    pull_del = t(r.random((k, v, n)) < 0.2) & ~new_del
    v_birth = t(r.integers(0, 100, (k, v)).astype(np.int32))
    n_pruned, src, slot = _pair_inputs(r, k * v, n, c, cuda)
    args = (*planes, new_del, pull_del, v_birth, 5_000, n_pruned, src, slot,
            np.array([1, 0], np.int32))
    kernels.reset_launch_counts()
    got = kernels.health_round_traffic(*args)
    assert kernels.LAUNCHES["health_round_traffic"] == 1
    _assert_equal(got, kernels.health_round_traffic_plain(*args),
                  "health_round_traffic crafted")


def _digest_edge_stack(case, cuda):
    """The crafted stacks of :data:`DIGEST_EDGES` (seeded)."""
    r = np.random.default_rng(len(case))
    if case == "runs_across_tiles":
        run = np.repeat(np.arange(5), 1000)         # runs of 1,000 over tiles
        x = np.stack([run, run[::-1], np.roll(run, 517)])
    elif case == "constant_and_extremes":
        x = np.stack([np.full(3000, -7),            # a constant row: no pass
                      r.choice([-(1 << 62), 1 << 62, 0, -1, 1], 3000)])
    elif case == "i64_both_signs_100k":
        x = r.integers(-(1 << 40), 1 << 40, (2, 100_000))
    else:
        p, n = {"p1_k0": (1, 3000), "k_is_n_tiles": (2, 2500),
                "one_past_a_tile": (3, 1025), "n1_p1": (1, 1)}[case]
        x = r.integers(-50, 50, (p, n))
    dtype = torch.int64 if case in (
        "constant_and_extremes", "i64_both_signs_100k",
        "k_is_n_tiles") else torch.int32
    return torch.as_tensor(x, dtype=dtype, device=cuda)


#: (k) of each crafted stack: runs of equal values across tile and block
#: boundaries, a constant row beside one of 64-bit extremes (8 passes),
#: int64 of both signs at N = 100,000, P = 1 with k = 0, k = N over
#: several tiles, N one past a tile, N = 1
DIGEST_EDGES = {"runs_across_tiles": 30, "constant_and_extremes": 20,
                "i64_both_signs_100k": 10, "p1_k0": 0, "k_is_n_tiles": 2500,
                "one_past_a_tile": 7, "n1_p1": 1}


@pytest.mark.parametrize("case", list(DIGEST_EDGES))
def test_health_digest_equals_plain_on_crafted_stacks(cuda, case):
    stack = _digest_edge_stack(case, cuda)
    n = stack.shape[1]
    dec = torch.as_tensor(np.random.default_rng(2).integers(0, 10, n),
                          dtype=torch.int32, device=cuda)
    k = DIGEST_EDGES[case]
    kernels.reset_launch_counts()
    got = kernels.health_digest(stack, dec, k)
    assert kernels.LAUNCHES["health_digest"] == 1
    _assert_equal(got, kernels.health_digest_plain(stack, dec, k),
                  f"health_digest {case}")


def test_health_round_traffic_equals_plain_on_firing_value_rows(cuda):
    """The traffic form on a round whose value rows fire: the round's
    ``rc_merge_prune`` inputs again with the upsert counters set to 18, 19
    and 20 across rows (seeded; the threshold is 20), its prune decision
    into the traffic form's call, against the plain form."""
    from gossip_sim_tpu_torch.engine.traffic import (device_traffic_tables,
                                                     init_traffic_state,
                                                     run_traffic_rounds,
                                                     traffic_round_step)
    n = 2000
    stakes = np.random.default_rng(6).integers(1, 1 << 45,
                                               size=n).astype(np.int64)
    params = EngineParams(num_nodes=n, traffic_values=64, traffic_rate=6,
                          warm_up_rounds=2, min_num_upserts=20,
                          packet_loss_rate=0.05, health=True)
    tables = make_cluster_tables(stakes, device=cuda)
    ttables = device_traffic_tables(stakes, device=cuda)
    state = init_traffic_state(stakes, params, 4, device=cuda)
    state, _ = run_traffic_rounds(params, tables, ttables, state, 12)
    _, calls = _recorded(("rc_merge_prune", "health_round_traffic"),
                         lambda: traffic_round_step(params, tables, ttables,
                                                    state, 12))
    (ma, mkw), = calls["rc_merge_prune"]
    (ha, hkw), = calls["health_round_traffic"]
    gen = torch.Generator(device=cuda).manual_seed(20)
    ups = torch.tensor([18, 19, 20], dtype=torch.int32, device=cuda)[
        torch.randint(0, 3, ma[4].shape, generator=gen, device=cuda)]
    mp = kernels.rc_merge_prune(*(ma[:4] + (ups,) + ma[5:]), **mkw)
    args = ha[:8] + (mp.n_pruned, mp.src_sorted, mp.pruned_slot) + ha[11:]
    assert int((mp.n_pruned > 0).sum()) > 0 and int(mp.pruned_slot.sum()) > 0
    kernels.reset_launch_counts()
    got = kernels.health_round_traffic(*args, **hkw)
    assert kernels.LAUNCHES["health_round_traffic"] == 1
    want = kernels.health_round_traffic_plain(*args, **hkw)
    _assert_equal(got, want, "health_round_traffic firing value rows")
    assert int((want[0] - ha[0]).sum()) == int(
        (mp.pruned_slot & (mp.n_pruned > 0)[..., None]).sum())


# ---- the flight recorder (trace outputs; trace_prune_pairs) ---------------

#: traced engine runs: push under loss + partition + churn with the
#: inbound ranking truncated and a prune cap that truncates, push-pull at
#: request cap 1, pull, adaptive
TRACE_CONFIGS = {
    "push_impaired": (2000, 4, 22, dict(
        warm_up_rounds=0, packet_loss_rate=0.1, churn_fail_rate=0.01,
        churn_recover_rate=0.2, partition_at=3, heal_at=12, impair_seed=5,
        inbound_cap=4, trace_prune_cap=500)),
    "push_pull_cap1": (2000, 4, 21, dict(
        warm_up_rounds=0, gossip_mode="push-pull", pull_fanout=4,
        pull_request_cap=1, packet_loss_rate=0.1, partition_at=3,
        heal_at=12, impair_seed=5)),
    "pull": (2000, 2, 21, dict(warm_up_rounds=0, gossip_mode="pull")),
    "adaptive": (2000, 3, 21, dict(warm_up_rounds=0, gossip_mode="adaptive",
                                   adaptive_switch_threshold=0.5)),
}
TRACED = ("push_targets", "rotate", "pull_exchange", "trace_prune_pairs")


@pytest.mark.parametrize("config", list(TRACE_CONFIGS))
def test_traced_kernels_equal_plain_on_engine_rounds(cuda, config):
    """Each traced call of a traced run equals its plain version, the same
    call without the trace gives the untraced call's outputs bit for bit,
    and the run's rows and state equal the same run on the CPU; the trace
    adds one ``trace_prune_pairs`` launch a round and nothing else."""
    n, n_origins, rounds, kw = TRACE_CONFIGS[config]
    stakes = np.random.default_rng(0).integers(1, 1 << 45,
                                               size=n).astype(np.int64)
    params = EngineParams(num_nodes=n, **kw)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        tables = make_cluster_tables(stakes, device=dev)
        origins = torch.arange(n_origins, dtype=torch.int32, device=dev)
        state = init_state(rng.prng_key(3, dev), tables, origins, params)
        runs[dev.type] = (tables, origins, state)
    tables, origins, state = runs["cuda"]
    calls = {name: [] for name in TRACED}
    real = {name: getattr(kernels, name) for name in TRACED}

    def recorder(name):
        def rec(*args, **kw):
            calls[name].append((args, kw))
            return real[name](*args, **kw)
        return rec

    kernels.reset_launch_counts()
    for name in TRACED:
        setattr(kernels, name, recorder(name))
    try:
        st, rows = run_rounds(params, tables, origins, state, rounds,
                              trace=True)
    finally:
        for name in TRACED:
            setattr(kernels, name, real[name])
    want = _launches_per_run(params, rounds)
    want["trace_prune_pairs"] = rounds
    assert {k: kernels.LAUNCHES[k] for k in want} == want
    for name in TRACED:
        plain = getattr(kernels, f"{name}_plain")
        for args, kw in calls[name]:
            got = real[name](*args, **kw)
            _assert_equal(got, plain(*args, **kw), name)
            if name != "trace_prune_pairs":
                off = dict(kw, trace=False)
                bare = {k: v for k, v in kw.items() if k != "trace"}
                _assert_equal(real[name](*args, **off),
                              real[name](*args, **bare), name + " off")
                n_plain = len(_outputs(real[name](*args, **bare)))
                _assert_equal(_outputs(got)[:n_plain],
                              real[name](*args, **bare), name + " on")
    c_tables, c_origins, c_state = runs["cpu"]
    c_st, c_rows = run_rounds(params, c_tables, c_origins, c_state, rounds,
                              trace=True)
    for f in st._fields:
        assert torch.equal(getattr(st, f).cpu(), getattr(c_st, f)), f
    assert set(rows) == set(c_rows)
    for k in rows:
        assert torch.equal(rows[k].cpu().nan_to_num(),
                           c_rows[k].nan_to_num()), k
    if config == "push_impaired":
        captured = (rows["trace_prune_src"] >= 0).sum(-1)
        assert bool((rows["prunes_sent"] > captured).any())
        assert int(rows["inb_dropped"].sum()) > 0


@pytest.mark.parametrize("cap", [1, 37, 4000, 160_000])
@pytest.mark.parametrize("r,n,c", [(1, 1, 64), (3, 1025, 9), (5, 3000, 64),
                                   (2, 10_000, 64)])
def test_trace_prune_pairs_equals_plain(cuda, r, n, c, cap):
    """Rows that fire densely, sparsely and not at all, N past one chunk of
    the scan and not a multiple of it, caps that truncate inside a row and
    past every pair."""
    g = np.random.default_rng(r * 7 + n + cap)
    share = np.linspace(0.0, 0.6, r)[:, None, None]
    slot = (g.random((r, n, c)) < share) & (g.random((r, n, 1)) < 0.3)
    t = lambda a: torch.as_tensor(a, device=cuda)
    args = (t(slot.sum(-1).astype(np.int32)), t(slot),
            t(g.integers(0, n, (r, n, c)).astype(np.int32)), cap)
    kernels.reset_launch_counts()
    got = kernels.trace_prune_pairs(*args)
    assert kernels.LAUNCHES["trace_prune_pairs"] == 1
    _assert_equal(got, kernels.trace_prune_pairs_plain(*args),
                  f"trace_prune_pairs r={r} n={n} c={c} cap={cap}")
    assert bool((got[0][0] == -1).all())
