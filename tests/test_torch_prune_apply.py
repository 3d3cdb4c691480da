"""``prune_apply``'s kernel schedule (csrc/prune_apply.cu) transcribed in
numpy and held against ``prune_apply_plain``.

The transcription follows the kernel's one cooperative launch: phase 1
copies the pruned plane in 16-byte vectors, grid-stride, with the bytes
past the last whole vector one at a time; after the grid barrier, phase 2
has each warp step over ``pruned_slot`` a vector a lane (a 16-bit mask of
the nonzero bytes), number the step's set bytes by a warp scan and hand
them to the lanes in turn (owner lane by binary search of the scan,
byte by its rank in the owner's mask).  Each live pair (pruner row,
prunee from ``src_sorted``) scans the prunee's slots for the pruner and
sets the bit.
Held on the port engine's recorded calls: the push round (a per-origin
active set) in the round whose upsert counters fire, and the traffic round
(its lane form: one [N, S] set per lane, shared by the lane's values), and
on dense synthetic inputs whose planes end in a partial vector.  Also the launch's grid (``grid_blocks``: one wave, or
fewer where the planes are small), and (hypothesis) that neither the plain
version nor the schedule reads ``src_sorted`` in rows whose
``pruned_slot`` is all zero (``rc_merge_prune`` orders only the rows that
fire).

Tolerance: 0 (exact equality of the pruned bits)."""

import importlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gossip_sim_tpu_torch import kernels, rng
from gossip_sim_tpu_torch.engine import (EngineParams, init_state,
                                         make_cluster_tables, run_rounds)
from gossip_sim_tpu_torch.engine import traffic as tt

pa = importlib.import_module("gossip_sim_tpu_torch.kernels.prune_apply")

VEC = pa.VECTOR
WARP = 32


def _warp_scan_owner(incl, k):
    """The kernel's binary search: lanes whose inclusive count is <= k."""
    owner = 0
    for b in (16, 8, 4, 2, 1):
        if incl[owner + b - 1] <= k:
            owner += b
    return owner


def _select_bit(m, j):
    """The position of the j-th (from 0) set bit of the 16-bit mask m, as
    the kernel's ``select_bit`` halves it."""
    pos = 0
    for b in (8, 4, 2, 1):
        low = m & ((1 << b) - 1)
        c = bin(low).count("1")
        if c <= j:
            j -= c
            m >>= b
            pos += b
        else:
            m = low
    return pos


def _prune_apply_schedule(pruned, active, src_sorted, pruned_slot,
                          grid=3):
    """csrc/prune_apply.cu on numpy arrays, at ``grid`` blocks of
    ``THREADS`` threads; returns the [O, N, S] pruned bits."""
    O, N, S = pruned.shape
    C = src_sorted.shape[-1]
    group = O if active.ndim == 2 else O // active.shape[0]
    stride = grid * pa.THREADS
    flat_in = pruned.reshape(-1).astype(np.uint8)
    out = np.full(flat_in.size, 7, np.uint8)    # 7: never written
    # phase 1: the copy, each vector and tail byte by one thread
    cvecs = flat_in.size // VEC
    for tid in range(stride):
        for i in range(tid, cvecs, stride):
            assert (out[i * VEC:(i + 1) * VEC] == 7).all()
            out[i * VEC:(i + 1) * VEC] = flat_in[i * VEC:(i + 1) * VEC]
        for j in range(cvecs * VEC + tid, flat_in.size, stride):
            out[j] = flat_in[j]
    assert (out != 7).all()
    # the grid barrier; phase 2: the live pairs, spread over each warp
    slot = pruned_slot.reshape(-1).astype(np.uint8)
    src = src_sorted.reshape(-1)
    act = active.reshape(-1)
    applied = []

    def apply(i):
        applied.append(i)
        row = i // C
        o_n = row - row % N
        t = row - o_n
        u = int(src[i])
        if u < 0 or u >= N:
            return
        prow = (o_n + u) * S
        arow0 = prow if group == 1 else ((o_n // N // group) * N + u) * S
        arow = act[arow0:arow0 + S]
        for j in range(S):
            if arow[j] == t:
                out[prow + j] = 1

    svecs = slot.size // VEC

    def mask_of(i):
        if i >= svecs:
            return 0
        nz = slot[i * VEC:(i + 1) * VEC] != 0
        return int((nz.astype(np.int64) << np.arange(VEC)).sum())

    for warp_first in range(0, stride, WARP):
        for w0 in range(warp_first, svecs, stride):
            masks = [mask_of(w0 + lane) for lane in range(WARP)]
            cnt = [bin(m).count("1") for m in masks]
            incl = np.cumsum(cnt)
            for k in range(int(incl[-1])):      # lane k % 32 takes pair k
                owner = _warp_scan_owner(incl, k)
                apply((w0 + owner) * VEC + _select_bit(
                    masks[owner], k - (incl[owner] - cnt[owner])))
    for tid in range(stride):
        for j in range(svecs * VEC + tid, slot.size, stride):
            if slot[j]:
                apply(j)
    # every live pair applied exactly once
    assert sorted(applied) == np.nonzero(slot)[0].tolist()
    return out.reshape(O, N, S).astype(bool)


def _stakes(n, seed=3):
    r = np.random.default_rng(seed)
    return r.choice(np.arange(1, 50 * n), size=n,
                    replace=False).astype(np.int64) * 10**6


def _recorded(run):
    """The prune_apply calls ``run()`` makes (the wrapper runs)."""
    calls = []
    real = kernels.prune_apply

    def rec(*a, **kw):
        calls.append(tuple(x.clone() for x in a))
        return real(*a, **kw)

    kernels.prune_apply = rec
    try:
        run()
    finally:
        kernels.prune_apply = real
    return calls


def _push_calls():
    n, o = 300, 3
    params = EngineParams(num_nodes=n, warm_up_rounds=0, received_cap=2,
                          rc_slots=16, min_num_upserts=4,
                          probability_of_rotation=0.2)
    stakes = _stakes(n)
    tables = make_cluster_tables(stakes, device="cpu")
    origins = torch.arange(o, dtype=torch.int32) * 7
    state = init_state(rng.prng_key(7, "cpu"), tables, origins, params)
    return _recorded(lambda: run_rounds(params, tables, origins, state, 12))


def _traffic_calls():
    n = 200
    params = EngineParams(num_nodes=n, traffic_values=8, traffic_rate=2,
                          warm_up_rounds=0, min_num_upserts=4,
                          probability_of_rotation=0.2, impair_seed=7)
    stakes = _stakes(n)
    tables = make_cluster_tables(stakes, device="cpu")
    ttables = tt.device_traffic_tables(stakes, device="cpu")
    state = tt.init_traffic_state(stakes, params, 5, device="cpu")
    return _recorded(lambda: tt.run_traffic_rounds(params, tables, ttables,
                                                   state, 10))


@pytest.mark.parametrize("which", ["push", "traffic"])
def test_prune_apply_schedule_equals_plain_on_rounds(which):
    """The two calls with the most live pairs of each run."""
    calls = _push_calls() if which == "push" else _traffic_calls()
    # the traffic round's one set per lane is shared by the lane's values
    assert ((calls[0][1].shape[0] < calls[0][0].shape[0])
            == (which == "traffic"))
    live = [int(c[3].sum()) for c in calls]
    busiest = sorted(range(len(calls)), key=lambda i: -live[i])[:2]
    assert live[busiest[0]] > 20
    for i in busiest:
        pruned, active, src, slot = calls[i]
        want = kernels.prune_apply_plain(pruned, active, src, slot)
        got = _prune_apply_schedule(pruned.numpy(), active.numpy(),
                                    src.numpy(), slot.numpy())
        np.testing.assert_array_equal(got, want.numpy())
        assert (want != pruned).any()


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("o,n,s,c", [(3, 37, 12, 10), (2, 50, 7, 64)])
def test_prune_apply_schedule_equals_plain_on_dense_pairs(o, n, s, c,
                                                          shared):
    """Half the slots live (vectors dense with pairs), planes that end in a
    partial vector (O * N * C and O * N * S not multiples of 16), and one
    or two grid steps."""
    r = np.random.default_rng(o * n + s)
    pruned = r.random((o, n, s)) < 0.1
    shape = (n, s) if shared else (o, n, s)
    active = r.integers(0, n + 1, size=shape).astype(np.int32)
    src = r.integers(0, n, size=(o, n, c)).astype(np.int32)
    slot = r.random((o, n, c)) < 0.5
    want = kernels.prune_apply_plain(torch.as_tensor(pruned),
                                     torch.as_tensor(active),
                                     torch.as_tensor(src),
                                     torch.as_tensor(slot))
    for grid in (1, 2):
        got = _prune_apply_schedule(pruned, active, src, slot, grid=grid)
        np.testing.assert_array_equal(got, want.numpy())
    assert (want.numpy() != pruned).any()


@pytest.mark.parametrize("plane,slots,per_sm,want", [
    (30_720_000, 163_840_000, 5, 660),     # traffic round, M=256
    (3_840_000, 20_480_000, 8, 1056),      # push round, O=32
    (120_000, 640_000, 8, 157),            # O=1: fewer blocks than a wave
    (7, 5, 5, 1),                          # a few bytes: one block
])
def test_prune_apply_grid_is_one_wave_or_less(plane, slots, per_sm, want):
    """One wave of blocks, or one thread a vector of the larger plane where
    that is fewer; the 64-bit index math past 2^31 - 1 bytes."""
    assert pa.grid_blocks(plane, slots, 132, per_sm) == want
    assert pa.wide_index(plane, slots) is False
    assert pa.wide_index(1 << 31, 0) and pa.wide_index(0, 1 << 31)
    assert not pa.wide_index((1 << 31) - 1, (1 << 31) - 1)


# ---- src_sorted is read at pruned slots only ------------------------------

@st.composite
def _rows_with_unfired(draw):
    """A prune_apply call (a per-origin or shared active set) whose
    ``pruned_slot`` rows are all zero in a drawn set of rows (the rows that
    did not fire), and a second ``src_sorted`` that differs from the first
    anywhere in those rows only."""
    o = draw(st.integers(1, 3))
    n = draw(st.integers(2, 24))
    s = draw(st.integers(1, 8))
    c = draw(st.integers(1, 12))
    shared = draw(st.booleans())
    seed = draw(st.integers(0, 2**32 - 1))
    r = np.random.default_rng(seed)
    pruned = r.random((o, n, s)) < 0.2
    active = r.integers(0, n + 1, size=(n, s) if shared else (o, n, s))
    src = r.integers(0, n + 1, size=(o, n, c))
    slot = r.random((o, n, c)) < 0.5
    unfired = r.random((o, n)) < draw(st.floats(0.0, 1.0))
    slot[unfired] = False
    src[slot] = r.integers(0, n, size=int(slot.sum()))  # pruned: a member
    other = np.where(unfired[..., None], r.integers(0, n + 1,
                                                    size=(o, n, c)), src)
    as_t = lambda a, dt: torch.as_tensor(a.astype(dt))
    return (as_t(pruned, np.bool_), as_t(active, np.int32),
            as_t(src, np.int32), as_t(other, np.int32),
            as_t(slot, np.bool_))


@settings(max_examples=60, deadline=None)
@given(_rows_with_unfired())
def test_prune_apply_ignores_src_sorted_in_rows_without_a_prune(call):
    """``rc_merge_prune`` leaves src_sorted of a row that did not fire in
    source order, not prune order: ``prune_apply_plain`` (and the kernel,
    whose schedule reads src_sorted at set pruned_slot bytes only) must
    give the same bits whatever those rows hold."""
    pruned, active, src, other, slot = call
    want = kernels.prune_apply_plain(pruned, active, src, slot)
    assert torch.equal(kernels.prune_apply_plain(pruned, active, other,
                                                 slot), want)
    sched = _prune_apply_schedule(pruned.numpy(), active.numpy(),
                                  other.numpy(), slot.numpy())
    assert np.array_equal(sched, want.numpy())
