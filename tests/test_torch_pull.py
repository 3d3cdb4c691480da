"""The port's pull and push-pull modes against the reference package's.

* ``pull_class_tables`` equals the reference's and the sampler's top-entry
  CDF; the peer table of ``pull_peers_plain`` equals the reference's scalar
  ``sample_pull_peer`` entry by entry;
* a transcription of ``csrc/pull_exchange.cu``'s schedule (a cluster of
  CTAs per origin owning node slices, counters updated from the other
  CTAs, the draws kept once, the request cap by passes of the least key
  over remote counters, the counts gathered by rank 0) equals
  ``pull_exchange_plain`` (the reference's stable-sort ranks), with the
  cap binding;
* ``round_step`` states and rows (``detail=True``) in ``push-pull`` at cap
  0 and 2 and in ``pull`` at interval 2, under loss + partition + churn,
  in both threefry layouts; push mode with the pull knobs set is push mode;
* the single-origin CLI's ``parity_snapshot()`` and deterministic Influx
  lines (``sim_pull`` among them), the all-origins aggregates, summary and
  Influx lines, and the ``pull-fanout`` sweep with its start-up error;
* the pull knobs' checks.

Parity tests import ``gossip_sim_tpu.engine`` first (64-bit types) and pin
both packages' threefry layout.  Tolerance: 0 everywhere (exact equality,
NaN == NaN in float rows)."""

import gossip_sim_tpu.engine as je  # noqa: I001  (64-bit types first)
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_sim_tpu import cli as ref_cli
from gossip_sim_tpu import pull as ref_pull
from gossip_sim_tpu.config import Config as RefConfig
from gossip_sim_tpu.identity import reset_unique_pubkeys as ref_reset
from gossip_sim_tpu.sinks import DatapointQueue as RefQueue
from gossip_sim_tpu.stats.gossip_stats import \
    GossipStatsCollection as RefCollection
from gossip_sim_tpu_torch import cli, kernels, pull, rng
from gossip_sim_tpu_torch.config import Config
from gossip_sim_tpu_torch.convert import state_to_numpy
from gossip_sim_tpu_torch.engine import core as tc
from gossip_sim_tpu_torch.engine.params import EngineParams as PortParams
from gossip_sim_tpu_torch.faults import edge_u32, node_u32, round_basis
from gossip_sim_tpu_torch.identity import reset_unique_pubkeys
from gossip_sim_tpu_torch.kernels.pull_exchange import (INF,
                                                        pull_exchange_plain,
                                                        pull_peers_plain)
from gossip_sim_tpu_torch.sinks import DatapointQueue
from gossip_sim_tpu_torch.stats.gossip_stats import GossipStatsCollection
from test_torch_aggregate import assert_state_dicts_equal, finalized

px = importlib.import_module("gossip_sim_tpu_torch.kernels.pull_exchange")

IMPAIRED = dict(packet_loss_rate=0.1, churn_fail_rate=0.02,
                churn_recover_rate=0.25, partition_at=8, heal_at=17,
                impair_seed=11)
CLI_BASE = ["--num-synthetic-nodes", "100", "--iterations", "16",
            "--warm-up-rounds", "8"]


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def layout(request):
    """Both packages in one threefry layout, the port on one CPU thread;
    restored afterwards."""
    old, old_port = jax.config.jax_threefry_partitionable, rng.partitionable()
    threads = torch.get_num_threads()
    jax.config.update("jax_threefry_partitionable", request.param)
    rng.set_partitionable(request.param)
    torch.set_num_threads(1)
    yield request.param
    jax.config.update("jax_threefry_partitionable", old)
    rng.set_partitionable(old_port)
    torch.set_num_threads(threads)


def stakes_of(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        1, 1 << 45, size=n).astype(np.int64)


def assert_state_equal(jstate, tstate, where=""):
    got = state_to_numpy(tstate)
    for f in jstate._fields:
        want, have = np.asarray(getattr(jstate, f)), getattr(got, f)
        assert want.dtype == have.dtype, (where, f, want.dtype, have.dtype)
        assert np.array_equal(want, have), (where, f)


def assert_rows_equal(jrows, trows):
    assert set(jrows) == set(trows)
    for k, v in jrows.items():
        want, have = np.asarray(v), trows[k].numpy()
        assert want.dtype == have.dtype, (k, want.dtype, have.dtype)
        assert np.array_equal(want, have, equal_nan=want.dtype.kind == "f"), k


def run_both(n, origins, rounds, seed=7, **kw):
    """``rounds`` rounds of both engines from their own ``init_state``:
    (reference state, rows, port state, rows)."""
    stakes = stakes_of(n)
    o = np.asarray(origins, dtype=np.int32)
    jt = je.make_cluster_tables(stakes)
    tt = tc.make_cluster_tables(stakes, device="cpu")
    jp, tp = je.EngineParams(num_nodes=n, **kw), PortParams(num_nodes=n, **kw)
    js = je.init_state(jax.random.PRNGKey(seed), jt, jnp.asarray(o), jp)
    ts = tc.init_state(rng.prng_key(seed), tt, torch.as_tensor(o), tp)
    js, jrows = je.run_rounds(jp, jt, jnp.asarray(o), js, rounds, start_it=0,
                              detail=True)
    ts, trows = tc.run_rounds(tp, tt, torch.as_tensor(o), ts, rounds,
                              start_it=0, detail=True)
    return js, jrows, ts, trows


def strings(snap: dict) -> dict:
    """Map the two packages' distinct Pubkey classes to base58 strings."""
    def key(k):
        return k.to_string() if hasattr(k, "to_string") else k
    return {name: ({key(k): x for k, x in v.items()} if isinstance(v, dict)
                   else {key(k) for k in v} if isinstance(v, set) else v)
            for name, v in snap.items()}


def sweeps_equal(argv) -> list:
    """``dispatch_sweeps`` of ``argv`` in both packages (the port on the
    CPU): every sim's parity snapshot and the deterministic Influx lines
    must be equal.  Returns the port's lines."""
    ref_reset()
    args = ref_cli.build_parser().parse_args(argv + ["--backend", "tpu"])
    coll, q = RefCollection(), RefQueue()
    ref_cli.dispatch_sweeps(ref_cli.config_from_args(args), "u",
                            args.origin_rank, coll, q, "77")
    want = [strings(s.parity_snapshot()) for s in coll.collection]
    want_lines = q.drain_deterministic_lines()
    reset_unique_pubkeys()
    args = cli.build_parser().parse_args(argv + ["--device", "cpu"])
    pcoll, pq = GossipStatsCollection(), DatapointQueue()
    cli.dispatch_sweeps(cli.config_from_args(args), "u", args.origin_rank,
                        pcoll, pq, "77")
    got = [strings(s.parity_snapshot()) for s in pcoll.collection]
    assert len(got) == len(want) == args.num_simulations
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for k in w:
            assert g[k] == w[k], (i, k)
    got_lines = pq.drain_deterministic_lines()
    assert len(got_lines) == len(want_lines)
    for n, (g, w) in enumerate(zip(got_lines, want_lines)):
        assert g == w, n
    return got_lines


# --------------------------------------------------------------------------
# the peer draw
# --------------------------------------------------------------------------

@pytest.mark.parametrize("stakes", [
    stakes_of(300),
    # one bucket holds every node: 24 empty classes around it
    np.full(40, 5 * 10**9, dtype=np.int64),
], ids=["spread", "one_class"])
def test_pull_class_tables_equal_reference_and_sampler(stakes):
    want = ref_pull.pull_class_tables(stakes)
    got = pull.pull_class_tables(stakes)
    for f in want._fields:
        w, g = getattr(want, f), getattr(got, f)
        assert w.dtype == g.dtype and np.array_equal(w, g), f
    tables = tc.make_cluster_tables(stakes, device="cpu")
    assert np.array_equal(got.cdf, tables.sampler.class_cdf[-1].numpy())
    assert np.array_equal(got.perm, tables.sampler.perm.numpy())


@pytest.mark.parametrize("seed,it", [(0, 0), (11, 7), (0xFFFFFFFF, 12345)])
def test_peer_draws_equal_sample_pull_peer(seed, it):
    n, slots = 200, 8
    stakes = stakes_of(n, seed=3)
    ref_tables = ref_pull.pull_class_tables(stakes)
    sm = tc.make_cluster_tables(stakes, device="cpu").sampler
    b_cls = round_basis(seed, it, pull.SALT_PULL_CLASS)
    b_mem = round_basis(seed, it, pull.SALT_PULL_MEMBER)
    table = pull_peers_plain(n, slots, b_cls, b_mem, sm.perm, sm.class_start,
                             sm.class_count, sm.class_cdf[-1]).numpy()
    want = np.array([[ref_pull.sample_pull_peer(ref_tables, b_cls, b_mem,
                                                node, slot)
                      for slot in range(slots)] for node in range(n)])
    assert np.array_equal(table, want)
    port_tables = pull.pull_class_tables(stakes)
    assert all(pull.sample_pull_peer(port_tables, b_cls, b_mem, node, slot)
               == want[node, slot] for node in range(0, n, 7)
               for slot in range(slots))
    # stake-weighted: the draws span many classes, and self-draws occur
    # only where a node draws itself
    assert len(np.unique(table)) > n // 4


# --------------------------------------------------------------------------
# the kernel's schedule on the CPU
# --------------------------------------------------------------------------

OK, SELF, SUP, DROP = range(4)   # a kept draw's gate (csrc/pull_exchange.cu)
NO_KEY = 0x7FFFFFFF


def kernel_schedule(reached, dist, failed, side, perm, cstart, ccount, cdf,
                    adaptive_on, fanout, pull_on, bases, fp_threshold, cap,
                    part_on, loss, cs, keep=True, seed=0):
    """``csrc/pull_exchange.cu``'s schedule on numpy arrays.  Per origin a
    cluster of ``cs`` CTAs; CTA r owns the nodes [r*S, (r+1)*S) (S from
    ``pull_exchange.shape``) as requesters and as peers, and its per-peer
    counters are arrays of its own that the other CTAs update through
    (rank, offset).  Each phase runs the CTAs, and each CTA its nodes, in a
    shuffled order (the atomics' order).  With the cap off one pass draws,
    gates, counts and transfers; with it on, phase 1 keeps each draw and
    its origin-independent gate (self, partition side, loss) where the
    geometry keeps words, the cluster's largest count is gathered by rank
    0, cap passes of the least key above the last run over the remote
    counters, and phase 3 reads the kept words (else draws again).  The
    per-CTA sums are gathered by rank 0.  Returns what
    ``pull_exchange_plain`` does, the requests the cap refused, and the
    draws made per origin."""
    O, n = reached.shape
    b_cls, b_mem, b_fp = bases
    g = px.shape(O, n, fanout, cap, cs, keep=keep)
    S = g.slice_len
    kept = g.draw_words > 0
    assert kept == (keep and cap > 0 and fanout > 0)
    gen = np.random.default_rng(seed)
    u01 = lambda h: np.float32(h >> 8) * np.float32(2.0 ** -24)
    bits = lambda a: [bool(x) for x in a]          # a staged bitmap

    def draw(node, slot, part):
        cls = int(np.count_nonzero(u01(edge_u32(b_cls, node, slot))
                                   >= cdf[:-1]))
        st, cnt = int(cstart[cls]), int(ccount[cls])
        pos = st + int(np.floor(u01(edge_u32(b_mem, node, slot))
                                * np.float32(cnt)))
        peer = int(perm[min(pos, st + max(cnt - 1, 0), n - 1)])
        if peer == node:
            return peer, SELF
        if part and sbit[node] != sbit[peer]:
            return peer, SUP
        if loss is not None and edge_u32(loss[0], node, peer) < loss[1]:
            return peer, DROP
        return peer, OK

    def owned(r):
        nodes = list(range(min(n, r * S), min(n, (r + 1) * S)))
        return [nodes[k] for k in gen.permutation(len(nodes))]

    def ctas():
        return gen.permutation(cs).tolist()

    hop = np.full((O, n), INF)
    egress, ingress = np.zeros((O, n), int), np.zeros((O, n), int)
    counts = np.zeros((O, 6), int)
    reached_all = np.zeros((O, n), bool)
    dist_all = np.zeros((O, n), int)
    capped, draws = 0, np.zeros(O, int)
    sbit = bits(side[:n])
    for o in range(O):
        gate = pull_on and fanout > 0 and (adaptive_on is None
                                           or adaptive_on[o])
        part = gate and part_on
        fbit, rbit = bits(failed[o]), bits(reached[o])
        req_in = [np.zeros(S, int) for _ in range(cs)]
        resp_out = [np.zeros(S, int) for _ in range(cs)]
        kth = [np.full(S, -1) for _ in range(cs)]
        nxt = [np.full(S, NO_KEY) for _ in range(cs)]
        words = [{} for _ in range(cs)]
        sums = np.zeros((cs, 5), int)   # arrived, responses, dropped,
        # suppressed, rescued
        at = lambda a, peer: (a[peer // S], peer % S)

        def add(a, peer, v=1):
            arr, k = at(a, peer)
            arr[k] += v

        def get(a, peer):
            arr, k = at(a, peer)
            return arr[k]

        def fresh(node, slot):
            draws[o] += 1
            return draw(node, slot, part)

        def word(r, node, slot):
            return words[r][node, slot] if kept else fresh(node, slot)

        def finish(i, t, best):
            ingress[o, i] = t
            hop[o, i] = best
            reached_all[o, i] = rbit[i] or best < INF
            dist_all[o, i] = dist[o, i] if rbit[i] else best

        def transfer(i, t, best, peer, slot, ranked):
            if not rbit[peer] or (ranked and get(req_in, peer) > cap
                                  and i * fanout + slot > get(kth, peer)):
                return t, best
            add(resp_out, peer)
            return t + 1, min(best, dist[o, peer] + 1)

        if cap <= 0:
            for r in ctas():                       # 1. one fused pass
                for i in owned(r):
                    a = t = 0
                    best = INF
                    if gate and not fbit[i]:
                        want = (not rbit[i]
                                and node_u32(b_fp, i) >= fp_threshold)
                        for slot in range(fanout):
                            peer, code = fresh(i, slot)
                            if code == SELF or fbit[peer]:
                                continue
                            sums[r, 3] += code == SUP
                            sums[r, 2] += code == DROP
                            if code != OK:
                                continue
                            add(req_in, peer)
                            a += 1
                            if want:
                                t, best = transfer(i, t, best, peer, slot,
                                                   False)
                    egress[o, i] = a
                    finish(i, t, best)
                    sums[r] += [a, t, 0, 0, best < INF]
        else:
            for r in ctas():                       # 1. requests
                for i in owned(r):
                    a = 0
                    if gate and not fbit[i]:
                        for slot in range(fanout):
                            peer, code = fresh(i, slot)
                            if kept:
                                words[r][i, slot] = (peer, code)
                            if code == SELF or fbit[peer]:
                                continue
                            sums[r, 3] += code == SUP
                            sums[r, 2] += code == DROP
                            if code == OK:
                                add(req_in, peer)
                                a += 1
                    egress[o, i] = a
                    sums[r, 0] += a
            # 2. the cluster's largest count (each CTA's, gathered by rank
            # 0), then the passes over the remote counters
            most = max(int(req_in[r].max()) if gate else 0
                       for r in range(cs))
            ranked = gate and most > cap
            for _ in range(cap if ranked else 0):
                for r in ctas():
                    for i in owned(r):
                        if fbit[i]:
                            continue
                        for slot in range(fanout):
                            peer, code = word(r, i, slot)
                            if (code != OK or fbit[peer]
                                    or get(req_in, peer) <= cap):
                                continue
                            key = i * fanout + slot
                            if key > get(kth, peer):
                                arr, k = at(nxt, peer)
                                arr[k] = min(arr[k], key)
                for r in range(cs):
                    kth[r], nxt[r] = nxt[r].copy(), np.full(S, NO_KEY)
            for r in ctas():                       # 3. transfers
                for i in owned(r):
                    t, best = 0, INF
                    if (gate and not fbit[i] and not rbit[i]
                            and node_u32(b_fp, i) >= fp_threshold):
                        for slot in range(fanout):
                            peer, code = word(r, i, slot)
                            if code != OK or fbit[peer]:
                                continue
                            t, best = transfer(i, t, best, peer, slot,
                                               ranked)
                    finish(i, t, best)
                    sums[r] += [0, t, 0, 0, best < INF]
            # (bookkeeping, no draw counted) the arrived requests the cap
            # refused
            for i in range(n):
                for slot in range(fanout if ranked and not fbit[i] else 0):
                    peer, code = draw(i, slot, part)
                    capped += (code == OK and not fbit[peer]
                               and get(req_in, peer) > cap
                               and i * fanout + slot > get(kth, peer))
        for r in ctas():                           # 4. the peers' side
            for i in owned(r):
                egress[o, i] += resp_out[r][i - r * S]
                ingress[o, i] += req_in[r][i - r * S]
        tot = sums.sum(0)                          # gathered by rank 0
        counts[o] = [tot[0], tot[1], tot[0] - tot[1], tot[2], tot[3],
                     tot[4]]
    return ((hop, egress, ingress, counts, reached_all, dist_all), capped,
            draws)


#: (N, pull fanout, pull round, cap, partition, loss, adaptive, cs, keep,
#: an origin whose nodes have all failed).  N = 121 no cs > 1 divides;
#: N = 7 leaves most CTAs of a cluster of 16 without a node.
SCHEDULE_CASES = [
    (120, 2, True, 0, None, False, False, 1, True, False),
    (120, 4, True, 1, True, True, True, 2, True, False),
    (120, 8, True, 2, False, True, False, 8, True, False),
    (120, 3, True, 3, True, False, True, 16, True, False),
    (120, 1, False, 0, None, True, False, 2, True, False),
    (120, 6, True, 2, True, True, True, 8, False, False),
    (121, 8, True, 5, True, True, False, 16, True, False),
    (121, 4, True, 2, None, False, False, 2, True, True),
    (121, 5, True, 0, True, True, True, 8, True, False),
    (121, 2, True, 1, None, True, False, 1, False, False),
    (121, 8, True, 5, True, False, False, 16, False, False),
    (121, 3, True, 0, True, False, False, 16, True, True),
    (7, 8, True, 1, True, True, False, 16, True, False),
    (121, 4, False, 2, None, False, True, 2, True, False),
]


@pytest.mark.parametrize("case", range(len(SCHEDULE_CASES)))
def test_kernel_schedule_equals_plain(case):
    """The kernel's schedule (csrc/pull_exchange.cu) gives what the plain
    version does: clusters of 1, 2, 8 and 16 CTAs, an N that no cluster
    size divides and one smaller than the cluster, caps 0, 1, 2, 3 and 5
    (binding), the draws kept and drawn again, partition on, off and
    absent, loss on and off, the adaptive bit, an origin whose nodes have
    all failed, and rounds off the pull interval; each request is drawn
    once per origin where the draws are kept or the cap is off."""
    (n, fanout, pull_on, cap, partition, lossy, adaptive_bits, cs, keep,
     all_failed) = SCHEDULE_CASES[case]
    gen = np.random.default_rng(case)
    O = 3
    tables = tc.make_cluster_tables(stakes_of(n, seed=case), device="cpu")
    sm = tables.sampler
    reached = torch.as_tensor(gen.random((O, n)) < 0.5)
    dist = torch.as_tensor(gen.integers(0, 9, (O, n)).astype(np.int32))
    failed = torch.as_tensor(gen.random((O, n)) < 0.1)
    if all_failed:
        failed[1] = True
    adaptive = (torch.as_tensor(np.array([True, False, True]))
                if adaptive_bits else None)
    kw = dict(fanout=fanout, slots=8, pull_on=pull_on,
              bases=(11 + case, 22 + case, 33), bloom_threshold=1 << 30,
              cap=cap, partition=partition,
              loss=(12345 + case, 1 << 31) if lossy else None)
    got = pull_exchange_plain(reached, dist, failed, tables.side, sm.perm,
                              sm.class_start, sm.class_count,
                              sm.class_cdf[-1], adaptive, **kw)
    want, capped, draws = kernel_schedule(
        reached.numpy(), dist.numpy(), failed.numpy(), tables.side.numpy(),
        sm.perm.numpy(), sm.class_start.numpy(), sm.class_count.numpy(),
        sm.class_cdf[-1].numpy(), None if adaptive is None
        else adaptive.numpy(), fanout, pull_on, kw["bases"],
        kw["bloom_threshold"], cap, bool(partition), kw["loss"], cs,
        keep=keep, seed=case)
    assert got._fields[:len(want)] == got._fields
    for name, g, w in zip(got._fields, got, want):
        assert np.array_equal(g.numpy(), w), name
    on = [pull_on and (adaptive is None or bool(adaptive[o]))
          for o in range(O)]
    live = [int((~failed[o]).sum()) * fanout if on[o] else 0
            for o in range(O)]
    if cap <= 0 or keep:
        assert draws.tolist() == live            # each request drawn once
    else:
        assert (draws >= live).all() and (draws > live).any()
    assert (capped > 0) == (cap > 0 and any(on))     # the cap binds
    if not pull_on:
        assert int(got.counts.abs().sum()) == 0
    if all_failed:
        assert int(got.counts[1].abs().sum()) == 0
        assert bool((got.pull_hop[1] == INF).all())


# --------------------------------------------------------------------------
# the round
# --------------------------------------------------------------------------

ROUND_CASES = {
    "push_pull": dict(gossip_mode="push-pull"),
    "push_pull_cap2": dict(gossip_mode="push-pull", pull_fanout=4,
                           pull_request_cap=2),
    "pull_interval2": dict(gossip_mode="pull", pull_interval=2,
                           pull_fanout=3),
}


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_round_step_equal(layout, case):
    """States and rows of 22 rounds under loss + partition + churn."""
    kw = dict(warm_up_rounds=5, **IMPAIRED, **ROUND_CASES[case])
    js, jrows, ts, trows = run_both(120, [0, 37, 101], 22, **kw)
    assert_state_equal(js, ts, case)
    assert_rows_equal(jrows, trows)
    for row in ("pull_requests", "pull_responses", "pull_rescued",
                "pull_dropped", "pull_suppressed"):
        assert int(trows[row].sum()) > 0, row
    assert int(trows["pull_hop"].max()) >= 1
    assert int(ts.pull_rescued_acc.sum()) > 0
    if case == "pull_interval2":
        # odd rounds send no pull request; no push is sent at all
        assert int(trows["pull_requests"][1::2].sum()) == 0
        assert int(trows["delivered"].sum()) == 0


def test_push_mode_ignores_the_pull_knobs(monkeypatch):
    """Push mode with every pull knob set is push mode: the same states
    and rows (and no pull row), and the pull kernel is never called."""
    def refuse(*a, **kw):
        raise AssertionError("pull_exchange called in push mode")

    monkeypatch.setattr(kernels, "pull_exchange", refuse)
    stakes = stakes_of(100)
    tt = tc.make_cluster_tables(stakes, device="cpu")
    o = torch.tensor([0, 50], dtype=torch.int32)
    out = []
    for kw in ({}, dict(pull_fanout=5, pull_interval=3, pull_request_cap=2,
                        pull_bloom_fp_rate=0.5, pull_slots=9,
                        adaptive_switch_threshold=0.3)):
        p = PortParams(num_nodes=100, warm_up_rounds=2, **IMPAIRED, **kw)
        st = tc.init_state(rng.prng_key(5), tt, o, p)
        out.append(tc.run_rounds(p, tt, o, st, 12, detail=True))
    (s0, r0), (s1, r1) = out
    for f in s0._fields:
        assert torch.equal(getattr(s0, f), getattr(s1, f)), f
    assert set(r0) == set(r1) and not any("pull" in k for k in r0)
    for k in r0:
        assert np.array_equal(r0[k].numpy(), r1[k].numpy(), equal_nan=(
            r0[k].dtype.is_floating_point)), k


# --------------------------------------------------------------------------
# the entry points
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode,sims", [
    # the pull-fanout sweep: F_pull = 2, 4, 6 in push-pull under loss
    (["--gossip-mode", "push-pull", "--packet-loss-rate", "0.1",
      "--test-type", "pull-fanout", "--num-simulations", "3",
      "--step-size", "2"], 3),
    (["--gossip-mode", "pull", "--pull-fanout", "4", "--pull-request-cap",
      "2", "--churn-fail-rate", "0.02", "--churn-recover-rate", "0.2",
      "--partition-at", "9", "--heal-at", "12"], 1),
], ids=["push_pull_loss_fanout_sweep", "pull_capped_impaired"])
def test_cli_parity_snapshot_and_influx_lines(layout, mode, sims):
    lines = sweeps_equal(CLI_BASE + mode)
    assert sum(ln.startswith("sim_pull,") for ln in lines) == 8 * sims


def test_pull_fanout_sweep_needs_a_pull_mode(caplog):
    argv = CLI_BASE + ["--test-type", "pull-fanout", "--num-simulations",
                       "2", "--device", "cpu"]
    assert cli.main(argv) == 1
    assert "requires a pull-capable --gossip-mode" in caplog.text


def test_all_origins_push_pull_equal(layout):
    """18 origins of 50 nodes at batch 16 (a padded tail) in push-pull
    under loss and churn: aggregates, finalized stats, summary (its pull
    keys among them) and Influx lines."""
    base = dict(num_synthetic_nodes=50, gossip_iterations=24,
                warm_up_rounds=8, all_origins=True, origin_batch=16,
                gossip_mode="push-pull", packet_loss_rate=0.1,
                churn_fail_rate=0.02, churn_recover_rate=0.25)
    origins = np.arange(0, 36, 2, dtype=np.int32)
    ref_reset()
    ref_cfg = RefConfig(**base, mesh_devices=1)
    accounts, _ = ref_cli.load_cluster_accounts(ref_cfg, "")
    ref_q = RefQueue()
    ref = ref_cli.run_all_origins(ref_cfg, "", dp_queue=ref_q, start_ts="5",
                                  accounts=accounts, origin_indices=origins)
    reset_unique_pubkeys()
    q = DatapointQueue()
    port = cli.run_all_origins(Config(**base, device="cpu"), dp_queue=q,
                               start_ts="5", origin_indices=origins)
    assert_state_dicts_equal(ref["stats"].state_dict(),
                             port["stats"].state_dict())
    assert finalized(ref["stats"]) == finalized(port["stats"])
    keys = set(ref) - {"elapsed_s", "origin_iters_per_sec", "stats"}
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}
    assert port["pull_rescued"] > 0 and port["pull_requests"] > 0
    lines = q.drain_deterministic_lines()
    assert lines == ref_q.drain_deterministic_lines()
    assert sum(ln.startswith("sim_pull,") for ln in lines) == 1


# --------------------------------------------------------------------------
# checks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(gossip_mode="push-pull", pull_fanout=9, pull_slots=8),
     "pull_fanout exceeds"),
    (dict(gossip_mode="pull", pull_fanout=0), "pull_fanout must be"),
    (dict(gossip_mode="pull", pull_interval=0), "pull_interval must be"),
    (dict(gossip_mode="push-pull", pull_bloom_fp_rate=1.5),
     "pull_bloom_fp_rate"),
    (dict(gossip_mode="push-pull", representation="sparse"),
     "dense representation"),
    (dict(gossip_mode="gossip"), "unknown gossip_mode"),
])
def test_params_checks(kw, match):
    with pytest.raises(ValueError, match=match):
        PortParams(num_nodes=40, **kw).validate()
    # an auto-sized width takes a fanout past 8
    assert PortParams(40, gossip_mode="pull",
                      pull_fanout=12).split()[0].pull_slots == 12


@pytest.mark.parametrize("argv,match", [
    (["--pull-bloom-fp-rate", "1.2"], "pull-bloom-fp-rate"),
    (["--gossip-mode", "pull", "--pull-fanout", "0"], "pull-fanout"),
    (["--gossip-mode", "push-pull", "--pull-interval", "0"],
     "pull-interval"),
])
def test_cli_checks(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.config_from_args(cli.build_parser().parse_args(CLI_BASE + argv))
