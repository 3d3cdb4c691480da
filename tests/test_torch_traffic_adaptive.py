"""The port's adaptive traffic round (the per-value pull rescue) against the
reference package's.

* ``engine.traffic.traffic_round_step`` in ``gossip_mode="adaptive"`` on
  the CPU equals the reference's ``traffic_round_step`` (JAX on the CPU)
  in every ``TrafficState`` field and every row (``detail`` rows and the
  pull_* rows included) after each of 16-20 rounds, from the same stakes
  and seed, at switch threshold 0.3 (so that values switch): caps off, the
  egress cap binding, the ingress cap binding, and loss + churn + a
  partition with both caps; rescues, pull deferrals and pull queue drops
  each happen in some case;
* ``traffic_rescue_plain``, on the port's calls of the impaired run,
  against the reference block's outputs: the rescue hops
  (``trace_pull_hop``), the pull_* counts and, with the push kernels'
  parts taken out, the per-node rows;
* ``traffic_rescue``'s kernel schedule (tiles of 32 requesters, 8 value
  chunks each, the egress count carried across the chunks, the count walk
  and its last block's cut or bucket per peer, the fill walk in a seeded
  order, the radix select 8 bits a pass, the final walk) transcribed in
  numpy against the plain twin on seeded inputs: caps off, egress cap 1,
  ingress cap 1, both binding under loss + a partition, a hub peer with
  more requests than any fixed bucket, no pull-phase value and every
  value in its pull phase.

Both threefry layouts are pinned as in the push-mode parity tests (the
traffic draws are counter hashes).  Tolerance: 0 (exact equality of every
array)."""

import gossip_sim_tpu.engine as je  # noqa: I001  (64-bit types first)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_sim_tpu.engine import traffic as jtraffic
from gossip_sim_tpu_torch import kernels, rng
from gossip_sim_tpu_torch.convert import traffic_state_to_numpy
from gossip_sim_tpu_torch.engine import core as tc
from gossip_sim_tpu_torch.engine import traffic as tt
from gossip_sim_tpu_torch.engine.params import EngineParams as PortParams
from gossip_sim_tpu_torch.faults import (edge_u32_t, node_u32_t,
                                         rate_threshold)
from gossip_sim_tpu_torch.kernels.traffic_rescue import (BIG, COUNT_NAMES,
                                                        key_bits)
from gossip_sim_tpu_torch.traffic import (TrafficTables, class_draw_arr,
                                          traffic_tables, u01_t,
                                          value_basis_t)

N, M = 200, 8
BASE = dict(num_nodes=N, traffic_values=M, traffic_rate=2,
            warm_up_rounds=3, probability_of_rotation=0.2, impair_seed=7,
            min_num_upserts=6, gossip_mode="adaptive",
            adaptive_switch_threshold=0.3)
#: case -> (knobs beyond BASE, rounds)
CASES = {
    "caps_off": (dict(), 16),
    "egress_cap": (dict(node_egress_cap=8), 16),
    "ingress_cap": (dict(node_ingress_cap=4), 16),
    "impaired_capped": (dict(packet_loss_rate=0.1, churn_fail_rate=0.02,
                             churn_recover_rate=0.3, partition_at=4,
                             heal_at=12, node_ingress_cap=6,
                             node_egress_cap=9), 20),
}
#: the case whose reference rounds also give the flight-recorder rows
TRACED = "impaired_capped"
RECORDED = ("traffic_send", "traffic_admit", "traffic_rescue")


@pytest.fixture(autouse=True)
def partitionable():
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


def _stakes(n, seed=3):
    r = np.random.default_rng(seed)
    return r.choice(np.arange(1, 50 * n), size=n,
                    replace=False).astype(np.int64) * 10**6


@functools.lru_cache(maxsize=None)
def _reference_step(static, trace):
    """The reference's round, jitted once per static shape."""
    stakes = _stakes(N)
    jt, jtt = je.make_cluster_tables(stakes), jtraffic.device_traffic_tables(
        stakes)
    return jax.jit(lambda st, it, kn: jtraffic.traffic_round_step(
        static, jt, jtt, st, it, detail=True, trace=trace, knobs=kn))


#: the per-run planes of each recorded kernel's arguments: the engine's
#: round calls every traffic kernel in its lane form, with a leading lane
#: axis (one lane here); the other arguments are shared or scalars
_LANE_ARGS = {"traffic_send": range(7), "traffic_admit": range(3),
              "traffic_rescue": (0, 1, 2, 3, 4, 5, 11, 12)}


def _one_run(name, args, out):
    """A one-lane call of kernel ``name`` (arguments and outputs) in the
    kernel's one-run form."""
    args = tuple(a[0] if i in _LANE_ARGS[name] else a
                 for i, a in enumerate(args))
    return args, type(out)(*(t[0] for t in out))


@functools.lru_cache(maxsize=None)
def _run_case(case):
    """Both engines through the case's rounds from one seed.  Returns the
    first difference (None if none), the reference's rows per round and the
    port's calls of the three traffic kernels (inputs, outputs) per
    round."""
    knobs, rounds = CASES[case]
    jp = je.EngineParams(**{**BASE, **knobs})
    pp = PortParams(**{**BASE, **knobs})
    stakes = _stakes(N)
    step = _reference_step(jp.static_part(), case == TRACED)
    js = jtraffic.init_traffic_state(stakes, jp, 5)
    tables = tc.make_cluster_tables(stakes, device="cpu")
    ttables = tt.device_traffic_tables(stakes, device="cpu")
    ps = tt.init_traffic_state(stakes, pp, 5, device="cpu")
    calls = {name: [] for name in RECORDED}
    real = {name: getattr(kernels, name) for name in RECORDED}

    def recorder(name):
        def rec(*args, **kw):
            out = real[name](*args, **kw)
            one_args, one_out = _one_run(name, args, out)
            calls[name].append((one_args, kw, one_out))
            return out
        return rec

    ref_rows = []
    for name in RECORDED:
        setattr(kernels, name, recorder(name))
    try:
        for it in range(rounds):
            js, jrows = step(js, jnp.int32(it), jp.knob_values())
            ps, prows = tt.traffic_round_step(pp, tables, ttables, ps, it,
                                              detail=True)
            jrows = {k: np.asarray(v) for k, v in jrows.items()}
            ref_rows.append(jrows)
            got = traffic_state_to_numpy(ps)
            for f in got._fields:
                a, b = np.asarray(getattr(js, f)), getattr(got, f)
                if a.dtype != b.dtype or not np.array_equal(a, b):
                    return f"round {it}: state.{f}", ref_rows, calls
            for k, a in jrows.items():
                if k.startswith("trace_"):
                    continue
                b = prows[k].numpy()
                if a.dtype != b.dtype or not np.array_equal(a, b):
                    return f"round {it}: rows[{k!r}]", ref_rows, calls
            if set(prows) != {k for k in jrows if not k.startswith("trace")}:
                return f"round {it}: row keys differ", ref_rows, calls
    finally:
        for name in RECORDED:
            setattr(kernels, name, real[name])
    return None, ref_rows, calls


@pytest.mark.parametrize("case", list(CASES))
def test_adaptive_traffic_round_equals_reference(case):
    diff, rows, calls = _run_case(case)
    assert diff is None, diff
    total = lambda k: int(sum(r[k] for r in rows))
    knobs = CASES[case][0]
    assert len(calls["traffic_rescue"]) == len(rows)
    assert total("switched_to_pull") > 0 and total("pull_active_values") > 0
    assert total("pull_rescued") > 0 and total("pull_responses") > 0
    if "node_egress_cap" in knobs:
        assert total("pull_deferred") > 0
    else:
        assert total("pull_deferred") == 0
    if "node_ingress_cap" in knobs:
        assert total("pull_queue_dropped") > 0
    else:
        assert total("pull_queue_dropped") == 0
    if case == TRACED:
        for k in ("pull_failed_target", "pull_suppressed", "pull_dropped"):
            assert total(k) > 0, k


def test_traffic_rescue_plain_equals_the_reference_block():
    """The rescue's outputs on every round of the impaired run against the
    reference's rows: the hop of each rescue (the flight recorder's
    ``trace_pull_hop``, -1 for none), the eleven pull_* counts, the values
    in their pull phase, and the per-node rows with the push round's parts
    (from the recorded ``traffic_send`` and ``traffic_admit`` outputs)
    taken out."""
    diff, rows, calls = _run_case(TRACED)
    assert diff is None, diff
    for r, ref in enumerate(rows):
        args, _, out = calls["traffic_rescue"][r]
        assert torch.equal(out.pull_del, out.pull_hop >= 0)
        np.testing.assert_array_equal(out.pull_hop.numpy(),
                                      ref["trace_pull_hop"])
        np.testing.assert_array_equal(args[0].numpy().astype(np.int8),
                                      ref["trace_value_pull"])
        for name, got in zip(COUNT_NAMES[:-1], out.counts[:-1]):
            assert int(got) == int(ref[name]), (r, name)
        code = calls["traffic_send"][r][2].code
        adm = calls["traffic_admit"][r][2]
        push_sent = ((code != 0) & (code != 5)).sum((0, 2))
        push_def = (code == 5).sum((0, 2))
        sent, deferred, resp_in, arrived, served, resp_out = (
            out.per_node.long())
        acc = adm.accepted_node.long()
        for name, want in (
                ("node_deferred", push_def + deferred),
                ("node_sent", push_sent + sent + resp_out),
                ("node_recv", acc + served + resp_in),
                ("node_queue_dropped",
                 adm.arrived_node.long() - acc + arrived - served)):
            np.testing.assert_array_equal(want.numpy(), ref[name],
                                          err_msg=f"round {r}: {name}")


WARPS = 8      # value chunks of a requester tile
TILE = 32      # requesters of a tile


def _draws(args, kw):
    """Each request's peer, loss hash and each (value, requester)'s bloom
    event: the same hashes as the plain twin (the schedule below is what
    the transcription checks)."""
    (pull_on, vid, holder_pre, *_rest) = args
    perm, cstart, ccount, cdf = args[7:11]
    V, n = holder_pre.shape
    F = kw["fanout"]
    nodes = torch.arange(n)
    slots = torch.arange(F)
    vb = lambda b: value_basis_t(b, vid)[:, None, None]
    tables = TrafficTables(perm, cstart, ccount, cdf)
    peers = class_draw_arr(
        tables, u01_t(edge_u32_t(vb(kw["draw"][0]), nodes[None, :, None],
                                 slots[None, None, :])),
        u01_t(edge_u32_t(vb(kw["draw"][1]), nodes[None, :, None],
                         slots[None, None, :])))
    loss = kw.get("loss")
    ue = (edge_u32_t(vb(loss[0]), nodes[None, :, None], peers.long())
          if loss is not None else None)
    fp = node_u32_t(vb(kw["bloom"][0])[:, :, 0], nodes[None, :]) < kw[
        "bloom"][1]
    return (peers.numpy(), None if ue is None else ue.numpy(), fp.numpy())


def _rescue_schedule(args, kw, seed=0):
    """csrc/traffic_rescue.cu in numpy.  A block per tile of 32 requesters
    lists the pull-phase values in value order, and its 8 warps each take a
    contiguous share of ceil(len / 8) of them; with the egress cap on, each
    lane's wanted requests over the shares before its warp's (and its push
    sends) start its running count.  With the ingress cap on: the
    count walk adds each arrival to its peer's count, its last block sets
    every peer's cut (0: none served, BIG: all) or lists it, with a bucket
    placed by a block scan of 256 peers a step (carried); the fill walk
    writes each arrival at a listed peer into its bucket in a seeded order
    (the atomics' order); the select finds the k-th smallest key of each
    bucket by a radix select of 8 bits a pass (a warp's lanes each summing
    8 bins).  The final walk decides every request and writes every (value,
    requester) once: the final walk's block first those of the values not
    in their pull phase.  Returns the outputs as numpy arrays in
    RescueOut's order, and the largest bucket."""
    r = np.random.default_rng(seed)
    a = [x.numpy() if torch.is_tensor(x) else x for x in args]
    (pull_on, vid, holder_pre, hop_pre, holder, failed, side, _perm, _cs,
     _cc, _cdf, push_out, acc_node) = a
    V, n = holder_pre.shape
    F, H, pb = kw["fanout"], kw["hist_bins"], kw["pb"]
    ecap, icap = kw["egress_cap"], kw["ingress_cap"]
    part = bool(kw.get("partition"))
    loss = kw.get("loss")
    peers, ue, fp = _draws(args, kw)
    pulls = [v for v in range(V) if pull_on[v]]
    span = -(-len(pulls) // WARPS)
    tiles = -(-n // TILE)
    bits = key_bits(V, n, F)
    per_node = np.zeros((6, n), np.int64)
    per_value = np.zeros((4, V), np.int64)
    counts = np.zeros(12, np.int64)
    pull_del = np.full((V, n), 2, np.int64)     # 2: never written
    pull_hop = np.zeros((V, n), np.int64)
    cut = np.zeros(n, np.int64)
    offset = np.zeros(n, np.int64)

    def lanes():
        for t in range(tiles):
            for w in range(WARPS):
                p0 = min(len(pulls), w * span)
                for node in range(t * TILE, min(n, t * TILE + TILE)):
                    yield w, pulls[p0:p0 + span], node

    eoff = {}
    if ecap > 0:
        wanted = {}
        for w, share, node in lanes():
            alive = not failed[node]
            wanted[w, node] = sum(
                int(peers[v, node, s] != node) for v in share
                if alive and not holder_pre[v, node] for s in range(F))
        for w, _, node in lanes():
            eoff[w, node] = push_out[node] + sum(
                wanted[x, node] for x in range(w))

    def walk(phase, events):
        if phase == "final":
            # the tiles' entries of the values not in their pull phase
            for v in range(V):
                if not pull_on[v]:
                    pull_del[v], pull_hop[v] = 0, -1
        for w, share, node in lanes():
            run = eoff.get((w, node), 0)
            alive = not failed[node]
            for v in share:
                if not (alive and not holder_pre[v, node]):
                    if phase == "final":
                        pull_del[v, node], pull_hop[v, node] = 0, -1
                    continue
                win = BIG
                for s in range(F):
                    peer = int(peers[v, node, s])
                    if peer == node:
                        continue
                    sent = ecap <= 0 or run < ecap
                    run += 1
                    if phase == "final":
                        counts[0 if sent else 1] += 1
                        per_node[0 if sent else 1, node] += 1
                    if not sent:
                        continue
                    if failed[peer]:
                        counts[2] += phase == "final"
                        continue
                    if part and side[peer] != side[node]:
                        counts[3] += phase == "final"
                        continue
                    if loss is not None and ue[v, node, s] < loss[1]:
                        counts[4] += phase == "final"
                        continue
                    key = (v * n + node) * F + s
                    if phase != "final":
                        events.append((peer, key))
                        continue
                    counts[5] += 1
                    if icap <= 0:
                        per_node[3, peer] += 1
                    if icap > 0 and key >= cut[peer]:
                        counts[6] += 1
                        per_value[3, v] += 1
                        continue
                    counts[7] += 1
                    per_value[0, v] += 1
                    per_node[4, peer] += 1
                    if fp[v, node] or not holder_pre[v, peer]:
                        continue
                    counts[8] += 1
                    per_value[1, v] += 1
                    per_node[2, node] += 1
                    per_node[5, peer] += 1
                    th = hop_pre[v, peer] + 1
                    ch = min(th, H - 1)
                    win = min(win, (((ch << 1) | int(th > H - 1)) << pb)
                              | peer)
                if phase == "final":
                    held = bool(holder[v, node])
                    dl = win != BIG and not held
                    pull_del[v, node] = dl
                    pull_hop[v, node] = win >> (pb + 1) if dl else -1
                    counts[9] += dl
                    counts[11] += dl and (win >> pb) & 1
                    per_value[2, v] += dl

    biggest = 0
    if icap > 0:
        arrivals = []
        walk("count", arrivals)
        for peer, _ in arrivals:
            per_node[3, peer] += 1
        k_of = icap - np.minimum(acc_node, icap)
        carry = 0
        listed = []
        for p0 in range(0, n, 256):
            for p in range(p0, min(n, p0 + 256)):
                c, k = per_node[3, p], k_of[p]
                cut[p] = 0 if k <= 0 else (BIG if c <= k else -1)
            step = [p for p in range(p0, min(n, p0 + 256)) if cut[p] == -1]
            for p in step:
                offset[p] = carry
                carry += per_node[3, p]
            listed += step
        bucket = np.full(carry, -1, np.int64)
        fill = np.zeros(n, np.int64)
        events = []
        walk("fill", events)
        for i in r.permutation(len(events)):
            peer, key = events[i]
            if cut[peer] == -1:
                bucket[offset[peer] + fill[peer]] = key
                fill[peer] += 1
        for p in listed:
            c = per_node[3, p]
            assert fill[p] == c
            biggest = max(biggest, c)
            keys = bucket[offset[p]:offset[p] + c]
            k = int(k_of[p])
            prefix = mask = 0
            for shift in range(((bits - 1) // 8) * 8, -1, -8):
                hist = np.bincount((keys[(keys & mask) == prefix] >> shift)
                                   & 255, minlength=256)
                sums = hist.reshape(32, 8).sum(1)
                incl = np.cumsum(sums)
                lane = int(np.nonzero((incl - sums <= k) & (k < incl))[0][0])
                k -= int(incl[lane] - sums[lane])
                d = 0
                while k >= hist[lane * 8 + d]:
                    k -= int(hist[lane * 8 + d])
                    d += 1
                prefix |= (lane * 8 + d) << shift
                mask |= 0xFF << shift
            assert (keys < prefix).sum() == k_of[p]
            cut[p] = prefix
    walk("final", None)
    counts[10] = int(pull_on.sum())
    if icap <= 0:
        per_node[4] = per_node[3]
    assert (pull_del != 2).all() and counts[10] == len(pulls)
    return (pull_del.astype(bool), pull_hop, per_value, per_node,
            counts), biggest


def _inputs(seed, v, n, hub=False, pull="some"):
    """Seeded inputs of any content the kernel takes: values in their pull
    phase at random (or none, or all), holders at random (a fifth of the
    values' rows mostly missing), hops past the histogram's last bin, a
    tenth of the nodes failed, two sides, push sends and acceptances up to
    and past the caps.  ``hub``: one node holds most of the stake, alone in
    its class, so that it draws a large share of the requests."""
    r = np.random.default_rng(seed)
    stakes = r.integers(1, 10**6, size=n).astype(np.int64) * 1000
    if hub:
        stakes[n // 3] = stakes.sum() * 50
    tables = traffic_tables(stakes)
    pull_on = {"some": r.random(v) < 0.6, "none": np.zeros(v, bool),
               "all": np.ones(v, bool)}[pull]
    holder_pre = r.random((v, n)) < np.where(r.random(v) < 0.2, 0.2,
                                             0.7)[:, None]
    holder = holder_pre | (r.random((v, n)) < 0.2)
    hop_pre = np.where(holder_pre, r.integers(0, 70, size=(v, n)), -1)
    t = torch.as_tensor
    return (t(pull_on), t(r.integers(0, 1 << 20, size=v).astype(np.int32)),
            t(holder_pre), t(hop_pre.astype(np.int32)), t(holder),
            t(r.random(n) < 0.1),
            t(r.integers(0, 2, size=n + 1).astype(np.int32)),
            *(t(x) for x in tables),
            t(r.integers(0, 12, size=n).astype(np.int32)),
            t(r.integers(0, 10, size=n).astype(np.int32)))


def _kw(fanout, ecap, icap, impaired):
    kw = dict(fanout=fanout, hist_bins=64, pb=14, egress_cap=ecap,
              ingress_cap=icap, draw=(0x1234567, 0x89ABCDEF),
              bloom=(0x2468ACE, rate_threshold(0.1)))
    if impaired:
        kw.update(partition=True, loss=(0x13579BD, rate_threshold(0.15)))
    return kw


#: case -> (seed, V, N, fanout, egress cap, ingress cap, impaired, hub,
#: pull-phase values).  V = 33 leaves the last warps of a tile short or
#: empty, N = 300 a short last tile.
SCHEDULE_CASES = {
    "caps_off": (1, 33, 300, 3, 0, 0, False, False, "some"),
    "egress_one": (2, 33, 300, 3, 1, 0, False, False, "some"),
    "ingress_one": (3, 33, 300, 3, 0, 1, False, False, "some"),
    "both_binding": (4, 40, 250, 2, 14, 12, True, False, "some"),
    "hub": (5, 24, 300, 4, 0, 30, True, True, "all"),
    "no_pull_value": (6, 33, 300, 3, 14, 12, True, False, "none"),
    "all_pull": (7, 17, 200, 2, 10, 11, False, False, "all"),
}


@pytest.mark.parametrize("case", list(SCHEDULE_CASES))
def test_traffic_rescue_schedule_equals_plain(case):
    seed, v, n, fanout, ecap, icap, impaired, hub, pull = SCHEDULE_CASES[
        case]
    args = _inputs(seed, v, n, hub=hub, pull=pull)
    kw = _kw(fanout, ecap, icap, impaired)
    want = kernels.traffic_rescue_plain(*args, **kw)
    got, biggest = _rescue_schedule(args, kw, seed=seed)
    for name, x, y in zip(want._fields, got, want):
        np.testing.assert_array_equal(x, y.numpy(), err_msg=name)
    counts = dict(zip(COUNT_NAMES, want.counts.tolist()))
    if pull == "none":
        assert not any(counts.values())
        return
    assert counts["pull_rescued"] > 0 and counts["hop_clamped"] > 0
    assert (counts["pull_deferred"] > 0) == (ecap > 0)
    assert (counts["pull_queue_dropped"] > 0) == (icap > 0)
    if icap > 0:
        # a cut inside some peer's arrivals: a bucket was selected
        assert biggest > 0
    if hub:
        assert biggest > 4 * 32
