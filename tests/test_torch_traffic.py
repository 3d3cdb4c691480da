"""The port's concurrent-traffic round against the reference package's.

* ``engine.traffic.traffic_round_step`` on the CPU equals the reference's
  ``traffic_round_step`` (JAX on the CPU) in every ``TrafficState`` field
  and every row (``detail`` rows included) after each of ~15-20 rounds,
  both started from the same stakes and seed: caps off, the egress cap
  binding, the ingress cap binding, loss + churn + partition with both
  caps, a value table that fills (injections dropped) and stall
  retirement;
* the plain twins of the two traffic kernels against the reference's
  blocks on every round of the impaired run: ``traffic_send_plain``'s
  peers and outcome codes against the reference's flight-recorder
  ``trace_peers``/``trace_code`` (its candidates, egress and network
  masks), ``traffic_admit_plain``'s acceptances and node counts against
  ``trace_code``'s accepted entries and the ``node_recv`` /
  ``node_queue_dropped`` rows;
* ``traffic_send``'s kernel schedule (tiles of 32 senders x 32 values,
  the prune tile staged only where it covers a live holder, the egress
  count across value chunks by a decoupled look-back with its waves and
  orders seeded, the transposed slot words) transcribed in numpy against
  the plain twin, on round inputs and at ragged shapes, at egress caps
  off, 1, binding and above every sender's candidates;
* ``traffic_admit``'s kernel schedule (a tally per sender into each
  target's total and bucket of in-neighbours, one cut per target past the
  cap, the acceptance plane written from the sender side in tiles)
  transcribed in numpy, against the plain twin and against a flat sort of
  ``traffic_send``'s peers and outcome codes, at caps off, 1, binding and
  above every target's arrivals, and on a set whose hubs have more
  in-neighbours than a bucket holds.

The push round's calls of the two kernels that gained an argument
(``rc_merge_prune``'s live mask, ``prune_apply``'s shared active set) are
checked in tests/test_torch_kernels.py.  The traffic draws are counter
hashes; both threefry layouts are pinned all the same, as in the other
parity tests.
Tolerance: 0 (exact equality of every array)."""

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

N, M = 200, 8
BASE = dict(num_nodes=N, traffic_values=M, traffic_rate=2,
            warm_up_rounds=3, probability_of_rotation=0.2, impair_seed=7,
            min_num_upserts=6)
#: case -> (knobs beyond BASE, rounds)
CASES = {
    "caps_off": (dict(), 16),
    "egress_cap": (dict(node_egress_cap=8), 16),
    "ingress_cap": (dict(node_ingress_cap=4), 16),
    "impaired_capped": (dict(packet_loss_rate=0.1, churn_fail_rate=0.02,
                             churn_recover_rate=0.3, partition_at=4,
                             heal_at=12, node_ingress_cap=6,
                             node_egress_cap=9), 20),
    "table_fills": (dict(traffic_rate=5), 12),
    "stall_retire": (dict(traffic_stall_rounds=1, node_ingress_cap=2),
                     14),
}
#: the case whose reference rounds also give the flight-recorder rows
TRACED = "impaired_capped"


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
    """The reference's round, jitted once per static shape (the knobs are
    traced, so the cases of one shape share it)."""
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
    port's traffic_send / traffic_admit calls (inputs, outputs) per round."""
    knobs, rounds = CASES[case]
    jp = je.EngineParams(**{**BASE, **knobs})
    pp = PortParams(**{**BASE, **knobs})
    stakes = _stakes(N)
    step = _reference_step(jp.static_part(), case == TRACED)
    js = jtraffic.init_traffic_state(stakes, jp, 5)
    tables = tc.make_cluster_tables(stakes, device="cpu")
    ttables = tt.device_traffic_tables(stakes, device="cpu")
    ps = tt.init_traffic_state(stakes, pp, 5, device="cpu")
    calls = {"traffic_send": [], "traffic_admit": []}
    real = {name: getattr(kernels, name) for name in calls}

    def recorder(name):
        def rec(*args, **kw):
            out = real[name](*args, **kw)
            one_args, one_out = _one_run(name, args, out)
            calls[name].append((one_args, kw, one_out))
            return out
        return rec

    ref_rows = []
    for name in calls:
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
        for name in calls:
            setattr(kernels, name, real[name])
    return None, ref_rows, calls


@pytest.mark.parametrize("case", list(CASES))
def test_traffic_round_equals_reference(case):
    diff, rows, _ = _run_case(case)
    assert diff is None, diff
    total = lambda k: int(sum(r[k] for r in rows))
    knobs = CASES[case][0]
    assert total("delivered") > 0
    if case == "caps_off":
        assert total("deferred") == total("queue_dropped") == 0
        assert total("prunes_sent") > 0 and total("retired") > 0
    if "node_egress_cap" in knobs:
        assert total("deferred") > 0
    if "node_ingress_cap" in knobs:
        assert total("queue_dropped") > 0
    if case == TRACED:
        for k in ("failed_target", "suppressed", "dropped"):
            assert total(k) > 0, k
    if case == "table_fills":
        assert total("inject_dropped") > 0
    if case == "stall_retire":
        assert total("retired") > total("converged")


def test_traffic_send_plain_equals_the_reference_blocks():
    """Candidates, egress budget and gates: the outcome codes before the
    ingress cap (an arrival is ACCEPTED, whichever way the cap decides it)
    and the peers, against the reference's trace rows of each round."""
    diff, rows, calls = _run_case(TRACED)
    assert diff is None, diff
    assert len(calls["traffic_send"]) == len(rows)
    seen = set()
    for r, ((_, _, out), ref) in enumerate(zip(calls["traffic_send"],
                                               rows)):
        code = out.code.numpy()
        want = np.where(ref["trace_code"] == 6, 1, ref["trace_code"])
        np.testing.assert_array_equal(code, want, err_msg=f"round {r}")
        np.testing.assert_array_equal(
            np.where(code != 0, out.peer.numpy(), -1), ref["trace_peers"],
            err_msg=f"round {r}")
        popc = lambda x: np.unpackbits(
            x.view(np.uint8).reshape(*x.shape, 4), axis=-1).sum(-1)
        np.testing.assert_array_equal(popc(out.cand_bits.numpy()).T,
                                      (code != 0).sum(-1))
        np.testing.assert_array_equal(popc(out.arr_bits.numpy()).T,
                                      (code == 1).sum(-1))
        seen |= set(np.unique(code).tolist())
    assert seen == {0, 1, 2, 3, 4, 5}


TILE = 32                      # senders and values of a send block
M32 = 0xFFFFFFFF


def _fmix32(x):
    """faults.fmix32 on a uint64 array of 32-bit words."""
    x = x & M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & M32
    return x ^ (x >> 16)


def _send_schedule(active, pruned, failed, v_live, v_holder, v_origin, v_vid,
                   side, fanout, cap, partition=None, loss=None, seed=0):
    """csrc/traffic_send.cu in numpy.  Blocks of 32 senders x 32 values
    (a chunk), in (chunk, tile) order.  A block stages its live holders
    per value row and, of each row's prune span, only the 16-byte vectors
    (bytes, where ``N * S`` is not a multiple of 16) that cover a live
    holder (bytes never loaded hold 2, and no holder may read one), turns
    each sender's prune bytes into a bit mask (a multiply per aligned
    word), then takes each (value, sender)'s first f valid slots.  With
    the cap on, the blocks run in waves of a seeded random size: every
    block of a wave publishes its senders' chunk totals (chunk 0: its
    inclusive prefix), then, in a seeded random order, each looks back
    over the earlier chunks' words, adding totals (flag A) until an
    inclusive prefix (flag P), publishes its own prefix and scans its
    rows; counts saturate at the cap.  Then the gates, each row's peers
    and codes out of the warp's stage, and the slot words through the
    32 x 32 transpose.  Every output element is written exactly once.
    Returns the four outputs and the number of look-back steps that added
    a total (flag A)."""
    r = np.random.default_rng(seed)
    V, n, s = pruned.shape
    f = min(fanout, s)
    tiles, chunks = -(-n // TILE), -(-V // TILE)
    flat = pruned.reshape(-1).astype(np.uint8)
    vec = (n * s) % 16 == 0
    peer = np.zeros((V, n, f), np.int64)
    code = np.zeros((V, n, f), np.int64)
    cand = np.zeros((n, V), np.int64)
    arr = np.zeros((n, V), np.int64)
    writes, bit_writes = np.zeros((V, n), int), np.zeros((n, V), int)
    word = np.zeros((chunks, n, 2), np.int64)     # (flag, count): 1 A, 2 P
    a_steps = 0

    def stage(block):
        chunk, tile = divmod(block, tiles)
        n0, v0 = tile * TILE, chunk * TILE
        nl, nv = min(TILE, n - n0), min(TILE, V - v0)
        lanes = np.arange(TILE)
        node = n0 + lanes
        inn = lanes < nl
        act = np.full((TILE, s), n, np.int64)
        act[:nl] = active[n0:n0 + nl]
        peer_ok = (act >= 0) & (act < n)
        pv = np.clip(act, 0, n - 1)
        pfail = peer_ok & failed[pv]
        cross = peer_ok & (side[np.minimum(node, n)][:, None] != side[pv])
        sends = inn & ~failed[np.minimum(node, n - 1)]
        rows = v0 + np.arange(TILE)
        rin = rows < V
        rv = np.minimum(rows, V - 1)
        hold = (rin[:, None] & sends[None] & v_live[rv][:, None]
                & v_holder[rv][:, np.minimum(node, n - 1)])
        origin = np.where(rin, v_origin[rv], n)
        # the prune tile: row r's span starts at ((v0 + r) * n + n0) * s
        prn = np.full((TILE, TILE * s), 2, np.int64)
        starts = ((v0 + np.arange(nv)) * n + n0) * s
        if vec:
            for j in range(nl * s // 16):
                lo, hi = 16 * j // s, min((16 * j + 15) // s, TILE - 1)
                cover = hold[:nv, lo:hi + 1].any(1)
                for rr in np.nonzero(cover)[0]:
                    prn[rr, 16 * j:16 * j + 16] = flat[
                        starts[rr] + 16 * j:starts[rr] + 16 * j + 16]
        else:
            need = np.repeat(hold[:nv, :nl], s, axis=1)
            idx = starts[:, None] + np.arange(nl * s)[None]
            prn[:nv, :nl * s] = np.where(need, flat[idx], 2)
        mine = prn.reshape(TILE, TILE, s)             # [row, sender, slot]
        assert (mine[hold] != 2).all(), "a holder read a byte never loaded"
        # the sender's prune bytes as a bit mask: the aligned words that
        # hold them, each word's four low bits gathered by one multiply
        words = np.zeros((TILE, TILE * s + 4), np.uint64)
        words[:, :TILE * s] = prn & 1
        b0 = np.arange(TILE) * s
        pbit = np.zeros((TILE, TILE), np.uint64)
        for lane in range(TILE):
            a0 = b0[lane] & ~3
            for q in range((b0[lane] - a0 + s + 3) // 4):
                w = sum(words[:, a0 + 4 * q + i] << np.uint64(8 * i)
                        for i in range(4))
                pbit[:, lane] |= ((w * np.uint64(0x10204080)) & np.uint64(
                    M32)) >> np.uint64(28) << np.uint64(4 * q)
            pbit[:, lane] >>= np.uint64(b0[lane] - a0)
        pruned_slot = (pbit[:, :, None] >> np.arange(s, dtype=np.uint64)) & 1
        valid = (hold[:, :, None] & peer_ok[None] & (pruned_slot == 0)
                 & (act[None] != origin[:, None, None]))
        first = valid & (np.cumsum(valid, -1) <= f)   # the early exit at f
        cbits = (first.astype(np.int64) << np.arange(s)).sum(-1)
        return dict(chunk=chunk, n0=n0, v0=v0, nl=nl, nv=nv, node=node,
                    act=act, pfail=pfail, cross=cross, first=first,
                    cbits=cbits, cnt=first.sum(-1))

    def look_back(b):
        """Warp 0 of a block: the chunk's exclusive prefix per sender."""
        nonlocal a_steps
        excl = np.zeros(TILE, np.int64)
        agg = b["cnt"].sum(0)
        for lane in range(b["nl"]):
            node = b["node"][lane]
            for c in range(b["chunk"] - 1, -1, -1):
                fl, val = word[c, node]
                assert fl in (1, 2), "looked back at an unpublished word"
                excl[lane] += val
                if fl == 2:
                    break
                a_steps += 1
            excl[lane] = min(excl[lane], cap)
            word[b["chunk"], node] = (2, min(excl[lane] + agg[lane], cap))
        before = excl[None] + np.cumsum(b["cnt"], 0) - b["cnt"]
        b["before"] = np.minimum(before, cap)

    def emit(b):
        n0, v0, nl, nv, node = (b[k] for k in ("n0", "v0", "nl", "nv",
                                               "node"))
        k = np.arange(f)
        for row in range(nv):
            v = v0 + row
            first = b["first"][row]                   # [sender, slot]
            order = np.argsort(np.where(first, np.arange(s), s), -1,
                               kind="stable")[:, :f]
            ok = k[None] < b["cnt"][row][:, None]
            pv = np.where(ok, np.take_along_axis(b["act"], order, 1), n)
            gate = lambda a: ok & np.take_along_axis(a, order, 1)
            c = np.where(ok, 1, 0)
            drop = np.zeros_like(ok)
            if loss is not None:
                vb = int(_fmix32(np.uint64((loss[0] ^ (int(v_vid[v])
                                                       * 0x9E3779B1))
                                           & M32)))
                h = _fmix32(np.uint64(vb)
                            ^ ((node[:, None].astype(np.uint64)
                                * 0x85EBCA6B) & M32)
                            ^ ((pv.astype(np.uint64) * 0xC2B2AE35) & M32))
                drop = ok & (h < loss[1])
            c = np.where(drop, 4, c)
            if partition:
                c = np.where(gate(b["cross"]), 3, c)
            c = np.where(gate(b["pfail"]), 2, c)
            if cap > 0:
                c = np.where(ok & (k[None] >= cap - b["before"][row][:, None]),
                             5, c)
            arrived = (c == 1)
            abits = np.zeros(TILE, np.int64)
            for kk in range(f):
                abits |= np.where(arrived[:, kk],
                                  np.int64(1) << order[:, kk], 0)
            peer[v, n0:n0 + nl] = pv[:nl]
            code[v, n0:n0 + nl] = c[:nl]
            writes[v, n0:n0 + nl] += 1
            b.setdefault("abt", np.zeros((TILE, TILE), np.int64))[:, row] = (
                abits)
        cbt = b["cbits"].T                            # [sender, row]
        cand[n0:n0 + nl, v0:v0 + nv] = cbt[:nl, :nv]
        arr[n0:n0 + nl, v0:v0 + nv] = b["abt"][:nl, :nv]
        bit_writes[n0:n0 + nl, v0:v0 + nv] += 1

    total = tiles * chunks
    t = 0
    while t < total:
        wave = [stage(x) for x in range(t, min(total, t + int(
            r.integers(1, 3 * tiles + 1))))]
        t += len(wave)
        if cap > 0:
            for b in wave:
                agg = np.minimum(b["cnt"].sum(0), cap)
                for lane in range(b["nl"]):
                    word[b["chunk"], b["node"][lane]] = (
                        2 if b["chunk"] == 0 else 1, agg[lane])
            for i in r.permutation(len(wave)):
                look_back(wave[i])
        for b in wave:
            emit(b)
    assert (writes == 1).all() and (bit_writes == 1).all()
    as_i32 = lambda x: x.astype(np.uint32).view(np.int32)
    return (peer.astype(np.int32), code.astype(np.uint8), as_i32(cand),
            as_i32(arr)), a_steps


def _send_inputs(seed, v, n, s):
    """Seeded inputs of any content the kernel takes: peers (the sender
    itself and the values' origins included), a tenth of the slots empty,
    a third pruned, a tenth of the nodes failed, most values live, holders
    at random, two sides."""
    r = np.random.default_rng(seed)
    origin = r.integers(0, n, size=v).astype(np.int32)
    active = r.integers(0, n, size=(n, s)).astype(np.int32)
    active[r.random((n, s)) < 0.05] = origin[r.integers(0, v)]
    active[r.random((n, s)) < 0.1] = n
    t = torch.as_tensor
    return (t(active), t(r.random((v, n, s)) < 0.3), t(r.random(n) < 0.1),
            t(r.random(v) < 0.85), t(r.random((v, n)) < 0.6), t(origin),
            t(r.integers(0, 1 << 31, size=v).astype(np.int32)),
            t(r.integers(0, 2, size=n + 1).astype(np.int32)))


def _sender_totals(out):
    """Each sender's candidates over every value (from the slot words)."""
    w = out.cand_bits.numpy().view(np.uint32).astype(np.int64)
    return ((w[..., None] >> np.arange(32)) & 1).sum((1, 2))


def _caps(totals):
    """Egress caps off, 1, binding (the median of the totals above 1, below
    the largest) and above every sender's total."""
    top = int(totals.max())
    mid = min(int(np.median(totals[totals > 1])), top - 1)
    return {"off": 0, "one": 1, "binding": mid, "above": top + 1}


def _check_schedule(args, kw, cap, seed):
    args = args[:9] + (cap,)
    want = kernels.traffic_send_plain(*args, **kw)
    got, a_steps = _send_schedule(*(a.numpy() if torch.is_tensor(a) else a
                                    for a in args),
                                  partition=kw.get("partition"),
                                  loss=kw.get("loss"), seed=seed)
    for name, x, y in zip(want._fields, got, want):
        np.testing.assert_array_equal(x, y.numpy(), err_msg=name)
    return want, a_steps


@pytest.mark.parametrize("cap", ["off", "one", "binding", "above"])
def test_traffic_send_kernel_schedule_equals_plain(cap):
    """The kernel's algorithm (its numpy transcription) against the plain
    twin on two rounds of the impaired capped run (loss and failed nodes;
    round 6 inside the partition window, round 15 after it), at egress
    caps off, 1, binding and above every sender's candidates."""
    _, _, calls = _run_case(TRACED)
    for r in (6, 15):
        args, kw, out = calls["traffic_send"][r]
        c = _caps(_sender_totals(out))[cap]
        want, _ = _check_schedule(args, kw, c, seed=r)
        codes = set(np.unique(want.code.numpy()).tolist())
        assert (5 in codes) == (cap in ("one", "binding")), codes
        assert {1, 2, 4} | ({3} if kw["partition"] else set()) <= codes


#: (V, N, S, fanout): V = 1, 33 and 257 (not multiples of the 32-value
#: chunk; 257 spans nine chunks), N not a multiple of 32 (70 and 45: the
#: byte path of the prune tile; 76 and 37: its 16-byte vectors), S = 32
#: (slot 31, the int32 sign bit) with F = S
SEND_SHAPES = [(1, 70, 12, 6), (33, 45, 12, 6), (257, 76, 12, 6),
               (40, 37, 32, 32)]


@pytest.mark.parametrize("cap", ["off", "one", "binding", "above"])
@pytest.mark.parametrize("v,n,s,fanout", SEND_SHAPES)
def test_traffic_send_schedule_at_its_edges(v, n, s, fanout, cap):
    """The transcription against the plain twin on seeded inputs at the
    ragged shapes, with loss and a partition, at each egress cap; the
    look-back adds chunk totals (not only prefixes) where it has chunks
    to cross."""
    args = _send_inputs(v * n + s, v, n, s) + (fanout, 0)
    kw = dict(partition=True, loss=(0x1234567, 1 << 30))
    c = _caps(_sender_totals(kernels.traffic_send_plain(*args, **kw)))[cap]
    want, a_steps = _check_schedule(args, kw, c, seed=v + n)
    if v == 257 and cap != "off":
        assert a_steps > 0
    if s == 32:
        assert (want.cand_bits.numpy() < 0).any()     # slot 31 set
    assert ((want.code.numpy() == 5).any()
            == (cap in ("one", "binding")))


def test_traffic_admit_plain_equals_the_reference_block():
    diff, rows, calls = _run_case(TRACED)
    assert diff is None, diff
    qdrops = 0
    for r, ((_, _, out), ref) in enumerate(zip(calls["traffic_admit"],
                                               rows)):
        np.testing.assert_array_equal(out.accepted.numpy(),
                                      ref["trace_code"] == 1,
                                      err_msg=f"round {r}")
        np.testing.assert_array_equal(out.accepted_node.numpy(),
                                      ref["node_recv"])
        np.testing.assert_array_equal(
            (out.arrived_node - out.accepted_node).numpy(),
            ref["node_queue_dropped"])
        qdrops += int(ref["queue_dropped"])
    assert qdrops > 0


BUCKET = 32                    # in-neighbours a target keeps (kBucket)
ACCEPT_ALL = (1 << 63) - 1     # the cut of a target within the cap


def _admit_schedule(cand_bits, arr_bits, active, f, cap, seed=0):
    """csrc/traffic_admit.cu's three kernels in numpy.  Tally: each
    (sender, slot)'s arrivals over the values, added to its target's
    total, and its entry ``src * S + slot`` appended to the target's bucket
    of 32 (in an arbitrary order: the atomics', shuffled here by
    ``seed``).  Cut (cap on, targets past it): values in chunks of 32, the
    warp scan placing each value's ranks, the straddling value's arrival of
    rank ``cap - base`` among its arrivals in entry order; a target past
    its bucket scans the whole set.  Write: tiles of 32 senders x 32
    values, each arrival's byte set iff its key ``v * N * S + entry`` is
    below its target's cut, every byte of the plane written once."""
    n, V = arr_bits.shape
    s = active.shape[1]
    ns = n * s
    ab, cb = arr_bits.astype(np.uint32), cand_bits.astype(np.uint32)
    act = active.reshape(-1).astype(np.int64)
    bit = lambda e, v: int(ab[e // s, v] >> (e % s)) & 1
    # tally
    count = ((ab[:, :, None] >> np.arange(s)) & 1).sum(1).reshape(-1)
    deg, total = np.zeros(n, np.int64), np.zeros(n, np.int64)
    bucket = [[] for _ in range(n)]
    for e in np.random.default_rng(seed).permutation(ns):
        t = act[e]
        if 0 <= t < n:
            if deg[t] < BUCKET:
                bucket[t].append(int(e))
            deg[t] += 1
            total[t] += count[e]
    # cut
    cut = np.full(n, ACCEPT_ALL, np.int64)
    for t in (np.nonzero(total > cap)[0] if cap > 0 else []):
        ents = (bucket[t] if deg[t] <= BUCKET
                else [e for e in range(ns) if act[e] == t])
        running, vcut, need = 0, -1, 0
        for v0 in range(0, V, 32):
            c = np.array([sum(bit(e, v) for e in ents)
                          for v in range(v0, min(v0 + 32, V))])
            incl = np.cumsum(c)
            base = running + incl - c
            hit = np.nonzero((c > 0) & (base <= cap) & (cap < base + c))[0]
            if hit.size:
                vcut, need = v0 + int(hit[0]), cap - int(base[hit[0]])
                break
            running += int(incl[-1])
        assert vcut >= 0
        arriving = [e for e in ents if bit(e, vcut)]
        ranks = [sum(x < e for x in arriving) for e in arriving]
        cut[t] = vcut * ns + arriving[ranks.index(need)]
    # write
    accepted = np.full((V, n, f), 2, np.uint8)    # 2: never written
    for src0 in range(0, n, 32):
        for v0 in range(0, V, 32):
            tile = np.zeros((32, 32 * f), np.uint8)
            for vl in range(min(32, V - v0)):
                for tx in range(min(32, n - src0)):
                    src, v = src0 + tx, v0 + vl
                    a, cw = int(ab[src, v]), int(cb[src, v])
                    while a:
                        sl = (a & -a).bit_length() - 1
                        a &= a - 1
                        fo = bin(cw & ((1 << sl) - 1)).count("1")
                        t = act[src * s + sl]
                        if fo < f and (cap <= 0 or (
                                0 <= t < n
                                and v * ns + src * s + sl < cut[t])):
                            tile[vl, tx * f + fo] = 1
                rows = min(32, n - src0) * f
                accepted[v, src0:src0 + rows // f] = tile[vl, :rows].reshape(
                    -1, f)
    assert (accepted != 2).all()
    arrived = total.astype(np.int32)
    accepted_node = (np.minimum(arrived, cap) if cap > 0 else arrived)
    return accepted.astype(bool), arrived, accepted_node


def _flat_sort_admit(peer, code, cap):
    """The reference block's flat sort on the send outputs: every arrival
    ranked at its target in flat (value, sender, fanout slot) order."""
    V, n, f = peer.shape
    L = V * n * f
    tgt = np.where(code == 1, peer, n).reshape(-1).astype(np.int64)
    order = np.argsort(tgt, kind="stable")
    st = tgt[order]
    rank = np.arange(L) - np.searchsorted(st, st)
    accepted = np.zeros(L, bool)
    accepted[order] = (st < n) & ((cap <= 0) | (rank < cap))
    return accepted.reshape(V, n, f), np.bincount(tgt, minlength=n + 1)[:n]


@pytest.mark.parametrize("cap", [0, 3, 1, 1 << 20])
def test_traffic_admit_kernel_schedule_equals_plain(cap):
    """The kernel's algorithm (its numpy transcription), the plain twin and
    a flat sort of the send outputs agree on two rounds of the impaired
    run: cap off, binding, 1 (every target's cut at its first arrival) and
    above every target's arrivals (no cut)."""
    _, _, calls = _run_case(TRACED)
    for r in (6, 15):
        args, _, _ = calls["traffic_admit"][r]
        cand_bits, arr_bits, active, f, _cap = args
        want = kernels.traffic_admit_plain(cand_bits, arr_bits, active, f,
                                           cap)
        got, arrived, acc_node = _admit_schedule(
            cand_bits.numpy(), arr_bits.numpy(), active.numpy(), f, cap,
            seed=r)
        np.testing.assert_array_equal(got, want.accepted.numpy())
        np.testing.assert_array_equal(arrived, want.arrived_node.numpy())
        np.testing.assert_array_equal(acc_node, want.accepted_node.numpy())
        snd = calls["traffic_send"][r][2]
        flat, flat_arrived = _flat_sort_admit(snd.peer.numpy(),
                                              snd.code.numpy(), cap)
        np.testing.assert_array_equal(flat, want.accepted.numpy())
        np.testing.assert_array_equal(flat_arrived,
                                      want.arrived_node.numpy())
        top = int(want.arrived_node.max())
        assert top > max(cap, 1) if cap < 1 << 20 else top < cap


def _hub_inputs(seed, n=90, v=40, s=6, f=4, hubs=2):
    """A shared set whose first ``hubs`` nodes are in every row (in-degree
    n - 1 > 32, past the bucket), other slots random or empty, and slot
    words with at most ``f`` candidates per (sender, value), the arrivals
    a subset of them."""
    r = np.random.default_rng(seed)
    active = np.full((n, s), n, np.int32)
    for i in range(n):
        peers = [h for h in range(hubs) if h != i]
        rest = r.permutation([x for x in range(n) if x != i
                              and x not in peers])[:s - len(peers)]
        row = np.array(peers + list(rest), np.int32)
        row[r.random(row.size) < 0.2] = n
        active[i] = r.permutation(row)
    valid = active < n
    cand = np.zeros((n, v), np.int64)
    arr = np.zeros((n, v), np.int64)
    for i in range(n):
        for j in range(v):
            slots = np.nonzero(valid[i] & (r.random(s) < 0.7))[0][:f]
            for sl in slots:
                cand[i, j] |= 1 << int(sl)
                if r.random() < 0.8:
                    arr[i, j] |= 1 << int(sl)
    return (cand.astype(np.int32), arr.astype(np.int32), active, f)


@pytest.mark.parametrize("cap", [0, 1, 7, 60])
def test_traffic_admit_schedule_past_the_bucket(cap):
    """Targets with more in-neighbours than a bucket holds (the cut
    kernel's scan of the whole set): the transcription against the plain
    twin, V not a multiple of 32, N not a multiple of 32, S = 6."""
    cand, arr, active, f = _hub_inputs(11)
    want = kernels.traffic_admit_plain(torch.as_tensor(cand),
                                       torch.as_tensor(arr),
                                       torch.as_tensor(active), f, cap)
    got, arrived, acc_node = _admit_schedule(cand, arr, active, f, cap)
    np.testing.assert_array_equal(got, want.accepted.numpy())
    np.testing.assert_array_equal(arrived, want.arrived_node.numpy())
    np.testing.assert_array_equal(acc_node, want.accepted_node.numpy())
    deg = np.bincount(active.reshape(-1), minlength=active.shape[0] + 1)
    assert deg[:2].min() > BUCKET and int(want.arrived_node[:2].min()) > cap


@pytest.mark.parametrize("kw,error", [
    (dict(traffic_values=0), ValueError),
    (dict(traffic_values=4, traffic_rate=-1), ValueError),
    (dict(traffic_values=4, traffic_stall_rounds=0), ValueError),
    (dict(node_ingress_cap=3, gossip_mode="push-pull"), ValueError),
    (dict(traffic_values=4, fail_at=2, fail_fraction=0.1), ValueError),
    (dict(node_ingress_cap=16384, gossip_mode="adaptive"), ValueError),
], ids=["values-0", "rate", "stall", "pull-mode", "fail-at", "adaptive"])
def test_traffic_params_refusals(kw, error):
    """The reference's traffic checks, each a ValueError (adaptive traffic
    with an ingress cap of 16384 or more: the reference's sort-key bound),
    from ``init_traffic_state`` and from the round before it reads the
    state."""
    stakes = _stakes(40)
    params = PortParams(num_nodes=40, **kw)
    with pytest.raises(error) as got:
        tt.init_traffic_state(stakes, params, 1, device="cpu")
    with pytest.raises(error):
        tt.traffic_round_step(params, None, None, None, 0)
    if kw.get("gossip_mode") == "adaptive":
        assert "node_ingress_cap < 16384" in str(got.value)
        PortParams(num_nodes=40, node_ingress_cap=16383,
                   gossip_mode="adaptive").validate()
    assert not PortParams(num_nodes=40).has_traffic
