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
* ``traffic_admit``'s kernel schedule (the reverse CSR of the shared set,
  a walk per target over values and in-neighbours reading the slot
  bitmasks) transcribed in numpy, against the plain twin and against a
  flat sort of ``traffic_send``'s peers and outcome codes.

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
from gossip_sim_tpu_torch.kernels.traffic_admit import in_neighbours

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
            calls[name].append((args, kw, out))
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


def _admit_schedule(cand_bits, arr_bits, active, f, cap):
    """csrc/traffic_admit.cu's walk in numpy: per target, values in order,
    in-neighbours in source order; rank = running count of arrivals."""
    n, V = arr_bits.shape
    s = active.shape[1]
    row_ptr, col = (x.numpy() for x in in_neighbours(torch.as_tensor(
        active)))
    cb, ab = cand_bits.astype(np.uint32), arr_bits.astype(np.uint32)
    accepted = np.zeros((V, n, f), bool)
    arrived = np.zeros(n, np.int32)
    for t in range(n):
        running = 0
        edges = col[row_ptr[t]:row_ptr[t + 1]]
        for v in range(V):
            for e in edges:
                src, slot = divmod(int(e), s)
                if (ab[src, v] >> slot) & 1:
                    if cap <= 0 or running < cap:
                        fo = bin(int(cb[src, v]) & ((1 << slot) - 1)).count(
                            "1")
                        accepted[v, src, fo] = True
                    running += 1
        arrived[t] = running
    return accepted, arrived


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


@pytest.mark.parametrize("cap", [0, 3])
def test_traffic_admit_kernel_schedule_equals_plain(cap):
    """The kernel's algorithm (its numpy transcription), the plain twin and
    a flat sort of the send outputs agree on two rounds of the impaired
    run."""
    _, _, calls = _run_case(TRACED)
    for r in (6, 15):
        args, _, _ = calls["traffic_admit"][r]
        cand_bits, arr_bits, active, f, _cap = args
        want = kernels.traffic_admit_plain(cand_bits, arr_bits, active, f,
                                           cap)
        got, arrived = _admit_schedule(cand_bits.numpy(), arr_bits.numpy(),
                                       active.numpy(), f, cap)
        np.testing.assert_array_equal(got, want.accepted.numpy())
        np.testing.assert_array_equal(arrived, want.arrived_node.numpy())
        snd = calls["traffic_send"][r][2]
        flat, flat_arrived = _flat_sort_admit(snd.peer.numpy(),
                                              snd.code.numpy(), cap)
        np.testing.assert_array_equal(flat, want.accepted.numpy())
        np.testing.assert_array_equal(flat_arrived,
                                      want.arrived_node.numpy())
        assert int(want.arrived_node.max()) > max(cap, 1)


@pytest.mark.parametrize("kw,error", [
    (dict(traffic_values=0), ValueError),
    (dict(traffic_values=4, traffic_rate=-1), ValueError),
    (dict(traffic_values=4, traffic_stall_rounds=0), ValueError),
    (dict(node_ingress_cap=3, gossip_mode="push-pull"), ValueError),
    (dict(traffic_values=4, fail_at=2, fail_fraction=0.1), ValueError),
    (dict(node_egress_cap=3, gossip_mode="adaptive"), NotImplementedError),
], ids=["values-0", "rate", "stall", "pull-mode", "fail-at", "adaptive"])
def test_traffic_params_refusals(kw, error):
    """The reference's traffic checks, each a ValueError (adaptive traffic:
    NotImplementedError naming ROADMAP A11b), from ``init_traffic_state``
    and from the round before it reads the state."""
    stakes = _stakes(40)
    params = PortParams(num_nodes=40, **kw)
    with pytest.raises(error) as got:
        tt.init_traffic_state(stakes, params, 1, device="cpu")
    with pytest.raises(error):
        tt.traffic_round_step(params, None, None, None, 0)
    if error is NotImplementedError:
        assert "ROADMAP A11b" in str(got.value)
    assert not PortParams(num_nodes=40).has_traffic
