"""The port's adaptive push-pull mode against the reference package's.

* ``switch_update_arr`` on numpy arrays and on torch tensors equals the
  reference's at the edges of the band: counts at, just under and just
  over ``threshold * N`` and ``(threshold - hysteresis) * N``, from either
  bit;
* ``round_step`` states and rows in ``adaptive`` under loss + partition +
  churn, the bit turning on and off for some origins, in both threefry
  layouts, from each engine's own ``init_state`` and then with the port
  continuing the reference's own mid-run state (the bit set, the pull
  accumulators filled; ``convert``);
* the ``adaptive-threshold`` sweep (single-origin CLI runs):
  ``parity_snapshot()`` and deterministic Influx lines (``sim_adaptive``
  and ``sim_pull`` among them), its start-up error and clamp warning;
* the adaptive knobs' checks.

Tolerance: 0 everywhere (exact equality)."""

import gossip_sim_tpu.engine as je  # noqa: I001  (64-bit types first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_sim_tpu import adaptive as ref_adaptive
from gossip_sim_tpu_torch import adaptive, cli, rng
from gossip_sim_tpu_torch.convert import (state_from_numpy, state_to_numpy,
                                          tables_from_numpy)
from gossip_sim_tpu_torch.engine import core as tc
from gossip_sim_tpu_torch.engine.params import EngineParams as PortParams
from test_torch_pull import (CLI_BASE, IMPAIRED, assert_rows_equal,
                             assert_state_equal, stakes_of, sweeps_equal)

ADAPTIVE = dict(gossip_mode="adaptive", adaptive_switch_threshold=0.5,
                adaptive_switch_hysteresis=0.1)


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


@pytest.mark.parametrize("n,thr,hyst", [(1000, 0.9, 0.05), (10_000, 0.7, 0.1),
                                        (37, 1.0, 0.0), (3, 0.1, 0.05)])
def test_switch_update_at_the_band_edges(n, thr, hyst):
    edges = []
    for x in (thr * n, (thr - hyst) * n):
        edges += [int(np.floor(x)) + d for d in (-1, 0, 1, 2)]
    cov = np.clip(np.array(edges + [0, n], dtype=np.int64), 0, n)
    for prev in (np.zeros_like(cov, bool), np.ones_like(cov, bool)):
        want = np.asarray(ref_adaptive.switch_update_arr(cov, n, prev, thr,
                                                         hyst))
        got_np = adaptive.switch_update_arr(cov, n, prev, thr, hyst)
        got_t = adaptive.switch_update_arr(
            torch.as_tensor(cov.astype(np.int32)), n, torch.as_tensor(prev),
            np.float64(thr), np.float64(hyst))
        assert got_np.dtype == bool and np.array_equal(got_np, want)
        assert got_t.dtype == torch.bool
        assert np.array_equal(got_t.numpy(), want)
        for c, p, w in zip(cov, prev, want):
            assert adaptive.switch_update(int(c), n, bool(p), thr,
                                          hyst) == bool(w)
    # the band: on at the threshold, off below threshold - hysteresis,
    # unchanged between
    up = int(np.ceil(thr * n))
    assert adaptive.switch_update(up, n, False, thr, hyst)


def test_round_step_equal(layout):
    """States and rows of 12 rounds from each engine's own ``init_state``
    under loss + partition + churn; then the reference's mid-run state
    (some bits on, the pull accumulators filled) moved into the port with
    ``convert`` (tables and state, and the state back and forth) and 12
    more rounds in each engine: equal again.  The bit turns on, and off
    again, for some origins only, and requests go out only from sims whose
    bit is on."""
    n = 120
    o = np.asarray([0, 37, 101, 60], np.int32)
    kw = dict(warm_up_rounds=5, **IMPAIRED, **ADAPTIVE)
    stakes = stakes_of(n)
    jt = je.make_cluster_tables(stakes)
    tt = tc.make_cluster_tables(stakes, device="cpu")
    jp, tp = je.EngineParams(num_nodes=n, **kw), PortParams(num_nodes=n, **kw)
    js = je.init_state(jax.random.PRNGKey(7), jt, jnp.asarray(o), jp)
    ts = tc.init_state(rng.prng_key(7), tt, torch.as_tensor(o), tp)
    rows = []
    for start in (0, 12):
        if start:
            on = np.asarray(js.adaptive_pull_on)
            assert on.any() and not on.all()
            assert int(np.asarray(js.pull_rescued_acc).sum()) > 0
            ts = state_from_numpy(js, device="cpu")
            assert_state_equal(js, ts, "moved")
            back = state_from_numpy(state_to_numpy(ts), device="cpu")
            for f in ts._fields:
                assert torch.equal(getattr(back, f), getattr(ts, f)), f
            tt = tables_from_numpy(jt, device="cpu")
        js, jrows = je.run_rounds(jp, jt, jnp.asarray(o), js, 12,
                                  start_it=start, detail=True)
        ts, trows = tc.run_rounds(tp, tt, torch.as_tensor(o), ts, 12,
                                  start_it=start, detail=True)
        assert_state_equal(js, ts, f"rounds {start}-{start + 11}")
        assert_rows_equal(jrows, trows)
        rows.append(trows)
    active = torch.cat([r["adaptive_pull_active"] for r in rows])
    requests = torch.cat([r["pull_requests"] for r in rows])
    assert bool(active.any()) and not bool(active.all())
    assert int(torch.cat([r["adaptive_switched"]
                          for r in rows]).sum()) >= 4
    assert int(requests[~active].sum()) == 0
    assert int(requests[active].sum()) > 0


def test_adaptive_threshold_sweep(layout, caplog):
    """Thresholds 0.5 and 1.1, clamped to 1.0 with the reference's
    warning, through ``main``'s checks and ``dispatch_sweeps``: each point
    is the single-origin CLI run of its threshold."""
    argv = CLI_BASE + ["--gossip-mode", "adaptive", "--packet-loss-rate",
                       "0.2", "--adaptive-switch-threshold", "0.5",
                       "--test-type", "adaptive-threshold",
                       "--num-simulations", "2", "--step-size", "0.6"]
    lines = sweeps_equal(argv)
    assert sum(ln.startswith("sim_adaptive,") for ln in lines) == 2 * 8
    assert sum(ln.startswith("sim_pull,") for ln in lines) == 2 * 8
    args = cli.build_parser().parse_args(argv)
    cfg = cli.config_from_args(args)
    assert [cli._stepped_sweep_config(cfg, i, args.origin_rank)[0]
            .adaptive_switch_threshold for i in range(2)] == [0.5, 1.0]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert "adaptive-threshold sweep clamps at 1.0" in caplog.text


def test_adaptive_threshold_sweep_needs_adaptive_mode(caplog):
    argv = CLI_BASE + ["--gossip-mode", "push-pull", "--test-type",
                       "adaptive-threshold", "--num-simulations", "2",
                       "--device", "cpu"]
    assert cli.main(argv) == 1
    assert "requires --gossip-mode adaptive" in caplog.text


@pytest.mark.parametrize("kw,match", [
    (dict(adaptive_switch_threshold=0.0), "adaptive_switch_threshold"),
    (dict(adaptive_switch_threshold=1.5), "adaptive_switch_threshold"),
    (dict(adaptive_switch_hysteresis=0.9), "adaptive_switch_hysteresis"),
    (dict(adaptive_switch_hysteresis=-0.1), "adaptive_switch_hysteresis"),
])
def test_params_checks(kw, match):
    with pytest.raises(ValueError, match=match):
        PortParams(num_nodes=40, gossip_mode="adaptive", **kw).validate()
    # inert outside the adaptive mode
    PortParams(num_nodes=40, gossip_mode="push-pull", **kw).validate()


@pytest.mark.parametrize("argv,match", [
    (["--adaptive-switch-threshold", "0"], "adaptive-switch-threshold"),
    (["--adaptive-switch-hysteresis", "0.95"], "adaptive-switch-hysteresis"),
])
def test_cli_checks(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.config_from_args(cli.build_parser().parse_args(
            CLI_BASE + ["--gossip-mode", "adaptive"] + argv))
