"""The port's ``AllOriginsStats`` (its own copy of stats/aggregate.py)
against the reference package's: the same seeded numpy rows and
accumulators go through both, batch by batch, unimpaired, impaired and with
a heal.  Compared are ``state_dict()``, every finalized field and the lines
``print_all`` logs; ``load_state_dict`` then ``finalize`` must give the same
statistics again.

Tolerance: 0 everywhere (exact equality; NaN == NaN)."""

import logging
import math
from types import SimpleNamespace

import numpy as np
import pytest

from gossip_sim_tpu.config import Config as RefConfig
from gossip_sim_tpu.identity import NodeIndex as RefIndex
from gossip_sim_tpu.identity import pubkey_new_unique as ref_pubkey
from gossip_sim_tpu.stats.aggregate import AllOriginsStats as RefStats
from gossip_sim_tpu_torch.config import Config
from gossip_sim_tpu_torch.identity import NodeIndex
from gossip_sim_tpu_torch.stats import AllOriginsStats

N, H, ITERS, WARM = 40, 64, 24, 6
BATCHES = (7, 5, 3)          # origins per batch, the last one a tail
ACC = ("stranded_acc", "egress_acc", "ingress_acc", "prune_acc")

CASES = {
    "unimpaired": dict(),
    "impaired": dict(packet_loss_rate=0.1, churn_fail_rate=0.02),
    "healed": dict(partition_at=4, heal_at=10),
}


def plain(x):
    """``x`` as nested builtins: pubkeys as base58 strings, NaN as "nan",
    objects as their attribute dicts (the two packages' classes differ)."""
    if hasattr(x, "to_string"):
        return x.to_string()
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return plain(x.tolist())
    if isinstance(x, (float, np.floating)):
        return "nan" if math.isnan(x) else float(x)
    if isinstance(x, (np.integer, np.bool_)):
        return x.item()
    if hasattr(x, "__dict__"):
        return {k: plain(v) for k, v in vars(x).items()}
    return x


def finalized(agg) -> dict:
    """Every field of a finalized ``AllOriginsStats`` but the node index
    and the per-point chunks (``state_dict`` holds those)."""
    out = {k: plain(v) for k, v in vars(agg).items()
           if k not in ("index", "_chunks")}
    out["recovery_summary"] = plain(agg.recovery_summary())
    return out


def print_all_lines(agg, caplog) -> list:
    """The messages ``agg.print_all()`` logs."""
    caplog.clear()
    with caplog.at_level(logging.INFO):
        agg.print_all()
    lines = [r.getMessage() for r in caplog.records]
    caplog.clear()
    return lines


def assert_state_dicts_equal(want: dict, got: dict) -> None:
    assert set(want) == set(got)
    for k, v in want.items():
        v, g = np.asarray(v), np.asarray(got[k])
        assert v.dtype == g.dtype and v.shape == g.shape, k
        assert np.array_equal(v, g), k


def _batches(seed: int):
    """Seeded rows [ITERS, O] and accumulators of each batch: coverage on
    a grid around the 0.95 recovery threshold, hop maxima with zeros, and
    counts in every delivery row."""
    rng = np.random.default_rng(seed)
    out = []
    for o in BATCHES:
        i32 = lambda hi: rng.integers(0, hi, (ITERS, o)).astype(np.int32)
        rows = {
            "coverage": (rng.integers(80, 101, (ITERS, o)) / 100.0
                         ).astype(np.float32),
            "rmr": rng.uniform(0.0, 9.0, (ITERS, o)).astype(np.float32),
            "branching": rng.uniform(4.0, 6.0, (ITERS, o)).astype(np.float32),
            "hop_max": i32(9), "delivered": i32(300), "dropped": i32(30),
            "suppressed": i32(20), "failed_count": i32(5),
            "hop_clamped": i32(2), "inb_dropped": i32(3),
            "rc_overflow": i32(4),
        }
        state = {f: rng.integers(0, 50, (o, N)).astype(np.int32)
                 for f in ACC}
        state["hops_hist_acc"] = rng.integers(0, 900, (o, H)).astype(np.int32)
        out.append((rows, state))
    return out


def _feed(stats_cls, index, cfg, batches):
    agg = stats_cls(index, H)
    for rows, state in batches:
        agg.add_batch(rows, SimpleNamespace(**state), cfg.warm_up_rounds,
                      heal_at=cfg.heal_at, impaired=cfg.impairments_on,
                      pull=False)
    return agg


@pytest.mark.parametrize("case", sorted(CASES))
def test_all_origins_stats_equal(case, caplog):
    names = [ref_pubkey().to_string() for _ in range(N)]
    stakes = np.random.default_rng(5).integers(1, 1 << 50, N)
    accounts = {pk: int(s) for pk, s in zip(names, stakes)}
    kw = dict(warm_up_rounds=WARM, **CASES[case])
    ref_cfg, cfg = RefConfig(**kw), Config(**kw)
    batches = _batches(seed=len(case))
    ref = _feed(RefStats, RefIndex.from_stakes(accounts), ref_cfg, batches)
    port = _feed(AllOriginsStats, NodeIndex.from_stakes(accounts), cfg,
                 batches)
    assert_state_dicts_equal(ref.state_dict(), port.state_dict())

    ref.finalize(ref_cfg)
    port.finalize(cfg)
    want = finalized(ref)
    assert want == finalized(port)
    assert want["measured_points"] == (ITERS - WARM) * sum(BATCHES)
    assert bool(want["impaired"]) == (case != "unimpaired")
    assert (want["recovery_summary"] is None) == (case != "healed")
    assert print_all_lines(ref, caplog) == print_all_lines(port, caplog)

    # a snapshot restored into a fresh aggregate finalizes alike
    again = AllOriginsStats(NodeIndex.from_stakes(accounts), H)
    again.load_state_dict(port.state_dict())
    again.finalize(cfg)
    assert finalized(again) == want
