"""The port's all-origins mode against the reference package's: the
reference's ``run_all_origins`` (JAX on the CPU, one device) and the
port's on ``device="cpu"`` run the same synthetic cluster, origins and
knobs, and give equal aggregate ``state_dict()``s, finalized statistics,
``print_all`` lines and summaries (but the two timing keys), in both
threefry layouts:

* 18 origins of 50 nodes at batch 16: a full batch and a tail of 2 valid
  origins padded with 14 copies of origin 0;
* packet loss 0.1 with churn, so that the delivery chunks fill, and
* a partition that heals, so that the recovery iterations fill, each on
  13 of the origins: one batch of 13 (the single-batch path).

Each (case, layout) runs once per module; its tests share the runs, and
most of their time is the reference's compile of each case's rounds.  The
port runs on one CPU thread: its tensors are small, and the suite's
workers share the cores.
Tolerance: 0 everywhere (exact equality)."""

import gossip_sim_tpu.engine  # noqa: F401, I001  (64-bit types first)
import jax
import numpy as np
import pytest
import torch

from gossip_sim_tpu import cli as ref_cli
from gossip_sim_tpu.config import Config as RefConfig
from gossip_sim_tpu.identity import reset_unique_pubkeys as ref_reset
from gossip_sim_tpu.obs import get_registry
from gossip_sim_tpu_torch import cli, rng
from gossip_sim_tpu_torch.config import Config
from gossip_sim_tpu_torch.identity import reset_unique_pubkeys
from test_torch_aggregate import (assert_state_dicts_equal, finalized,
                                  print_all_lines)

BASE = dict(num_synthetic_nodes=50, gossip_iterations=30, warm_up_rounds=10,
            all_origins=True, origin_batch=16)
CASES = {
    # 16 + (2 valid, 14 padded)
    "padded_tail": (dict(), range(0, 36, 2)),
    "loss_churn": (dict(packet_loss_rate=0.1, churn_fail_rate=0.02,
                        churn_recover_rate=0.25), range(0, 50, 4)),
    "partition_heal": (dict(partition_at=5, heal_at=14), range(1, 50, 4)),
}
TIMING = ("elapsed_s", "origin_iters_per_sec")
COUNTERS = ("origin_iters", "messages_delivered")


@pytest.fixture(scope="module", params=[
    (case, part) for part in (True, False) for case in CASES],
    ids=lambda p: f"{p[0]}-{'partitionable' if p[1] else 'original'}")
def runs(request):
    """(case, reference summary with its run-report counters, port
    summary) of one case in one threefry layout, both packages pinned to
    it and restored afterwards."""
    case, part = request.param
    knobs, origins = CASES[case]
    origins = np.asarray(origins, np.int32)
    old, old_port = jax.config.jax_threefry_partitionable, rng.partitionable()
    threads = torch.get_num_threads()
    jax.config.update("jax_threefry_partitionable", part)
    rng.set_partitionable(part)
    try:
        ref_reset()
        ref_cfg = RefConfig(**BASE, **knobs, mesh_devices=1)
        accounts, _ = ref_cli.load_cluster_accounts(ref_cfg, "")
        reg = get_registry()
        before = {c: reg.counter(c) for c in COUNTERS}
        ref = ref_cli.run_all_origins(ref_cfg, "", accounts=accounts,
                                      origin_indices=origins)
        ref.update({c: reg.counter(c) - before[c] for c in COUNTERS})
        reset_unique_pubkeys()
        cfg = Config(**BASE, **knobs, device="cpu")
        torch.set_num_threads(1)
        port = cli.run_all_origins(cfg, origin_indices=origins)
    finally:
        jax.config.update("jax_threefry_partitionable", old)
        rng.set_partitionable(old_port)
        torch.set_num_threads(threads)
    return case, ref, port


def test_aggregate_state_dict_equal(runs):
    _, ref, port = runs
    assert_state_dicts_equal(ref["stats"].state_dict(),
                             port["stats"].state_dict())


def test_finalized_stats_equal(runs):
    case, ref, port = runs
    want = finalized(ref["stats"])
    assert want == finalized(port["stats"])
    if case == "loss_churn":
        assert want["total_dropped"] > 0
        assert want["delivered_stats"]["mean"] > 0
    if case == "partition_heal":
        assert want["total_suppressed"] > 0
        assert want["recovery_summary"]["origins"] == 13


def test_summary_equal(runs):
    case, ref, port = runs
    keys = set(ref) - set(TIMING) - {"stats"}
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}
    assert set(port) - set(ref) == {"batches"}
    assert port["padded_sims"] == (14 if case == "padded_tail" else 0)
    assert [b["n_valid"] for b in port["batches"]] == (
        [16, 2] if case == "padded_tail" else [13])


def test_print_all_lines_equal(runs, caplog):
    _, ref, port = runs
    want = print_all_lines(ref["stats"], caplog)
    assert len(want) > 20
    assert print_all_lines(port["stats"], caplog) == want
