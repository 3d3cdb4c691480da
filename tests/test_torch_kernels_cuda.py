"""On a CUDA device, each hand-written kernel equals its plain PyTorch
version on the inputs real engine rounds give it.

Marked ``cuda``: without a device every test here skips (the CUDA kernels
have no CPU mode; their plain versions are held against the reference
package by tests/test_torch_kernels.py).  This file imports no JAX, so it
also runs on a machine with the card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerance: 0 everywhere (exact equality of every output tensor)."""

import numpy as np
import pytest
import torch

from gossip_sim_tpu_torch import kernels, rng
from gossip_sim_tpu_torch.engine import (EngineParams, init_state,
                                         make_cluster_tables, run_rounds)

pytestmark = pytest.mark.cuda

NAMES = ("bfs_relax", "rank_inbound", "rc_merge_prune", "prune_apply")
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
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _outputs(x):
    return tuple(x) if isinstance(x, tuple) else (x,)


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
    assert all(kernels.LAUNCHES[name] == rounds for name in NAMES)
    for name in NAMES:
        plain = getattr(kernels, f"{name}_plain")
        for args, kw in calls[name]:
            got, want = real[name](*args, **kw), plain(*args, **kw)
            for g, w in zip(_outputs(got), _outputs(want)):
                assert g.dtype == w.dtype and torch.equal(g, w), name
    if config == "overflow":
        assert int(rows["rc_overflow"].sum()) > 0
    if config == "truncated":
        assert int(rows["inb_dropped"].sum()) > 0


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
