"""The port's counter hashes and stake bipartition equal the reference
package's ``faults.py`` on random inputs.

Tolerance: 0 everywhere (exact integer equality)."""

import numpy as np
import pytest
import torch

from gossip_sim_tpu import faults as ref
from gossip_sim_tpu_torch import faults as port

RNG = np.random.default_rng(20260101)
U32 = RNG.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
U32_B = RNG.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(a.astype(np.int64))


def test_fmix32_tensor_matches_reference_arrays():
    assert np.array_equal(port.fmix32_t(_t(U32)).numpy(),
                          ref.fmix32_arr(U32).astype(np.int64))


@pytest.mark.parametrize("it", [0, 1, 199, 2**31 - 1])
@pytest.mark.parametrize("salt", [ref.SALT_EDGE, ref.SALT_CHURN])
def test_round_basis_and_hashes(it, salt):
    seed = 0xDEADBEEF
    basis = port.round_basis(seed, it, salt)
    assert basis == ref.round_basis(seed, it, salt)
    assert basis == int(ref.round_basis_arr(
        np.array([seed], np.uint32), np.array([it], np.int64), salt)[0])
    src, dst = U32 % 40_000, U32_B % 40_000
    assert np.array_equal(
        port.edge_u32_t(basis, _t(src), _t(dst)).numpy(),
        ref.edge_u32_arr(np.uint32(basis), src, dst).astype(np.int64))
    assert np.array_equal(
        port.node_u32_t(basis, _t(U32)).numpy(),
        ref.node_u32_arr(np.uint32(basis), U32).astype(np.int64))


def test_scalar_paths_match():
    for x, y in zip(U32[:64].tolist(), U32_B[:64].tolist()):
        assert port.fmix32(x) == ref.fmix32(x)
        assert port.edge_u32(x, y, x ^ y) == ref.edge_u32(x, y, x ^ y)
        assert port.node_u32(x, y) == ref.node_u32(x, y)


@pytest.mark.parametrize("rate", [-0.5, 0.0, 1e-9, 0.013333, 0.1, 0.5,
                                  0.999999, 1.0, 3.0])
def test_rate_threshold(rate):
    assert port.rate_threshold(rate) == ref.rate_threshold(rate)
    assert port.rate_threshold(rate) == int(ref.rate_threshold_arr(rate))


def test_partition_window_and_bipartition():
    for it, at, heal in [(5, -1, -1), (5, 5, -1), (4, 5, 9), (9, 5, 9),
                         (8, 5, 9)]:
        assert port.partition_active(it, at, heal) == ref.partition_active(
            it, at, heal)
    stakes = RNG.integers(0, 2**40, size=777).astype(np.int64)
    stakes[::7] = stakes[3]            # ties break by index
    assert np.array_equal(port.stake_bipartition(stakes),
                          ref.stake_bipartition(stakes))
