"""Network-impairment primitives: stateless counter hashes and the stake
bipartition (the port's copy of the reference package's ``faults.py``).

Every impairment decision is a counter hash of ``(seed, iteration, node
ids)``, so two backends make bit-identical decisions under a shared seed:

    drop(edge)   = fmix32(base_e(seed, it) ^ src*C1 ^ dst*C2)  < p_loss  * 2^32
    fail(node)   = fmix32(base_c(seed, it) ^ node*C1)          < p_fail  * 2^32
    recover(node)= same hash                                   < p_recov * 2^32

The scalar functions work on Python ints (the per-round bases are host
scalars); :func:`round_basis_lanes` and :func:`partition_active_lanes` give
one value per sweep lane (numpy).  The ``*_t`` functions work on int64
tensors holding u32 values:
CPU PyTorch has no ``>>`` on uint32, so the lanes are int64 masked with
``& 0xFFFFFFFF``, and every 32-bit product is split in two 16-bit halves
so that no int64 product overflows.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B1          # 2^32 / phi, round-mixing multiplier
_C1 = 0x85EBCA6B            # murmur3 fmix constants reused as lane salts
_C2 = 0xC2B2AE35
SALT_EDGE = 0x7F4A7C15      # domain separation: packet-loss stream
SALT_CHURN = 0x2545F491     # domain separation: churn stream


def fmix32(x: int) -> int:
    """Murmur3 32-bit finalizer on Python ints."""
    x &= _M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    x ^= x >> 16
    return x


def round_basis(seed: int, it: int, salt: int) -> int:
    """Per-(seed, iteration, domain) hash basis."""
    return fmix32((seed & _M32) ^ fmix32((it * _GOLD + salt) & _M32))


def edge_u32(basis: int, src: int, dst: int) -> int:
    """Per-edge hash in [0, 2^32)."""
    return fmix32(basis ^ ((src * _C1) & _M32) ^ ((dst * _C2) & _M32))


def node_u32(basis: int, node: int) -> int:
    """Per-node churn hash in [0, 2^32)."""
    return fmix32(basis ^ ((node * _C1) & _M32))


def rate_threshold(rate: float) -> int:
    """Bernoulli(rate) as an integer threshold: event iff u32 < threshold.
    rate <= 0 never fires, rate >= 1 always fires (threshold 2^32)."""
    if rate <= 0.0:
        return 0
    if rate >= 1.0:
        return 1 << 32
    return int(rate * (1 << 32))


def partition_active(it: int, partition_at: int, heal_at: int) -> bool:
    """Partition window: [partition_at, heal_at); heal_at < 0 = never heals."""
    if partition_at < 0:
        return False
    return it >= partition_at and (heal_at < 0 or it < heal_at)


def fmix32_np(x: np.ndarray) -> np.ndarray:
    """``fmix32`` on a uint64 array of u32 values (each product of two u32
    values fits uint64 exactly)."""
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(0x7FEB352D)) & np.uint64(_M32)
    x = x ^ (x >> np.uint64(15))
    x = (x * np.uint64(0x846CA68B)) & np.uint64(_M32)
    return x ^ (x >> np.uint64(16))


def round_basis_lanes(seeds, its, salt: int) -> np.ndarray:
    """:func:`round_basis` of each lane's (seed, iteration): an int64 array
    of u32 values, one per lane (broadcast), or of one value where every
    lane's is the same."""
    seeds = np.asarray(seeds, np.int64).reshape(-1)
    its = np.asarray(its, np.int64).reshape(-1)
    if (seeds == seeds[0]).all() and (its == its[0]).all():
        return np.array([round_basis(int(seeds[0]), int(its[0]), salt)],
                        np.int64)
    m = np.uint64(_M32)
    h = (((its.astype(np.uint64) & m) * np.uint64(_GOLD)) & m) + np.uint64(salt)
    b = fmix32_np((seeds.astype(np.uint64) & m) ^ fmix32_np(h & m))
    return b.astype(np.int64)


def round_basis_t(seeds: torch.Tensor, its: torch.Tensor,
                  salt: int) -> torch.Tensor:
    """:func:`round_basis` on int64 tensors of seeds and iterations
    (broadcastable), on their device."""
    h = (mul32_t(its & _M32, _GOLD) + salt) & _M32
    return fmix32_t((seeds & _M32) ^ fmix32_t(h))


def partition_active_lanes(its, partition_at, heal_at) -> np.ndarray:
    """:func:`partition_active` of each lane (numpy, broadcast)."""
    its, pa, heal = (np.asarray(a, np.int64) for a in
                     (its, partition_at, heal_at))
    return (pa >= 0) & (its >= pa) & ((heal < 0) | (its < heal))


def stake_bipartition(stakes) -> np.ndarray:
    """Deterministic stake-balanced bipartition -> bool side per node.

    Greedy: walk nodes by (stake desc, index asc), assign each to the
    currently lighter side."""
    stakes = np.asarray(stakes, dtype=np.int64)
    n = stakes.shape[0]
    order = np.lexsort((np.arange(n), -stakes)).tolist()
    vals = stakes.tolist()
    side = [False] * n
    tot0 = tot1 = 0
    for i in order:
        if tot1 < tot0:
            side[i] = True
            tot1 += vals[i]
        else:
            tot0 += vals[i]
    return np.asarray(side, dtype=bool)


def mul32_t(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in [0, 2^32) and a u32 constant,
    as two 16-bit partial products (each < 2^48, so int64 never wraps)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def fmix32_t(x: torch.Tensor) -> torch.Tensor:
    """``fmix32`` on an int64 tensor of u32 values."""
    x = x ^ (x >> 16)
    x = mul32_t(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32_t(x, 0x846CA68B)
    return x ^ (x >> 16)


def edge_u32_t(basis: int, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Vectorized ``edge_u32``: int64 src/dst node ids (broadcastable)."""
    return fmix32_t(basis ^ mul32_t(src.long(), _C1) ^ mul32_t(dst.long(), _C2))


def node_u32_t(basis: int, node: torch.Tensor) -> torch.Tensor:
    """Vectorized ``node_u32`` over an int64 tensor of node ids."""
    return fmix32_t(basis ^ mul32_t(node.long(), _C1))
