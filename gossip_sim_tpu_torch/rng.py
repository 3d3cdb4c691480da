"""Threefry-2x32 keys and uniforms, bit for bit as ``jax.random`` makes them.

The reference engine draws every random decision from ``jax.random`` with
raw ``uint32[2]`` threefry keys: ``PRNGKey``, ``fold_in``, ``split`` and
``uniform(float32)``.  This module reproduces those four functions on
tensors so the port's draws equal the reference's exactly.

Keys are int64 tensors of shape ``[..., 2]`` holding u32 words (CPU PyTorch
lacks ``>>`` on uint32); every op masks back to 32 bits.  ``split`` and
``uniform`` have two counter layouts, selected in JAX by the global
``jax_threefry_partitionable`` flag; here by :func:`set_partitionable`
(default True, the layout JAX 0.9 uses by default) or per call:

* partitionable: element ``j`` of a ``size``-element draw hashes the counter
  pair ``(0, j)`` and a 32-bit word is ``y0 ^ y1``;
* original: the counters ``0 .. size-1`` are split in two halves
  ``x0 = [0, h)``, ``x1 = [h, 2h)`` (``h = ceil(size / 2)``, an odd tail
  padded with 0), hashed pairwise, and the outputs concatenated.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARTITIONABLE = True


def set_partitionable(flag: bool) -> None:
    """Select the counter layout of ``split``/``uniform`` (mirrors JAX's
    ``jax_threefry_partitionable``)."""
    global _PARTITIONABLE
    _PARTITIONABLE = bool(flag)


def partitionable() -> bool:
    return _PARTITIONABLE


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The threefry-2x32 block (20 rounds) on broadcastable int64 tensors
    of u32 words; returns the two output words."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 64-bit seed: ``[seed >> 32,
    seed & 0xFFFFFFFF]``."""
    s = int(seed) & ((1 << 64) - 1)
    return torch.tensor([s >> 32, s & M32], dtype=torch.int64, device=device)


def _hash_counters(keys: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """Hash counter vectors ``x0``/``x1`` ([M] int64) under every key of a
    ``[..., 2]`` batch -> two ``[..., M]`` word tensors."""
    return threefry2x32(keys[..., 0:1], keys[..., 1:2], x0, x1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter pair ``(0, data)`` under each
    key.  ``data`` is an int or an int tensor broadcastable to
    ``keys.shape[:-1]``."""
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & M32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def split(keys: torch.Tensor, num: int, partitionable: bool | None = None):
    """``jax.random.split(key, num)`` under each key: ``[..., num, 2]``."""
    part = _PARTITIONABLE if partitionable is None else partitionable
    dev = keys.device
    if part:
        iot = _iota(num, dev)
        y0, y1 = _hash_counters(keys, torch.zeros_like(iot), iot)
        return torch.stack([y0, y1], dim=-1)
    y0, y1 = _hash_counters(keys, _iota(num, dev), _iota(num, dev) + num)
    return torch.cat([y0, y1], dim=-1).reshape(*keys.shape[:-1], num, 2)


def random_bits(keys: torch.Tensor, size: int,
                partitionable: bool | None = None) -> torch.Tensor:
    """32-bit random words of a ``size``-element draw under each key:
    ``[..., size]`` int64."""
    part = _PARTITIONABLE if partitionable is None else partitionable
    dev = keys.device
    if part:
        iot = _iota(size, dev)
        y0, y1 = _hash_counters(keys, torch.zeros_like(iot), iot)
        return y0 ^ y1
    h = (size + 1) // 2
    x1 = _iota(h, dev) + h
    if size % 2:
        x1[-1] = 0
    y0, y1 = _hash_counters(keys, _iota(h, dev), x1)
    return torch.cat([y0, y1], dim=-1)[..., :size]


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """u32 words -> float32 in [0, 1): the mantissa of ``1.0 | bits >> 9``
    minus one, exactly as ``jax.random.uniform`` maps them."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(keys: torch.Tensor, shape: tuple,
            partitionable: bool | None = None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` under each key of a
    ``[..., 2]`` batch -> ``[..., *shape]`` float32."""
    size = 1
    for d in shape:
        size *= int(d)
    bits = random_bits(keys, size, partitionable)
    return bits_to_uniform(bits).reshape(*keys.shape[:-1], *shape)
