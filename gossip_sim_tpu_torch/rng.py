"""Threefry-2x32 keys and uniforms, bit for bit as ``jax.random`` makes them.

The reference engine draws every random decision from ``jax.random`` with
raw ``uint32[2]`` threefry keys: ``PRNGKey``, ``fold_in``, ``split`` and
``uniform(float32)``.  This module reproduces those four functions on
tensors so the port's draws equal the reference's exactly.

Keys are int64 tensors of shape ``[..., 2]`` holding u32 words (CPU PyTorch
lacks ``>>`` on uint32).  ``split`` and ``uniform`` have two counter
layouts, selected in JAX by the global ``jax_threefry_partitionable`` flag;
here by :func:`set_partitionable` (default True, the layout JAX 0.9 uses by
default) or per call.  The layouts and the arithmetic are in
``kernels/threefry.py``: every function here is one call of the
``threefry`` kernel for CUDA tensors, and of its plain version for CPU
tensors.  The kernel is looked up on the ``kernels`` module at call time.
The engine draws ``init_state``'s keys and uniforms and the fail round's
uniforms here; verb 5's draws are made inside the ``rotate`` kernel, which
hashes the same words from each origin's key and reads the layout from
:func:`partitionable`.
"""

from __future__ import annotations

import torch

from . import kernels

M32 = 0xFFFFFFFF
_PARTITIONABLE = True


def set_partitionable(flag: bool) -> None:
    """Select the counter layout of ``split``/``uniform`` (mirrors JAX's
    ``jax_threefry_partitionable``)."""
    global _PARTITIONABLE
    _PARTITIONABLE = bool(flag)


def partitionable() -> bool:
    return _PARTITIONABLE


def _layout(flag: bool | None) -> bool:
    return _PARTITIONABLE if flag is None else bool(flag)


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 64-bit seed: ``[seed >> 32,
    seed & 0xFFFFFFFF]``."""
    s = int(seed) & ((1 << 64) - 1)
    return torch.tensor([s >> 32, s & M32], dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter pair ``(0, data)`` under each
    key.  ``data`` is an int or an int tensor broadcastable to
    ``keys.shape[:-1]``."""
    return kernels.threefry(keys, "fold_in", data)


def split(keys: torch.Tensor, num: int, partitionable: bool | None = None):
    """``jax.random.split(key, num)`` under each key: ``[..., num, 2]``."""
    return kernels.threefry(keys, "split", num, _layout(partitionable))


def random_bits(keys: torch.Tensor, size: int,
                partitionable: bool | None = None) -> torch.Tensor:
    """32-bit random words of a ``size``-element draw under each key:
    ``[..., size]`` int64."""
    return kernels.threefry(keys, "bits", size, _layout(partitionable))


def uniform(keys: torch.Tensor, shape: tuple,
            partitionable: bool | None = None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` under each key of a
    ``[..., 2]`` batch -> ``[..., *shape]`` float32."""
    size = 1
    for d in shape:
        size *= int(d)
    u = kernels.threefry(keys, "uniform", size, _layout(partitionable))
    return u.reshape(*keys.shape[:-1], *shape)
