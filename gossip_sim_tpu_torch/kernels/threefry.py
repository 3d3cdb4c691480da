"""``threefry``: threefry-2x32 draws, as ``jax.random`` makes them.

Replaces the reference engine's key derivation and uniforms
(gossip_sim_tpu/engine/core.py:328-339 in ``init_state``, :507-509
``fold_in``/``split`` and :522 the draw of the fail round), which
``jax.random`` lowers to elementwise u32 arithmetic.  The CUDA kernel is
``csrc/threefry.cu``; :func:`threefry_plain` is the same function in plain
PyTorch, used for CPU tensors and as the spec.  ``rng.py`` routes its public
functions here.  Verb 5's draws (core.py:952-958) are made inside the
``rotate`` kernel from the same block (``csrc/threefry.cuh``), one word at a
time: :func:`word_at` and :func:`split_word` are the plain mirrors of that
header's word maps.

One function, four operations (``op``) on a batch of keys ``[..., 2]``
(int64 tensors holding u32 words; CPU PyTorch lacks ``>>`` on uint32):

* ``"fold_in"``: hash the counter pair ``(0, arg)``; ``arg`` an int or an
  int tensor broadcastable to ``keys.shape[:-1]`` -> keys ``[..., 2]``;
* ``"split"``: ``arg`` new keys under each key -> ``[..., arg, 2]``;
* ``"bits"``: ``arg`` 32-bit words under each key -> ``[..., arg]`` int64;
* ``"uniform"``: ``arg`` float32 in [0, 1) under each key -> ``[..., arg]``.

``split``, ``bits`` and ``uniform`` have two counter layouts (JAX's
``jax_threefry_partitionable``):

* partitionable: element ``j`` hashes the counter pair ``(0, j)``; a
  32-bit word is ``y0 ^ y1``;
* original: the counters ``0 .. size-1`` are split in two halves
  ``x0 = [0, h)``, ``x1 = [h, 2h)`` (``h = ceil(size / 2)``, an odd tail
  padded with 0), hashed pairwise, and the outputs concatenated.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "threefry"
M32 = 0xFFFFFFFF
OPS = ("fold_in", "split", "bits", "uniform")    # csrc/threefry.cu modes
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


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


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _hash_counters(keys: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """Hash counter vectors ``x0``/``x1`` ([M] int64) under every key of a
    ``[..., 2]`` batch -> two ``[..., M]`` word tensors."""
    return threefry2x32(keys[..., 0:1], keys[..., 1:2], x0, x1)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """u32 words -> float32 in [0, 1): the mantissa of ``1.0 | bits >> 9``
    minus one, exactly as ``jax.random.uniform`` maps them."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def threefry_plain(keys: torch.Tensor, op: str, arg,
                   partitionable: bool = True) -> torch.Tensor:
    """Plain PyTorch threefry draws (the module docstring says what each
    ``op`` returns)."""
    dev = keys.device
    if op == "fold_in":
        d = torch.as_tensor(arg, dtype=torch.int64, device=dev) & M32
        y0, y1 = threefry2x32(keys[..., 0], keys[..., 1],
                              torch.zeros_like(d), d)
        return torch.stack([y0, y1], dim=-1)
    n = int(arg)
    if op == "split":
        if partitionable:
            iot = _iota(n, dev)
            y0, y1 = _hash_counters(keys, torch.zeros_like(iot), iot)
            return torch.stack([y0, y1], dim=-1)
        y0, y1 = _hash_counters(keys, _iota(n, dev), _iota(n, dev) + n)
        return torch.cat([y0, y1], dim=-1).reshape(*keys.shape[:-1], n, 2)
    if op not in ("bits", "uniform"):
        raise ValueError(f"{NAME}: unknown op {op!r}; expected one of {OPS}")
    if partitionable:
        iot = _iota(n, dev)
        y0, y1 = _hash_counters(keys, torch.zeros_like(iot), iot)
        bits = y0 ^ y1
    else:
        h = (n + 1) // 2
        x1 = _iota(h, dev) + h
        if n % 2:
            x1[-1] = 0
        y0, y1 = _hash_counters(keys, _iota(h, dev), x1)
        bits = torch.cat([y0, y1], dim=-1)[..., :n]
    return bits if op == "bits" else bits_to_uniform(bits)


def word_at(keys: torch.Tensor, f, n: int,
            partitionable: bool = True) -> torch.Tensor:
    """The 32-bit word at flat index ``f`` of an ``n``-word draw
    (``"bits"``) under each key, one threefry block each: the plain mirror
    of ``tf_word`` in ``csrc/threefry.cuh``.  ``keys`` ``[..., 2]``; ``f``
    an int or an int64 tensor broadcastable to ``keys.shape[:-1]``."""
    f = torch.as_tensor(f, dtype=torch.int64, device=keys.device)
    k0, k1 = keys[..., 0], keys[..., 1]
    if partitionable:
        y0, y1 = threefry2x32(k0, k1, torch.zeros_like(f), f)
        return y0 ^ y1
    h = (n + 1) // 2
    hi = f >= h
    p = torch.where(hi, f - h, f)
    x1 = torch.where((n % 2 == 1) & (p == h - 1), 0, p + h)
    y0, y1 = threefry2x32(k0, k1, p, x1)
    return torch.where(hi, y1, y0)


def split_word(keys: torch.Tensor, i, w: int, m: int,
               partitionable: bool = True) -> torch.Tensor:
    """Word ``w`` (0 or 1) of key ``i`` of ``split(key, m)`` under each key,
    one threefry block each: the plain mirror of ``tf_split_word`` in
    ``csrc/threefry.cuh``."""
    i = torch.as_tensor(i, dtype=torch.int64, device=keys.device)
    k0, k1 = keys[..., 0], keys[..., 1]
    if partitionable:
        y0, y1 = threefry2x32(k0, k1, torch.zeros_like(i), i)
        return y1 if w else y0
    g = 2 * i + w
    hi = g >= m
    x0 = torch.where(hi, g - m, g)
    y0, y1 = threefry2x32(k0, k1, x0, x0 + m)
    return torch.where(hi, y1, y0)


def pairs(op: str, n: int, partitionable: bool) -> int:
    """Threefry blocks (counter pairs) the kernel hashes per key: one
    thread each."""
    if op == "fold_in":
        return 1
    if op == "split" or partitionable:
        return n
    return (n + 1) // 2


def batch2(shape: tuple, strides: tuple) -> tuple[int, int, int, int] | None:
    """A batch of at most two dimensions as (b0, b1, s0, s1): sizes and
    element strides of an outer and an inner batch axis; None for more
    dimensions.  The engine's key batches have at most two (``[O, T]``);
    ``rng.py``'s public functions take a ``[..., 2]`` batch of any rank, as
    ``jax.random`` and the plain version do, and for a deeper one the
    wrapper merges the outer axes (``reshape``, which copies only where
    they cannot be merged in place)."""
    if len(shape) == 0:
        return 1, 1, 0, 0
    if len(shape) == 1:
        return 1, shape[0], 0, strides[0]
    if len(shape) == 2:
        return shape[0], shape[1], strides[0], strides[1]
    return None


def _lib():
    fn = _build.library(NAME).threefry_launch
    if fn.argtypes is None:
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp, ci, ci, cl, cl, cl, ci, ci, cl, vp, cl, cl, cl,
                        vp, vp])
        fn.restype = ci
    return fn


def threefry(keys: torch.Tensor, op: str, arg,
             partitionable: bool = True) -> torch.Tensor:
    """Threefry draws: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  Returns what :func:`threefry_plain` does."""
    if not keys.is_cuda:
        return threefry_plain(keys, op, arg, partitionable)
    return _launch(keys, op, arg, partitionable)


def _launch(keys: torch.Tensor, op: str, arg,
            partitionable: bool) -> torch.Tensor:
    if op not in OPS:
        raise ValueError(f"{NAME}: unknown op {op!r}; expected one of {OPS}")
    if keys.dtype != torch.int64 or keys.dim() < 1 or keys.shape[-1] != 2:
        raise ValueError(f"{NAME}: keys must be int64 [..., 2], got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    dev = keys.device
    bshape = tuple(keys.shape[:-1])
    kb = batch2(bshape, keys.stride()[:-1])
    if kb is None:
        keys = keys.reshape(-1, bshape[-1], 2)
        kb = batch2(tuple(keys.shape[:-1]), keys.stride()[:-1])
    b0, b1, s0, s1 = kb
    data, ds0, ds1, scalar = None, 0, 0, 0
    if op == "fold_in":
        n = 1
        if isinstance(arg, torch.Tensor) and arg.dim() > 0:
            if arg.device != dev:
                raise ValueError(f"{NAME}: fold_in data on {arg.device}, "
                                 f"keys on {dev}")
            data = torch.broadcast_to(arg.to(torch.int64), bshape)
            if data.dim() > 2:
                data = data.reshape(b0, b1)
            _, _, ds0, ds1 = batch2(tuple(data.shape), data.stride())
        else:
            scalar = int(arg) & M32
    else:
        n = int(arg)
        if not 0 <= n < 1 << 32:
            raise ValueError(f"{NAME}: {op} of {n} elements per key; the "
                             f"counters are 32-bit")
    if op == "split":
        out = torch.empty((*bshape, n, 2), dtype=torch.int64, device=dev)
    elif op == "fold_in":
        out = torch.empty((*bshape, 2), dtype=torch.int64, device=dev)
    else:
        out = torch.empty((*bshape, n),
                          dtype=torch.int64 if op == "bits" else torch.float32,
                          device=dev)
    if out.numel() == 0:
        return out
    rc = _lib()(_build.ptr(keys), b0, b1, s0, s1, keys.stride(-1),
                OPS.index(op), int(bool(partitionable)), n,
                None if data is None else _build.ptr(data), ds0, ds1, scalar,
                _build.ptr(out), _build.stream_of(keys))
    _build.launched(NAME, rc)
    return out
