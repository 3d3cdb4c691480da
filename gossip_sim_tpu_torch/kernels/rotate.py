"""``rotate``: verb 5, rotate one stake-weighted new peer into each active
set.

Replaces the reference engine's ``round/verb5_rotate`` block
(gossip_sim_tpu/engine/core.py:950-1011) with its sampler ``_sample_fast``
(core.py:274-305) and its draws (the round key and its sub keys,
core.py:507-509, and the uniforms, :952-958).  The CUDA kernel is
``csrc/rotate.cu``, which draws its own uniforms from each origin's key;
:func:`rotate_plain` is the same function in plain PyTorch, used for CPU
tensors and as the spec, and :func:`sample_members_plain` is its sampler
(``engine/sampler.py`` draws ``init_state``'s peers with it too).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ..constants import NUM_PUSH_ACTIVE_SET_ENTRIES as NB
from . import _build
from .threefry import threefry_plain

NAME = "rotate"
#: Static shared memory of the kernel: the class CDF table and the class
#: starts and counts (csrc/rotate.cu), padded to 16 bytes ahead of the
#: dynamic shared memory (ptxas reports it; chip_smoke.py checks it).
TABLE_BYTES = -(-(4 * NB * NB + 8 * NB) // 16) * 16
#: Bytes of one key (the round key or a sub key) in shared memory: two u32
#: words.
KEY_BYTES = 8


class Geometry(NamedTuple):
    """Rows (threads) per block, the bytes of the block's round keys and sub
    keys (16-byte padded, ahead of the staged rows) and the block's dynamic
    shared memory (keys and rows)."""

    rows: int
    key_bytes: int
    smem: int


def row_bytes(s: int) -> int:
    """Shared memory the kernel stages per row: the S slots (i32 peer,
    pruned and tfail bytes), updated in place."""
    return 6 * s


def key_origins(rows: int, n: int, o: int) -> int:
    """The most origins that a block of ``rows`` consecutive rows of an
    ``[O, N]`` row space spans, where the blocks start at multiples of
    ``rows``: a block starts ``g = gcd(rows, N)``-aligned within its origin,
    at worst ``N - g`` rows in, so it spans ``(N - g + rows - 1) // N + 1``
    origins, at most O (two for N = 10,000 and 128 rows; one where N is a
    multiple of the rows, ``rows / N`` where the rows are a multiple of
    N)."""
    g = math.gcd(rows, n)
    return min(o, (n - g + rows - 1) // n + 1)


def key_bytes(rows: int, n: int, o: int, tries: int) -> int:
    """Shared memory of a block's keys: ``T + 2`` of every origin its rows
    span (the round key, derived once per origin, and the sub keys of the
    rotation uniforms and of each try), 16-byte padded."""
    return -(-key_origins(rows, n, o) * (tries + 2) * KEY_BYTES // 16) * 16


@functools.lru_cache(maxsize=64)
def launch_geometry(s: int, tries: int, n: int, o: int,
                    smem_limit: int) -> Geometry:
    """Rows per block and shared memory (beside the static class tables):
    ``_build.ROWS_PER_BLOCK`` rows, fewer where their slots and sub keys
    would pass the block's shared memory; raises, naming the bytes, where
    one row and its origin's round key and sub keys do not fit."""
    room = smem_limit - TABLE_BYTES
    rb = row_bytes(s)
    if rb + key_bytes(1, n, o, tries) > room:
        raise ValueError(
            f"{NAME}: a row needs {rb} bytes of shared memory and its "
            f"origin's round key and {tries + 1} sub keys "
            f"{key_bytes(1, n, o, tries)} bytes, more than the {room} bytes "
            f"of one block")
    rows = min(_build.ROWS_PER_BLOCK, room // max(rb, 1))
    while rows * rb + key_bytes(rows, n, o, tries) > room:
        rows -= 1
    kb = key_bytes(rows, n, o, tries)
    return Geometry(rows, kb, kb + rows * rb)


def sample_members_plain(buckets: torch.Tensor, origins: torch.Tensor,
                         class_cdf: torch.Tensor, class_start: torch.Tensor,
                         class_count: torch.Tensor, u_class: torch.Tensor,
                         u_member: torch.Tensor) -> torch.Tensor:
    """Weighted draw for active-set entry ``k = min(bucket(n), bucket(o))``.

    ``u_class``/``u_member``: [O, N, T] f32 uniforms.  Returns class-member
    positions [O, N, T] i32 in bucket-sorted space (``perm[pos]`` is the
    node id).  The class is the number of the entry's first 24 CDF values
    at or below ``u_class``; the member is ``start + floor(u_member *
    count)``, capped at the class's last member.  The reference selects the
    CDF row as ``cdf_own[n]`` (= ``class_cdf[bucket(n)]``) where ``b_n <=
    b_o`` and the origin's row otherwise: the row of ``min(b_n, b_o)``."""
    b_o = buckets[origins.long()]                                 # [O]
    k = torch.minimum(buckets[None, :], b_o[:, None])             # [O, N]
    cdf = class_cdf[k.long()][:, :, None, :-1]                    # [O,N,1,24]
    cls = (u_class[..., None] >= cdf).sum(-1)                     # [O, N, T]
    start = class_start[cls]
    count = class_count[cls]
    member = start + torch.floor(
        u_member * count.to(torch.float32)).to(torch.int32)
    return torch.minimum(member, start + torch.clamp(count - 1, min=0))


def draws_plain(key: torch.Tensor, it: int, n: int, tries: int,
                partitionable: bool = True):
    """Verb 5's uniforms as the reference round draws them, in plain
    PyTorch: the round key ``fold_in(key, it)``, its ``T + 2`` sub keys, the
    rotation uniforms ``rot_u`` [O, N] (sub key 1) and the tries' class and
    member uniforms ``u_all`` [O, T, N, 2] (sub keys 2 .. T + 1)."""
    kr = threefry_plain(key, "fold_in", it)
    subs = threefry_plain(kr, "split", tries + 2, partitionable)
    rot_u = threefry_plain(subs[:, 1], "uniform", n, partitionable)
    u_all = threefry_plain(subs[:, 2:2 + tries], "uniform", 2 * n,
                           partitionable)
    return rot_u, u_all.reshape(key.shape[0], tries, n, 2)


def rotate_plain(active, pruned, tfail, failed, key, it, origins, buckets,
                 perm, class_start, class_count, class_cdf,
                 probability: float, tries: int, partitionable: bool = True):
    """Verb 5 over every (origin, node) row.

    ``active`` [O, N, S] i32, ``pruned`` (this round's bits after verb 4)
    and ``tfail`` [O, N, S] bool, ``failed`` [O, N] bool, ``key`` [O, 2]
    i64 (each origin's threefry key), ``it`` the iteration, ``origins``
    [O], ``buckets`` and ``perm`` [N] i32, the class tables
    (``engine/sampler.py``), ``probability`` the rotation probability as a
    float32 value, ``tries`` the tries T per rotating row, ``partitionable``
    the threefry layout.  The uniforms are :func:`draws_plain`'s.  Returns
    ``new_active``, ``new_pruned``, ``new_tfail`` [O, N, S] and
    ``rot_failed`` [O] i32."""
    O, N, S = active.shape
    T = int(tries)
    dev = active.device
    i32 = torch.int32
    iota_n = torch.arange(N, device=dev, dtype=i32)[None, :]
    rot_u, u_all = draws_plain(key, it, N, T, partitionable)
    rotate = rot_u < probability
    u = u_all.permute(0, 2, 1, 3)                                 # [O,N,T,2]
    members = sample_members_plain(buckets, origins, class_cdf, class_start,
                                   class_count, u[..., 0], u[..., 1])
    cands = perm[members.clamp(max=N - 1).long()]                 # [O, N, T]

    chosen = torch.full((O, N), N, dtype=i32, device=dev)
    found_new = torch.zeros((O, N), dtype=torch.bool, device=dev)
    for t in range(T):
        cand = cands[..., t]
        ok = (cand != iota_n) & ~(active == cand[..., None]).any(-1)
        chosen = torch.where(ok & ~found_new, cand, chosen)
        found_new = found_new | ok
    do_rot = rotate & found_new
    rot_failed = (rotate & ~found_new).sum(-1, dtype=i32)
    chosen_failed = failed.gather(1, chosen.clamp(max=N - 1).long())

    mcnt = (active < N).sum(-1, dtype=i32)
    full_row = (mcnt >= S)[..., None]
    shift_act = torch.cat([active[..., 1:], chosen[..., None]], -1)
    shift_prn = torch.cat([pruned[..., 1:],
                           torch.zeros_like(pruned[..., :1])], -1)
    shift_tf = torch.cat([tfail[..., 1:], chosen_failed[..., None]], -1)
    slot_oh = (torch.arange(S, device=dev)[None, None, :]
               == torch.clamp(mcnt, max=S - 1)[..., None]) & ~full_row
    append_act = torch.where(slot_oh, chosen[..., None], active)
    append_tf = torch.where(slot_oh, chosen_failed[..., None], tfail)
    rot3 = do_rot[..., None]
    new_active = torch.where(rot3, torch.where(full_row, shift_act,
                                               append_act), active)
    new_pruned = torch.where(rot3 & full_row, shift_prn, pruned)
    new_tfail = torch.where(rot3, torch.where(full_row, shift_tf, append_tf),
                            tfail)
    return (new_active.contiguous(), new_pruned.contiguous(),
            new_tfail.contiguous(), rot_failed)


def _lib():
    fn = _build.library(NAME).rotate_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([vp] * 15 + [ci, ctypes.c_longlong, ci, ci, ci,
                                    ctypes.c_float, ctypes.c_uint32, ci, ci,
                                    ci, ci, vp])
        fn.restype = ci
    return fn


def rotate(active, pruned, tfail, failed, key, it, origins, buckets, perm,
           class_start, class_count, class_cdf, probability: float,
           tries: int, partitionable: bool = True):
    """Verb 5: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.  Returns what :func:`rotate_plain` does."""
    if not active.is_cuda:
        return rotate_plain(active, pruned, tfail, failed, key, it, origins,
                            buckets, perm, class_start, class_count,
                            class_cdf, probability, tries, partitionable)
    O, N, S = active.shape
    T = int(tries)
    if T < 0:
        raise ValueError(f"{NAME}: tries must be >= 0, got {T}")
    dev = active.device
    chk = _build.check
    chk(active, "active", torch.int32, (O, N, S), dev)
    chk(pruned, "pruned", torch.bool, (O, N, S), dev)
    chk(tfail, "tfail", torch.bool, (O, N, S), dev)
    chk(failed, "failed", torch.bool, (O, N), dev)
    chk(key, "key", torch.int64, (O, 2), dev)
    chk(origins, "origins", torch.int32, (O,), dev)
    chk(buckets, "buckets", torch.int32, (N,), dev)
    chk(perm, "perm", torch.int32, (N,), dev)
    chk(class_start, "class_start", torch.int32, (NB,), dev)
    chk(class_count, "class_count", torch.int32, (NB,), dev)
    chk(class_cdf, "class_cdf", torch.float32, (NB, NB), dev)
    new_active = torch.empty_like(active)
    new_pruned = torch.empty_like(pruned)
    new_tfail = torch.empty_like(tfail)
    rot_failed = torch.empty((O,), dtype=torch.int32, device=dev)
    if active.numel() == 0:
        return new_active, new_pruned, new_tfail, rot_failed.zero_()
    g = launch_geometry(S, T, N, O, _build.smem_optin(dev))
    p = _build.ptr
    rc = _lib()(p(active), p(pruned), p(tfail), p(failed), p(key),
                p(origins), p(buckets), p(perm), p(class_start),
                p(class_count), p(class_cdf), p(new_active), p(new_pruned),
                p(new_tfail), p(rot_failed), O, O * N, N, S, T,
                float(probability), int(it) & 0xFFFFFFFF,
                int(bool(partitionable)), g.rows, g.key_bytes, g.smem,
                _build.stream_of(active))
    _build.launched(NAME, rc)
    return new_active, new_pruned, new_tfail, rot_failed
