"""``health_digest``: the node-health digest of a [P, N] metric stack.

Replaces the reference's on-device digest
(gossip_sim_tpu/obs/health.py:125-146, ``_device_digest_fn``): per metric
row the stake-decile sums, the top-k nodes (value descending, ties toward
the lower node id, as ``lax.top_k`` and the numpy twin's lexsort order
them) and the exact integer Gini parts ``num = sum((2 i - n - 1) *
x_sorted[i])``, ``den = n * sum(x)``, all in int64.  The CUDA kernel is
``csrc/health_digest.cu``: one cooperative launch sorts each row, stable
and descending by value, by an LSD radix sort over the row's own range
(tiles of :data:`TILE` entries, a histogram, a scan and a stable scatter
a pass in device-memory scratch), then reads the top-k and the Gini
numerator off the sorted positions; :func:`health_digest_plain` is the
same function in plain PyTorch, used for CPU tensors and as the spec.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

NAME = "health_digest"
NUM_DECILES = 10
#: entries of a row one tile holds, threads of a block (csrc/
#: health_digest.cu kTile, kThreads)
TILE = 1024
THREADS = 256
#: digit bins of a radix pass (8 bits), and per-tile stats (min, max,
#: sum, the 10 decile sums)
BINS = 256
TILE_STATS = NUM_DECILES + 3


class Digest(NamedTuple):
    deciles: torch.Tensor   # [P, 10] i64 per-decile sums
    top_idx: torch.Tensor   # [P, k] i32 hot nodes, value descending
    top_val: torch.Tensor   # [P, k] i64 their values
    gini_num: torch.Tensor  # [P] i64
    gini_den: torch.Tensor  # [P] i64


class Geometry(NamedTuple):
    tiles_per_row: int      # tiles of TILE entries a row spans
    blocks: int             # blocks of the cooperative launch


def launch_geometry(p: int, n: int, sms: int, blocks_per_sm: int) -> Geometry:
    """The kernel's tiles per row and grid: a block per tile, or per 8
    (row, digit) warps of the scan phase where those are more, at most
    the one wave that a cooperative launch may hold (``sms`` x
    ``blocks_per_sm``); at least one block."""
    tpr = max(1, -(-n // TILE))
    work = max(p * tpr, -(-p * BINS // (THREADS // 32)))
    return Geometry(tpr, max(1, min(work, sms * blocks_per_sm)))


def scratch_layout(p: int, n: int, wide: bool) -> dict:
    """Byte offset and size of each scratch region of the kernel, in one
    buffer, each 256-byte aligned: the two key buffers ([2, P, N] of u32,
    u64 for an int64 stack), the two id buffers ([2, P, N] i32), the tile
    stats ([P x tiles, 13] u64), the digit counts ([P, 256, tiles] u32),
    the digit totals ([P, passes, 256] u32: 4 passes of 8 bits for u32
    keys, 8 for u64), the row max ([P] i64) and passes ([P] i32), and the
    pass count.  ``"total"``: the buffer's bytes."""
    key = 8 if wide else 4
    tpr = max(1, -(-n // TILE))
    sizes = (("keys", 2 * p * n * key), ("ids", 2 * p * n * 4),
             ("tstat", p * tpr * TILE_STATS * 8),
             ("counts", p * BINS * tpr * 4),
             ("totals", p * key * BINS * 4), ("rowmax", p * 8),
             ("rowpasses", p * 4), ("ctrl", 4))
    out, off = {}, 0
    for name, size in sizes:
        out[name] = (off, size)
        off += -(-size // 256) * 256
    out["total"] = off
    return out


def health_digest_plain(stack: torch.Tensor, decile_ids: torch.Tensor,
                        k: int) -> Digest:
    """``stack`` [P, N] (int32 or int64), ``decile_ids`` [N] int32 in
    0-9, ``k`` <= N.  Sums wrap in int64 as the reference's do."""
    x = stack.to(torch.int64)
    P, N = x.shape
    dec = torch.zeros((P, NUM_DECILES), dtype=torch.int64, device=x.device)
    dec.index_add_(1, decile_ids.long(), x)
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    xs = torch.sort(x, dim=-1).values
    w = 2 * torch.arange(1, N + 1, dtype=torch.int64, device=x.device) - N - 1
    return Digest(deciles=dec, top_idx=idx[:, :k].to(torch.int32),
                  top_val=vals[:, :k], gini_num=(w * xs).sum(-1),
                  gini_den=N * x.sum(-1))


def _lib():
    fn = _build.library(NAME).health_digest_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ci, vp] + [ci] * 5 + [vp] * 12
        fn.restype = ci
    return fn


@functools.lru_cache(maxsize=8)
def blocks_per_sm(device: torch.device, wide: bool) -> int:
    """Blocks of the i32 (or, ``wide``, the i64) kernel one SM of
    ``device`` holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``,
    read once per device and instance)."""
    fn = _build.library(NAME).health_digest_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(int(wide), ctypes.byref(out))
    if rc != 0 or out.value < 1:
        raise RuntimeError(f"{NAME}: occupancy query failed (error {rc}, "
                           f"{out.value} blocks per SM)")
    return out.value


def health_digest(stack: torch.Tensor, decile_ids: torch.Tensor,
                  k: int) -> Digest:
    """The digest: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  On the card one cooperative launch writes every output
    (the decile sums and the Gini parts as views of one [P, 12] int64
    buffer) and its scratch comes from one ``torch.empty``: no memset, no
    host sync."""
    P, N = stack.shape
    k = int(k)
    if not 0 <= k <= N:
        raise ValueError(f"{NAME}: k={k} outside [0, {N}]")
    if not stack.is_cuda:
        return health_digest_plain(stack, decile_ids, k)
    dev = stack.device
    if stack.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{NAME}: stack must be int32 or int64, got "
                         f"{stack.dtype}")
    _build.check(stack, "stack", stack.dtype, (P, N), dev)
    _build.check(decile_ids, "decile_ids", torch.int32, (N,), dev)
    wide = stack.dtype == torch.int64
    geo = launch_geometry(P, N, _build.sm_count(dev), blocks_per_sm(dev, wide))
    lay = scratch_layout(P, N, wide)
    acc = torch.empty((P, NUM_DECILES + 2), dtype=torch.int64, device=dev)
    top_idx = torch.empty((P, k), dtype=torch.int32, device=dev)
    top_val = torch.empty((P, k), dtype=torch.int64, device=dev)
    scratch = torch.empty(lay["total"], dtype=torch.uint8, device=dev)
    base = scratch.data_ptr()
    regions = [ctypes.c_void_p(base + lay[r][0]) for r in (
        "keys", "ids", "tstat", "counts", "totals", "rowmax", "rowpasses",
        "ctrl")]
    p = _build.ptr
    rc = _lib()(p(stack), int(wide), p(decile_ids), P, N, k,
                geo.tiles_per_row, geo.blocks, p(acc), p(top_idx),
                p(top_val), *regions, _build.stream_of(stack))
    _build.launched(NAME, rc)
    return Digest(deciles=acc[:, :NUM_DECILES], top_idx=top_idx,
                  top_val=top_val, gini_num=acc[:, NUM_DECILES],
                  gini_den=acc[:, NUM_DECILES + 1])
