"""``health_digest``: the node-health digest of a [P, N] metric stack.

Replaces the reference's on-device digest
(gossip_sim_tpu/obs/health.py:125-146, ``_device_digest_fn``): per metric
row the stake-decile sums, the top-k nodes (value descending, ties toward
the lower node id, as ``lax.top_k`` and the numpy twin's lexsort order
them) and the exact integer Gini parts ``num = sum((2 i - n - 1) *
x_sorted[i])``, ``den = n * sum(x)``, all in int64.  The CUDA kernel is
``csrc/health_digest.cu`` (no row is sorted: each entry counts the row's
entries below, equal to and above it, tile by tile through shared memory,
which covers rows of any length); :func:`health_digest_plain` is the same
function in plain PyTorch, used for CPU tensors and as the spec.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

NAME = "health_digest"
NUM_DECILES = 10
#: threads per block and entries per thread (csrc/health_digest.cu
#: kThreads, kItems): a block owns this many entries of one row
BLOCK_ENTRIES = 128 * 8


class Digest(NamedTuple):
    deciles: torch.Tensor   # [P, 10] i64 per-decile sums
    top_idx: torch.Tensor   # [P, k] i32 hot nodes, value descending
    top_val: torch.Tensor   # [P, k] i64 their values
    gini_num: torch.Tensor  # [P] i64
    gini_den: torch.Tensor  # [P] i64


def grid(p: int, n: int) -> tuple[int, int]:
    """The kernel's grid: (blocks per row, rows); the C launcher checks
    that the blocks cover the row."""
    return -(-n // BLOCK_ENTRIES), p


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
        fn.argtypes = [vp, ci, vp, ci, ci, ci, ci, vp, vp, vp, vp]
        fn.restype = ci
    return fn


def health_digest(stack: torch.Tensor, decile_ids: torch.Tensor,
                  k: int) -> Digest:
    """The digest: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  On the card the decile sums and the Gini parts come back
    as views of one zeroed [P, 12] int64 buffer (one memset and one
    kernel launch)."""
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
    acc = torch.zeros((P, NUM_DECILES + 2), dtype=torch.int64, device=dev)
    top_idx = torch.empty((P, k), dtype=torch.int32, device=dev)
    top_val = torch.empty((P, k), dtype=torch.int64, device=dev)
    p = _build.ptr
    rc = _lib()(p(stack), int(stack.dtype == torch.int64), p(decile_ids), P,
                N, k, grid(P, N)[0], p(acc), p(top_idx), p(top_val),
                _build.stream_of(stack))
    _build.launched(NAME, rc)
    return Digest(deciles=acc[:, :NUM_DECILES], top_idx=top_idx,
                  top_val=top_val, gini_num=acc[:, NUM_DECILES],
                  gini_den=acc[:, NUM_DECILES + 1])
