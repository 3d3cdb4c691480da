"""``bfs_relax``: BFS frontier relaxation of one round's push edges.

Replaces the reference engine's ``round/bfs_propagate`` block
(gossip_sim_tpu/engine/core.py:620-661; twin engine/sparse.py:64-95).
The CUDA kernel is ``csrc/bfs_relax.cu``; :func:`bfs_relax_plain` is the
same function in plain PyTorch, used for CPU tensors and as the spec.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

NAME = "bfs_relax"
INF = 1 << 20
MAX_CLUSTER = 8        # the portable thread block cluster size


class Geometry(NamedTuple):
    cs: int            # CTAs per origin (thread block cluster size)
    slice_len: int     # nodes per CTA, a whole number of 32-bit words
    state_words: int   # 32-bit words of state per CTA
    smem: int          # dynamic shared memory per CTA; 0 = state in scratch
    scratch_words: int  # device-memory state of all CTAs; 0 = in smem


def cluster_size(o: int, sms: int) -> int:
    """CTAs per origin: the largest power of two <= ``MAX_CLUSTER`` with
    ``o * cs <= sms``, and at least 1."""
    cs = MAX_CLUSTER
    while cs > 1 and o * cs > sms:
        cs //= 2
    return cs


def slice_len(n: int, cs: int) -> int:
    """Nodes per CTA: ceil(n / cs) rounded up to a whole 32-bit word, so
    no bitmap word is shared by two CTAs."""
    return -(-(-(-n // cs)) // 32) * 32


def slice_bounds(n: int, cs: int) -> list[tuple[int, int]]:
    """The node range [lo, hi) each CTA rank of a cluster owns (empty for a
    rank past N)."""
    s = slice_len(n, cs)
    return [(min(n, r * s), min(n, (r + 1) * s)) for r in range(cs)]


def state_words(n: int, cs: int) -> int:
    """32-bit words of state per CTA: reached and frontier bitmaps of its
    slice, two "sent" bitmaps over all ``cs`` slices, two live flags."""
    return (2 + 2 * cs) * (slice_len(n, cs) // 32) + 2


def launch_geometry(o: int, n: int, sms: int, smem_limit: int) -> Geometry:
    """The launch of ``o`` origins over ``n`` nodes on a card of ``sms``
    SMs and ``smem_limit`` bytes of opt-in shared memory per block.  The
    state of a CTA lives in shared memory where it fits, else in a
    device-memory scratch buffer (any ``n``)."""
    cs = cluster_size(o, sms)
    words = state_words(n, cs)
    if 4 * words <= smem_limit:
        return Geometry(cs, slice_len(n, cs), words, 4 * words, 0)
    return Geometry(cs, slice_len(n, cs), words, 0, o * cs * words)


def bfs_relax_plain(tgt: torch.Tensor, origins: torch.Tensor):
    """Plain PyTorch BFS: ``tgt`` [O, N, F] i32 (N = no push), ``origins``
    [O] -> (reached [O, N] bool, dist [O, N] i32, INF = unreached).

    Hop 1 is the origin's own targets and the origin is reached at 0
    (core.py:627-633); each hop ORs the frontier bit of every edge's source
    into its target (a scatter of True, order-free)."""
    O, N, F = tgt.shape
    dev = tgt.device
    o1 = torch.arange(O, device=dev)
    org = origins.long()
    seed = tgt[o1, org].long()                                   # [O, F]
    seed = torch.where((seed >= 0) & (seed < N), seed, N)
    frontier = torch.zeros((O, N + 1), dtype=torch.bool, device=dev)
    frontier.scatter_(1, seed, True)
    dist = torch.full((O, N + 1), INF, dtype=torch.int32, device=dev)
    dist.scatter_(1, seed, 1)
    frontier = frontier[:, :N].contiguous()
    dist = dist[:, :N].contiguous()
    reached = frontier.clone()
    reached[o1, org] = True
    dist[o1, org] = 0
    live = (tgt >= 0) & (tgt < N)
    h = 1
    while bool(frontier.any()):
        idx = torch.where(frontier[:, :, None] & live, tgt, N).long()
        hit = torch.zeros((O, N + 1), dtype=torch.bool, device=dev)
        hit.scatter_(1, idx.reshape(O, N * F), True)
        newly = hit[:, :N] & ~reached
        dist = torch.where(newly, h + 1, dist)
        reached = reached | newly
        frontier = newly
        h += 1
    return reached, dist


def _lib():
    lib = _build.library(NAME)
    fn = lib.bfs_relax_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 5 + [ci] * 7 + [vp]
        fn.restype = ci
    return fn


def bfs_relax(tgt: torch.Tensor, origins: torch.Tensor):
    """BFS over the push edges: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns (reached [O, N] bool, dist [O, N] i32)."""
    if not tgt.is_cuda:
        return bfs_relax_plain(tgt, origins)
    O, N, F = tgt.shape
    dev = tgt.device
    _build.check(tgt, "tgt", torch.int32, (O, N, F), dev)
    _build.check(origins, "origins", torch.int32, (O,), dev)
    return _launch(tgt, origins, launch_geometry(O, N, _build.sm_count(dev),
                                                 _build.smem_optin(dev)))


def _launch(tgt: torch.Tensor, origins: torch.Tensor, g: Geometry):
    O, N, F = tgt.shape
    dev = tgt.device
    reached = torch.empty((O, N), dtype=torch.bool, device=dev)
    dist = torch.empty((O, N), dtype=torch.int32, device=dev)
    scratch = (torch.empty(g.scratch_words, dtype=torch.int32, device=dev)
               if g.scratch_words else None)
    rc = _lib()(_build.ptr(tgt), _build.ptr(origins), _build.ptr(reached),
                _build.ptr(dist),
                None if scratch is None else _build.ptr(scratch), O, N, F,
                g.cs, g.slice_len, g.state_words, g.smem,
                _build.stream_of(tgt))
    _build.launched(NAME, rc)
    return reached, dist
