"""``bfs_relax``: BFS frontier relaxation of one round's push edges.

Replaces the reference engine's ``round/bfs_propagate`` block
(gossip_sim_tpu/engine/core.py:620-661; twin engine/sparse.py:64-95).
The CUDA kernel is ``csrc/bfs_relax.cu``; :func:`bfs_relax_plain` is the
same function in plain PyTorch, used for CPU tensors and as the spec.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "bfs_relax"
INF = 1 << 20


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
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
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
    reached = torch.empty((O, N), dtype=torch.bool, device=dev)
    dist = torch.empty((O, N), dtype=torch.int32, device=dev)
    scratch = torch.empty((2, O, N), dtype=torch.uint8, device=dev)
    rc = _lib()(_build.ptr(tgt), _build.ptr(origins), _build.ptr(reached),
                _build.ptr(dist), _build.ptr(scratch), O, N, F,
                _build.stream_of(tgt))
    _build.launched(NAME, rc)
    return reached, dist
