"""``bfs_relax``: BFS frontier relaxation of one round's push edges.

Replaces the reference engine's ``round/bfs_propagate`` block
(gossip_sim_tpu/engine/core.py:620-661; twin engine/sparse.py:64-95).
The CUDA kernel is ``csrc/bfs_relax.cu``; :func:`bfs_relax_plain` is the
same function in plain PyTorch, used for CPU tensors and as the spec.

Sweep lanes (engine/lanes.py) run as more origin rows: the relaxation
takes no knob, so a batch of K lanes is K times the rows, unchanged.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

NAME = "bfs_relax"
INF = 1 << 20
MAX_CLUSTER = 8        # the portable thread block cluster size
THREADS = 1024         # csrc/bfs_relax.cu kThreads
MAX_CHUNK = 512        # csrc/bfs_relax.cu kMaxChunk: frontier words a pass
TOT_WORDS = 32         # csrc/bfs_relax.cu kTotWords


class Geometry(NamedTuple):
    cs: int            # CTAs per origin (thread block cluster size)
    slice_len: int     # nodes per CTA, a whole number of 32-bit words
    chunk: int         # frontier words compacted per pass (list: 32 x that)
    state_words: int   # 32-bit words of state per CTA
    smem: int          # dynamic shared memory per CTA (list, then state)
    scratch_words: int  # device-memory state of all CTAs; 0 = in smem


def slice_len(n: int, cs: int) -> int:
    """Nodes per CTA: ceil(n / cs) rounded up to a whole 32-bit word, so
    no bitmap word is shared by two CTAs."""
    return -(-(-(-n // cs)) // 32) * 32


def slice_bounds(n: int, cs: int) -> list[tuple[int, int]]:
    """The node range [lo, hi) each CTA rank of a cluster owns (empty for a
    rank past N)."""
    s = slice_len(n, cs)
    return [(min(n, r * s), min(n, (r + 1) * s)) for r in range(cs)]


def chunk_words(n: int, cs: int) -> int:
    """Frontier words a CTA compacts per pass: its slice's words, up to
    ``MAX_CHUNK``, a whole number of warps.  The list holds 32 nodes a
    word, so one pass always fits it."""
    return min(MAX_CHUNK, -(-(slice_len(n, cs) // 32) // 32) * 32)


def list_bytes(n: int, cs: int) -> int:
    """Shared memory of a CTA's frontier list and its prefix sum's warp
    totals (always in shared memory)."""
    return 4 * (32 * chunk_words(n, cs) + TOT_WORDS)


def state_words(n: int, cs: int) -> int:
    """32-bit words of state per CTA: reached and frontier bitmaps of its
    slice, two "sent" bitmaps over all ``cs`` slices, two live flags."""
    return (2 + 2 * cs) * (slice_len(n, cs) // 32) + 2


def one_per_sm(smem: int, cs: int, smem_limit: int) -> int:
    """The shared memory a CTA asks for: a cluster's CTA (``cs`` > 1) asks
    for more than half of an SM's (``smem_limit`` // 2 + 1 bytes at
    least), so that no two CTAs share an SM and each hop's barrier waits
    on no SM that serves two CTAs; one CTA per origin asks for what it
    uses."""
    return max(smem, smem_limit // 2 + 1) if cs > 1 else smem


def shape(o: int, n: int, cs: int, smem_limit: int) -> Geometry:
    """The launch of ``o`` origins over ``n`` nodes with ``cs`` CTAs per
    origin, on a card of ``smem_limit`` bytes of opt-in shared memory per
    block: the state of a CTA lives in shared memory after its frontier
    list where both fit, else in a device-memory scratch buffer (any
    ``n``); see :func:`one_per_sm` for the bytes asked."""
    if o < 1 or n < 1 or cs < 1:
        raise ValueError(f"{NAME}: needs O, N and the cluster size >= 1, "
                         f"got {o}, {n} and {cs}")
    lb, words = list_bytes(n, cs), state_words(n, cs)
    if lb + 4 * words <= smem_limit:
        return Geometry(cs, slice_len(n, cs), chunk_words(n, cs), words,
                        one_per_sm(lb + 4 * words, cs, smem_limit), 0)
    return Geometry(cs, slice_len(n, cs), chunk_words(n, cs), words,
                    one_per_sm(lb, cs, smem_limit), o * cs * words)


def launch_geometry(o: int, n: int, sms: int, smem_limit: int,
                    max_clusters=None) -> Geometry:
    """:func:`shape` with the most CTAs per origin (up to 8, at most
    ``sms`` CTAs in all, any count, not only powers of two) whose clusters
    the card holds at once (``max_clusters(geometry)``, read from the
    device; None = any), else one CTA per origin.  More CTAs per origin
    split each hop's frontier loads over more SMs."""
    for cs in range(min(MAX_CLUSTER, sms // o), 1, -1):
        g = shape(o, n, cs, smem_limit)
        if max_clusters is None or o <= max_clusters(g):
            return g
    return shape(o, n, 1, smem_limit)


def max_clusters(g: Geometry) -> int:
    """Clusters of launch ``g`` the current CUDA device holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    fn = _build.library(NAME).bfs_relax_max_clusters
    if fn.argtypes is None:
        ci = ctypes.c_int
        fn.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
        fn.restype = ci
    out = ctypes.c_int(0)
    rc = fn(g.cs, g.smem, int(g.scratch_words == 0), ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"{NAME}: cudaOccupancyMaxActiveClusters failed "
                           f"with error {rc}")
    return out.value


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


def _lib(floor: bool = False):
    fn = (_build.library("bfs_relax_floor").bfs_relax_floor_launch if floor
          else _build.library(NAME).bfs_relax_launch)
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 5 + [ci] * (9 if floor else 8) + [vp]
        fn.restype = ci
    return fn


_GEOMETRY: dict = {}


def geometry_for(o: int, n: int, dev: torch.device) -> Geometry:
    """:func:`launch_geometry` of ``o`` origins over ``n`` nodes on ``dev``
    (read once per shape: its occupancy queries would cost every call host
    time, and the round at N=10,000 is host-bound)."""
    key = (o, n, dev)
    g = _GEOMETRY.get(key)
    if g is None:
        g = _GEOMETRY[key] = launch_geometry(
            o, n, _build.sm_count(dev), _build.smem_optin(dev), max_clusters)
    return g


def bfs_relax(tgt: torch.Tensor, origins: torch.Tensor):
    """BFS over the push edges: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns (reached [O, N] bool, dist [O, N] i32)."""
    if not tgt.is_cuda:
        return bfs_relax_plain(tgt, origins)
    O, N, F = tgt.shape
    dev = tgt.device
    _build.check(tgt, "tgt", torch.int32, (O, N, F), dev)
    _build.check(origins, "origins", torch.int32, (O,), dev)
    return _launch(tgt, origins, geometry_for(O, N, dev))


def _latency_floor(tgt: torch.Tensor, origins: torch.Tensor, hops: int):
    """A measurement aid, not on the engine's path: the kernel's geometry
    for ``tgt``'s shape run for ``hops`` hops with an empty frontier (the
    clear, each hop's compaction pass, cluster barrier and DSMEM pass, the
    final writes; no target is read), from a library of its own
    (csrc/bfs_relax_floor.cu).  Not counted in ``LAUNCHES``.  Returns
    (reached, dist): nothing reached."""
    O, N, _ = tgt.shape
    return _launch(tgt, origins, geometry_for(O, N, tgt.device),
                   floor_hops=hops)


def _launch(tgt: torch.Tensor, origins: torch.Tensor, g: Geometry,
            floor_hops: int | None = None):
    O, N, F = tgt.shape
    dev = tgt.device
    reached = torch.empty((O, N), dtype=torch.bool, device=dev)
    dist = torch.empty((O, N), dtype=torch.int32, device=dev)
    scratch = (torch.empty(g.scratch_words, dtype=torch.int32, device=dev)
               if g.scratch_words else None)
    args = [_build.ptr(tgt), _build.ptr(origins), _build.ptr(reached),
            _build.ptr(dist),
            None if scratch is None else _build.ptr(scratch), O, N, F,
            g.cs, g.slice_len, g.state_words, g.chunk, g.smem]
    if floor_hops is not None:
        rc = _lib(True)(*args, int(floor_hops), _build.stream_of(tgt))
        if rc != 0:
            raise RuntimeError(f"{NAME}: latency floor launch failed with "
                               f"error {rc}")
        return reached, dist
    rc = _lib()(*args, _build.stream_of(tgt))
    _build.launched(NAME, rc)
    return reached, dist
