"""``rank_inbound``: ingress counts and the K best inbound edges per target.

Replaces the reference engine's ``round/verb2_consume`` block
(gossip_sim_tpu/engine/core.py:663-741; twin engine/sparse.py:98-149).
The CUDA kernel is ``csrc/rank_inbound.cu``, one launch per call (a thread
block cluster per origin); :func:`rank_inbound_plain` is the same function
in plain PyTorch, used for CPU tensors and as the spec.

Sweep lanes (engine/lanes.py) run as more origin rows: the ranking
takes no knob, so a batch of K lanes is K times the rows, unchanged.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

NAME = "rank_inbound"
MAX_WARPS = 32         # csrc/rank_inbound.cu kMaxThreads / 32
MAX_CLUSTER = 8        # the portable thread block cluster size
MISC_WORDS = 64        # csrc/rank_inbound.cu kMiscWords


class Geometry(NamedTuple):
    cs: int             # CTAs per origin (thread block cluster size)
    slice_len: int      # targets per CTA
    threads: int        # threads per CTA: four targets a warp in the select
    state_words: int    # 32-bit words of state per CTA (counts, starts)
    csr_cap: int        # CSR keys a CTA keeps in shared memory
    smem: int           # dynamic shared memory per CTA
    scratch_words: int  # device-memory state of all CTAs; 0 = in smem


def warp_buffer_words(k: int) -> int:
    """Shared-memory words of one warp's selection: two buffers of the K
    best keys and 64 more, for a chunk of 32 candidates or the ranked keys
    of the warp's (or its four quarters') rows."""
    return 2 * k + 64


def shape(o: int, n: int, k: int, cs: int, smem_limit: int) -> Geometry:
    """The launch of ``o`` origins over ``n`` nodes at inbound width ``k``
    with ``cs`` CTAs per origin, on a card of ``smem_limit`` bytes of
    opt-in shared memory per block.  Each warp's selection buffers live in
    shared memory, with up to 32 warps per CTA; the counts and segment
    starts of a CTA's targets follow them where they fit, else they go to
    a device-memory scratch buffer (any ``n``); the rest of the shared
    memory holds up to ``csr_cap`` of the CTA's CSR keys (a slice with
    more keeps them in device memory).  Raises only where one warp's
    buffers do not fit."""
    if o < 1 or n < 1 or k < 1:
        raise ValueError(f"{NAME}: needs O, N and k_inbound >= 1, got "
                         f"{o}, {n} and {k}")
    per_warp = 4 * warp_buffer_words(k)
    warps = min(MAX_WARPS, (smem_limit - 4 * MISC_WORDS) // per_warp)
    if warps < 1:
        raise ValueError(
            f"{NAME}: k_inbound={k} needs {4 * MISC_WORDS + per_warp} bytes "
            f"of shared memory for one warp's selection, more than the "
            f"{smem_limit} bytes of one block")
    slen = -(-n // cs)
    words = 2 * slen
    used, scratch = 4 * MISC_WORDS + warps * per_warp, 0
    if used + 4 * words <= smem_limit:
        used += 4 * words
    else:
        scratch = o * cs * words
    cap = (smem_limit - used) // 4
    return Geometry(cs, slen, 32 * warps, words, cap, used + 4 * cap,
                    scratch)


def launch_geometry(o: int, n: int, k: int, sms: int, smem_limit: int,
                    max_clusters=None) -> Geometry:
    """:func:`shape` with the most CTAs per origin (up to 8, at most
    ``sms`` CTAs in all) whose clusters the card holds at once
    (``max_clusters(geometry)``, read from the device; None = any), else
    one CTA per origin.  Every CTA reads all edges of its origin and
    selects for its slice of the targets, so more CTAs per origin split
    the select over more SMs."""
    for cs in range(min(MAX_CLUSTER, sms // o), 1, -1):
        g = shape(o, n, k, cs, smem_limit)
        if max_clusters is None or o <= max_clusters(g):
            return g
    return shape(o, n, k, 1, smem_limit)


def max_k_inbound(smem_limit: int) -> int:
    """The widest inbound ranking the kernel takes on a card of
    ``smem_limit`` bytes of opt-in shared memory per block."""
    return ((smem_limit - 4 * MISC_WORDS) // 4 - 64) // 2


def rank_inbound_plain(tgt: torch.Tensor, delivered: torch.Tensor,
                       hop1: torch.Tensor, pb: int, k: int):
    """Plain PyTorch inbound ranking.

    ``tgt`` [O, N, F] i32 targets, ``delivered`` [O, N, F] bool, ``hop1``
    [O, N] i32 the delivery hop of each source.  Returns (inb [O, N, K] i32
    inbound sources ranked by ``hop1 << pb | src`` ascending, N = empty;
    ingress [O, N] i32; dropped [O] i32 = sum of max(ingress - K, 0)).

    One sort of the packed (target, key) pairs ranks every delivered edge
    within its target (rank = position - first position of the target's
    run); kept edges land in their unique slot ``target * K + rank``."""
    O, N, F = tgt.shape
    dev = tgt.device
    nf = N * F
    kd = torch.where(delivered, tgt, N).reshape(O, nf).long()
    iota_n = torch.arange(N, device=dev, dtype=torch.int64)
    kv = (hop1.long() << pb) | iota_n[None, :]
    kv = kv[:, :, None].expand(O, N, F).reshape(O, nf)
    ingress = torch.zeros((O, N + 1), dtype=torch.int32, device=dev)
    ingress.scatter_add_(1, kd, torch.ones_like(kd, dtype=torch.int32))
    ingress = ingress[:, :N].contiguous()
    dropped = torch.clamp(ingress - k, min=0).sum(-1, dtype=torch.int32)

    sk = torch.sort((kd << 32) | kv, dim=1).values
    st, skv = sk >> 32, sk & 0xFFFFFFFF
    rank = torch.arange(nf, device=dev) - torch.searchsorted(st, st)
    keep = (st < N) & (rank < k)
    buf = torch.full((O, N * k + 1), -1, dtype=torch.int64, device=dev)
    buf.scatter_(1, torch.where(keep, st * k + rank, N * k), skv)
    buf = buf[:, :N * k]
    inb = torch.where(buf >= 0, buf & ((1 << pb) - 1), N)
    return inb.to(torch.int32).reshape(O, N, k), ingress, dropped


def _lib():
    fn = _build.library(NAME).rank_inbound_launch
    if fn.argtypes is None:
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 8 + [ci] * 8 + [cl, ci, ci, vp]
        fn.restype = ci
    return fn


_GEOMETRY: dict = {}


def rank_inbound(tgt: torch.Tensor, delivered: torch.Tensor,
                 hop1: torch.Tensor, pb: int, k: int):
    """Inbound ranking: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  Returns (inb, ingress, dropped) as
    :func:`rank_inbound_plain` does.

    The kernel builds each key ``hop1 << pb | src`` in int32 (the plain
    version in int64), so every key must fit in int32: with ``hop1`` at
    most the engine's ``hist_bins - 1``, ``hist_bins << pb`` below 2^31
    guarantees it.  The wrapper gets no bin count; ``round_step`` refuses
    a shape past that bound before any launch, as the reference does."""
    if not tgt.is_cuda:
        return rank_inbound_plain(tgt, delivered, hop1, pb, k)
    O, N, F = tgt.shape
    dev = tgt.device
    _build.check(tgt, "tgt", torch.int32, (O, N, F), dev)
    _build.check(delivered, "delivered", torch.bool, (O, N, F), dev)
    _build.check(hop1, "hop1", torch.int32, (O, N), dev)
    if N * F >= 1 << 30:
        raise ValueError(f"{NAME}: N*F = {N * F} edges per origin; the "
                         f"kernel takes fewer than 2^30")
    key = (O, N, k, dev)
    g = _GEOMETRY.get(key)
    if g is None:
        g = _GEOMETRY[key] = launch_geometry(
            O, N, k, _build.sm_count(dev), _build.smem_optin(dev),
            max_clusters)
    return _launch(tgt, delivered, hop1, pb, k, g)


def max_clusters(g: Geometry) -> int:
    """Clusters of launch ``g`` the current CUDA device holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    fn = _build.library(NAME).rank_inbound_max_clusters
    if fn.argtypes is None:
        ci = ctypes.c_int
        fn.argtypes = [ci, ci, ci, ci, ctypes.POINTER(ci)]
        fn.restype = ci
    out = ctypes.c_int(0)
    rc = fn(g.cs, g.threads, g.smem, int(g.scratch_words == 0),
            ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"{NAME}: cudaOccupancyMaxActiveClusters failed "
                           f"with error {rc}")
    return out.value


def _launch(tgt: torch.Tensor, delivered: torch.Tensor, hop1: torch.Tensor,
            pb: int, k: int, g: Geometry):
    O, N, F = tgt.shape
    dev = tgt.device
    ingress = torch.empty((O, N), dtype=torch.int32, device=dev)
    inb = torch.empty((O, N, k), dtype=torch.int32, device=dev)
    dropped = torch.empty((O,), dtype=torch.int32, device=dev)
    csr = torch.empty(O * N * F, dtype=torch.int32, device=dev)
    scratch = (torch.empty(g.scratch_words, dtype=torch.int32, device=dev)
               if g.scratch_words else None)
    rc = _lib()(_build.ptr(tgt), _build.ptr(delivered), _build.ptr(hop1),
                _build.ptr(ingress), _build.ptr(inb), _build.ptr(dropped),
                _build.ptr(csr),
                None if scratch is None else _build.ptr(scratch),
                O, N, F, k, pb, g.cs, g.slice_len, g.threads, g.state_words,
                g.csr_cap, g.smem, _build.stream_of(tgt))
    _build.launched(NAME, rc)
    return inb, ingress, dropped
