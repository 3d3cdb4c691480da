"""``pull_exchange``: the pull (anti-entropy) phase of one round.

Replaces the reference engine's ``round/pull`` block
(gossip_sim_tpu/engine/core.py:1012-1180; pull.py) and the delivery view
the round stats build from it (core.py:1182-1190).  The CUDA kernel is
``csrc/pull_exchange.cu``, one launch per call (a thread block cluster per
origin, its CTAs owning slices of the nodes); :func:`launch_geometry` is
the launch's shape and its only owner; :func:`pull_exchange_plain` is the
same function in plain PyTorch, used for CPU tensors and as the spec.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..faults import edge_u32_t, node_u32_t
from . import _build

NAME = "pull_exchange"
INF = 1 << 20          # engine/core.py INF: no pull delivery
#: The [O, 6] ``counts`` columns, under their round-row names.
COUNT_NAMES = ("pull_requests", "pull_responses", "pull_misses",
               "pull_dropped", "pull_suppressed", "pull_rescued")
MAX_CLUSTER = 16       # the H100's non-portable thread block cluster size
MAX_THREADS = 1024     # csrc/pull_exchange.cu kMaxThreads
MISC_WORDS = 128       # csrc/pull_exchange.cu kMiscWords: class tables, sums


class PullOut(NamedTuple):
    pull_hop: torch.Tensor  # [O, N] i32 best pull hop, INF = none
    egress: torch.Tensor    # [O, N] i32 requests arrived + responses sent
    ingress: torch.Tensor   # [O, N] i32 requests received + transfers
    counts: torch.Tensor    # [O, 6] i32, columns COUNT_NAMES
    reached_all: torch.Tensor  # [O, N] bool reached by push or by pull
    dist_all: torch.Tensor     # [O, N] i32 dist where reached, else pull_hop


class Geometry(NamedTuple):
    cs: int             # CTAs per origin (thread block cluster size)
    slice_len: int      # nodes per CTA, as requesters and as peers
    threads: int        # threads per CTA: one per node of the slice
    bitmap_words: int   # failed, reached and side bits of all N nodes
    state_words: int    # words a node of the slice: 3, 5 with the cap on
    draw_words: int     # kept draws of the slice (fanout a node); 0 = none
    smem: int           # dynamic shared memory per CTA, bytes
    scratch_words: int  # device-memory per-peer words; 0 = in smem


def cluster_size(o: int, sms: int) -> int:
    """CTAs per origin that fill the card in one wave: the largest power
    of two <= ``MAX_CLUSTER`` with ``o * cs <= sms``, and at least 1."""
    cs = MAX_CLUSTER
    while cs > 1 and o * cs > sms:
        cs //= 2
    return cs


def shape(o: int, n: int, fanout: int, cap: int, cs: int, *,
          keep: bool = True, in_smem: bool = True) -> Geometry:
    """The launch of ``o`` origins over ``n`` nodes with ``cs`` CTAs per
    origin.  Each CTA's shared memory holds ``MISC_WORDS`` words (class
    tables, sums) and, with the state in shared memory, the bitmaps of
    the origin's failed and reached bytes and of the sides (3 ceil(n / 32)
    words), three words a node of its slice (requests in and responses
    out as a peer, its own arrivals and transfers as a requester), five
    with the cap on (the cap's two keys) and, with the cap on and
    ``keep``, the draws of its slice's live slots (``fanout`` words a
    node).  With the cap off one pass draws each request once and keeps
    nothing.  Without ``in_smem`` the per-peer words (2 a node, 4 with the
    cap on) go to a device-memory scratch buffer and nothing else is
    staged or kept."""
    slen = -(-n // cs)
    per_peer = 4 if cap > 0 else 2
    bitmap = 3 * -(-n // 32) if in_smem else 0
    state = (per_peer + 1) * slen if in_smem else 0
    draws = fanout * slen if keep and in_smem and cap > 0 else 0
    threads = min(MAX_THREADS, -(-slen // 32) * 32)
    return Geometry(cs, slen, threads, bitmap, state, draws,
                    4 * (MISC_WORDS + bitmap + state + draws),
                    0 if in_smem else o * per_peer * n)


def launch_geometry(o: int, n: int, fanout: int, cap: int, sms: int,
                    smem_limit: int, max_clusters=None) -> Geometry:
    """The launch on a card of ``sms`` SMs and ``smem_limit`` bytes of
    opt-in shared memory per block; ``max_clusters(geometry)`` is how many
    clusters of a launch the card holds at once (None = any).

    In order: the draws kept (with the cap on), else drawn again where
    used; for each, the largest cluster of at most :func:`cluster_size`
    CTAs whose shape fits and whose ``o`` clusters the card holds at once,
    else the smallest cluster whose shape fits (a larger one than the
    card fills in one wave, where a smaller one does not fit); past every
    cluster's shared memory, the per-peer words in device memory.  Raises,
    naming the bytes, where not even that fits."""
    cs0 = cluster_size(o, sms)
    holds = lambda g, k: max_clusters is None or max_clusters(g) >= k
    sizes = [1 << k for k in range(MAX_CLUSTER.bit_length())]
    for keep in ((True, False) if cap > 0 and fanout > 0 else (True,)):
        fit = [g for g in (shape(o, n, fanout, cap, cs, keep=keep)
                           for cs in sizes) if g.smem <= smem_limit]
        for g in [g for g in fit if g.cs <= cs0][::-1] or fit[:1]:
            if holds(g, o):
                return g
        for g in fit:
            if holds(g, 1):
                return g
    for cs in sizes[:sizes.index(cs0) + 1][::-1]:
        g = shape(o, n, fanout, cap, cs, in_smem=False)
        if g.smem > smem_limit:
            raise ValueError(
                f"{NAME}: a CTA needs {g.smem} bytes of shared memory for "
                f"its class tables and sums alone, more than the "
                f"{smem_limit} bytes of one block")
        if holds(g, 1):
            return g
    raise ValueError(f"{NAME}: the card holds no cluster of {o} origins' "
                     f"launch at N={n}")


def pull_peers_plain(n: int, slots: int, basis_cls: int, basis_mem: int,
                     perm: torch.Tensor, class_start: torch.Tensor,
                     class_count: torch.Tensor,
                     cdf: torch.Tensor) -> torch.Tensor:
    """The [N, slots] pull peer table (pull.py ``sample_pull_peer`` per
    entry): the class from the top-entry CDF, then a uniform member of it,
    both from ``(edge_u32(basis, node, slot) >> 8) * 2^-24``."""
    dev = perm.device
    nodes = torch.arange(n, device=dev)[:, None]
    slot = torch.arange(slots, device=dev)[None, :]
    u01 = lambda b: ((edge_u32_t(b, nodes, slot) >> 8).to(torch.float32)
                     * 2.0 ** -24)
    u_cls, u_mem = u01(basis_cls), u01(basis_mem)
    cls = (u_cls[..., None] >= cdf[:-1]).sum(-1)
    start, count = class_start[cls], class_count[cls]
    pos = start + torch.floor(u_mem * count.to(torch.float32)).to(torch.int32)
    pos = torch.minimum(pos, start + (count - 1).clamp(min=0))
    return perm[pos.clamp(max=n - 1).long()]


def pull_exchange_plain(reached: torch.Tensor, dist: torch.Tensor,
                        failed: torch.Tensor, side: torch.Tensor,
                        perm: torch.Tensor, class_start: torch.Tensor,
                        class_count: torch.Tensor, cdf: torch.Tensor,
                        adaptive_on, *, fanout: int, slots: int,
                        pull_on: bool, bases: tuple, bloom_threshold: int,
                        cap: int, partition=None, loss=None) -> PullOut:
    """One pull exchange against this round's push outcome.

    ``reached``/``failed`` [O, N] bool and ``dist`` [O, N] i32 (the push
    BFS), ``side`` [N + 1] i32 stake-bipartition sides, the sampler's
    ``perm`` and class tables with its top-entry ``cdf`` [25] f32,
    ``adaptive_on`` [O] bool (None outside the adaptive mode).  ``fanout``
    live slots of ``slots``; ``pull_on`` whether this is a pull round;
    ``bases`` the round's (class, member, bloom) hash bases;
    ``bloom_threshold`` and ``cap`` the bloom false-positive threshold and
    the request cap (<= 0 off); ``partition`` None without a partition
    gate, else whether its window is on; ``loss`` None without packet
    loss, else the round's (basis, threshold).  Returns :class:`PullOut`,
    whose ``reached_all`` and ``dist_all`` are the delivery view of the
    round stats: push BFS plus the pull rescues.
    """
    O, N = reached.shape
    dev = reached.device
    i32 = torch.int32
    b_cls, b_mem, b_fp = bases
    peer_ns = pull_peers_plain(N, slots, b_cls, b_mem, perm, class_start,
                               class_count, cdf)                  # [N, PS]
    nodes = torch.arange(N, device=dev)
    slot_live = (torch.arange(slots, device=dev) < fanout) & bool(pull_on)
    sent = (((peer_ns != nodes[:, None]) & slot_live)[None]
            & ~failed[:, :, None])                                # [O, N, PS]
    if adaptive_on is not None:
        sent = sent & adaptive_on[:, None, None]
    peer_flat = peer_ns.long().reshape(1, -1).expand(O, -1)
    gather = lambda t: t.gather(1, peer_flat).reshape(O, N, slots)
    arrived = sent & ~gather(failed)
    zero_o = torch.zeros(O, dtype=i32, device=dev)
    n_sup = n_drop = zero_o
    if partition is not None:
        sup = arrived & bool(partition) & (side[:N][:, None]
                                           != side[peer_ns.long()])[None]
        arrived = arrived & ~sup
        n_sup = sup.sum((1, 2), dtype=i32)
    if loss is not None:
        basis, threshold = loss
        drop = arrived & (edge_u32_t(basis, nodes[:, None], peer_ns)
                          < threshold)[None]
        arrived = arrived & ~drop
        n_drop = drop.sum((1, 2), dtype=i32)

    # per peer: arrived requests, and each request's rank among them in
    # flat (requester, slot) order (a stable sort keyed by peer)
    arr_flat = arrived.reshape(O, -1)
    key = torch.where(arr_flat, peer_flat, N)
    skey, order = torch.sort(key, dim=1, stable=True)
    pos = torch.arange(key.shape[1], device=dev).expand(O, -1)
    run_start = torch.ones_like(skey, dtype=torch.bool)
    run_start[:, 1:] = skey[:, 1:] != skey[:, :-1]
    first = torch.cummax(torch.where(run_start, pos, 0), dim=1).values
    rank = torch.empty_like(pos).scatter_(1, order, pos - first)
    req_in = torch.zeros((O, N + 1), dtype=i32, device=dev).scatter_add_(
        1, key, arr_flat.to(i32))[:, :N]
    served = arrived
    if cap > 0:
        served = arrived & (rank.reshape(O, N, slots) < cap)

    fp = node_u32_t(b_fp, nodes) < bloom_threshold                # [N]
    transfer = (served & gather(reached) & ~reached[:, :, None]
                & ~fp[None, :, None])
    resp_out = torch.zeros((O, N + 1), dtype=i32, device=dev).scatter_add_(
        1, torch.where(transfer.reshape(O, -1), peer_flat, N),
        torch.ones_like(key, dtype=i32))[:, :N]
    hop = torch.where(transfer, gather(torch.where(reached, dist, 0)) + 1,
                      INF)
    pull_hop = hop.amin(-1).to(i32)
    n_arr = arrived.sum((1, 2), dtype=i32)
    n_resp = transfer.sum((1, 2), dtype=i32)
    counts = torch.stack([n_arr, n_resp, n_arr - n_resp, n_drop, n_sup,
                          (pull_hop < INF).sum(-1, dtype=i32)], dim=1)
    return PullOut(
        pull_hop=pull_hop.contiguous(),
        egress=(arrived.sum(-1, dtype=i32) + resp_out).contiguous(),
        ingress=(req_in + transfer.sum(-1, dtype=i32)).contiguous(),
        counts=counts.contiguous(),
        reached_all=(reached | (pull_hop < INF)).contiguous(),
        dist_all=torch.where(reached, dist, pull_hop).contiguous())


def _lib():
    fn = _build.library(NAME).pull_exchange_launch
    if fn.argtypes is None:
        vp, ci, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        fn.argtypes = ([vp] * 16 + [ci] * 7 + [u32] * 4
                       + [ctypes.c_ulonglong] * 2 + [ci] * 5 + [vp])
        fn.restype = ci
    return fn


def max_clusters(g: Geometry) -> int:
    """Clusters of launch ``g`` the current CUDA device holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    fn = _build.library(NAME).pull_exchange_max_clusters
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


_GEOMETRY: dict = {}


def geometry_for(o: int, n: int, fanout: int, cap: int,
                 device: torch.device) -> Geometry:
    """:func:`launch_geometry` on ``device`` (read once per shape)."""
    key = (o, n, fanout, cap > 0, device)
    g = _GEOMETRY.get(key)
    if g is None:
        g = _GEOMETRY[key] = launch_geometry(
            o, n, fanout, cap, _build.sm_count(device),
            _build.smem_optin(device), max_clusters)
    return g


def pull_exchange(reached: torch.Tensor, dist: torch.Tensor,
                  failed: torch.Tensor, side: torch.Tensor,
                  perm: torch.Tensor, class_start: torch.Tensor,
                  class_count: torch.Tensor, cdf: torch.Tensor, adaptive_on,
                  *, fanout: int, slots: int, pull_on: bool, bases: tuple,
                  bloom_threshold: int, cap: int, partition=None,
                  loss=None) -> PullOut:
    """The pull phase: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  Arguments and result as :func:`pull_exchange_plain`;
    the kernel takes ``side`` values of 0 and 1 (the stake bipartition).
    """
    if not reached.is_cuda:
        return pull_exchange_plain(
            reached, dist, failed, side, perm, class_start, class_count, cdf,
            adaptive_on, fanout=fanout, slots=slots, pull_on=pull_on,
            bases=bases, bloom_threshold=bloom_threshold, cap=cap,
            partition=partition, loss=loss)
    return _launch(reached, dist, failed, side, perm, class_start,
                   class_count, cdf, adaptive_on, None, fanout=fanout,
                   slots=slots, pull_on=pull_on, bases=bases,
                   bloom_threshold=bloom_threshold, cap=cap,
                   partition=partition, loss=loss)


def _launch(reached, dist, failed, side, perm, class_start, class_count, cdf,
            adaptive_on, g, *, fanout, slots, pull_on, bases,
            bloom_threshold, cap, partition, loss) -> PullOut:
    """Check the inputs and launch the kernel in geometry ``g`` (None:
    the device's :func:`launch_geometry`)."""
    O, N = reached.shape
    dev = reached.device
    _build.check(reached, "reached", torch.bool, (O, N), dev)
    _build.check(dist, "dist", torch.int32, (O, N), dev)
    _build.check(failed, "failed", torch.bool, (O, N), dev)
    _build.check(side, "side", torch.int32, (N + 1,), dev)
    _build.check(perm, "perm", torch.int32, (N,), dev)
    _build.check(class_start, "class_start", torch.int32, (25,), dev)
    _build.check(class_count, "class_count", torch.int32, (25,), dev)
    _build.check(cdf, "cdf", torch.float32, (25,), dev)
    if adaptive_on is not None:
        _build.check(adaptive_on, "adaptive_on", torch.bool, (O,), dev)
    if not 0 <= fanout <= min(slots, 0xFFFF):
        raise ValueError(f"{NAME}: fanout {fanout} outside [0, "
                         f"{min(slots, 0xFFFF)}]")
    if N >= 1 << 30 or N * max(fanout, 1) >= (1 << 31) - 1:
        raise ValueError(f"{NAME}: request keys node * fanout + slot pass "
                         f"int32 at N={N}, fanout={fanout}")
    b_loss, loss_thr = (0, 0) if loss is None else loss
    for what, thr in (("bloom", bloom_threshold), ("loss", loss_thr)):
        if not 0 <= thr <= 1 << 32:
            raise ValueError(f"{NAME}: {what} threshold {thr} outside "
                             f"[0, 2^32]")
    plane = lambda dt: torch.empty((O, N), dtype=dt, device=dev)
    out = PullOut(plane(torch.int32), plane(torch.int32), plane(torch.int32),
                  torch.empty((O, len(COUNT_NAMES)), dtype=torch.int32,
                              device=dev),
                  plane(torch.bool), plane(torch.int32))
    if O == 0 or N == 0:
        return out
    if g is None:
        g = geometry_for(O, N, fanout, cap, dev)
    scratch = (torch.empty(g.scratch_words, dtype=torch.int32, device=dev)
               if g.scratch_words else None)
    p = _build.ptr
    b_cls, b_mem, b_fp = bases
    rc = _lib()(p(reached), p(dist), p(failed), p(side), p(perm),
                p(class_start), p(class_count), p(cdf),
                None if adaptive_on is None else p(adaptive_on),
                p(out.pull_hop), p(out.egress), p(out.ingress),
                p(out.reached_all), p(out.dist_all), p(out.counts),
                None if scratch is None else p(scratch),
                O, N, fanout, int(bool(pull_on)), cap, int(bool(partition)),
                int(loss is not None), b_cls & 0xFFFFFFFF,
                b_mem & 0xFFFFFFFF, b_fp & 0xFFFFFFFF, b_loss & 0xFFFFFFFF,
                bloom_threshold, loss_thr, g.cs, g.slice_len, g.threads,
                int(g.draw_words > 0), g.smem, _build.stream_of(reached))
    _build.launched(NAME, rc)
    return out
