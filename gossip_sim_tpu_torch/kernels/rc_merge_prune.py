"""``rc_merge_prune``: received-cache merge fused with the prune decision.

Replaces the reference engine's ``round/rc_merge`` and
``round/verb3_prune_decide`` blocks plus the fired-row cache reset
(gossip_sim_tpu/engine/core.py:743-862, 943-948), and the traffic round's
``traffic/rc_merge`` and ``traffic/prune_decide`` with the value axis in
place of the origin axis (gossip_sim_tpu/engine/traffic.py:621-709; a
row fires only while its value slot is live).  The CUDA kernel is
``csrc/rc_merge_prune.cu``; :func:`rc_merge_prune_plain` is the same
function in plain PyTorch, used for CPU tensors and as the spec.

Called with ``rc_shi=None, rc_slo=None`` it is the sparse layout's variant
(the reference's sparse arms, gossip_sim_tpu/engine/core.py:783-816,
835-842): the member stakes are ``shi[rc_src]`` and ``slo[rc_src]``, the
stake planes come back zero-width ([O, N, 0]), and no ``live`` mask is
taken.  On the card it is the kernel source's sparse instantiation
(``rc_merge_prune_sparse_kernel``), counted as ``rc_merge_prune_sparse``.

Sweep lanes (engine/lanes.py) run as more origin rows: ``min_ingress_nodes``
and ``prune_stake_threshold`` may be per lane (``kernels/_lanes.py``), in
both layouts; traffic lanes (engine/traffic.py, with ``live``) run as
K x V value rows, lane k's knobs for rows ``[k V, (k + 1) V)``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build, _lanes

NAME = "rc_merge_prune"
SPARSE_NAME = "rc_merge_prune_sparse"  # launch count of the sparse variant
BIG = 0x7FFFFFFF
I32_MAX = 0x7FFFFFFF
ROWS_PER_BLOCK = 8         # one warp per row
#: One lane's knobs in the launch's struct (csrc/rc_merge_prune.cu
#: MergeLane).
LANE_DTYPE = np.dtype([("threshold", "<f8"), ("min_ingress", "<i4"),
                       ("pad", "<i4")])


class Geometry(NamedTuple):
    rows_per_block: int  # rows (warps) per block
    key_slots: int       # prune keys per row: C padded to a power of two
    row_bytes: int       # shared memory per row
    smem: int            # shared memory per block


def key_slots(c: int) -> int:
    """The prune keys of a row: ``c`` padded to a power of two (the
    bitonic sort's width)."""
    return 1 << max(c - 1, 0).bit_length()


def row_smem_bytes(c: int, k: int, sparse: bool = False) -> int:
    """Shared memory the kernel stages for one row of ``c`` cache slots and
    ``k`` inbound ranks: the 16-byte prune keys padded to a power of two,
    the member planes (four; the sparse variant's two), and three words
    per inserted inbound source, rounded up to 16 bytes."""
    planes = 2 if sparse else 4
    return -(-(16 * key_slots(c) + 4 * planes * c + 12 * k) // 16) * 16


def launch_geometry(c: int, k: int, smem_limit: int,
                    sparse: bool = False) -> Geometry:
    """The launch for rows of ``c`` cache slots and ``k`` inbound ranks on
    a card of ``smem_limit`` bytes of opt-in shared memory per block (of
    the sparse variant with ``sparse``); raises where one row does not
    fit."""
    if c < 1 or k < 1:
        raise ValueError(f"{NAME}: needs rc_slots >= 1 and k_inbound >= 1, "
                         f"got {c} and {k}")
    row = row_smem_bytes(c, k, sparse)
    if row > smem_limit:
        raise ValueError(
            f"{NAME}: a row of rc_slots={c} and k_inbound={k} needs {row} "
            f"bytes of shared memory, more than the {smem_limit} bytes of "
            f"one block")
    rows = min(ROWS_PER_BLOCK, smem_limit // row)
    return Geometry(rows, key_slots(c), row, rows * row)


class MergePruneOut(NamedTuple):
    rc_src: torch.Tensor       # [O, N, C] i32 merged cache (empty if fired)
    rc_score: torch.Tensor     # [O, N, C] i32
    rc_shi: torch.Tensor       # [O, N, C] i32 ([O, N, 0] sparse)
    rc_slo: torch.Tensor       # [O, N, C] i32 ([O, N, 0] sparse)
    rc_upserts: torch.Tensor   # [O, N] i32 (0 if fired)
    src_sorted: torch.Tensor   # [O, N, C] i32 fired: members in prune order;
    #                            unfired: the merged members in source order
    #                            (prune_apply reads it at pruned slots only)
    pruned_slot: torch.Tensor  # [O, N, C] bool prune decision per slot
    n_pruned: torch.Tensor     # [O, N] i32
    rc_overflow: torch.Tensor  # [O] i32 sum of max(n_valid - C, 0)


def _lexsort(keys):
    """Permutation sorting the last axis lexicographically by ``keys``
    (most significant first): successive stable sorts from the least
    significant key."""
    perm = None
    for key in reversed(keys):
        k = key if perm is None else key.gather(-1, perm)
        order = torch.sort(k, dim=-1, stable=True).indices
        perm = order if perm is None else perm.gather(-1, order)
    return perm


def is_sparse(rc_shi, rc_slo, live) -> bool:
    """Whether a call is the sparse variant's (no stake planes); raises on
    one plane without the other, and on a ``live`` mask with neither."""
    if (rc_shi is None) != (rc_slo is None):
        raise ValueError(f"{NAME}: pass both stake planes (dense layout) or "
                         f"neither (sparse layout)")
    if rc_shi is None and live is not None:
        raise ValueError(f"{NAME}: the sparse variant takes no live mask "
                         f"(the sparse layout has no traffic round)")
    return rc_shi is None


def lane_knobs(rows: int, min_ingress_nodes, prune_stake_threshold):
    """(K, min_ingress_nodes [K] i32, prune_stake_threshold [K] f64) of a
    call over ``rows`` origin rows (push lanes: K x O origin rows; traffic
    lanes, with ``live``: K x V value rows)."""
    mi = _lanes.values(min_ingress_nodes, np.int32)
    thr = _lanes.values(prune_stake_threshold, np.float64)
    k = _lanes.count(rows, mi, thr)
    return k, mi, thr


def rc_merge_prune_plain(rc_src, rc_score, rc_shi, rc_slo, rc_upserts, inb,
                         shi, slo, stakes, origins, *, received_cap: int,
                         min_num_upserts: int, min_ingress_nodes: int,
                         prune_stake_threshold: float,
                         live=None) -> MergePruneOut:
    """Plain PyTorch merge + prune decide over every (origin, node) row.

    ``rc_*`` [O, N, C] the carried cache (src sorted ascending, N = empty),
    ``rc_upserts`` [O, N], ``inb`` [O, N, K] ranked inbound sources,
    ``shi``/``slo`` [N + 1] and ``stakes`` [N + 1] the cluster tables,
    ``origins`` [O] (at most N: N reads the tables' zero pad).  ``live``
    (None, or [O] bool) gates which origins' rows may fire: the traffic
    round's value slots.  With ``rc_shi`` and ``rc_slo`` None (the sparse
    layout) the stake planes are ``shi[rc_src]``/``slo[rc_src]`` and come
    back zero-width.  ``src_sorted`` is a fired row's members in prune
    order and an unfired row's merged members in source order (its new
    ``rc_src`` before any reset), N-padded: the kernel orders only the rows
    that fire.  ``min_ingress_nodes`` and ``prune_stake_threshold``
    may be per lane: K values, lane k's for rows ``[k O / K, (k + 1) O /
    K)``."""
    sparse = is_sparse(rc_shi, rc_slo, live)
    k, mi, thr = lane_knobs(rc_src.shape[0], min_ingress_nodes,
                            prune_stake_threshold)
    if _lanes.uniform(mi, thr):
        min_ingress_nodes, prune_stake_threshold = int(mi[0]), float(thr[0])
    else:
        per = rc_src.shape[0] // k
        row = lambda a: torch.as_tensor(np.repeat(_lanes.widen(a, k), per),
                                        device=rc_src.device)
        min_ingress_nodes = row(mi)[:, None, None]
        prune_stake_threshold = row(thr)[:, None]
    if sparse:
        src = rc_src.long()
        rc_shi, rc_slo = shi[src], slo[src]
    O, N, C = rc_src.shape
    K = inb.shape[-1]
    dev = rc_src.device
    r = torch.arange(K, device=dev)
    member = rc_src < N
    valid_inb = inb < N
    same = inb[..., :, None] == rc_src[..., None, :]             # [O,N,K,C]
    found = same.any(-1) & valid_inb
    # rank-order capacity scan: ranks < 2 insert unconditionally, the rest
    # honor received_cap (received_cache.rs:92-97)
    want = valid_inb & ~found
    ln = member.sum(-1, dtype=torch.int32)
    cols = []
    for j in range(K):
        a = want[..., j] & ((j < 2) | (ln < received_cap))
        cols.append(a)
        ln = ln + a.to(torch.int32)
    allowed = torch.stack(cols, -1)
    bump = found & (r < 2)
    score_c = rc_score + (same & bump[..., :, None]).any(-2).to(torch.int32)

    inb_l = inb.long()
    m_src = torch.cat([torch.where(member, rc_src, BIG),
                       torch.where(allowed, inb, BIG)], -1)
    m_sc = torch.cat([score_c, (allowed & (r < 2)).to(torch.int32)], -1)
    m_hi = torch.cat([rc_shi, shi[inb_l]], -1)
    m_lo = torch.cat([rc_slo, slo[inb_l]], -1)
    order = torch.sort(m_src, dim=-1, stable=True).indices[..., :C]
    s_src = m_src.gather(-1, order)
    n_valid = (m_src != BIG).sum(-1, dtype=torch.int32)
    rc_overflow = torch.clamp(n_valid - C, min=0).sum(-1, dtype=torch.int32)
    kept = s_src != BIG
    new_src = torch.where(kept, s_src, N)
    new_sc = torch.where(kept, m_sc.gather(-1, order), 0)
    new_hi = torch.where(kept, m_hi.gather(-1, order), 0)
    new_lo = torch.where(kept, m_lo.gather(-1, order), 0)
    ups = rc_upserts + valid_inb[..., 0].to(torch.int32)

    # prune decide (received_cache.rs:38-63,100-131)
    fired = ups >= min_num_upserts
    if live is not None:
        fired = fired & live[:, None]
    org = origins.long()
    min_stake = torch.minimum(stakes[:N][None, :], stakes[org][:, None])
    min_ingress_stake = (min_stake.to(torch.float64)
                         * prune_stake_threshold).to(torch.int64)
    memb = new_src < N
    perm = _lexsort([torch.where(memb, -new_sc, I32_MAX),
                     torch.where(memb, -new_hi, I32_MAX),
                     torch.where(memb, -new_lo, I32_MAX), new_src])
    src_sorted = new_src.gather(-1, perm)
    stake = ((new_hi.gather(-1, perm).long() << 31)
             | new_lo.gather(-1, perm).long())
    cum_excl = torch.cumsum(stake, -1) - stake
    posn = torch.arange(C, device=dev)
    pruned_slot = ((src_sorted < N) & (posn >= min_ingress_nodes)
                   & (cum_excl >= min_ingress_stake[..., None])
                   & (src_sorted != origins[:, None, None])
                   & fired[..., None])
    n_pruned = pruned_slot.sum(-1, dtype=torch.int32)

    # mem::take on fire: the whole entry resets (received_cache.rs:48-55)
    f3 = fired[..., None]
    if sparse:
        new_hi = new_lo = torch.zeros((O, N, 0), dtype=torch.int32,
                                      device=dev)
    return MergePruneOut(
        rc_src=torch.where(f3, N, new_src).to(torch.int32),
        rc_score=torch.where(f3, 0, new_sc).to(torch.int32),
        rc_shi=torch.where(f3, 0, new_hi).to(torch.int32),
        rc_slo=torch.where(f3, 0, new_lo).to(torch.int32),
        rc_upserts=torch.where(fired, 0, ups).to(torch.int32),
        src_sorted=torch.where(f3, src_sorted, new_src).to(torch.int32),
        pruned_slot=pruned_slot,
        n_pruned=n_pruned, rc_overflow=rc_overflow)


def _lib():
    lib = _build.library(NAME)
    fn = lib.rc_merge_prune_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([vp] * 20 + [ci] * 9 + [vp, ci, ci, ci, vp])
        fn.restype = ci
    return fn


def rc_merge_prune(rc_src, rc_score, rc_shi, rc_slo, rc_upserts, inb, shi,
                   slo, stakes, origins, *, received_cap: int,
                   min_num_upserts: int, min_ingress_nodes: int,
                   prune_stake_threshold: float,
                   live=None) -> MergePruneOut:
    """Merge + prune decide: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Without ``live`` (the push round) the kernel
    reads no mask and launches as before; with ``rc_shi`` and ``rc_slo``
    None it launches the sparse variant.

    The kernel takes each ``rc_src`` row as the engine keeps it (and as this
    function returns it): members sorted ascending and unique, then N; and
    the inbound sources of a row unique."""
    kw = dict(received_cap=received_cap, min_num_upserts=min_num_upserts,
              min_ingress_nodes=min_ingress_nodes,
              prune_stake_threshold=prune_stake_threshold, live=live)
    sparse = is_sparse(rc_shi, rc_slo, live)
    if not rc_src.is_cuda:
        return rc_merge_prune_plain(rc_src, rc_score, rc_shi, rc_slo,
                                    rc_upserts, inb, shi, slo, stakes,
                                    origins, **kw)
    O, N, C = rc_src.shape
    k, mi, thr = lane_knobs(O, min_ingress_nodes, prune_stake_threshold)
    lanes = _lanes.pack(k, LANE_DTYPE, threshold=thr, min_ingress=mi)
    K = inb.shape[-1]
    dev = rc_src.device
    g = launch_geometry(C, K, _build.smem_optin(dev), sparse)
    i32 = torch.int32
    planes = (("rc_src", rc_src), ("rc_score", rc_score))
    if not sparse:
        planes += (("rc_shi", rc_shi), ("rc_slo", rc_slo))
    for name, t in planes:
        _build.check(t, name, i32, (O, N, C), dev)
    _build.check(rc_upserts, "rc_upserts", i32, (O, N), dev)
    _build.check(inb, "inb", i32, (O, N, K), dev)
    _build.check(shi, "shi", i32, (N + 1,), dev)
    _build.check(slo, "slo", i32, (N + 1,), dev)
    _build.check(stakes, "stakes", torch.int64, (N + 1,), dev)
    _build.check(origins, "origins", i32, (O,), dev)
    if live is not None:
        _build.check(live, "live", torch.bool, (O,), dev)
    Cs = 0 if sparse else C
    out = MergePruneOut(
        rc_src=torch.empty((O, N, C), dtype=i32, device=dev),
        rc_score=torch.empty((O, N, C), dtype=i32, device=dev),
        rc_shi=torch.empty((O, N, Cs), dtype=i32, device=dev),
        rc_slo=torch.empty((O, N, Cs), dtype=i32, device=dev),
        rc_upserts=torch.empty((O, N), dtype=i32, device=dev),
        src_sorted=torch.empty((O, N, C), dtype=i32, device=dev),
        pruned_slot=torch.empty((O, N, C), dtype=torch.bool, device=dev),
        n_pruned=torch.empty((O, N), dtype=i32, device=dev),
        rc_overflow=torch.empty((O,), dtype=i32, device=dev))
    # the sparse variant's stake planes (in and out) are null pointers
    p = lambda t: None if t is None or t.numel() == 0 else _build.ptr(t)
    rc = _lib()(p(rc_src), p(rc_score), p(rc_shi), p(rc_slo), p(rc_upserts),
                p(inb), p(shi), p(slo), p(stakes), p(origins), p(live),
                *(p(t) for t in out), O, N, C, K, g.rows_per_block,
                g.key_slots, g.row_bytes, int(received_cap),
                int(min_num_upserts), lanes.ctypes.data, k, O // k,
                int(sparse), _build.stream_of(rc_src))
    _build.launched(SPARSE_NAME if sparse else NAME, rc)
    return out
