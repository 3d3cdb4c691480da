"""``traffic_admit``: the traffic round's ingress budget, the cross-value
contention point.

Replaces the reference engine's ``traffic/ingress_cap`` block
(gossip_sim_tpu/engine/traffic.py:316-342: one flat sort of every arrival
by (target, value-major arrival order)).  The CUDA kernel is
``csrc/traffic_admit.cu``; :func:`traffic_admit_plain` is the same function
in plain PyTorch, used for CPU tensors and as the spec.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build, _lanes

NAME = "traffic_admit"
#: i32 words of scratch per node: the cut (i64), the in-degree, the
#: arrivals and a bucket of 32 in-neighbours
SCRATCH_WORDS = 2 + 1 + 1 + 32
#: One lane's record of the launch (csrc/traffic_admit.cu AdmitLane).
LANE_DTYPE = np.dtype([("ingress_cap", "<i4"), ("pad", "<i4")])


class AdmitOut(NamedTuple):
    accepted: torch.Tensor       # [V, N, F] bool arrival within the cap
    arrived_node: torch.Tensor   # [N] i32 arrivals per target
    accepted_node: torch.Tensor  # [N] i32 accepted arrivals per target


def traffic_admit_plain(cand_bits: torch.Tensor, arr_bits: torch.Tensor,
                        active: torch.Tensor, fanout: int,
                        ingress_cap) -> AdmitOut:
    """The ingress budget in plain PyTorch (see :func:`_admit_one`).  The
    lane form takes ``cand_bits``/``arr_bits`` [K, N, V] and ``active``
    [K, N, S] with ``ingress_cap`` a scalar or K per-lane values, runs each
    lane with its own cap, and returns ``accepted`` [K, V, N, F] and the
    node counts [K, N]."""
    if active.dim() == 2:
        return _admit_one(cand_bits, arr_bits, active, fanout,
                          int(ingress_cap))
    k = active.shape[0]
    cap = _lanes.per_lane(ingress_cap, k, np.int64)
    outs = [_admit_one(cand_bits[j], arr_bits[j], active[j], fanout,
                       int(cap[j])) for j in range(k)]
    return AdmitOut(*(torch.stack(x) for x in zip(*outs)))


def _admit_one(cand_bits: torch.Tensor, arr_bits: torch.Tensor,
               active: torch.Tensor, fanout: int,
               ingress_cap: int) -> AdmitOut:
    """Rank every arrival among the arrivals at its target in flat (value,
    sender, fanout slot) order; with ``ingress_cap`` > 0 the ranks below it
    are accepted, else all.  ``cand_bits``/``arr_bits`` [N, V] and
    ``active`` [N, S] are :func:`traffic_send`'s outputs and input: bit s of
    a (sender, value) word marks slot s a candidate / an arrival at peer
    ``active[sender, s]``, whose fanout slot is the candidates below s.
    ``fanout`` is the F of the [V, N, F] acceptance plane."""
    N, V = arr_bits.shape
    S = active.shape[-1]
    dev = arr_bits.device
    bit = torch.arange(S, device=dev)
    arr = ((arr_bits.T.long()[..., None] >> bit) & 1).bool()    # [V, N, S]
    cand = (cand_bits.T.long()[..., None] >> bit) & 1
    fo = torch.cumsum(cand, -1) - cand
    v_i, n_i, s_i = arr.nonzero(as_tuple=True)   # flat (v, n, f) order
    f_i = fo[v_i, n_i, s_i]
    tgt = active[n_i, s_i].long()
    order = torch.sort(tgt, stable=True).indices
    st = tgt[order]
    rank = torch.arange(st.numel(), device=dev) - torch.searchsorted(st, st)
    ok = (ingress_cap <= 0) | (rank < ingress_cap)
    accepted = torch.zeros((V, N, fanout), dtype=torch.bool, device=dev)
    accepted[v_i[order], n_i[order], f_i[order]] = ok
    arrived_node = torch.bincount(tgt, minlength=N).to(torch.int32)
    accepted_node = (arrived_node.clamp(max=ingress_cap) if ingress_cap > 0
                     else arrived_node)
    return AdmitOut(accepted, arrived_node, accepted_node)


def _lib():
    fn = _build.library(NAME).traffic_admit_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 7 + [ci] * 4 + [vp, ci, vp]
        fn.restype = ci
    return fn


def traffic_admit(cand_bits: torch.Tensor, arr_bits: torch.Tensor,
                  active: torch.Tensor, fanout: int,
                  ingress_cap) -> AdmitOut:
    """The ingress budget: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns :class:`AdmitOut`; takes the one-run
    form or the lane form of :func:`traffic_admit_plain` (at most
    :data:`~._lanes.MAX_LANES` lanes).

    The accepted arrivals at a target are a prefix of its arrivals in flat
    (value, source, slot) order, so the cap is one cut per target.  On the
    card a tally (a warp per sender) counts each target's arrivals and
    lists its in-neighbours, a cut kernel (a lane's cap on only; a warp per
    target past the cap) finds the first rejected arrival, and a write
    kernel (a tile of 32 senders x 32 values per block) writes every byte
    of the acceptance plane once from the sender side
    (``csrc/traffic_admit.cu``); each has the lane in its grid.
    """
    if not arr_bits.is_cuda:
        return traffic_admit_plain(cand_bits, arr_bits, active, fanout,
                                   ingress_cap)
    if active.dim() == 2:
        out = _launch(cand_bits[None], arr_bits[None], active[None], fanout,
                      ingress_cap)
        return AdmitOut(*(t[0] for t in out))
    return _launch(cand_bits, arr_bits, active, fanout, ingress_cap)


def _launch(cand_bits, arr_bits, active, fanout, ingress_cap) -> AdmitOut:
    K, N, V = arr_bits.shape
    S = active.shape[-1]
    F = int(fanout)
    dev = arr_bits.device
    _lanes.check_batch(K, NAME)
    i32 = torch.int32
    _build.check(cand_bits, "cand_bits", i32, (K, N, V), dev)
    _build.check(arr_bits, "arr_bits", i32, (K, N, V), dev)
    _build.check(active, "active", i32, (K, N, S), dev)
    records = _lanes.pack(K, LANE_DTYPE, ingress_cap=_lanes.per_lane(
        ingress_cap, K, np.int64))
    scratch = torch.empty((SCRATCH_WORDS * K * N,), dtype=i32, device=dev)
    out = AdmitOut(torch.empty((K, V, N, F), dtype=torch.bool, device=dev),
                   torch.empty((K, N), dtype=i32, device=dev),
                   torch.empty((K, N), dtype=i32, device=dev))
    p = _build.ptr
    rc = _lib()(p(active), p(cand_bits), p(arr_bits), p(scratch),
                *(p(t) for t in out), V, N, S, F, records.ctypes.data, K,
                _build.stream_of(arr_bits))
    _build.launched(NAME, rc)
    return out
