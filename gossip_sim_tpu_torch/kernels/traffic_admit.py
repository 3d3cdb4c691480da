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

import torch

from . import _build

NAME = "traffic_admit"


class AdmitOut(NamedTuple):
    accepted: torch.Tensor       # [V, N, F] bool arrival within the cap
    arrived_node: torch.Tensor   # [N] i32 arrivals per target
    accepted_node: torch.Tensor  # [N] i32 accepted arrivals per target


def traffic_admit_plain(cand_bits: torch.Tensor, arr_bits: torch.Tensor,
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


def in_neighbours(active: torch.Tensor):
    """The reverse CSR of the shared [N, S] active set: ``row_ptr`` [N + 1]
    and ``col`` [N * S] i32 (``src * S + slot``; the first ``row_ptr[N]``
    entries), each target's in-neighbours in ascending source order."""
    N, S = active.shape
    dev = active.device
    tg = active.reshape(-1).long().clamp(max=N)
    key = tg * (N * S) + torch.arange(N * S, device=dev)
    col = (torch.sort(key).values % (N * S)).to(torch.int32)
    row_ptr = torch.zeros(N + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = torch.cumsum(torch.bincount(tg, minlength=N + 1)[:N], 0)
    return row_ptr, col


def _lib():
    fn = _build.library(NAME).traffic_admit_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 7 + [ci] * 5 + [vp]
        fn.restype = ci
    return fn


def traffic_admit(cand_bits: torch.Tensor, arr_bits: torch.Tensor,
                  active: torch.Tensor, fanout: int,
                  ingress_cap: int) -> AdmitOut:
    """The ingress budget: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns :class:`AdmitOut`.

    The kernel gives each target a warp that walks the values in order and,
    within a value, the target's in-neighbours in source order (the
    reverse CSR, built here), reading whether the (value, source) message
    through that slot arrived from ``arr_bits``.  An arrival's rank is the
    running count, and its fanout slot is the candidates below its slot in
    ``cand_bits``: each source's peers are distinct, so a source sends a
    target at most one message per value, and the (value, source) order is
    the flat order."""
    if not arr_bits.is_cuda:
        return traffic_admit_plain(cand_bits, arr_bits, active, fanout,
                                   ingress_cap)
    N, V = arr_bits.shape
    S = active.shape[-1]
    F = int(fanout)
    dev = arr_bits.device
    i32 = torch.int32
    _build.check(cand_bits, "cand_bits", i32, (N, V), dev)
    _build.check(arr_bits, "arr_bits", i32, (N, V), dev)
    _build.check(active, "active", i32, (N, S), dev)
    row_ptr, col = in_neighbours(active)
    out = AdmitOut(torch.empty((V, N, F), dtype=torch.bool, device=dev),
                   torch.empty((N,), dtype=i32, device=dev),
                   torch.empty((N,), dtype=i32, device=dev))
    p = _build.ptr
    rc = _lib()(p(row_ptr), p(col), p(cand_bits), p(arr_bits),
                *(p(t) for t in out), V, N, S, F, int(ingress_cap),
                _build.stream_of(arr_bits))
    _build.launched(NAME, rc)
    return out
