"""``prune_apply``: apply this round's (pruner, prunee) pairs to the
active-set pruned bits.

Replaces the reference engine's ``round/verb4_prune_apply`` join
(gossip_sim_tpu/engine/core.py:894-941), and the traffic round's
``traffic/prune_apply`` (gossip_sim_tpu/engine/traffic.py:711-755), whose
value axis shares one [N, S] active set.  The CUDA kernel is
``csrc/prune_apply.cu``; :func:`prune_apply_plain` is the same function in
plain PyTorch, used for CPU tensors and as the spec.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NAME = "prune_apply"


def prune_apply_plain(pruned: torch.Tensor, active: torch.Tensor,
                      src_sorted: torch.Tensor,
                      pruned_slot: torch.Tensor) -> torch.Tensor:
    """``pruned`` [O, N, S] bool | hit, where hit[o, u, s] is set iff
    ``active[o, u, s] == t`` for a live pair (pruner t = the row of
    ``pruned_slot``/``src_sorted`` [O, N, C], prunee u = its src).  An
    ``active`` of shape [N, S] is shared by every o (the traffic round's)."""
    out = pruned.clone()
    o_i, t_i, c_i = pruned_slot.nonzero(as_tuple=True)
    u_i = src_sorted[o_i, t_i, c_i].long()
    rows = active[u_i] if active.dim() == 2 else active[o_i, u_i]  # [P, S]
    p_i, s_i = (rows == t_i[:, None]).nonzero(as_tuple=True)
    out[o_i[p_i], u_i[p_i], s_i] = True
    return out


def _lib():
    lib = _build.library(NAME)
    fn = lib.prune_apply_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 5 + [ci] * 5 + [vp]
        fn.restype = ci
    return fn


def prune_apply(pruned: torch.Tensor, active: torch.Tensor,
                src_sorted: torch.Tensor,
                pruned_slot: torch.Tensor) -> torch.Tensor:
    """Prune application: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns the new [O, N, S] pruned bits.
    ``active`` is [O, N, S], or [N, S] shared by every o (no copy of it per
    value is made)."""
    if not active.is_cuda:
        return prune_apply_plain(pruned, active, src_sorted, pruned_slot)
    O, N, S = pruned.shape
    C = src_sorted.shape[-1]
    dev = active.device
    shared = active.dim() == 2
    _build.check(pruned, "pruned", torch.bool, (O, N, S), dev)
    _build.check(active, "active", torch.int32,
                 (N, S) if shared else (O, N, S), dev)
    _build.check(src_sorted, "src_sorted", torch.int32, (O, N, C), dev)
    _build.check(pruned_slot, "pruned_slot", torch.bool, (O, N, C), dev)
    out = torch.empty((O, N, S), dtype=torch.bool, device=dev)
    p = _build.ptr
    rc = _lib()(p(pruned), p(active), p(src_sorted), p(pruned_slot), p(out),
                O, N, S, C, int(shared), _build.stream_of(active))
    _build.launched(NAME, rc)
    return out
