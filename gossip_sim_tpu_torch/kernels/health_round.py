"""``health_round``: the node-health planes' update of one round.

Replaces the ``p.health`` arms of the reference engine's round
(gossip_sim_tpu/engine/core.py:1255-1283) and traffic round
(gossip_sim_tpu/engine/traffic.py:857-895).  Both count, per prunee, the
pruned slots that name it (the pruner -> prunee pairs of
``rc_merge_prune``'s ``src_sorted``/``pruned_slot``), gated by the
measured-round gate; the round form also stamps each node's first
delivery round (``it + 1`` where the plane is still 0 and the node is
reached, not gated), the traffic form sums each node's first deliveries,
rescues and their latencies (``it - v_birth + 1``) over the value axis.
The CUDA kernels are ``csrc/health_round.cu`` (``health_round_kernel``, and
the traffic form ``health_round_traffic_kernel``, counted apart as
``health_round_traffic``); :func:`health_round_plain` and
:func:`health_round_traffic_plain` are the same functions in plain
PyTorch, used for CPU tensors and as the spec.

The reference hides the prune scatter behind ``lax.cond`` on the round's
prune count; the kernel needs no host sync for that: it reads
``n_pruned`` and touches only the slot rows of pruners whose count is
above 0.  Every update is an integer sum, so the scatter's atomics are
exact in any order.  The planes come back as new tensors (the state's are
not written).

Sweep lanes (engine/lanes.py) run as more origin rows: each lane's
iteration and gate go in the launch's per-lane records (``_lanes``); the
traffic form takes a leading lane axis on its planes and K x V value rows
of the prune pairs.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build, _lanes

NAME = "health_round"
TRAFFIC_NAME = "health_round_traffic"  # launch count of the traffic form
#: threads per block of both kernels (csrc/health_round.cu kThreads)
THREADS = 256
#: One lane's iteration and measured-round gate in the launch's struct
#: (csrc/health_round.cu HealthLane).
LANE_DTYPE = np.dtype([("it", "<i8"), ("gate", "<i4"), ("pad", "<i4")])


def lane_values(rows: int, its, gates):
    """(K, its [K] int64, gates [K] int32) of a call over ``rows`` rows:
    each lane's iteration and measured-round gate (0 or 1); a scalar is
    every lane's."""
    its = _lanes.values(its, np.int64)
    gates = (_lanes.values(gates, np.int64) != 0).astype(np.int32)
    k = _lanes.count(rows, its, gates)
    return k, np.array(_lanes.widen(its, k)), np.array(_lanes.widen(gates,
                                                                    k))


def prune_counts(src_sorted: torch.Tensor, pruned_slot: torch.Tensor,
                 groups: int, n: int) -> torch.Tensor:
    """[groups, n] int32: per group of ``src_sorted.shape[0] / groups``
    rows, the pruned slots that name each node (the reference's
    ``segment_sum`` over ``where(pruned_slot, src_sorted, N)``)."""
    seg = torch.where(pruned_slot, src_sorted, n).long().reshape(groups, -1)
    cnt = torch.zeros((groups, n + 1), dtype=torch.int32,
                      device=src_sorted.device)
    cnt.scatter_add_(1, seg, pruned_slot.reshape(groups, -1).to(torch.int32))
    return cnt[:, :n]


def health_round_plain(prune_recv, first_round, n_pruned, src_sorted,
                       pruned_slot, reached, its, gates):
    """The round form over R rows: ``prune_recv``/``first_round`` [R, N]
    i32 (the carried planes), ``n_pruned`` [R, N], ``src_sorted``/
    ``pruned_slot`` [R, N, C] from the prune decision, ``reached`` [R, N]
    bool (the round's delivery view); ``its`` and ``gates`` a scalar or K
    per-lane values (lane k's for rows ``[k R / K, (k + 1) R / K)``).
    Returns the new (prune_recv, first_round).  ``n_pruned`` is the count
    of each row's pruned slots, which the kernel reads to skip rows; here
    the pairs are summed whole."""
    R, N = prune_recv.shape
    k, its, gates = lane_values(R, its, gates)
    dev = prune_recv.device
    per = R // k
    it_r = torch.as_tensor(np.repeat(its, per), device=dev)[:, None]
    g_r = torch.as_tensor(np.repeat(gates, per), device=dev)[:, None]
    cnt = prune_counts(src_sorted, pruned_slot, R, N)
    new_prune = prune_recv + g_r * cnt
    new_first = torch.where((first_round == 0) & reached,
                            (it_r + 1).to(torch.int32), first_round)
    return new_prune.to(torch.int32), new_first


def health_round_traffic_plain(prune_recv, lat_acc, del_acc, resc_acc,
                               new_del, pull_del, v_birth, it: int,
                               n_pruned, src_sorted, pruned_slot, gates):
    """The traffic form over K lanes: the four planes [K, N] i32
    (prune-received, latency sum, deliveries, rescues), ``new_del`` [K, V,
    N] bool (the round's first push deliveries), ``pull_del`` the same of
    the pull rescues or None, ``v_birth`` [K, V] i32, the round ``it``
    (every lane's), ``n_pruned`` [K V, N] and ``src_sorted``/
    ``pruned_slot`` [K V, N, C] over the value rows, ``gates`` a scalar or
    K per-lane values.  Returns the four new planes."""
    K, V, N = new_del.shape
    _, _, gates = lane_values(K, it, gates)
    i32 = torch.int32
    g = torch.as_tensor(gates, device=new_del.device)[:, None]
    del_nv = new_del.to(i32)
    resc_nv = (pull_del.to(i32) if pull_del is not None
               else torch.zeros_like(del_nv))
    del_all = del_nv + resc_nv
    lat_v = int(it) - v_birth + 1                                 # [K, V]
    lat_node = (del_all * lat_v[..., None]).sum(1, dtype=i32)
    cnt = prune_counts(src_sorted, pruned_slot, K, N)
    return ((prune_recv + g * cnt).to(i32),
            (lat_acc + g * lat_node).to(i32),
            (del_acc + g * del_all.sum(1, dtype=i32)).to(i32),
            (resc_acc + g * resc_nv.sum(1, dtype=i32)).to(i32))


def grid_blocks(elems: int, sms: int, blocks_per_sm: int) -> int:
    """Blocks of a cooperative launch over ``elems`` grid-stride elements:
    one wave (``sms`` x ``blocks_per_sm``, all co-resident, as the grid
    barrier needs), or fewer where one wave has more threads than
    elements."""
    return max(1, min(-(-elems // THREADS), sms * blocks_per_sm))


@functools.lru_cache(maxsize=8)
def blocks_per_sm(device: torch.device, traffic: bool) -> int:
    """Blocks of the round (or, ``traffic``, the traffic) kernel one SM of
    ``device`` holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``,
    read once per device and form)."""
    fn = _build.library(NAME).health_round_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(int(traffic), ctypes.byref(out))
    if rc != 0 or out.value < 1:
        raise RuntimeError(f"{NAME}: occupancy query failed (error {rc}, "
                           f"{out.value} blocks per SM)")
    return out.value


def _grid(device: torch.device, elems: int, traffic: bool) -> int:
    return grid_blocks(elems, _build.sm_count(device),
                       blocks_per_sm(device, traffic))


def _fn(symbol: str, nargs: tuple):
    fn = getattr(_build.library(NAME), symbol)
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp if a == "p" else ci for a in nargs]
        fn.restype = ci
    return fn


def health_round(prune_recv, first_round, n_pruned, src_sorted, pruned_slot,
                 reached, its, gates):
    """The round form (see :func:`health_round_plain`): the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors.

    On the card one cooperative launch writes the new first-round plane
    and a copy of the prune plane, and after a grid barrier adds each
    firing pruner's pairs to the copy with atomics."""
    if not prune_recv.is_cuda:
        return health_round_plain(prune_recv, first_round, n_pruned,
                                  src_sorted, pruned_slot, reached, its,
                                  gates)
    R, N = prune_recv.shape
    C = src_sorted.shape[-1]
    dev = prune_recv.device
    k, its, gates = lane_values(R, its, gates)
    i32 = torch.int32
    _build.check(prune_recv, "prune_recv", i32, (R, N), dev)
    _build.check(first_round, "first_round", i32, (R, N), dev)
    _build.check(n_pruned, "n_pruned", i32, (R, N), dev)
    _build.check(src_sorted, "src_sorted", i32, (R, N, C), dev)
    _build.check(pruned_slot, "pruned_slot", torch.bool, (R, N, C), dev)
    _build.check(reached, "reached", torch.bool, (R, N), dev)
    lanes = _lanes.pack(k, LANE_DTYPE, it=its, gate=gates)
    out_prune = torch.empty((R, N), dtype=i32, device=dev)
    out_first = torch.empty((R, N), dtype=i32, device=dev)
    p = _build.ptr
    rc = _fn("health_round_launch", "p" * 8 + "iiipiii" + "p")(
        p(prune_recv), p(first_round), p(n_pruned), p(src_sorted),
        p(pruned_slot), p(reached), p(out_prune), p(out_first), R, N, C,
        lanes.ctypes.data, k, R // k, _grid(dev, R * N, False),
        _build.stream_of(prune_recv))
    _build.launched(NAME, rc)
    return out_prune, out_first


def health_round_traffic(prune_recv, lat_acc, del_acc, resc_acc, new_del,
                         pull_del, v_birth, it: int, n_pruned, src_sorted,
                         pruned_slot, gates):
    """The traffic form (see :func:`health_round_traffic_plain`): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.

    On the card one cooperative launch sums each (lane, node)'s
    deliveries, rescues and latencies over the values into the new planes
    (and copies the prune plane), and after a grid barrier adds each
    firing pruner's pairs to the copy with atomics."""
    if not new_del.is_cuda:
        return health_round_traffic_plain(
            prune_recv, lat_acc, del_acc, resc_acc, new_del, pull_del,
            v_birth, it, n_pruned, src_sorted, pruned_slot, gates)
    K, V, N = new_del.shape
    C = src_sorted.shape[-1]
    dev = new_del.device
    k, its, gates = lane_values(K, it, gates)
    i32 = torch.int32
    for name, t in (("prune_recv", prune_recv), ("lat_acc", lat_acc),
                    ("del_acc", del_acc), ("resc_acc", resc_acc)):
        _build.check(t, name, i32, (K, N), dev)
    _build.check(new_del, "new_del", torch.bool, (K, V, N), dev)
    if pull_del is not None:
        _build.check(pull_del, "pull_del", torch.bool, (K, V, N), dev)
    _build.check(v_birth, "v_birth", i32, (K, V), dev)
    _build.check(n_pruned, "n_pruned", i32, (K * V, N), dev)
    _build.check(src_sorted, "src_sorted", i32, (K * V, N, C), dev)
    _build.check(pruned_slot, "pruned_slot", torch.bool, (K * V, N, C), dev)
    lanes = _lanes.pack(k, LANE_DTYPE, it=its, gate=gates)
    outs = [torch.empty((K, N), dtype=i32, device=dev) for _ in range(4)]
    p = lambda t: None if t is None else _build.ptr(t)
    rc = _fn("health_round_traffic_launch", "p" * 14 + "iiiipiii" + "p")(
        p(prune_recv), p(lat_acc), p(del_acc), p(resc_acc), p(new_del),
        p(pull_del), p(v_birth), p(n_pruned), p(src_sorted), p(pruned_slot),
        *(p(t) for t in outs), K, V, N, C, lanes.ctypes.data, k, 1,
        _grid(dev, max(K * N, K * V * N), True),
        _build.stream_of(new_del))
    _build.launched(TRAFFIC_NAME, rc)
    return tuple(outs)
