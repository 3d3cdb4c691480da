"""Sweep lanes: K sweep points as one batch of rows.

The port of the reference package's ``engine/lanes.py``.  A knob sweep's K
points share every shape, so they run together: stack their
:class:`EngineKnobs` into ``[K]`` leaves (:func:`stack_knobs`), tile the
initial :class:`SimState` (``[O, ...]`` -> ``[K, O, ...]``,
:func:`broadcast_state`), and run the K lanes as R = K * O rows of the
origin axis.  The reference vmaps ``round_step`` over a lane axis; here a
lane is more rows, not a new axis: :func:`run_rounds_lanes` views the
state as ``[K * O, ...]`` and runs the one round body
(``core.lane_round``, whose one-lane case is the serial ``round_step``).
The kernels that take no knob (``bfs_relax``, ``rank_inbound``,
``prune_apply``, ``threefry``) run the R rows unchanged; the four that
read a sweep knob (``push_targets``, ``rc_merge_prune``, ``rotate``,
``pull_exchange``) read each row's from its lane (``kernels/_lanes.py``).

Contract (tests/test_torch_lanes.py, chip_smoke.py (k)): a lane's rows and
final state equal, bit for bit, a serial :func:`~.core.run_rounds` with the
merged static and that lane's knobs, and the reference's lane run.  Every
row is independent of the others, so batching them changes no value, and
a batch of more than :data:`MAX_LANES` lanes (the records a kernel launch
holds) runs as groups of at most that many (:func:`lane_groups`).  The
traffic engine's lanes (engine/traffic.py ``run_traffic_lanes``) group the
same way.

Rows come back as ``[iters, K, O, ...]`` (``stats.aggregate.lane_rows``
slices one lane).  :func:`run_rounds_lanes_dyn` runs lanes with their own
origins (``[K, O]``, :func:`stack_origins`) and start iterations, the
dynamic-membership runner: :func:`splice_lane_state` admits a fresh state
into one lane and leaves the others' bits as they were.

The reference's ``lane_cache_size``/``clear_lane_cache`` and their dyn
twins count compiled JAX executables; the port compiles nothing per shape
(its kernels are built once from ``csrc/``), so they have no counterpart
here, as ``--compilation-cache-dir`` has none in the CLI.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import (ClusterTables, Lanes, SimState, _validate_static,
                   lane_round, stack_rows)
from .params import EngineKnobs, EngineStatic, _check_knob_gates
from ..kernels._lanes import MAX_LANES


def stack_knobs(knob_list) -> EngineKnobs:
    """K per-lane :class:`EngineKnobs` -> one of ``[K]`` leaves, each of the
    knob's dtype."""
    knob_list = list(knob_list)
    if not knob_list:
        raise ValueError("stack_knobs needs at least one lane")
    return EngineKnobs(*(np.stack([np.asarray(getattr(k, f))
                                   for k in knob_list])
                         for f in EngineKnobs._fields))


def num_lanes(knobs: EngineKnobs) -> int:
    """Lane count of a stacked knob vector."""
    return int(np.shape(knobs.impair_seed)[0])


def broadcast_state(state: SimState, lanes: int) -> SimState:
    """One ``[O, ...]`` SimState as ``lanes`` identical lanes
    ``[K, O, ...]``.  Each lane is a contiguous copy (an ``expand`` view has
    stride 0, which the kernels refuse).  The lanes of a knob sweep start
    from the state a serial point would (``init_state`` reads only shapes
    and the key), so the copies are the serial sweep's K initial states."""
    return SimState(*(x.unsqueeze(0).repeat((lanes,) + (1,) * x.dim())
                      for x in state))


def lane_state(states: SimState, lane: int) -> SimState:
    """One lane's ``[O, ...]`` SimState out of a ``[K, O, ...]`` batch."""
    return SimState(*(x[lane] for x in states))


def stack_origins(origin_list) -> torch.Tensor:
    """K per-lane origin index sequences -> one ``[K, O]`` int32 tensor (on
    the CPU; the runner moves it).  Every lane carries the same origin
    count O."""
    origin_list = [np.asarray(o, np.int32).reshape(-1) for o in origin_list]
    if not origin_list:
        raise ValueError("stack_origins needs at least one lane")
    widths = {o.shape[0] for o in origin_list}
    if len(widths) != 1:
        raise ValueError(f"all lanes must carry the same origin count "
                         f"(got widths {sorted(widths)})")
    return torch.as_tensor(np.stack(origin_list))


def splice_lane_state(states: SimState, lane: int,
                      state: SimState) -> SimState:
    """Admit one ``[O, ...]`` SimState into lane ``lane`` of a
    ``[K, O, ...]`` batch; every other lane's buffers keep their bits (the
    batch is copied, not written in place)."""
    lane = int(lane)
    out = []
    for b, x in zip(states, state):
        b = b.clone()
        b[lane] = x.to(b.device)
        out.append(b)
    return SimState(*out)


def check_lane_knobs(static: EngineStatic, knob_list) -> None:
    """Every lane's knob vector must be servable by the (merged) static: an
    active knob against a False gate would be ignored
    (``params._check_knob_gates``)."""
    for kn in knob_list:
        _check_knob_gates(static, kn)


def _unstack(knobs: EngineKnobs):
    return [EngineKnobs(*(np.asarray(v)[k] for v in knobs))
            for k in range(num_lanes(knobs))]


def _run(static, tables, origin_rows, states, knobs, num_iters, its0,
         detail):
    """The lanes' rounds; states and rows back in ``[K, O, ...]``.  A batch
    of more than :data:`MAX_LANES` lanes (a kernel's per-launch records)
    runs as groups of at most that many, one after another: the lanes are
    independent, so the grouping changes no value."""
    _validate_static(static)
    check_lane_knobs(static, _unstack(knobs))
    k = num_lanes(knobs)
    if states.active.shape[0] != k:
        raise ValueError(f"states carry {states.active.shape[0]} lanes, "
                         f"knobs {k}")
    if k <= MAX_LANES:
        return _run_group(static, tables, origin_rows, states, knobs,
                          num_iters, its0, detail)
    o = origin_rows.shape[0] // k
    parts = [_run_group(static, tables, origin_rows[g * o:(g + w) * o],
                        SimState(*(x[g:g + w] for x in states)),
                        EngineKnobs(*(np.asarray(v)[g:g + w] for v in knobs)),
                        num_iters, its0[g:g + w], detail)
             for g, w in lane_groups(k)]
    return cat_lanes(parts, SimState)


def lane_groups(k: int):
    """``(first lane, width)`` of each group of at most :data:`MAX_LANES`
    lanes of a batch of ``k``."""
    return [(g, min(MAX_LANES, k - g)) for g in range(0, k, MAX_LANES)]


def cat_lanes(parts, state_type):
    """The ``(states, rows)`` of lane groups as one batch: states joined on
    their lane axis (0), rows on theirs (1, after the round axis)."""
    states = state_type(*(torch.cat(xs) for xs in zip(*(s for s, _ in parts))))
    rows = {name: torch.cat([r[name] for _, r in parts], 1)
            for name in parts[0][1]}
    return states, rows


def _run_group(static, tables, origin_rows, states, knobs, num_iters, its0,
               detail):
    """At most :data:`MAX_LANES` lanes' rounds over R = K * O rows."""
    k = num_lanes(knobs)
    o = int(states.active.shape[1])
    dev = states.active.device
    flat = SimState(*(x.reshape((k * o,) + tuple(x.shape[2:])).contiguous()
                      for x in states))
    origin_rows = origin_rows.to(device=dev, dtype=torch.int32)
    lanes = Lanes(knobs, o, its0, dev)
    per_round = []
    for r in range(int(num_iters)):
        flat, rows = lane_round(static, lanes, tables, origin_rows, flat, r,
                                detail)
        per_round.append(rows)
    lane_shape = lambda x, lead: x.reshape(lead + (k, o) + tuple(
        x.shape[len(lead) + 1:]))
    out = SimState(*(lane_shape(x, ()) for x in flat))
    rows = {name: lane_shape(v, (v.shape[0],))
            for name, v in stack_rows(per_round).items()}
    return out, rows


def run_rounds_lanes(static: EngineStatic, tables: ClusterTables,
                     origins: torch.Tensor, states: SimState,
                     knobs: EngineKnobs, num_iters: int, start_it: int = 0,
                     detail: bool = False):
    """Run ``num_iters`` rounds of K lanes from iteration ``start_it``.

    ``states`` carries a leading lane axis (:func:`broadcast_state`),
    ``knobs`` ``[K]`` leaves (:func:`stack_knobs`), ``origins`` the O
    origins every lane runs.  Returns ``(states, rows)``, every rows leaf
    ``[num_iters, K, O, ...]``; a lane's slice equals a serial
    ``run_rounds(static, ..., knobs=<that lane's>)``.  K may pass
    :data:`MAX_LANES`: the lanes then run in groups of at most that many."""
    k = num_lanes(knobs)
    origins = torch.as_tensor(origins).reshape(-1)
    return _run(static, tables, origins.repeat(k), states, knobs, num_iters,
                np.full(k, int(start_it), np.int64), detail)


def run_rounds_lanes_dyn(static: EngineStatic, tables: ClusterTables,
                         origins, states: SimState, knobs: EngineKnobs,
                         num_iters: int, start_its, detail: bool = False):
    """One block of K lanes that each run their own scenario: ``origins``
    ``[K, O]`` (:func:`stack_origins`) and ``start_its`` ``[K]``, so lane k
    runs rounds ``start_its[k] .. start_its[k] + num_iters`` from its own
    origins.  Rows come back as from :func:`run_rounds_lanes`; a lane's
    equal a solo run of its scenario.  An idle lane keeps stepping its last
    state and its rows are the caller's to drop."""
    k = num_lanes(knobs)
    origins = torch.as_tensor(origins)
    if origins.dim() != 2 or origins.shape[0] != k:
        raise ValueError(f"origins must be [K={k}, O], got "
                         f"{tuple(origins.shape)}")
    its0 = np.asarray(start_its, np.int64).reshape(-1)
    if its0.shape[0] != k:
        raise ValueError(f"start_its must carry {k} lanes, got "
                         f"{its0.shape[0]}")
    return _run(static, tables, origins.reshape(-1), states, knobs,
                num_iters, its0, detail)
