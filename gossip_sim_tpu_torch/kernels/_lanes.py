"""Per-lane knobs of the kernels that read a sweep knob.

A batch of K sweep lanes over O origins runs as R = K * O rows of the
origin axis (engine/lanes.py): lane ``k`` owns rows ``[k * O, (k + 1) *
O)``.  The four kernels that read a knob (``push_targets``,
``rc_merge_prune``, ``rotate``, ``pull_exchange``) take each knob either
as a scalar (every row) or as a sequence of K per-lane values, and read
row ``r``'s value as ``knob[r // (R / K)]``.  A batch of K traffic lanes
(engine/traffic.py) runs its K x V value rows the same way in
``rank_inbound``, ``rc_merge_prune`` and ``prune_apply``; ``traffic_send``,
``traffic_admit`` and ``traffic_rescue`` take every plane with a leading
lane axis and each lane's knobs from its record.

On the card the lanes' values travel by value, in a per-launch struct of
at most :data:`MAX_LANES` entries (kernel parameters, no copy to device
memory); the plain versions run each lane's rows with that lane's scalars.
"""

from __future__ import annotations

import numpy as np
import torch

#: Lanes a kernel's per-launch struct holds (the csrc kernels' kMaxLanes).
MAX_LANES = 64


def values(v, dtype) -> np.ndarray:
    """A knob as a 1-D array of per-lane values (a scalar: one lane)."""
    a = np.asarray(v).astype(dtype, copy=False).reshape(-1)
    if a.size == 0:
        raise ValueError("a per-lane knob needs at least one value")
    return a


def count(rows: int, *knobs: np.ndarray) -> int:
    """The lane count K of per-lane knob arrays over ``rows`` origin rows:
    the length every array of more than one value shares (1 where all are
    scalars).  K must divide the rows and be at most :data:`MAX_LANES`."""
    k = 1
    for a in knobs:
        if a.size == 1:
            continue
        if k not in (1, a.size):
            raise ValueError(f"per-lane knobs of {k} and {a.size} lanes")
        k = a.size
    if k > MAX_LANES:
        raise ValueError(f"{k} lanes: a launch takes at most {MAX_LANES}")
    if rows % k:
        raise ValueError(f"{rows} origin rows do not split into {k} lanes")
    return k


def per_lane(v, k: int, dtype) -> np.ndarray:
    """A knob as K per-lane values: a scalar (or one value) repeated, or
    exactly K values."""
    a = values(v, dtype)
    if a.size not in (1, k):
        raise ValueError(f"a per-lane knob of {a.size} values for {k} lanes")
    return np.array(widen(a, k))


def check_batch(k: int, name: str) -> None:
    """Raise unless a launch's K lanes fit its per-launch records."""
    if not 1 <= k <= MAX_LANES:
        raise ValueError(f"{name}: {k} lanes; a launch takes 1 to "
                         f"{MAX_LANES}")


def widen(a: np.ndarray, k: int) -> np.ndarray:
    """``a`` as K per-lane values (a single value repeated)."""
    return np.broadcast_to(a, (k,)) if a.size == 1 else a


def uniform(*knobs: np.ndarray) -> bool:
    """Whether every lane has the same value of every knob."""
    return all((a == a[0]).all() for a in knobs)


def slices(rows: int, k: int):
    """``(lane, slice of its rows)`` for each of K lanes of ``rows``."""
    per = rows // k
    return [(j, slice(j * per, (j + 1) * per)) for j in range(k)]


def pack(k: int, dtype: np.dtype, **fields) -> np.ndarray:
    """The launch's per-lane struct array: K records of ``dtype`` (whose
    layout is the C struct's), each field from its per-lane values."""
    out = np.zeros(k, dtype=dtype)
    for name, a in fields.items():
        a = np.asarray(a).reshape(-1)
        out[name] = a[0] if a.size == 1 else a
    return out


#: The per-lane planes among each traffic kernel's positional arguments in
#: its lane form (a leading lane axis), and the positions of its per-lane
#: knobs; the other arguments are shared.
TRAFFIC_LANE_ARGS = {
    "traffic_send": ((0, 1, 2, 3, 4, 5, 6), (9,)),
    "traffic_admit": ((0, 1, 2), (4,)),
    "traffic_rescue": ((0, 1, 2, 3, 4, 5, 11, 12), (13, 16, 17)),
}
#: Each kernel's per-lane keyword knobs (pairs: each half per lane).
TRAFFIC_LANE_KW = {
    "traffic_send": ("partition", "loss"),
    "traffic_admit": (),
    "traffic_rescue": ("draw", "bloom", "partition", "loss"),
    "rc_merge_prune": ("min_ingress_nodes", "prune_stake_threshold"),
}


def pick(x, j: int):
    """Lane ``j``'s value of a knob that is a scalar, K values, None or a
    pair of either."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(pick(y, j) for y in x)
    a = np.asarray(x)
    return (a.reshape(-1)[j] if a.size > 1 else a.reshape(-1)[0]).item()


def one_lane_call(name: str, args, kw, j: int, v: int):
    """Lane ``j``'s one-run call (arguments and keywords) of a traffic
    kernel's lane call ``name(*args, **kw)`` over lanes of ``v`` value
    rows: for ``traffic_send``, ``traffic_admit`` and ``traffic_rescue``
    its planes at lane j and its knobs' lane-j values; for
    ``rank_inbound``, ``rc_merge_prune`` and ``prune_apply`` (K x V value
    rows) its rows ``[j V, (j + 1) V)``."""
    rows = slice(j * v, (j + 1) * v)
    kw = {key: (pick(val, j) if key in TRAFFIC_LANE_KW.get(name, ())
                else val) for key, val in kw.items()}
    if name in TRAFFIC_LANE_ARGS:
        planes, knobs = TRAFFIC_LANE_ARGS[name]
        args = tuple(a[j] if i in planes else pick(a, j) if i in knobs
                     else a for i, a in enumerate(args))
    elif name == "rank_inbound":
        args = (args[0][rows], args[1][rows], args[2][rows]) + tuple(args[3:])
    elif name == "rc_merge_prune":
        args = tuple(a[rows] if i in (0, 1, 2, 3, 4, 5, 9) else a
                     for i, a in enumerate(args))
        if kw.get("live") is not None:
            kw["live"] = kw["live"][rows]
    elif name == "prune_apply":
        pruned, active, src_sorted, pruned_slot = args
        args = (pruned[rows], active[j], src_sorted[rows], pruned_slot[rows])
    else:
        raise ValueError(f"{name} has no traffic lane form")
    return args, kw


def lane_part(name: str, out, j: int, v: int):
    """Lane ``j``'s part of the output of a traffic kernel's lane call
    (see :func:`one_lane_call`)."""
    if name in TRAFFIC_LANE_ARGS:
        return type(out)(*(t[j] for t in out))
    rows = slice(j * v, (j + 1) * v)
    if isinstance(out, torch.Tensor):
        return out[rows]
    parts = [t[rows] for t in out]
    return type(out)(*parts) if hasattr(out, "_fields") else tuple(parts)
