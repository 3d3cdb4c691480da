"""Per-lane knobs of the kernels that read a sweep knob.

A batch of K sweep lanes over O origins runs as R = K * O rows of the
origin axis (engine/lanes.py): lane ``k`` owns rows ``[k * O, (k + 1) *
O)``.  The four kernels that read a knob (``push_targets``,
``rc_merge_prune``, ``rotate``, ``pull_exchange``) take each knob either
as a scalar (every row) or as a sequence of K per-lane values, and read
row ``r``'s value as ``knob[r // (R / K)]``.

On the card the lanes' values travel by value, in a per-launch struct of
at most :data:`MAX_LANES` entries (kernel parameters, no copy to device
memory); the plain versions run each lane's rows with that lane's scalars.
"""

from __future__ import annotations

import numpy as np

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
        out[name] = widen(np.asarray(a).reshape(-1), k)
    return out
