"""Carry engine tables and state across packages as numpy arrays.

``tables_from_numpy`` and ``state_from_numpy`` take any object with the
reference package's ``ClusterTables``/``SimState`` fields (its arrays, or
numpy copies of them) and return this package's tensors on a device;
``state_to_numpy`` goes the other way, giving the reference's dtypes (the
threefry key back as uint32).  ``traffic_state_from_numpy`` and
``traffic_state_to_numpy`` do the same for the traffic engine's
``TrafficState`` (same dtypes in both packages).  The parity tests use them
to start both engines from one state.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine.core import ClusterTables, SimState, resolve_device
from .engine.sampler import SamplerTables
from .engine.traffic import TrafficState


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device)


def tables_from_numpy(tables, device="cuda") -> ClusterTables:
    """The port's ``ClusterTables`` from the reference's fields."""
    dev = resolve_device(device)
    s = tables.sampler
    sampler = SamplerTables(**{f: _tensor(getattr(s, f), dev)
                               for f in SamplerTables._fields})
    return ClusterTables(**{f: (sampler if f == "sampler"
                                else _tensor(getattr(tables, f), dev))
                            for f in ClusterTables._fields})


def state_from_numpy(state, device="cuda") -> SimState:
    """The port's ``SimState`` from the reference's fields; the uint32 key
    becomes int64 words."""
    dev = resolve_device(device)
    out = {}
    for f in SimState._fields:
        a = np.array(getattr(state, f))
        if f == "key":
            a = a.astype(np.int64)
        out[f] = torch.as_tensor(a, device=dev)
    return SimState(**out)


def state_to_numpy(state: SimState) -> SimState:
    """A ``SimState`` of numpy arrays in the reference's dtypes."""
    out = {f: getattr(state, f).detach().cpu().numpy()
           for f in SimState._fields}
    out["key"] = out["key"].astype(np.uint32)
    return SimState(**out)


def traffic_state_from_numpy(state, device="cuda") -> TrafficState:
    """The port's ``TrafficState`` from the reference's fields."""
    dev = resolve_device(device)
    return TrafficState(**{f: _tensor(getattr(state, f), dev)
                           for f in TrafficState._fields})


def traffic_state_to_numpy(state: TrafficState) -> TrafficState:
    """A ``TrafficState`` of numpy arrays."""
    return TrafficState(**{f: getattr(state, f).detach().cpu().numpy()
                           for f in TrafficState._fields})
