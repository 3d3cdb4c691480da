"""Simulation-state checkpoints: the reference package's v9 ``.npz``
format, read and written by the port (the port's copy of the reference's
``checkpoint.py``).

One ``.npz`` holds every array of a ``SimState`` (or, ``kind="traffic"``,
of a ``TrafficState``) as ``state.<field>``, plus a JSON ``__meta__``
block: the format version, the state kind, the ``EngineParams`` the state
evolved under, the impairment, pull, traffic, adaptive, health and
representation knobs, the iteration the state is at, the run journal's
cross-reference (resilience.py) and the ``Config``.  A file written here
is read by the reference's ``load_state``/``restore_sim_state``/
``restore_traffic_state`` as its own, and the reverse:

* the arrays carry the reference's dtypes: the threefry ``key`` goes out
  as uint32 words and comes back as the port's int64 words
  (``convert.state_to_numpy``/``state_from_numpy``);
* ``params`` holds the reference's keys and values: the one field the
  port's ``EngineParams`` does not carry (``pa_slots``, the reference's
  prune-apply budget) is written with the reference's default;
* ``config`` holds the port's own ``Config`` fields; the reference's
  single-run resume reads only the fields both have (its drift warnings).

Loading validates the shape-defining params, so a resumed run cannot
continue under another geometry, and warns where a schedule knob differs.
Every older version stays readable (``_READABLE_VERSIONS``), with the
reference's backfills: v1 files lack ``tfail``/``rc_shi``/``rc_slo``
(derived from the state and the cluster tables); pre-v3 files lack the
impairment block (all off), pre-v4 the pull accumulators (zeros: no pull
round ran) and block (mode push), pre-v5 the journal block, pre-v6 the
traffic block and the kind (sim), pre-v7 the adaptive bits and counters
(zeros), pre-v8 the health planes (zeros) and pre-v9 the representation
(dense).  The sparse representation carries ``rc_shi``/``rc_slo`` at zero
width (``[O, N, 0]``): restoring dense from a sparse file re-derives them
from the tables, restoring sparse collapses stored planes.  Both
representations give the same bits, so a resume may switch.

Writes are atomic (a temporary file in the target directory, then
``os.replace``).  The ``restore_*`` entry points build tensors on
``device``, ``cuda`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from types import SimpleNamespace

import numpy as np

from .convert import (state_from_numpy, state_to_numpy,
                      traffic_state_from_numpy, traffic_state_to_numpy)
from .engine.params import EngineParams

log = logging.getLogger(__name__)

_FORMAT_VERSION = 9
_READABLE_VERSIONS = (1, 2, 3, 4, 5, 6, 7, 8, 9)

#: the reference's ``EngineParams`` fields the port's lacks, with the
#: reference's defaults: a port file's ``params`` block has the reference's
#: keys and values
_REFERENCE_ONLY_PARAMS = {"pa_slots": 8}

# EngineParams fields that define array shapes; a mismatch makes the stored
# state unusable under the new geometry.
_SHAPE_FIELDS = ("num_nodes", "active_set_size", "rc_slots", "hist_bins")

# The schedule blocks (v3 impair, v4 pull, v6 traffic, v7 adaptive, v8
# health, v9 repr).  Every decision of the engine is a stateless counter
# hash of (impair_seed, iteration, ids), so the recorded knobs and the
# stored state determine a bit-exact continuation; the backfills of older
# files derive from the engine's own defaults.
_IMPAIR_FIELDS = ("packet_loss_rate", "churn_fail_rate",
                  "churn_recover_rate", "partition_at", "heal_at",
                  "impair_seed")
_PULL_FIELDS = ("gossip_mode", "pull_fanout", "pull_interval",
                "pull_bloom_fp_rate", "pull_request_cap")
_TRAFFIC_FIELDS = ("traffic_values", "traffic_rate", "node_ingress_cap",
                   "node_egress_cap", "traffic_stall_rounds")
_ADAPTIVE_FIELDS = ("adaptive_switch_threshold", "adaptive_switch_hysteresis")
_HEALTH_FIELDS = ("health",)
_REPR_FIELDS = ("representation",)


def _defaults(fields) -> dict:
    return {f: EngineParams._field_defaults[f] for f in fields}


_IMPAIR_DEFAULTS = _defaults(_IMPAIR_FIELDS)
_PULL_DEFAULTS = _defaults(_PULL_FIELDS)
_TRAFFIC_DEFAULTS = _defaults(_TRAFFIC_FIELDS)
_ADAPTIVE_DEFAULTS = _defaults(_ADAPTIVE_FIELDS)
_HEALTH_DEFAULTS = _defaults(_HEALTH_FIELDS)
_REPR_DEFAULTS = _defaults(_REPR_FIELDS)

# shape-defining fields of kind="traffic" files (TrafficState arrays are
# [V, N, ...]; hist_bins never shapes them)
_TRAFFIC_SHAPE_FIELDS = ("num_nodes", "active_set_size", "rc_slots",
                         "traffic_values")

#: (meta block, its fields, its defaults, what a differing knob means)
_SCHEDULES = (
    ("impair", _IMPAIR_FIELDS, _IMPAIR_DEFAULTS,
     "the continuation's impairment schedule diverges from the original "
     "run"),
    ("pull", _PULL_FIELDS, _PULL_DEFAULTS,
     "the continuation's pull schedule diverges from the original run"),
    ("traffic", _TRAFFIC_FIELDS, _TRAFFIC_DEFAULTS,
     "the continuation's traffic schedule diverges from the original run"),
    ("adaptive", _ADAPTIVE_FIELDS, _ADAPTIVE_DEFAULTS,
     "the continuation's adaptive switch schedule diverges from the "
     "original run"),
    ("health", _HEALTH_FIELDS, _HEALTH_DEFAULTS,
     "the health planes cover only the rounds run under an enabled gate"),
)


def _params_dict(params) -> dict:
    """``params`` as the reference's ``params._asdict()`` would give it."""
    pdict = dict(params._asdict())
    for f, v in _REFERENCE_ONLY_PARAMS.items():
        pdict.setdefault(f, v)
    return pdict


def _state_arrays(state, kind: str) -> dict:
    to_numpy = state_to_numpy if kind == "sim" else traffic_state_to_numpy
    host = to_numpy(state)
    return {f"state.{name}": getattr(host, name) for name in host._fields}


def save_state(path: str, state, params, config=None,
               iteration: int = 0, resilience: dict | None = None,
               kind: str = "sim", extra_meta: dict | None = None) -> None:
    """Write a SimState (``kind="sim"``) or TrafficState (``"traffic"``)
    and its EngineParams (and the Config, if given) to one ``.npz``.

    ``iteration`` records how many rounds produced the state; a resumed
    run continues from there (the round keys fold in the absolute
    iteration, so the continuation is bit-exact).  ``resilience`` names the
    journal alongside and its committed units (v5); ``extra_meta`` merges
    more JSON blocks into the meta (the serialized TrafficStats)."""
    arrays = _state_arrays(state, kind)
    pdict = _params_dict(params)
    meta = {
        "format_version": _FORMAT_VERSION,
        "kind": str(kind),
        "params": pdict,
    }
    for block, fields, defaults, _ in _SCHEDULES:
        meta[block] = {f: pdict.get(f, defaults[f]) for f in fields}
    meta["repr"] = {f: pdict.get(f, _REPR_DEFAULTS[f]) for f in _REPR_FIELDS}
    meta["iteration"] = int(iteration)
    meta["resilience"] = dict(resilience or {})
    if extra_meta:
        meta.update(extra_meta)
    if config is not None:
        cfg = dict(vars(config))
        cfg["test_type"] = str(cfg["test_type"])
        cfg["step_size"] = str(cfg["step_size"])
        meta["config"] = cfg
    if not path.endswith(".npz"):
        path += ".npz"   # np.savez would append it; make the target explicit
    atomic_savez(path, __meta__=np.frombuffer(json.dumps(meta).encode(),
                                              dtype=np.uint8), **arrays)
    log.info("checkpoint saved: %s (%s arrays)", path, len(arrays))


def atomic_savez(path: str, **arrays) -> None:
    """``np.savez_compressed`` of ``arrays`` to ``path``, atomically: a
    temporary file in the target directory, then ``os.replace``."""
    fd, tmp = tempfile.mkstemp(
        suffix=".npz", prefix=".ckpt-", dir=os.path.dirname(path) or ".")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_state(path: str, params=None, expect_kind=None):
    """Read a checkpoint -> (state-field dict of numpy arrays, stored-params
    dict, meta).

    With ``params`` the shape-defining fields are validated against the
    stored ones (a mismatch raises ``ValueError``) and each differing
    schedule knob logs a warning.  ``expect_kind`` ("sim"/"traffic")
    rejects a file of the other kind before the shape check, so its
    guidance wins over a confusing shape mismatch."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("format_version") not in _READABLE_VERSIONS:
            raise ValueError(
                f"unsupported checkpoint version {meta.get('format_version')}")
        arrays = {k[len("state."):]: z[k] for k in z.files
                  if k.startswith("state.")}
    stored = meta["params"]
    meta.setdefault("impair", dict(_IMPAIR_DEFAULTS))
    meta.setdefault("pull", dict(_PULL_DEFAULTS))
    meta.setdefault("resilience", {})
    meta.setdefault("traffic", dict(_TRAFFIC_DEFAULTS))
    meta.setdefault("adaptive", dict(_ADAPTIVE_DEFAULTS))
    meta.setdefault("health", dict(_HEALTH_DEFAULTS))
    meta.setdefault("repr", dict(_REPR_DEFAULTS))
    meta.setdefault("kind", "sim")
    if expect_kind is not None and meta["kind"] != expect_kind:
        hint = ("restore_traffic_state / the --traffic-values run path"
                if meta["kind"] == "traffic" else "restore_sim_state")
        raise ValueError(
            f"checkpoint {path} holds a {meta['kind']!r}-kind state, not "
            f"{expect_kind!r}; resume it with the matching run mode "
            f"({hint})")
    if params is not None:
        shape_fields = (_TRAFFIC_SHAPE_FIELDS if meta["kind"] == "traffic"
                        else _SHAPE_FIELDS)
        for f in shape_fields:
            if getattr(params, f) != stored[f]:
                raise ValueError(
                    f"checkpoint {f}={stored[f]} != current {getattr(params, f)}")
        for block, fields, defaults, why in _SCHEDULES:
            for f in fields:
                now = getattr(params, f, defaults[f])
                if now != meta[block][f]:
                    log.warning(
                        "WARNING: resuming with %s=%s but checkpoint was "
                        "written with %s — %s", f, now, meta[block][f], why)
        for f in _REPR_FIELDS:
            now = getattr(params, f, _REPR_DEFAULTS[f])
            if now != meta["repr"][f]:
                log.info(
                    "resuming with %s=%s but checkpoint was written with %s "
                    "— both representations are bit-identical, so the "
                    "continuation is exact; the rc stake planes are "
                    "re-derived to match the new shape",
                    f, now, meta["repr"][f])
    return arrays, stored, meta


def _backfill_sim(arrays: dict, stored: dict, params, tables) -> None:
    """The reference's backfills of older files and the v9 representation
    switch, in place (restore_sim_state)."""
    from .engine.core import SimState

    o, n = arrays["failed"].shape
    h = int(stored.get("hist_bins", EngineParams._field_defaults["hist_bins"]))
    # pre-v4 files were written by the push-only engine: the pull
    # accumulators are exactly zero (no pull round ever ran)
    arrays.setdefault("pull_hops_hist_acc", np.zeros((o, h), np.int32))
    arrays.setdefault("pull_rescued_acc", np.zeros((o, n), np.int32))
    # pre-v7: the adaptive direction bit was identically False
    arrays.setdefault("adaptive_pull_on", np.zeros((o,), bool))
    # pre-v8: the gated-off engine carries the health planes as zeros
    for f in ("health_prune_recv", "health_first_round"):
        arrays.setdefault(f, np.zeros((o, n), np.int32))
    # v9: the sparse round carries the rc stake planes at zero width
    target_repr = (getattr(params, "representation", None)
                   if params is not None else None)
    if target_repr is None:
        target_repr = stored.get("representation", "dense")
    if target_repr == "sparse":
        n_nodes = stored["num_nodes"]
        arrays["rc_shi"] = np.zeros((o, n_nodes, 0), np.int32)
        arrays["rc_slo"] = np.zeros((o, n_nodes, 0), np.int32)
    else:
        for f in ("rc_shi", "rc_slo"):
            if f in arrays and arrays[f].ndim == 3 \
                    and arrays[f].shape[-1] == 0:
                del arrays[f]
    missing = set(SimState._fields) - set(arrays)
    if missing and missing <= {"tfail", "rc_shi", "rc_slo"} \
            and tables is not None:
        n_nodes = stored["num_nodes"]
        active = arrays["active"]                      # [O, N, S], N = empty
        failed = arrays["failed"]                      # [O, N] bool
        stakes = tables.stakes.detach().cpu().numpy()  # [N+1], pad 0 at N
        if "tfail" in missing:
            pad_failed = np.concatenate(
                [failed, np.zeros((failed.shape[0], 1), bool)], axis=1)
            arrays["tfail"] = np.take_along_axis(
                pad_failed[:, :, None], np.minimum(active, n_nodes), axis=1)
        if "rc_shi" in missing or "rc_slo" in missing:
            rc_stake = stakes[np.minimum(arrays["rc_src"], n_nodes)]
            arrays["rc_shi"] = (rc_stake >> 31).astype(np.int32)
            arrays["rc_slo"] = (rc_stake & 0x7FFFFFFF).astype(np.int32)
        missing = set(SimState._fields) - set(arrays)
    if missing:
        raise ValueError(f"checkpoint missing fields: {sorted(missing)}")


def restore_sim_state(path: str, params=None, tables=None, device="cuda"):
    """Read a checkpoint -> (``SimState`` on ``device``, stored-params dict,
    meta).  ``tables`` (a ``ClusterTables``) lets v1 files, and sparse
    files resumed dense, derive ``tfail``/``rc_shi``/``rc_slo``."""
    arrays, stored, meta = load_state(path, params, expect_kind="sim")
    _backfill_sim(arrays, stored, params, tables)
    return state_from_numpy(SimpleNamespace(**arrays), device), stored, meta


def save_traffic_state(path: str, state, params, config=None,
                       iteration: int = 0,
                       traffic_stats: dict | None = None) -> None:
    """Write a ``kind="traffic"`` checkpoint: the TrafficState and the
    serialized TrafficStats (``TrafficStats.state_dict``), so a resumed run
    re-reports the rounds and retirements before the interruption."""
    save_state(path, state, params, config=config, iteration=iteration,
               kind="traffic",
               extra_meta={"traffic_stats": traffic_stats or {}})


def restore_traffic_state(path: str, params=None, device="cuda"):
    """Read a ``kind="traffic"`` checkpoint -> (``TrafficState`` on
    ``device``, stored-params dict, meta); ``meta["traffic_stats"]``
    carries the TrafficStats snapshot."""
    from .engine.traffic import TrafficState

    arrays, stored, meta = load_state(path, params, expect_kind="traffic")
    v = arrays["v_live"].shape[0]
    n = arrays["failed"].shape[0]
    # pre-v7: no pull phase ran and no per-value drop was recorded;
    # pre-v8: the gated-off engine carries the health planes as zeros
    arrays.setdefault("v_pull", np.zeros((v,), bool))
    arrays.setdefault("v_rescued", np.zeros((v,), np.int32))
    arrays.setdefault("v_qdrop", np.zeros((v,), np.int32))
    for f in ("health_prune_recv", "health_lat_acc", "health_del_acc",
              "health_rescued_acc"):
        arrays.setdefault(f, np.zeros((n,), np.int32))
    missing = set(TrafficState._fields) - set(arrays)
    if missing:
        raise ValueError(f"traffic checkpoint missing fields: "
                         f"{sorted(missing)}")
    state = traffic_state_from_numpy(SimpleNamespace(**arrays), device)
    meta.setdefault("traffic_stats", {})
    return state, stored, meta
