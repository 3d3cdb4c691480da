"""Protocol flight recorder: message-level delivery/prune traces.

The port's own copy of the reference package's ``obs/trace.py`` (its
``OracleTraceCollector`` comes with the oracle backend, ROADMAP A18).  The
stats layer answers *what* a topology did (coverage, RMR, LDH, stranded
counts); this module records *why*: with ``--trace-dir`` set, every
measured round's protocol events are captured as fixed-shape arrays inside
the engine's round (the trace outputs of the ``push_targets``, ``rotate``
and ``pull_exchange`` kernels and the ``trace_prune_pairs`` kernel) and
written as versioned ``.npz`` segments plus a JSON manifest, so any run
can be replayed and root-caused offline with ``tools/trace_report.py`` —
no re-run with print statements.  A trace written here is the reference
package's format: each package's ``load_trace``/``validate_trace_dir``
reads the other's.

Per traced round (leading axes ``[rounds, O]``; node ids are int16,
``-1`` = none/empty):

* ``peers``   [O,N,F]  candidate push target per fanout slot — the first F
                       valid (unpruned, non-origin) active-set slots, the
                       exact list verb 1 pushed through this round
* ``code``    [O,N,F]  per-slot outcome: 0 empty, 1 deliverable candidate,
                       2 failed target, 3 partition-suppressed, 4 loss-
                       dropped (precedence matches faults.classify_edge);
                       a candidate actually delivers iff its source was
                       reached this round (``dist[src] >= 0``)
* ``dist``    [O,N]    hop distance from the origin (-1 unreached)
* ``first_src`` [O,N]  first-delivery sender: the minimum (hop, src-index)
                       inbound edge — identical to the reference's
                       (hops, pubkey-string) consume ranking because
                       NodeIndex assigns indices in pubkey-string order
* ``failed``  [O,N]    node-failure mask after this round's churn/fail step
* ``rot``     [O,N]    rotation events: the rotated-in peer id
* ``active``  [O,N,S]  PRE-round active-set snapshot (what verb 1 consulted)
* ``pruned``  [O,N,S]  PRE-round per-slot pruned bits for this origin
* ``prune_src``/``prune_dst`` [O,P]  prune pairs emitted this round
                       (pruner, prunee); P = ``EngineParams.prune_cap``
                       slots, overflow flagged in the manifest, never
                       silently dropped
* ``coverage`` [O]     fraction reached (cross-check vs the stats layer)
* ``prunes_total`` [O] total prune messages (the ``prunes_sent`` row)

Segments are written atomically (temp + ``os.replace``, like checkpoints)
and named by round range, so a ``--resume`` continuation appends new
segments without duplicating or losing already-traced rounds.  The
manifest (``manifest.json``, schema ``gossip-sim-tpu/trace/v4``) is keyed
to the run-report schema from obs/report.py: it embeds the same JSON-safe
``config`` block and cross-references ``run_report_schema`` so a trace and
its run report can always be joined on (seed, config, round range).

Everything here is numpy-only (the traffic codes come from ``traffic.py``
when a writer is built).
"""

from __future__ import annotations

import json
import logging
import os
import tempfile

import numpy as np

from ..pull import PULL_CODE_NAMES
from .report import RUN_REPORT_SCHEMA, config_dict

log = logging.getLogger("gossip_sim_tpu_torch.obs")

# v2 (pull-gossip subsystem): adds the pull request/response event arrays
# (``pull_peers``/``pull_code``/``pull_hop``) plus the ``gossip_mode`` /
# ``pull_slots`` manifest keys.  v3 (concurrent traffic, traffic.py): adds
# the value-id column — traffic-mode traces carry per-value-slot event
# arrays (``value_id``/``value_origin`` identify each slot's in-flight
# value per round; delivery and prune arrays gain a leading V axis) and
# the ``traffic_slots`` manifest key.  v4 (adaptive push-pull,
# adaptive.py): adds the switch-round events — single-origin adaptive
# traces carry the per-round direction bit (``adaptive_on``), traffic
# adaptive traces the per-value phase bit (``value_pull``) and per-node
# rescue deliveries (``pull_hop`` with a V axis).  New traces are written
# as v4 (adaptive arrays present only under gossip_mode "adaptive");
# v1/v2/v3 remain readable.
TRACE_SCHEMA_V1 = "gossip-sim-tpu/trace/v1"
TRACE_SCHEMA_V2 = "gossip-sim-tpu/trace/v2"
TRACE_SCHEMA_V3 = "gossip-sim-tpu/trace/v3"
TRACE_SCHEMA = "gossip-sim-tpu/trace/v4"
READABLE_SCHEMAS = (TRACE_SCHEMA_V1, TRACE_SCHEMA_V2, TRACE_SCHEMA_V3,
                    TRACE_SCHEMA)
MANIFEST_NAME = "manifest.json"

# per-slot outcome codes (the push_targets kernel's trace output, engine/
# core.py; precedence: failed target > suppressed > dropped)
TRACE_EMPTY = 0
TRACE_CANDIDATE = 1
TRACE_FAILED_TARGET = 2
TRACE_SUPPRESSED = 3
TRACE_DROPPED = 4
TRACE_CODE_NAMES = {
    TRACE_EMPTY: "empty",
    TRACE_CANDIDATE: "candidate",
    TRACE_FAILED_TARGET: "failed_target",
    TRACE_SUPPRESSED: "suppressed",
    TRACE_DROPPED: "dropped",
}

#: segment arrays: name -> (on-disk dtype, symbolic per-round shape suffix).
#: Dims: N nodes, F push fanout, S active-set size, P prune_cap.
ARRAY_SPECS = {
    "peers": ("int16", ("N", "F")),
    "code": ("int8", ("N", "F")),
    "dist": ("int16", ("N",)),
    "first_src": ("int16", ("N",)),
    "failed": ("bool", ("N",)),
    "rot": ("int16", ("N",)),
    "active": ("int16", ("N", "S")),
    "pruned": ("bool", ("N", "S")),
    "prune_src": ("int16", ("P",)),
    "prune_dst": ("int16", ("P",)),
    "coverage": ("float32", ()),
    "prunes_total": ("int32", ()),
}

#: v2 pull-phase arrays (pull.py), present when the manifest's
#: ``gossip_mode`` includes a pull phase.  Dims: Q = pull_slots.
PULL_ARRAY_SPECS = {
    "pull_peers": ("int16", ("N", "Q")),
    "pull_code": ("int8", ("N", "Q")),
    "pull_hop": ("int16", ("N",)),
}

#: v3 concurrent-traffic arrays (traffic.py), used INSTEAD of the base
#: specs when the manifest's ``traffic_slots`` > 0.  Dims: V = value
#: slots.  ``value_id``/``value_origin`` are the value-id column: the
#: per-round identity of each slot's in-flight value (-1 = free slot), so
#: every delivery/prune event row is value-attributable.
TRAFFIC_ARRAY_SPECS = {
    "peers": ("int16", ("V", "N", "F")),
    "code": ("int8", ("V", "N", "F")),
    "dist": ("int16", ("V", "N")),
    "first_src": ("int16", ("V", "N")),
    "failed": ("bool", ("N",)),
    "active": ("int16", ("N", "S")),
    "pruned": ("bool", ("V", "N", "S")),
    "prune_src": ("int16", ("V", "P")),
    "prune_dst": ("int16", ("V", "P")),
    "value_id": ("int32", ("V",)),
    "value_origin": ("int16", ("V",)),
    "prunes_total": ("int32", ("V",)),
}

#: v4 adaptive arrays (adaptive.py), present when the manifest's
#: ``gossip_mode`` is "adaptive".  Single-origin traces carry the
#: per-round direction bit; traffic traces the per-value phase bit plus
#: the per-node rescue deliveries (hop, -1 = no rescue) that make every
#: rescue attributable to its value slot (stats/edges.py).
ADAPTIVE_ARRAY_SPECS = {
    "adaptive_on": ("int8", ()),
}
TRAFFIC_ADAPTIVE_ARRAY_SPECS = {
    "value_pull": ("int8", ("V",)),
    "pull_hop": ("int16", ("V", "N")),
}

#: every array name a non-traffic readable schema can carry
ALL_ARRAY_SPECS = {**ARRAY_SPECS, **PULL_ARRAY_SPECS,
                   **ADAPTIVE_ARRAY_SPECS}
#: every array name a traffic readable schema can carry
ALL_TRAFFIC_ARRAY_SPECS = {**TRAFFIC_ARRAY_SPECS,
                           **TRAFFIC_ADAPTIVE_ARRAY_SPECS}


def specs_for_manifest(manifest: dict) -> dict:
    """The array-spec dict a manifest's schema/mode implies (v1 manifests
    and v2 push-mode manifests carry the base arrays only; v3+ traffic
    manifests — ``traffic_slots`` > 0 — the traffic arrays; v4 adaptive
    manifests additionally the switch-event arrays)."""
    if int(manifest.get("traffic_slots") or 0) > 0:
        return {name: ALL_TRAFFIC_ARRAY_SPECS[name]
                for name in (manifest.get("arrays") or TRAFFIC_ARRAY_SPECS)
                if name in ALL_TRAFFIC_ARRAY_SPECS}
    return {name: ALL_ARRAY_SPECS[name]
            for name in (manifest.get("arrays") or ARRAY_SPECS)
            if name in ALL_ARRAY_SPECS}


#: engine row name -> segment array name (detail + trace rows, cli harvest)
_ENGINE_ROW_MAP = {
    "trace_peers": "peers",
    "trace_code": "code",
    "dist": "dist",
    "trace_first": "first_src",
    "failed_mask": "failed",
    "trace_rot": "rot",
    "trace_active": "active",
    "trace_pruned": "pruned",
    "trace_prune_src": "prune_src",
    "trace_prune_dst": "prune_dst",
    "coverage": "coverage",
    "prunes_sent": "prunes_total",
}

#: engine trace rows -> v2 pull arrays (only emitted under pull modes)
_ENGINE_PULL_ROW_MAP = {
    "trace_pull_peers": "pull_peers",
    "trace_pull_code": "pull_code",
    "pull_hop": "pull_hop",
}

#: traffic-engine trace rows (engine/traffic.py) -> v3 traffic arrays
_TRAFFIC_ENGINE_ROW_MAP = {
    "trace_peers": "peers",
    "trace_code": "code",
    "t_hop": "dist",
    "trace_first": "first_src",
    "trace_failed": "failed",
    "trace_active": "active",
    "trace_pruned": "pruned",
    "trace_prune_src": "prune_src",
    "trace_prune_dst": "prune_dst",
    "trace_vid": "value_id",
    "trace_origin": "value_origin",
    "trace_prunes": "prunes_total",
}

_MATCH_KEYS = ("schema", "backend", "num_nodes", "push_fanout",
               "active_set_size", "prune_cap", "seed", "origins",
               "gossip_mode", "pull_slots", "traffic_slots")


#: adaptive engine trace rows (mode "adaptive") -> v4 arrays
_ENGINE_ADAPTIVE_ROW_MAP = {
    "adaptive_pull_active": "adaptive_on",
}
_TRAFFIC_ADAPTIVE_ROW_MAP = {
    "trace_value_pull": "value_pull",
    "trace_pull_hop": "pull_hop",
}


def block_from_engine_rows(rows) -> dict:
    """Engine harvest rows (numpy, ``[R, O, ...]``) -> writer block dict.
    Pull-phase and adaptive rows ride along when the engine emitted them
    (pull / adaptive modes)."""
    block = {seg: np.asarray(rows[eng])
             for eng, seg in _ENGINE_ROW_MAP.items()}
    for rowmap in (_ENGINE_PULL_ROW_MAP, _ENGINE_ADAPTIVE_ROW_MAP):
        for eng, seg in rowmap.items():
            if eng in rows:
                block[seg] = np.asarray(rows[eng])
    return block


def traffic_block_from_engine_rows(rows) -> dict:
    """Traffic-engine harvest rows (numpy, ``[R, V, ...]``) -> writer
    block dict for a ``traffic_slots > 0`` (v3+) trace; the v4 adaptive
    arrays ride along under gossip_mode "adaptive"."""
    block = {seg: np.asarray(rows[eng])
             for eng, seg in _TRAFFIC_ENGINE_ROW_MAP.items()}
    for eng, seg in _TRAFFIC_ADAPTIVE_ROW_MAP.items():
        if eng in rows:
            block[seg] = np.asarray(rows[eng])
    return block


def _atomic_write_bytes(path: str, payload: bytes) -> None:
    fd, tmp = tempfile.mkstemp(prefix=".trace-",
                               dir=os.path.dirname(path) or ".")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _atomic_savez(path: str, arrays: dict) -> int:
    fd, tmp = tempfile.mkstemp(suffix=".npz", prefix=".trace-",
                               dir=os.path.dirname(path) or ".")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        size = os.path.getsize(tmp)
        os.replace(tmp, path)
        return size
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class TraceWriter:
    """Incremental flight-recorder writer: one ``.npz`` segment per harvest
    block, one merged ``manifest.json`` (updated after every segment so a
    killed run still leaves a loadable trace).

    On construction against a directory that already holds a manifest for
    the *same* run geometry (num_nodes, fanout, seed, origins, backend, ...)
    existing segments are kept and new ones merged in — the ``--resume``
    composition contract: a checkpoint restart appends the remaining rounds
    without duplicating or losing already-traced ones.  A mismatched
    manifest is replaced (with a warning).
    """

    #: node ids are stored int16, so the writer refuses a larger cluster
    MAX_TRACE_NODES = 32767

    def __init__(self, trace_dir: str, *, backend: str, num_nodes: int,
                 push_fanout: int, active_set_size: int, prune_cap: int,
                 origins, origin_pubkeys, seed: int, warm_up_rounds: int,
                 iterations: int, config=None, gossip_mode: str = "push",
                 pull_slots: int = 0, traffic_slots: int = 0):
        if num_nodes > self.MAX_TRACE_NODES:
            raise ValueError(
                f"trace arrays store node ids as int16; num_nodes must be "
                f"<= {self.MAX_TRACE_NODES}, got {num_nodes}")
        self.trace_dir = trace_dir
        os.makedirs(trace_dir, exist_ok=True)
        if traffic_slots > 0:
            # v3 traffic mode: value-slot event arrays; there is no origin
            # column (values carry their own origins per round)
            self.array_specs = dict(TRAFFIC_ARRAY_SPECS)
            if gossip_mode == "adaptive":
                self.array_specs.update(TRAFFIC_ADAPTIVE_ARRAY_SPECS)
        else:
            self.array_specs = dict(ARRAY_SPECS)
            if gossip_mode != "push":
                self.array_specs.update(PULL_ARRAY_SPECS)
            if gossip_mode == "adaptive":
                self.array_specs.update(ADAPTIVE_ARRAY_SPECS)
        from ..traffic import TRAFFIC_CODE_NAMES
        self.manifest = {
            "schema": TRACE_SCHEMA,
            "run_report_schema": RUN_REPORT_SCHEMA,
            "backend": str(backend),
            "num_nodes": int(num_nodes),
            "push_fanout": int(push_fanout),
            "active_set_size": int(active_set_size),
            "prune_cap": int(prune_cap),
            "gossip_mode": str(gossip_mode),
            "pull_slots": int(pull_slots) if gossip_mode != "push" else 0,
            "traffic_slots": int(traffic_slots),
            "origins": [int(o) for o in origins],
            "origin_pubkeys": [str(p) for p in origin_pubkeys],
            "seed": int(seed),
            "warm_up_rounds": int(warm_up_rounds),
            "iterations": int(iterations),
            "codes": ({str(k): v for k, v in TRAFFIC_CODE_NAMES.items()}
                      if traffic_slots > 0 else
                      {str(k): v for k, v in TRACE_CODE_NAMES.items()}),
            "pull_codes": {str(k): v for k, v in PULL_CODE_NAMES.items()},
            "arrays": {name: {"dtype": dt, "dims": list(dims)}
                       for name, (dt, dims) in self.array_specs.items()},
            "config": config_dict(config) if config is not None else {},
            "segments": [],
        }
        prior = self._load_existing_manifest()
        if prior is not None:
            self.manifest["segments"] = prior.get("segments", [])

    # -- resume merge -----------------------------------------------------

    def _load_existing_manifest(self):
        path = os.path.join(self.trace_dir, MANIFEST_NAME)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                prior = json.load(f)
        except (OSError, ValueError) as e:
            log.warning("WARNING: unreadable trace manifest %s (%s); "
                        "starting a fresh trace", path, e)
            return None
        mismatch = [k for k in _MATCH_KEYS
                    if prior.get(k) != self.manifest.get(k)]
        if mismatch:
            log.warning("WARNING: existing trace in %s was recorded under a "
                        "different run (%s differ); replacing it",
                        self.trace_dir, ", ".join(mismatch))
            return None
        log.info("trace: resuming into %s (%s prior segment(s) kept)",
                 self.trace_dir, len(prior.get("segments", [])))
        return prior

    # -- segments ---------------------------------------------------------

    def add_block(self, start_round: int, block: dict) -> dict:
        """Write one harvest block (arrays ``[R, O, ...]``) as a segment.

        Returns a summary dict: file, round range, delivered-edge / prune
        counts, bytes written, and the rounds whose prune capture hit the
        ``prune_cap`` truncation ceiling.
        """
        n_rounds = None
        out = {}
        for name, (dtype, _) in self.array_specs.items():
            if name not in block:
                raise ValueError(f"trace block missing array: {name}")
            arr = np.asarray(block[name])
            if n_rounds is None:
                n_rounds = arr.shape[0]
            elif arr.shape[0] != n_rounds:
                raise ValueError(
                    f"trace block round-axis mismatch for {name}: "
                    f"{arr.shape[0]} != {n_rounds}")
            out[name] = arr.astype(np.dtype(dtype), copy=False)
        start = int(start_round)
        end = start + int(n_rounds)
        out["rounds"] = np.arange(start, end, dtype=np.int32)

        delivered = int(np.count_nonzero(
            (out["code"] == TRACE_CANDIDATE)
            & (out["dist"] >= 0)[..., None]))
        captured_pairs = np.count_nonzero(out["prune_src"] >= 0,
                                          axis=-1)                 # [R, O]
        total_prunes = out["prunes_total"]
        truncated = sorted(
            int(out["rounds"][t])
            for t in range(n_rounds)
            if (total_prunes[t] > captured_pairs[t]).any())
        if truncated:
            log.warning("WARNING: trace prune capture truncated at "
                        "prune_cap=%s in round(s) %s — raise "
                        "EngineParams.trace_prune_cap for full prune "
                        "lineage", self.manifest["prune_cap"], truncated)

        fname = f"seg-{start:06d}-{end:06d}.npz"
        size = _atomic_savez(os.path.join(self.trace_dir, fname), out)
        summary = {
            "file": fname,
            "start_round": start,
            "end_round": end,
            "delivered_edges": delivered,
            "prunes": int(total_prunes.sum()),
            "truncated_prune_rounds": truncated,
            "bytes": size,
        }
        self._merge_segment(summary)
        self._write_manifest()
        return summary

    def _merge_segment(self, summary: dict) -> None:
        """Replace any existing segment overlapping the new round range
        (a resume re-running the same block overwrites it bit-identically;
        partially-overlapping stale segments are dropped, never doubled)."""
        s, e = summary["start_round"], summary["end_round"]
        kept = []
        for seg in self.manifest["segments"]:
            if seg["start_round"] < e and s < seg["end_round"]:
                if (seg["start_round"], seg["end_round"]) != (s, e):
                    log.warning("trace: dropping stale overlapping segment "
                                "%s", seg["file"])
                    try:
                        os.unlink(os.path.join(self.trace_dir, seg["file"]))
                    except OSError:
                        pass
                continue
            kept.append(seg)
        kept.append(summary)
        kept.sort(key=lambda g: g["start_round"])
        self.manifest["segments"] = kept

    def _write_manifest(self) -> None:
        payload = (json.dumps(self.manifest, indent=2) + "\n").encode()
        _atomic_write_bytes(os.path.join(self.trace_dir, MANIFEST_NAME),
                            payload)

    def finalize(self) -> dict:
        """Final manifest write; returns the manifest dict."""
        self._write_manifest()
        segs = self.manifest["segments"]
        rounds = sum(g["end_round"] - g["start_round"] for g in segs)
        log.info("trace: %s segment(s), %s round(s) in %s", len(segs),
                 rounds, self.trace_dir)
        return self.manifest


# --------------------------------------------------------------------------
# loading + validation
# --------------------------------------------------------------------------

class Trace:
    """A loaded trace: manifest + segment arrays concatenated on the round
    axis (``rounds[t]`` is the absolute round index of slice ``t``)."""

    def __init__(self, manifest: dict, rounds: np.ndarray, arrays: dict,
                 gaps=None):
        self.manifest = manifest
        self.rounds = rounds
        self.arrays = arrays
        self.gaps = list(gaps or [])

    def __len__(self):
        return int(self.rounds.shape[0])

    @property
    def num_nodes(self) -> int:
        return int(self.manifest["num_nodes"])

    @property
    def origins(self) -> list:
        return list(self.manifest["origins"])

    def col_of(self, origin: int) -> int:
        """Column index of an origin node id."""
        return self.origins.index(int(origin))

    def pos_of(self, round_idx: int) -> int:
        """Round-axis position of an absolute round index."""
        t = int(np.searchsorted(self.rounds, round_idx))
        if t >= len(self) or self.rounds[t] != round_idx:
            raise KeyError(f"round {round_idx} not in trace "
                           f"(have {self.rounds[0]}..{self.rounds[-1]})")
        return t

    def at(self, round_idx: int) -> dict:
        """All arrays for one absolute round: ``{name: [O, ...]}``."""
        t = self.pos_of(round_idx)
        return {name: arr[t] for name, arr in self.arrays.items()}


def load_trace(trace_dir: str) -> Trace:
    """Read ``manifest.json`` + every listed segment; concatenate on the
    round axis.  Raises on a missing/invalid manifest or segment; round
    gaps (e.g. a crashed run that never resumed) load fine and are listed
    in ``Trace.gaps``."""
    path = os.path.join(trace_dir, MANIFEST_NAME)
    with open(path) as f:
        manifest = json.load(f)
    problems = validate_trace_manifest(manifest)
    if problems:
        raise ValueError(f"invalid trace manifest {path}: {problems}")
    segs = sorted(manifest["segments"], key=lambda g: g["start_round"])
    if not segs:
        raise ValueError(f"trace {trace_dir} has no segments")
    specs = specs_for_manifest(manifest)
    rounds_parts, parts = [], {name: [] for name in specs}
    gaps = []
    prev_end = None
    for seg in segs:
        with np.load(os.path.join(trace_dir, seg["file"])) as z:
            rounds_parts.append(z["rounds"])
            for name in specs:
                parts[name].append(z[name])
        if prev_end is not None and seg["start_round"] != prev_end:
            gaps.append((prev_end, seg["start_round"]))
        prev_end = seg["end_round"]
    if gaps:
        log.warning("WARNING: trace %s has round gap(s): %s", trace_dir,
                    gaps)
    rounds = np.concatenate(rounds_parts)
    arrays = {name: np.concatenate(parts[name]) for name in specs}
    return Trace(manifest, rounds, arrays, gaps=gaps)


def validate_trace_manifest(manifest: dict) -> list:
    """Schema self-check: returns a list of problems (empty == valid)."""
    problems = []
    if not isinstance(manifest, dict):
        return [f"manifest is {type(manifest).__name__}, not dict"]
    if manifest.get("schema") not in READABLE_SCHEMAS:
        problems.append(f"unknown schema: {manifest.get('schema')!r}")
    for key, types in (("backend", str), ("num_nodes", int),
                       ("push_fanout", int), ("active_set_size", int),
                       ("prune_cap", int), ("origins", list),
                       ("origin_pubkeys", list), ("seed", int),
                       ("warm_up_rounds", int), ("iterations", int),
                       ("arrays", dict), ("segments", list),
                       ("config", dict)):
        if not isinstance(manifest.get(key), types):
            problems.append(f"key {key}: missing or not {types.__name__}")
    is_traffic = int(manifest.get("traffic_slots") or 0) > 0
    base_specs = TRAFFIC_ARRAY_SPECS if is_traffic else ARRAY_SPECS
    for name in base_specs:
        if name not in (manifest.get("arrays") or {}):
            problems.append(f"arrays entry missing: {name}")
    if manifest.get("schema") in (TRACE_SCHEMA_V2, TRACE_SCHEMA_V3,
                                  TRACE_SCHEMA):
        # v2+: mode + pull geometry are mandatory; pull arrays exist
        # exactly when the mode has a pull phase
        mode = manifest.get("gossip_mode")
        if mode not in ("push", "pull", "push-pull", "adaptive"):
            problems.append(f"v2 manifest: bad gossip_mode {mode!r}")
        if not isinstance(manifest.get("pull_slots"), int):
            problems.append("v2 manifest: pull_slots missing or not int")
        if mode in ("pull", "push-pull", "adaptive") and not is_traffic:
            for name in PULL_ARRAY_SPECS:
                if name not in (manifest.get("arrays") or {}):
                    problems.append(f"pull arrays entry missing: {name}")
    if (manifest.get("schema") in (TRACE_SCHEMA_V3, TRACE_SCHEMA)
            and is_traffic):
        # v3+ traffic manifests: the value-id column is mandatory
        for name in ("value_id", "value_origin"):
            if name not in (manifest.get("arrays") or {}):
                problems.append(f"traffic arrays entry missing: {name}")
    if manifest.get("schema") == TRACE_SCHEMA:
        # v4: adaptive manifests carry the switch-event arrays
        if manifest.get("gossip_mode") == "adaptive":
            need = (TRAFFIC_ADAPTIVE_ARRAY_SPECS if is_traffic
                    else ADAPTIVE_ARRAY_SPECS)
            for name in need:
                if name not in (manifest.get("arrays") or {}):
                    problems.append(
                        f"adaptive arrays entry missing: {name}")
    for seg in manifest.get("segments") or []:
        if (not isinstance(seg, dict) or "file" not in seg
                or "start_round" not in seg or "end_round" not in seg):
            problems.append(f"malformed segment entry: {seg!r}")
        elif seg["end_round"] <= seg["start_round"]:
            problems.append(f"empty/negative segment range: {seg['file']}")
    if (isinstance(manifest.get("origins"), list)
            and isinstance(manifest.get("origin_pubkeys"), list)
            and len(manifest["origins"]) != len(manifest["origin_pubkeys"])):
        problems.append("origins / origin_pubkeys length mismatch")
    try:
        json.dumps(manifest)
    except (TypeError, ValueError) as e:
        problems.append(f"not JSON-serializable: {e}")
    return problems


def validate_trace_dir(trace_dir: str) -> list:
    """Manifest validation + on-disk segment existence/shape checks."""
    path = os.path.join(trace_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return [f"no {MANIFEST_NAME} in {trace_dir}"]
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return [f"unreadable manifest: {e}"]
    problems = validate_trace_manifest(manifest)
    if problems:
        return problems
    n, f_, s, p = (manifest["num_nodes"], manifest["push_fanout"],
                   manifest["active_set_size"], manifest["prune_cap"])
    o = len(manifest["origins"])
    dim = {"N": n, "F": f_, "S": s, "P": p,
           "Q": manifest.get("pull_slots", 0),
           "V": manifest.get("traffic_slots", 0)}
    specs = specs_for_manifest(manifest)
    for seg in manifest["segments"]:
        fpath = os.path.join(trace_dir, seg["file"])
        if not os.path.exists(fpath):
            problems.append(f"segment file missing: {seg['file']}")
            continue
        r = seg["end_round"] - seg["start_round"]
        with np.load(fpath) as z:
            names = set(z.files)
            for name, (dtype, dims) in specs.items():
                if name not in names:
                    problems.append(f"{seg['file']}: missing array {name}")
                    continue
                # traffic (v3) arrays carry their own V axis in ``dims``
                # instead of the per-origin column
                want = ((r,) if dim["V"] > 0
                        else (r, o)) + tuple(dim[d] for d in dims)
                if z[name].shape != want:
                    problems.append(
                        f"{seg['file']}: {name} shape {z[name].shape} != "
                        f"{want}")
                if z[name].dtype != np.dtype(dtype):
                    problems.append(
                        f"{seg['file']}: {name} dtype {z[name].dtype} != "
                        f"{dtype}")
            if "rounds" not in names:
                problems.append(f"{seg['file']}: missing rounds axis")
    return problems
