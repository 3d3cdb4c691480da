"""The run report's schema name and JSON-safe ``Config`` block: the part
of the reference package's ``obs/report.py`` (lines 81, 119-138) that the
flight recorder's manifest embeds (obs/trace.py).  The run report itself
comes with ROADMAP A15, which extends this module."""

from __future__ import annotations

import dataclasses
import enum

RUN_REPORT_SCHEMA = "gossip-sim-tpu/run-report/v1"


def _jsonable(value):
    """Best-effort JSON-safe conversion (enums/StepSize -> str)."""
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, enum.Enum):
        return str(value)
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set)):
        return [_jsonable(v) for v in value]
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: _jsonable(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    return str(value)


def config_dict(config) -> dict:
    """A Config dataclass as a JSON-safe dict."""
    return _jsonable(config)
