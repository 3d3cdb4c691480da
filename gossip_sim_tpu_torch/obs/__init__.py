"""Observability of the port: the node-health observatory (obs/health.py)
and the flight recorder (obs/trace.py, with the run report's schema name
and config block from obs/report.py).

The reference package's span registry, heartbeats, run report and
telemetry come with their ROADMAP items (A15, A16).
"""

from .health import (HEALTH_SCHEMA, build_node_health_section, digest_stack,
                     digest_stack_np, stake_decile_ids)
from .trace import (TRACE_SCHEMA, Trace, TraceWriter, load_trace,
                    validate_trace_dir, validate_trace_manifest)

__all__ = ["HEALTH_SCHEMA", "TRACE_SCHEMA", "Trace", "TraceWriter",
           "build_node_health_section", "digest_stack", "digest_stack_np",
           "load_trace", "stake_decile_ids", "validate_trace_dir",
           "validate_trace_manifest"]
