"""Observability of the port: the node-health observatory (obs/health.py).

The reference package's span registry, heartbeats, run report, telemetry
and flight recorder come with their ROADMAP items (A13, A15, A16).
"""

from .health import (HEALTH_SCHEMA, build_node_health_section, digest_stack,
                     digest_stack_np, stake_decile_ids)

__all__ = ["HEALTH_SCHEMA", "build_node_health_section", "digest_stack",
           "digest_stack_np", "stake_decile_ids"]
