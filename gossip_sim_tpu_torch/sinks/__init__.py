"""Metrics sinks (reference: influx_db.rs)."""

from .influx import (DatapointQueue, InfluxDataPoint, InfluxDB, InfluxThread,
                     Tracker, deterministic_wire_lines, load_dotenv)

__all__ = ["DatapointQueue", "InfluxDataPoint", "InfluxDB", "InfluxThread",
           "Tracker", "deterministic_wire_lines", "load_dotenv"]
