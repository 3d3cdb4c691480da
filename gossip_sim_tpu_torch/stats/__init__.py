"""Statistics suite (reference: gossip_stats.rs).

The port's own copy of the single-origin statistics layer: histograms,
series summaries, hop/stranded collections, message trackers and the
per-simulation ``GossipStats`` hub, the all-origins aggregates
(``AllOriginsStats``) and the concurrent-traffic series and records
(``TrafficStats``).
"""

from .aggregate import AllOriginsStats
from .collections import StatCollection
from .gossip_stats import GossipStats, GossipStatsCollection, SimulationParameters
from .histogram import Histogram
from .hops import HopsStat, HopsStatCollection
from .stranded import StrandedNodeCollection, StrandedNodeStats
from .trackers import EgressIngressMessageTracker, branching_factor_outbound
from .traffic import TrafficStats, TrafficStatsCollection

__all__ = [
    "AllOriginsStats",
    "EgressIngressMessageTracker",
    "GossipStats",
    "GossipStatsCollection",
    "Histogram",
    "HopsStat",
    "HopsStatCollection",
    "SimulationParameters",
    "StatCollection",
    "StrandedNodeCollection",
    "StrandedNodeStats",
    "TrafficStats",
    "TrafficStatsCollection",
    "branching_factor_outbound",
]
