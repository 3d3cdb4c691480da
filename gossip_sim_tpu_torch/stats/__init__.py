"""Statistics suite (reference: gossip_stats.rs).

The port's own copy of the single-origin statistics layer: histograms,
series summaries, hop/stranded collections, message trackers and the
per-simulation ``GossipStats`` hub, and the all-origins aggregates
(``AllOriginsStats``).
"""

from .aggregate import AllOriginsStats
from .collections import StatCollection
from .gossip_stats import GossipStats, GossipStatsCollection, SimulationParameters
from .histogram import Histogram
from .hops import HopsStat, HopsStatCollection
from .stranded import StrandedNodeCollection, StrandedNodeStats
from .trackers import EgressIngressMessageTracker, branching_factor_outbound

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
    "branching_factor_outbound",
]
