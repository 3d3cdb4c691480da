"""The gossip engine on PyTorch tensors: the five-verb round over dense
per-origin state, with its cross-node blocks in hand-written CUDA kernels
(:mod:`gossip_sim_tpu_torch.kernels`), and sweep lanes as more rows of it
(:mod:`.lanes`)."""

from .core import (ClusterTables, SimState, init_state, make_cluster_tables,
                   resolve_device, round_step, run_rounds)
from .lanes import (broadcast_state, check_lane_knobs, lane_state, num_lanes,
                    run_rounds_lanes, run_rounds_lanes_dyn, splice_lane_state,
                    stack_knobs, stack_origins)
from .params import (EngineKnobs, EngineParams, EngineStatic,
                     merge_lane_statics)
from .sampler import SamplerTables, build_sampler_tables

__all__ = [
    "ClusterTables",
    "EngineKnobs",
    "EngineParams",
    "EngineStatic",
    "SamplerTables",
    "SimState",
    "broadcast_state",
    "build_sampler_tables",
    "check_lane_knobs",
    "init_state",
    "lane_state",
    "make_cluster_tables",
    "merge_lane_statics",
    "num_lanes",
    "resolve_device",
    "round_step",
    "run_rounds",
    "run_rounds_lanes",
    "run_rounds_lanes_dyn",
    "splice_lane_state",
    "stack_knobs",
    "stack_origins",
]
