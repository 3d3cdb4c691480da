"""The gossip engine on PyTorch tensors: the five-verb round over dense
per-origin state, with its cross-node blocks in hand-written CUDA kernels
(:mod:`gossip_sim_tpu_torch.kernels`)."""

from .core import (ClusterTables, SimState, init_state, make_cluster_tables,
                   resolve_device, round_step, run_rounds)
from .params import EngineKnobs, EngineParams, EngineStatic
from .sampler import SamplerTables, build_sampler_tables

__all__ = [
    "ClusterTables",
    "EngineKnobs",
    "EngineParams",
    "EngineStatic",
    "SamplerTables",
    "SimState",
    "build_sampler_tables",
    "init_state",
    "make_cluster_tables",
    "resolve_device",
    "round_step",
    "run_rounds",
]
