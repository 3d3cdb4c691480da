"""Hand-written CUDA kernels for the round's cross-node blocks.

Each kernel has a wrapper (launches the CUDA kernel for CUDA tensors, and
uses the plain PyTorch version for CPU tensors — never as a fallback for a
CUDA tensor) and its plain version beside it in the same module.
``LAUNCHES`` counts the kernel launches per wrapper.
"""

from ._build import (KERNEL_NAMES, LAUNCHES, build_all,
                     reset_launch_counts)
from .bfs_relax import bfs_relax, bfs_relax_plain
from .prune_apply import prune_apply, prune_apply_plain
from .rank_inbound import rank_inbound, rank_inbound_plain
from .rc_merge_prune import MergePruneOut, rc_merge_prune, rc_merge_prune_plain

__all__ = [
    "KERNEL_NAMES",
    "LAUNCHES",
    "MergePruneOut",
    "bfs_relax",
    "bfs_relax_plain",
    "build_all",
    "prune_apply",
    "prune_apply_plain",
    "rank_inbound",
    "rank_inbound_plain",
    "rc_merge_prune",
    "rc_merge_prune_plain",
    "reset_launch_counts",
]
