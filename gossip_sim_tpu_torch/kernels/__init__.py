"""Hand-written CUDA kernels for the round's cross-node blocks and draws.

Each kernel has a wrapper (launches the CUDA kernel for CUDA tensors, and
uses the plain PyTorch version for CPU tensors — never as a fallback for a
CUDA tensor) and its plain version beside it in the same module.
``LAUNCHES`` counts the kernel launches per wrapper.
"""

from ._build import (KERNEL_NAMES, LAUNCHES, build_all,
                     reset_launch_counts)
from .bfs_relax import bfs_relax, bfs_relax_plain
from .prune_apply import prune_apply, prune_apply_plain
from .pull_exchange import PullOut, pull_exchange, pull_exchange_plain
from .push_targets import push_targets, push_targets_plain
from .rank_inbound import rank_inbound, rank_inbound_plain
from .rc_merge_prune import MergePruneOut, rc_merge_prune, rc_merge_prune_plain
from .rotate import rotate, rotate_plain
from .threefry import threefry, threefry_plain
from .traffic_admit import AdmitOut, traffic_admit, traffic_admit_plain
from .traffic_rescue import RescueOut, traffic_rescue, traffic_rescue_plain
from .traffic_send import SendOut, traffic_send, traffic_send_plain

__all__ = [
    "AdmitOut",
    "KERNEL_NAMES",
    "LAUNCHES",
    "MergePruneOut",
    "PullOut",
    "RescueOut",
    "SendOut",
    "bfs_relax",
    "bfs_relax_plain",
    "build_all",
    "prune_apply",
    "prune_apply_plain",
    "pull_exchange",
    "pull_exchange_plain",
    "push_targets",
    "push_targets_plain",
    "rank_inbound",
    "rank_inbound_plain",
    "rc_merge_prune",
    "rc_merge_prune_plain",
    "reset_launch_counts",
    "rotate",
    "rotate_plain",
    "threefry",
    "threefry_plain",
    "traffic_admit",
    "traffic_admit_plain",
    "traffic_rescue",
    "traffic_rescue_plain",
    "traffic_send",
    "traffic_send_plain",
]
