"""Stake-class weighted peer sampling (replaces the reference's
``WeightedShuffle``, push_active_set.rs:164).

The reference's per-candidate weight for active-set entry ``k`` is
``(min(bucket_j, k) + 1)^2`` (push_active_set.rs:96-111): it depends on the
candidate only through its stake bucket.  With 25 buckets, sampling
factorizes exactly:

  1. draw the bucket class from a 25-way categorical with mass
     ``count[c] * (min(c, k) + 1)^2`` (one 25-entry CDF per ``k``);
  2. draw a node uniformly within the class;
  3. map through the bucket-sorted permutation back to the node id.

The tables are built on the host with numpy (stakes are static) and moved
to the engine's device once.  The draw itself is the ``rotate`` kernel's
sampler (``kernels/rotate.py``); :func:`sample_members` runs its plain
version for ``init_state``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import NUM_PUSH_ACTIVE_SET_ENTRIES
from ..kernels.rotate import sample_members_plain

NB = NUM_PUSH_ACTIVE_SET_ENTRIES  # 25


class SamplerTables(NamedTuple):
    """Static per-cluster sampling tables (tensors on the engine device)."""

    perm: torch.Tensor          # [N] i32  node ids sorted by bucket (stable)
    class_start: torch.Tensor   # [NB] i32 offset of each bucket class in perm
    class_count: torch.Tensor   # [NB] i32 nodes per bucket class
    class_cdf: torch.Tensor     # [NB, NB] f32 normalized inclusive CDF per k


def build_sampler_tables(buckets: np.ndarray, device) -> SamplerTables:
    """Precompute the class tables from per-node stake buckets (host numpy,
    f64 cumulative mass normalized then cast to f32)."""
    buckets = np.asarray(buckets, dtype=np.int32)
    perm = np.argsort(buckets, kind="stable").astype(np.int32)
    class_count = np.bincount(buckets, minlength=NB).astype(np.int32)
    class_start = np.concatenate(
        [[0], np.cumsum(class_count)[:-1]]).astype(np.int32)
    # mass[k, c] = count[c] * (min(c, k) + 1)^2   (push_active_set.rs:96-111)
    c = np.arange(NB)
    weight = (np.minimum(c[None, :], np.arange(NB)[:, None]) + 1) ** 2
    mass = class_count[None, :].astype(np.float64) * weight
    cdf = np.cumsum(mass, axis=1)
    totals = cdf[:, -1:]
    totals = np.where(totals == 0, 1.0, totals)
    cdf = (cdf / totals).astype(np.float32)
    cdf[:, -1] = 1.0
    t = lambda a: torch.as_tensor(a, device=device)
    return SamplerTables(perm=t(perm), class_start=t(class_start),
                         class_count=t(class_count), class_cdf=t(cdf))


def sample_members(tables: SamplerTables, buckets: torch.Tensor,
                   origins: torch.Tensor, u_class: torch.Tensor,
                   u_member: torch.Tensor) -> torch.Tensor:
    """Weighted draw for entry ``k = min(bucket(n), bucket(o))``:
    class-member positions [O, N, T] i32 for [O, N, T] f32 uniforms
    (``kernels.rotate.sample_members_plain``)."""
    return sample_members_plain(buckets, origins, tables.class_cdf,
                                tables.class_start, tables.class_count,
                                u_class, u_member)
