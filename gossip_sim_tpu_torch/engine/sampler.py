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
to the engine's device once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import NUM_PUSH_ACTIVE_SET_ENTRIES

NB = NUM_PUSH_ACTIVE_SET_ENTRIES  # 25


class SamplerTables(NamedTuple):
    """Static per-cluster sampling tables (tensors on the engine device)."""

    perm: torch.Tensor          # [N] i32  node ids sorted by bucket (stable)
    class_start: torch.Tensor   # [NB] i32 offset of each bucket class in perm
    class_count: torch.Tensor   # [NB] i32 nodes per bucket class
    class_cdf: torch.Tensor     # [NB, NB] f32 normalized inclusive CDF per k
    cdf_own: torch.Tensor       # [N, NB] f32 == class_cdf[bucket(n)]


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
                         class_count=t(class_count), class_cdf=t(cdf),
                         cdf_own=t(cdf[buckets]))


def sample_members(tables: SamplerTables, buckets: torch.Tensor,
                   origins: torch.Tensor, u_class: torch.Tensor,
                   u_member: torch.Tensor) -> torch.Tensor:
    """Weighted draw for entry ``k = min(bucket(n), bucket(o))``.

    ``u_class``/``u_member``: [O, N, T] f32 uniforms.  Returns class-member
    positions [O, N, T] i32 in bucket-sorted space (``perm[pos]`` is the
    node id).  The CDF row is ``cdf_own[n]`` when ``b_n <= b_o`` and the
    origin's row otherwise, exactly as the reference's ``_sample_fast``
    selects it."""
    b_o = buckets[origins.long()]                                 # [O]
    cdf_org = tables.class_cdf[b_o.long()]                        # [O, NB]
    own = (buckets[None, :] <= b_o[:, None])[..., None, None]     # [O,N,1,1]
    cdf = torch.where(own, tables.cdf_own[None, :, None, :],
                      cdf_org[:, None, None, :])                  # [O,N,1,NB]
    cls = (u_class[..., None] >= cdf[..., :-1]).sum(-1)           # [O, N, T]
    start = tables.class_start[cls]
    count = tables.class_count[cls]
    member = start + torch.floor(
        u_member * count.to(torch.float32)).to(torch.int32)
    return torch.minimum(member, start + torch.clamp(count - 1, min=0))
