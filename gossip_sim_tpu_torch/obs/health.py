"""Node health observatory: per-node load, latency and drop attribution.

The port's own copy of the reference package's ``obs/health.py``.  The
engine accumulates O(N) health planes in the round (engine/core.py,
engine/traffic.py, behind the static ``EngineStatic.health`` gate, through
the ``health_round`` kernel), and this module turns those planes into
small digests on the device (:func:`digest_stack`, the ``health_digest``
kernel):

* stake-decile segment sums over the ``ClusterTables.stake_decile`` id
  table: the host reads a ``[P, 10]`` array (P = number of metrics),
  never the raw ``[N]`` planes;
* top-k hot nodes per metric, ties toward the lower node id (the numpy
  twin's lexsort order);
* load-imbalance Gini as an exact integer numerator/denominator pair (the
  i64 sums are order-independent, so the device and the numpy twin agree
  bit for bit; the one float division happens on the host).

The numpy twins (:func:`digest_stack_np` and its parts) serve the host
paths and the tests.  Importing this module imports no kernel: the device
digest loads ``kernels`` when it is called.
"""

from __future__ import annotations

import numpy as np

HEALTH_SCHEMA = "gossip-sim-tpu/node-health/v1"

#: number of stake-decile segments (ClusterTables.stake_decile ids)
NUM_DECILES = 10

#: default hot-node extraction width (Config.health_topk)
DEFAULT_TOPK = 10

__all__ = [
    "HEALTH_SCHEMA", "NUM_DECILES", "DEFAULT_TOPK",
    "stake_decile_ids", "digest_stack", "digest_stack_np", "digest_tensors",
    "decile_sums_np", "topk_nodes_np", "gini_parts_np", "gini_value",
    "build_node_health_section", "influx_values",
]


# --------------------------------------------------------------------------
# the decile id table (numpy twin of engine/core.py make_cluster_tables)
# --------------------------------------------------------------------------

def stake_decile_ids(stakes) -> np.ndarray:
    """[N] i32 stake-rank decile ids: stable ascending sort (equal stakes
    tie-break by node id), decile 0 = the lowest-staked tenth.  This is
    the exact computation ``make_cluster_tables`` bakes into
    ``ClusterTables.stake_decile``: one id map shared by the engine and
    the host paths."""
    stakes = np.asarray(stakes, dtype=np.int64)
    n = stakes.shape[0]
    order = np.argsort(stakes, kind="stable")
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n, dtype=np.int64)
    return (rank * 10 // n).astype(np.int32)


# --------------------------------------------------------------------------
# numpy twins (exact integer math — the parity reference)
# --------------------------------------------------------------------------

def decile_sums_np(metric, decile_ids) -> np.ndarray:
    """[10] i64 per-decile sums of one [N] metric plane."""
    out = np.zeros(NUM_DECILES, dtype=np.int64)
    np.add.at(out, np.asarray(decile_ids), np.asarray(metric, np.int64))
    return out


def topk_nodes_np(metric, k: int):
    """Top-k hot nodes of one [N] plane -> (idx [k] i32, val [k] i64).
    Ties break toward the lower node id (lax.top_k's documented order)."""
    metric = np.asarray(metric, dtype=np.int64)
    n = metric.shape[0]
    k = min(int(k), n)
    order = np.lexsort((np.arange(n), -metric))[:k]
    return order.astype(np.int32), metric[order]


def gini_parts_np(metric):
    """Exact integer Gini parts of one [N] plane -> (num, den) i64 with
    ``gini = num / den`` (0 when den == 0).  Formulation: sort ascending,
    ``num = sum((2i - n - 1) * x_i)``, ``den = n * sum(x)`` — every term
    is an exact i64, so summation order cannot matter and the device twin
    matches bit-for-bit."""
    xs = np.sort(np.asarray(metric, dtype=np.int64))
    n = xs.shape[0]
    w = 2 * np.arange(1, n + 1, dtype=np.int64) - n - 1
    return int(np.sum(w * xs)), int(n * np.sum(xs))


def gini_value(num: int, den: int) -> float:
    """The one float division, shared by both paths."""
    return float(num) / float(den) if den else 0.0


def digest_stack_np(stack, decile_ids, k: int) -> dict:
    """Loop/numpy twin of :func:`digest_stack` over a [P, N] i64-able
    stack.  Returns the identical integer arrays."""
    stack = np.asarray(stack, dtype=np.int64)
    dec = np.stack([decile_sums_np(row, decile_ids) for row in stack])
    idx, val = zip(*(topk_nodes_np(row, k) for row in stack))
    gnum, gden = zip(*(gini_parts_np(row) for row in stack))
    return {
        "deciles": dec,                                   # [P, 10] i64
        "top_idx": np.stack(idx),                         # [P, k]  i32
        "top_val": np.stack(val),                         # [P, k]  i64
        "gini_num": np.asarray(gnum, np.int64),           # [P]     i64
        "gini_den": np.asarray(gden, np.int64),           # [P]     i64
    }


# --------------------------------------------------------------------------
# the device digest (the health_digest kernel on the card)
# --------------------------------------------------------------------------

def digest_tensors(stack, decile_ids, k: int):
    """The digest of a [P, N] int32/int64 tensor stack as tensors on its
    device (``kernels.health_digest``: the CUDA kernel for a CUDA stack,
    its plain version for a CPU one), ``k`` clamped to N.  A caller that
    queues the digest behind other work copies the outputs itself."""
    from ..kernels import health_digest
    n = int(stack.shape[-1])
    return health_digest(stack, decile_ids, min(int(k), n))


def digest_stack(stack, decile_ids, k: int) -> dict:
    """Digest of a [P, N] metric stack (tensors in, small host numpy arrays
    out, with :func:`digest_stack_np`'s dtypes).  Bit-identical to
    :func:`digest_stack_np` on the same integers."""
    d = digest_tensors(stack, decile_ids, k)
    return {name: getattr(d, name).cpu().numpy() for name in d._fields}


# --------------------------------------------------------------------------
# report / wire assembly (host-side, numpy-only)
# --------------------------------------------------------------------------

def build_node_health_section(metric_names, digest, *, enabled: bool,
                              topk: int, source: str,
                              latency: dict | None = None,
                              extra: dict | None = None) -> dict:
    """Assemble the REQUIRED ``node_health`` run-report section.

    ``digest`` is a :func:`digest_stack` / :func:`digest_stack_np` result
    whose row order matches ``metric_names``.  ``latency`` optionally
    carries the decile coverage-latency table ({"lat_sum": [10],
    "delivered": [10]} style pairs already reduced to deciles).  When the
    gate is off the section still exists (schema + enabled=False) so
    ``validate_run_report`` holds on every run."""
    section: dict = {
        "schema": HEALTH_SCHEMA,
        "enabled": bool(enabled),
        "topk": int(topk),
        "source": str(source),
        "metrics": {},
    }
    if not enabled or digest is None:
        return section
    for i, name in enumerate(metric_names):
        section["metrics"][name] = {
            "total": int(digest["deciles"][i].sum()),
            "deciles": [int(x) for x in digest["deciles"][i]],
            "hot_nodes": [
                {"node": int(a), "count": int(b)}
                for a, b in zip(digest["top_idx"][i], digest["top_val"][i])
            ],
            "gini": gini_value(int(digest["gini_num"][i]),
                               int(digest["gini_den"][i])),
        }
    if latency:
        section["latency"] = latency
    if extra:
        section.update(extra)
    return section


def influx_values(metric_names, digest, *, topk: int) -> dict:
    """Flatten a digest into the ``sim_node_health`` point's field dict
    (sorted-key emission happens in sinks/influx.py).  Totals and Gini
    per metric, plus the hot-node (id, count) pairs of every metric so
    drop attribution is replayable per block."""
    vals: dict = {}
    for i, name in enumerate(metric_names):
        vals[f"{name}_total"] = int(digest["deciles"][i].sum())
        vals[f"{name}_gini"] = gini_value(int(digest["gini_num"][i]),
                                          int(digest["gini_den"][i]))
        for j in range(min(int(topk), digest["top_idx"].shape[1])):
            vals[f"{name}_hot{j}_node"] = int(digest["top_idx"][i, j])
            vals[f"{name}_hot{j}_count"] = int(digest["top_val"][i, j])
    return vals
