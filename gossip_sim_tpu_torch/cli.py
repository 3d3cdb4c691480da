"""Experiment driver for the single-origin push simulation (reference:
gossip_main.rs) and all-origins mode, on the PyTorch engine.

Flag names and defaults are the reference's (gossip_main.rs:53-241) for the
flags this port carries; ``--device`` (``cuda`` by default, or ``cpu``)
selects where the engine runs.  A flag the port lacks is rejected by
argparse: sweeps, account files / RPC, Influx, checkpoints, traces and
telemetry are later slices (ROADMAP A5-A16).

``python -m gossip_sim_tpu_torch --num-synthetic-nodes 10000
--iterations 300 --print-stats`` runs the 10,000-node synthetic cluster on
the GPU; ``--all-origins`` runs every node as an origin, in origin batches
(:func:`run_all_origins`).
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import kernels
from .config import Config, StepSize, Testing
from .constants import (AGGREGATE_HOPS_FAIL_NODES_HISTOGRAM_UPPER_BOUND,
                        AGGREGATE_HOPS_MIN_INGRESS_NODES_HISTOGRAM_UPPER_BOUND,
                        COVERAGE_RECOVERY_THRESHOLD,
                        STANDARD_HISTOGRAM_UPPER_BOUND, UNREACHED,
                        VALIDATOR_STAKE_DISTRIBUTION_NUM_BUCKETS)
from .engine import (EngineParams, init_state, make_cluster_tables,
                     run_rounds)
from .identity import NodeIndex
from .ingest import filter_accounts, log_cluster_summary, synthetic_accounts
from .rng import prng_key
from .rustrng import ChaChaRng
from .stats.aggregate import AllOriginsStats
from .stats.gossip_stats import GossipStats, GossipStatsCollection

log = logging.getLogger("gossip_sim_tpu_torch")

POOR_COVERAGE_THRESHOLD = COVERAGE_RECOVERY_THRESHOLD

#: measured rounds per device->host harvest block
HARVEST_BLOCK = 256


def _warn_shape_truncation(rows, params) -> None:
    """Surface the engine's dense-shape truncations (inbound ranking width,
    received-cache slots, hop-histogram bins) as loud warnings.  The
    delivered count (per-round rows, or the all-origins ingress total) is
    the entries received, the base of the overflow's share."""
    dropped = int(np.asarray(rows["inb_dropped"]).sum())
    overflow = int(np.asarray(rows["rc_overflow"]).sum())
    clamped = int(np.asarray(rows["hop_clamped"]).sum())
    received = int(np.asarray(rows.get("delivered", 0)).sum())
    if clamped:
        log.warning("WARNING: %s hop sample(s) reached the top histogram "
                    "bin (hist_bins=%s) and were clamped", clamped,
                    params.hist_bins)
    if dropped:
        log.warning("WARNING: %s inbound message(s) exceeded the ranking "
                    "width (inbound_cap=%s) and were dropped from peer "
                    "scoring", dropped, params.k_inbound)
    if overflow:
        pct = (f" ({100.0 * overflow / received:.2f}% of the {received} "
               f"entries received)" if received > 0 else "")
        log.warning("WARNING: %s received-cache entries%s exceeded "
                    "rc_slots=%s and were evicted early", overflow, pct,
                    params.rc_slots)


def _engine_params(config: Config, num_nodes: int) -> EngineParams:
    """The EngineParams a Config selects.  The one-shot fail event only arms
    on a FAIL_NODES run (gossip_main.rs:449-452)."""
    fail = config.test_type == Testing.FAIL_NODES
    return EngineParams(
        num_nodes=num_nodes,
        push_fanout=config.gossip_push_fanout,
        active_set_size=config.gossip_active_set_size,
        probability_of_rotation=config.probability_of_rotation,
        prune_stake_threshold=config.prune_stake_threshold,
        min_ingress_nodes=config.min_ingress_nodes,
        warm_up_rounds=config.warm_up_rounds,
        fail_at=config.when_to_fail if fail else -1,
        fail_fraction=config.fraction_to_fail if fail else 0.0,
        packet_loss_rate=config.packet_loss_rate,
        churn_fail_rate=config.churn_fail_rate,
        churn_recover_rate=config.churn_recover_rate,
        partition_at=config.partition_at,
        heal_at=config.heal_at,
        impair_seed=config.seed,
        gossip_mode=config.gossip_mode)


def build_parser() -> argparse.ArgumentParser:
    """The reference CLI surface for the single-origin push slice."""
    p = argparse.ArgumentParser(
        prog="gossip-sim",
        description="Solana gossip push-protocol simulator (PyTorch/CUDA)")
    p.add_argument("--push-fanout", type=int, default=6,
                   help="gossip push fanout")
    p.add_argument("--active-set-size", type=int, default=12,
                   help="gossip push active set entry size")
    p.add_argument("--iterations", type=int, default=1,
                   help="gossip iterations")
    p.add_argument("--origin-rank", type=int, default=1,
                   help="Select an origin with origin rank for gossip "
                        "(1 = largest stake)")
    p.add_argument("--rotation-probability", "-p", type=float,
                   default=0.013333,
                   help="After each round of gossip, rotate a node's active "
                        "set with probability 0 <= p <= 1")
    p.add_argument("--min-ingress-nodes", type=int, default=2,
                   help="Minimum number of incoming peers a node must keep")
    p.add_argument("--prune-stake-threshold", type=float, default=0.15,
                   help="Ensure a node is connected to a minimum stake of "
                        "prune_stake_threshold*node.stake()")
    p.add_argument("--test-type", default="no-test",
                   choices=[Testing.NO_TEST.value, Testing.FAIL_NODES.value],
                   help="no-test, or fail-nodes (one-shot node failure)")
    p.add_argument("--fraction-to-fail", type=float, default=0.1,
                   help="Fail fraction-to-fail of total nodes in cluster")
    p.add_argument("--when-to-fail", type=int, default=0,
                   help="On what iteration should the nodes fail")
    p.add_argument("--warm-up-rounds", type=int, default=200,
                   help="Number of gossip rounds to run before measuring "
                        "statistics")
    p.add_argument("--packet-loss-rate", type=float, default=0.0,
                   help="drop each gossip message with this probability")
    p.add_argument("--churn-fail-rate", type=float, default=0.0,
                   help="per-iteration probability that an alive node fails")
    p.add_argument("--churn-recover-rate", type=float, default=0.0,
                   help="per-iteration probability that a failed node "
                        "recovers and rejoins delivery")
    p.add_argument("--partition-at", type=int, default=-1,
                   help="iteration at which a stake-balanced bipartition "
                        "starts suppressing cross-partition messages "
                        "(-1 = never)")
    p.add_argument("--heal-at", type=int, default=-1,
                   help="iteration at which the partition heals (-1 = never)")
    p.add_argument("--print-stats", action="store_true",
                   help="Print Gossip Stats to console at end of simulation")
    p.add_argument("--seed", type=int, default=42,
                   help="Deterministic RNG seed")
    p.add_argument("--num-synthetic-nodes", type=int, default=0,
                   help="number of nodes of the synthetic seeded cluster "
                        "(required: account files and RPC are not ported)")
    p.add_argument("--all-origins", action="store_true",
                   help="batch-simulate every node as origin (origin "
                        "batches on one device)")
    p.add_argument("--origin-batch", type=int, default=0,
                   help="origins per device batch in --all-origins mode "
                        "(0 = auto)")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="devices to shard origin batches over in "
                        "--all-origins mode (0 = all available; one GPU "
                        "until more than one is ported, ROADMAP A6b)")
    p.add_argument("--mesh-node-shards", type=int, default=1,
                   help="--all-origins mode: additionally shard the "
                        "per-origin node axis over this many devices per "
                        "origin-shard (1 = origins axis only; more is not "
                        "ported yet, ROADMAP A6b)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the engine runs (default cuda; a run without "
                        "a GPU must ask for cpu)")
    return p


def config_from_args(args) -> Config:
    prob = args.rotation_probability
    if not 0.0 <= prob <= 1.0:
        raise SystemExit("rotation-probability must be between 0 and 1")
    if not 0.0 <= args.prune_stake_threshold <= 1.0:
        raise SystemExit("prune-stake-threshold must be between 0 and 1")
    for flag in ("packet_loss_rate", "churn_fail_rate", "churn_recover_rate"):
        if not 0.0 <= getattr(args, flag) <= 1.0:
            raise SystemExit(
                f"{flag.replace('_', '-')} must be between 0 and 1")
    if args.heal_at >= 0 and args.partition_at < 0:
        raise SystemExit("heal-at requires partition-at")
    if args.partition_at >= 0 and 0 <= args.heal_at < args.partition_at:
        raise SystemExit("heal-at must not precede partition-at")
    if args.origin_rank < 1:
        raise SystemExit("origin-rank must be >= 1 (1 = highest stake)")
    return Config(
        gossip_push_fanout=args.push_fanout,
        gossip_active_set_size=args.active_set_size,
        gossip_iterations=args.iterations,
        origin_rank=args.origin_rank,
        probability_of_rotation=prob,
        prune_stake_threshold=args.prune_stake_threshold,
        min_ingress_nodes=args.min_ingress_nodes,
        fraction_to_fail=args.fraction_to_fail,
        when_to_fail=args.when_to_fail,
        test_type=Testing.parse(args.test_type),
        step_size=StepSize.parse("1"),
        warm_up_rounds=args.warm_up_rounds,
        print_stats=args.print_stats,
        packet_loss_rate=args.packet_loss_rate,
        churn_fail_rate=args.churn_fail_rate,
        churn_recover_rate=args.churn_recover_rate,
        partition_at=args.partition_at,
        heal_at=args.heal_at,
        seed=args.seed,
        num_synthetic_nodes=args.num_synthetic_nodes,
        all_origins=args.all_origins,
        origin_batch=args.origin_batch,
        mesh_devices=args.mesh_devices,
        mesh_node_shards=args.mesh_node_shards,
        device=args.device,
    )


def find_nth_largest_node(n, items):
    """Min-heap nth-largest-stake selection (gossip_main.rs:279-290).

    ``items``: [(key, stake)]. Returns the first item whose stake equals the
    nth largest stake value (duplicates counted separately).
    """
    import heapq
    if n <= 0:
        return None
    heap = []
    for _, stake in items:
        if len(heap) < n:
            heapq.heappush(heap, stake)
        elif stake >= heap[0]:
            heapq.heapreplace(heap, stake)
    if not heap:
        return None
    target = heap[0]
    for item in items:
        if item[1] == target:
            return item
    return None


def load_cluster_accounts(config: Config):
    """The synthetic seeded cluster -> ({pk: stake}, source label).  Account
    files and JSON-RPC are not ported yet (ROADMAP A5)."""
    if config.num_synthetic_nodes <= 0:
        raise NotImplementedError(
            "only --num-synthetic-nodes clusters are ported; account files "
            "and JSON-RPC sources are not (ROADMAP A5)")
    rng = ChaChaRng.from_seed_byte(config.seed % 256)
    accounts = synthetic_accounts(config.num_synthetic_nodes, rng)
    accounts = filter_accounts(accounts, config.filter_zero_staked_nodes)
    log_cluster_summary(accounts)
    return accounts, f"synthetic:{config.num_synthetic_nodes}"


def _run_torch_backend(config: Config, accounts, origin_pubkey,
                       stats: GossipStats):
    """The simulation on the PyTorch engine: the warm-up rounds in one
    call, then the measured rounds harvested per iteration into the stats
    layer (the reference's per-iteration loop, gossip_main.rs:425-565)."""
    index = NodeIndex.from_stakes(accounts)
    stakes = dict(accounts)
    N = len(index)
    params = _engine_params(config, N)
    tables = make_cluster_tables(index.stakes.astype(np.int64),
                                 device=config.device)
    dev = tables.stakes.device
    origins = torch.tensor([index.index_of(origin_pubkey)],
                           dtype=torch.int32, device=dev)

    log.info("Simulating Gossip and setting active sets. Please wait.....")
    state = init_state(prng_key(config.seed, dev), tables, origins, params)
    log.info("Simulation Complete!")

    def _record_failed():
        failed_idx = np.nonzero(state.failed[0].cpu().numpy())[0]
        stats.set_failed_nodes({index.pubkeys[i] for i in failed_idx})

    warm = min(config.warm_up_rounds, config.gossip_iterations)
    if warm > 0:
        for it in range(0, warm, 10):
            log.info("GOSSIP ITERATION: %s", it)
        state, wrows = run_rounds(params, tables, origins, state, warm)
        if 0 <= config.heal_at < warm:
            # post-heal coverage inside the warm-up still feeds the
            # recovery metric (iteration-exact)
            for t, cov in enumerate(wrows["coverage"][:, 0].tolist()):
                if t >= config.heal_at:
                    stats.note_post_heal_coverage(t, cov)
        if 0 <= params.fail_at < warm:
            _record_failed()
    measured = config.gossip_iterations - warm
    done = 0
    while done < measured:
        n_it = min(HARVEST_BLOCK, measured - done)
        start_it = warm + done
        state, trows = run_rounds(params, tables, origins, state, n_it,
                                  start_it=start_it, detail=True)
        rows = {k: v.cpu().numpy() for k, v in trows.items()}
        _warn_shape_truncation(rows, params)
        if (params.fail_at >= 0
                and start_it <= params.fail_at < start_it + n_it):
            _record_failed()
        for t in range(n_it):
            it = start_it + t
            if it % 10 == 0:
                log.info("GOSSIP ITERATION: %s", it)
            _feed_measured_round(stats, rows, t, 0, it, config, index,
                                 stakes, origin_pubkey)
        done += n_it
    if measured > 0:
        _feed_message_counters(stats, state, 0, index)
        if params.has_churn:
            _record_failed()
    return stakes


def _feed_measured_round(stats, rows, t, col, it, config, index, stakes,
                         origin_pubkey):
    """Insert one measured round (origin column ``col`` of harvested rows)
    into the stats layer (gossip_main.rs:480-563)."""
    coverage = float(rows["coverage"][t, col])
    if config.heal_at >= 0 and it >= config.heal_at:
        stats.note_post_heal_coverage(it, coverage)
    if coverage < POOR_COVERAGE_THRESHOLD:
        log.warning("WARNING: poor coverage for origin: %s, %s",
                    origin_pubkey, coverage)
    dist = rows["dist"][t, col]            # [N], -1 = unreached
    hops = np.where(dist < 0, UNREACHED, dist.astype(np.uint64))
    stranded_mask = rows["stranded_mask"][t, col]
    stranded = [index.pubkeys[i] for i in np.nonzero(stranded_mask)[0]]
    stats.insert_coverage(coverage)
    stats.insert_hops_stat(hops.tolist())
    stats.insert_stranded_nodes(stranded, stakes)
    stats.insert_branching_factor(float(rows["branching"][t, col]))
    stats.insert_rmr(float(rows["rmr"][t, col]))
    if config.wants_delivery_stats:
        stats.insert_delivery(int(rows["delivered"][t, col]),
                              int(rows["dropped"][t, col]),
                              int(rows["suppressed"][t, col]),
                              int(rows["failed_count"][t, col]))


def _feed_message_counters(stats, state, col, index):
    """Message counters accumulate on the device across measured rounds;
    feed the trackers once (equals the reference's per-round updates)."""
    n = len(index)
    egress = state.egress_acc[col].cpu().numpy()
    ingress = state.ingress_acc[col].cpu().numpy()
    prunes = state.prune_acc[col].cpu().numpy()
    stats.update_message_counts(
        {index.pubkeys[i]: int(egress[i]) for i in range(n)},
        {index.pubkeys[i]: int(ingress[i]) for i in range(n)})
    stats.update_prune_counts(
        {index.pubkeys[i]: int(prunes[i]) for i in range(n)})


def run_simulation(config: Config, stats_collection: GossipStatsCollection,
                   sim_iter: int = 0) -> GossipStats:
    """One simulation (gossip_main.rs:292-647): load the cluster, pick the
    origin, run the engine, finalize the stats into ``stats_collection``."""
    log.info("##### SIMULATION ITERATION: %s #####", sim_iter)
    accounts, _ = load_cluster_accounts(config)
    log.info("%s", config)
    if len(accounts) < config.origin_rank:
        raise SystemExit(
            f"ERROR: origin_rank larger than number of simulation nodes. "
            f"nodes: {len(accounts)}, origin_rank: {config.origin_rank}")
    origin_pubkey = find_nth_largest_node(config.origin_rank,
                                          list(accounts.items()))[0]
    stakes = dict(accounts)
    log.info("ORIGIN: %s", origin_pubkey)

    stats = GossipStats()
    stats.set_simulation_parameters(config)
    stats.set_origin(origin_pubkey)
    stats.initialize_message_stats(stakes)
    stats.build_validator_stake_distribution_histogram(
        VALIDATOR_STAKE_DISTRIBUTION_NUM_BUCKETS, stakes)
    stakes = _run_torch_backend(config, accounts, origin_pubkey, stats)
    if not stats.is_empty():
        _build_final_stats(config, stats, stakes)
        stats_collection.push(stats)
    return stats


def _build_final_stats(config, stats, stakes):
    """The end-of-sim histogram builds + calculations."""
    stats.build_stranded_node_histogram(
        config.gossip_iterations - config.warm_up_rounds, 0,
        config.num_buckets_for_stranded_node_hist)
    if config.test_type == Testing.FAIL_NODES:
        stats.build_aggregate_hops_stats_histogram(
            int(AGGREGATE_HOPS_FAIL_NODES_HISTOGRAM_UPPER_BOUND
                * (1.0 + config.fraction_to_fail)),
            0, config.num_buckets_for_hops_stats_hist)
    elif config.test_type == Testing.MIN_INGRESS_NODES:
        stats.build_aggregate_hops_stats_histogram(
            AGGREGATE_HOPS_MIN_INGRESS_NODES_HISTOGRAM_UPPER_BOUND,
            0, config.num_buckets_for_hops_stats_hist)
    else:
        stats.build_aggregate_hops_stats_histogram(
            STANDARD_HISTOGRAM_UPPER_BOUND, 0,
            config.num_buckets_for_hops_stats_hist)
    stats.build_message_histograms(
        config.num_buckets_for_message_hist, True, stakes)
    stats.build_prune_histogram(
        config.num_buckets_for_message_hist, True, stakes)
    stats.run_all_calculations()


def simulate(config: Config) -> GossipStatsCollection:
    """The main path: one simulation into a fresh stats collection."""
    collection = GossipStatsCollection()
    collection.set_number_of_simulations(config.num_simulations)
    run_simulation(config, collection, 0)
    return collection


# --------------------------------------------------------------------------
# all-origins mode
# --------------------------------------------------------------------------

#: SimState accumulators the all-origins harvest reads, summed over the
#: batch's valid origins on the device (int64 sums of int32 counts: exact)
HARVEST_STATE = ("hops_hist_acc", "stranded_acc", "egress_acc",
                 "ingress_acc", "prune_acc")


def all_origins_params(config: Config, num_nodes: int) -> EngineParams:
    """All-origins' EngineParams (reference cli.py:1841-1853): the
    single-origin run's without the one-shot fail event, which all-origins
    never arms, even on a FAIL_NODES run."""
    return _engine_params(config, num_nodes)._replace(fail_at=-1,
                                                      fail_fraction=0.0)


def _mark(dev: torch.device):
    """A point on the device's stream (a recorded CUDA event), or on the
    host clock for the CPU."""
    if dev.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _span_s(a, b) -> float:
    """Seconds between two :func:`_mark` points (both reached)."""
    if isinstance(a, float):
        return b - a
    return a.elapsed_time(b) / 1e3


def _start_copy(rows: dict, state, n_valid: int):
    """Start moving what the harvest reads of one batch to the host: every
    row of the valid origins, and the ``HARVEST_STATE`` accumulators summed
    over them.  On the card the copies go into pinned buffers behind the
    batch's rounds on the stream, and the returned event marks their end,
    so the next batch's launches queue behind them and the harvest waits
    for this batch only.  Returns (host tensors, event or None)."""
    out = {"row." + k: v[:, :n_valid] for k, v in rows.items()}
    for f in HARVEST_STATE:
        out["sum." + f] = getattr(state, f)[:n_valid].sum(
            0, dtype=torch.int64, keepdim=True)
    if not next(iter(out.values())).is_cuda:
        return out, None
    host = {}
    for k, v in out.items():
        host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host[k].copy_(v, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def run_all_origins(config: Config, accounts=None,
                    origin_indices=None) -> dict:
    """Origin-parallel mode (reference: gossip_sim_tpu/cli.py:1800-2209):
    every node (or each of ``origin_indices``) is the origin of its own
    simulation, run in origin batches on one device, and the full aggregate
    stats suite is built from the on-device accumulators.  Returns a
    summary dict (also logged); its ``stats`` key carries the finalized
    ``AllOriginsStats``.

    Batches are ``config.origin_batch`` wide (0 = auto:
    ``min(64, 2^22 // N)``), at most the number of origins; every batch
    starts from ``prng_key(seed)``, and the tail is padded with origin 0 to
    the full width, its padded sims cut off before the harvest
    (``padded_sims``).  Two batches are in flight: batch k + 1 is queued
    before batch k is harvested.

    Beyond the reference's keys the summary carries ``origin_iters`` and
    ``messages_delivered``, counted as the reference's run report counts
    them (a multi-batch run leaves out its first batch, the reference's
    compile carrier), and ``batches``: per batch its ``init_state`` and
    rounds spans on the device's stream, its host dispatch time, the wait
    for its copy and its harvest time (seconds)."""
    if config.mesh_devices > 1 or config.mesh_node_shards > 1:
        raise NotImplementedError(
            "splitting origin batches over more than one GPU "
            "(--mesh-devices / --mesh-node-shards > 1) is not ported yet "
            "(ROADMAP A6b)")
    if accounts is None:
        accounts, _ = load_cluster_accounts(config)
    index = NodeIndex.from_stakes(accounts)
    N = len(index)
    params = all_origins_params(config, N)
    tables = make_cluster_tables(index.stakes.astype(np.int64),
                                 device=config.device)
    dev = tables.stakes.device
    all_origins = (np.arange(N, dtype=np.int32) if origin_indices is None
                   else np.asarray(origin_indices, dtype=np.int32))
    total_o = len(all_origins)
    batch = config.origin_batch or max(1, min(64, (1 << 22) // max(N, 1)))
    if total_o > 0:
        batch = min(batch, total_o)
    single_batch = total_o <= batch
    iters = config.gossip_iterations
    agg = AllOriginsStats(index, params.hist_bins)
    key = prng_key(config.seed, dev)
    counts = {"padded_sims": 0, "origin_iters": 0, "messages_delivered": 0}
    batches = []
    t0 = time.time()

    def _dispatch(lo):
        """Queue one origin batch (init + rounds) and the copy of what its
        harvest reads, without waiting on the device."""
        chunk = all_origins[lo:lo + batch]
        n_valid = len(chunk)
        if n_valid < batch:
            chunk = np.concatenate(
                [chunk, np.zeros(batch - n_valid, np.int32)])
        origins = torch.as_tensor(chunk, dtype=torch.int32, device=dev)
        t_host = time.perf_counter()
        marks = [_mark(dev)]
        state = init_state(key, tables, origins, params)
        marks.append(_mark(dev))
        state, rows = run_rounds(params, tables, origins, state, iters)
        marks.append(_mark(dev))
        host, ready = _start_copy(rows, state, n_valid)
        dispatch_s = time.perf_counter() - t_host
        return lo, n_valid, host, ready, marks, dispatch_s

    def _harvest(job):
        """Wait for one batch's copy and fold it into the aggregates."""
        lo, n_valid, host, ready, marks, dispatch_s = job
        t = time.perf_counter()
        if ready is not None:
            ready.synchronize()
        waited = time.perf_counter() - t
        if n_valid < batch:
            counts["padded_sims"] += batch - n_valid
        rows = {k[4:]: v.numpy() for k, v in host.items()
                if k.startswith("row.")}
        if lo > 0 or single_batch:
            counts["origin_iters"] += n_valid * iters
            counts["messages_delivered"] += int(rows["delivered"].sum())
        sums = SimpleNamespace(**{f: host["sum." + f].numpy()
                                  for f in HARVEST_STATE})
        agg.add_batch(rows, sums, config.warm_up_rounds,
                      heal_at=config.heal_at,
                      impaired=config.impairments_on, pull=False)
        batches.append({"lo": lo, "n_valid": n_valid,
                        "init_s": _span_s(marks[0], marks[1]),
                        "rounds_s": _span_s(marks[1], marks[2]),
                        "dispatch_s": dispatch_s, "copy_wait_s": waited,
                        "harvest_s": time.perf_counter() - t})
        log.info("all-origins: %s/%s origins done",
                 min(lo + n_valid, total_o), total_o)

    # double-buffered: batch k + 1 is queued before batch k is harvested;
    # batch k's device state is freed once its copy is queued, so the two
    # batches' states never coexist on the device
    pending = None
    for lo in range(0, total_o, batch):
        job = _dispatch(lo)
        if pending is not None:
            _harvest(pending)
        pending = job
    if pending is not None:
        _harvest(pending)
    dt = time.time() - t0

    extra = {"origin_iters": counts["origin_iters"],
             "messages_delivered": counts["messages_delivered"],
             "batches": batches}
    if agg.measured_points == 0:
        log.warning("WARNING: no measured rounds (iterations <= "
                    "warm-up-rounds); skipping stats")
        return {
            "num_nodes": N, "num_origins": total_o,
            "iterations": iters, "measured_points": 0,
            "coverage_mean": 0.0, "rmr_mean": 0.0, "elapsed_s": dt,
            "origin_iters_per_sec": total_o * iters / dt,
            "mesh_devices": 1, "mesh_node_shards": 1,
            "padded_sims": counts["padded_sims"], "hop_clamped": 0,
            "stats": agg, **extra,
        }
    agg.finalize(config)
    _warn_shape_truncation(
        {"inb_dropped": agg.inb_dropped, "rc_overflow": agg.rc_overflow,
         "hop_clamped": agg.hop_clamped,
         # per-node ingress summed over nodes == total delivered entries
         "delivered": int(agg.ingress.sum())},
        params)
    if config.print_stats:
        agg.print_all()
    summary = {
        "num_nodes": N,
        "num_origins": total_o,
        "iterations": iters,
        "measured_points": agg.measured_points,
        "coverage_mean": agg.coverage_stats.mean,
        "rmr_mean": agg.rmr_stats.mean,
        "elapsed_s": dt,
        "origin_iters_per_sec": total_o * iters / dt,
        "mesh_devices": 1,
        "mesh_node_shards": 1,
        "padded_sims": counts["padded_sims"],
        "hop_clamped": int(agg.hop_clamped),
        "stats": agg,
        # queue-cap drops (traffic runs, ROADMAP A11) ride in every summary
        "queue_dropped": 0,
        "queue_dropped_ingress": 0,
        "queue_deferred_egress": 0,
        **extra,
    }
    log.info("ALL-ORIGINS SUMMARY: %s",
             {k: v for k, v in summary.items()
              if k not in ("stats", "batches")})
    return summary


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s")
    args = build_parser().parse_args(argv)
    config = config_from_args(args)
    if config.gossip_iterations <= config.warm_up_rounds:
        log.warning("WARNING: Gossip Iterations (%s) <= Warm Up Rounds (%s). "
                    "No stats will be recorded....",
                    config.gossip_iterations, config.warm_up_rounds)
    t0 = time.perf_counter()
    if config.all_origins:
        run_all_origins(config)
    else:
        collection = simulate(config)
    log.info("simulation wall time: %.3f s on %s", time.perf_counter() - t0,
             config.device)
    if config.device != "cpu":
        log.info("kernel launches: %s", dict(kernels.LAUNCHES))
    if config.all_origins:
        return 0
    if config.print_stats:
        if not collection.is_empty():
            collection.print_all(config.gossip_iterations,
                                 config.warm_up_rounds, config.test_type)
        else:
            log.warning("WARNING: Gossip Stats Collection is empty. "
                        "Is `Iterations` <= `warm-up-rounds`?")
    return 0


if __name__ == "__main__":
    sys.exit(main())
