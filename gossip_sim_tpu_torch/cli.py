"""Experiment harness and sweeps (reference: gossip_main.rs), on the
PyTorch engine: one simulation or a ``--test-type`` sweep of them, and
all-origins mode.  ``--gossip-mode`` picks the protocol phases: push (the
reference's protocol), pull, push-pull or adaptive (pull.py, adaptive.py).

Flag names, defaults and sweep semantics are the reference's
(gossip_main.rs:53-241, 774-951); ``--device`` (``cuda`` by default, or
``cpu``) selects where the engine runs.  The cluster comes from the
synthetic seeded recipe (``--num-synthetic-nodes``), a YAML account file
(``--account-file ... --accounts-from-yaml``) or the JSON-RPC
``getVoteAccounts`` pull (``--url``).  ``--influx l|i`` streams the
reference's Influx series (sinks/influx.py).  ``--traffic-values`` > 1 or a
queue cap (``--node-ingress-cap``, ``--node-egress-cap``) runs the
concurrent-traffic engine instead (:func:`run_traffic`: one run, or a
``traffic-rate``, ``node-ingress-cap``, ``packet-loss``, ``churn`` or
``adaptive-threshold`` sweep, serial or, with ``--sweep-lanes K``, K points
at a time as the lanes of one batch, :func:`_run_traffic_lane_sweep`).  A
flag the port lacks is rejected by argparse: traces, checkpoints, telemetry
and the run report are later slices (ROADMAP A12-A16).

``python -m gossip_sim_tpu_torch --num-synthetic-nodes 10000
--iterations 300 --print-stats`` runs the 10,000-node synthetic cluster on
the GPU; ``--test-type active-set-size --num-simulations 4 --step-size 4``
sweeps it (:func:`dispatch_sweeps`; an origin-rank sweep runs its ranks as
the origins of one engine batch, :func:`run_origin_rank_sweep`);
``--all-origins`` runs every node as an origin, in origin batches
(:func:`run_all_origins`).  With ``--sweep-lanes K`` a knob sweep
(``LANE_SWEEP_TYPES``) runs its points as the lanes of one batch, K at a
time (:func:`run_lane_sweep`), with the serial sweep's results.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import kernels
from .config import Config, StepSize, Testing
from .constants import (AGGREGATE_HOPS_FAIL_NODES_HISTOGRAM_UPPER_BOUND,
                        AGGREGATE_HOPS_MIN_INGRESS_NODES_HISTOGRAM_UPPER_BOUND,
                        API_MAINNET_BETA, COVERAGE_RECOVERY_THRESHOLD,
                        STANDARD_HISTOGRAM_UPPER_BOUND, UNREACHED,
                        VALIDATOR_STAKE_DISTRIBUTION_NUM_BUCKETS,
                        get_influx_url, get_json_rpc_url)
from .engine import (EngineParams, broadcast_state, check_lane_knobs,
                     init_state, lane_state, make_cluster_tables,
                     merge_lane_statics, run_rounds, run_rounds_lanes,
                     stack_knobs)
from .engine.traffic import (broadcast_traffic_state, device_traffic_tables,
                             init_traffic_state, run_traffic_lanes,
                             run_traffic_rounds, traffic_lane_state)
from .identity import NodeIndex
from .ingest import (fetch_vote_accounts_rpc, filter_accounts,
                     load_accounts_yaml, log_cluster_summary,
                     synthetic_accounts)
from .rng import prng_key
from .rustrng import ChaChaRng
from .sinks import DatapointQueue, InfluxDataPoint, InfluxThread, load_dotenv
from .stats.aggregate import AllOriginsStats, lane_rows
from .stats.gossip_stats import GossipStats, GossipStatsCollection
from .stats.traffic import (ADAPTIVE_ROUND_FIELDS, ROUND_FIELDS,
                            TrafficStats, TrafficStatsCollection)
from .traffic import retire_record

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
        gossip_mode=config.gossip_mode,
        pull_fanout=config.pull_fanout,
        pull_interval=config.pull_interval,
        pull_bloom_fp_rate=config.pull_bloom_fp_rate,
        pull_request_cap=config.pull_request_cap,
        adaptive_switch_threshold=config.adaptive_switch_threshold,
        adaptive_switch_hysteresis=config.adaptive_switch_hysteresis,
        traffic_values=config.traffic_values,
        traffic_rate=config.traffic_rate,
        node_ingress_cap=config.node_ingress_cap,
        node_egress_cap=config.node_egress_cap,
        traffic_stall_rounds=config.traffic_stall_rounds,
        representation=config.engine_representation)


def build_parser() -> argparse.ArgumentParser:
    """The reference CLI surface (gossip_main.rs:53-241) for what the port
    carries, plus ``--device``."""
    p = argparse.ArgumentParser(
        prog="gossip-sim",
        description="Solana gossip protocol simulator (PyTorch/CUDA)")
    p.add_argument("--url", dest="json_rpc_url", default=API_MAINNET_BETA,
                   metavar="URL_OR_MONIKER", help="solana's json rpc url")
    p.add_argument("--account-file", default="", metavar="PATH",
                   help="yaml of solana accounts to either read from or "
                        "write to")
    p.add_argument("--accounts-from-yaml", action="store_true",
                   help="set to read in key/stake pairs from yaml. "
                        "use with --account-file <path>")
    p.add_argument("--filter-zero-staked-nodes", "-f", action="store_true",
                   help="Filter out all zero-staked nodes")
    p.add_argument("--push-fanout", type=int, default=6,
                   help="gossip push fanout")
    p.add_argument("--active-set-size", type=int, default=12,
                   help="gossip push active set entry size")
    p.add_argument("--iterations", type=int, default=1,
                   help="gossip iterations")
    p.add_argument("--origin-rank", type=int, nargs="+", default=[1],
                   help="Select an origin with origin rank for gossip "
                        "(1 = largest stake). Pass a list with "
                        "--test-type origin-rank to sweep.")
    p.add_argument("--rotation-probability", "-p", type=float,
                   default=0.013333,
                   help="After each round of gossip, rotate a node's active "
                        "set with probability 0 <= p <= 1")
    p.add_argument("--min-ingress-nodes", type=int, default=2,
                   help="Minimum number of incoming peers a node must keep")
    p.add_argument("--prune-stake-threshold", type=float, default=0.15,
                   help="Ensure a node is connected to a minimum stake of "
                        "prune_stake_threshold*node.stake()")
    p.add_argument("--num-buckets-stranded", type=int, default=10,
                   help="Number of buckets for the stranded node histogram")
    p.add_argument("--num-buckets-message", type=int, default=5,
                   help="Number of buckets for the ingress/egress message "
                        "histograms")
    p.add_argument("--num-buckets-hops", type=int, default=15,
                   help="Number of buckets for the hops_stats histogram")
    p.add_argument("--test-type", default="no-test",
                   choices=[t.value for t in Testing],
                   help="Type of sweep to run")
    p.add_argument("--num-simulations", type=int, default=1,
                   help="Number of simulations to run")
    p.add_argument("--step-size", default="1",
                   help="Size of step for test_type (int or float)")
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
    p.add_argument("--gossip-mode", default="push",
                   choices=["push", "pull", "push-pull", "adaptive"],
                   help="protocol phases to simulate: push (the reference "
                        "protocol; default), pull (anti-entropy only), "
                        "push-pull (both; pull rescues push-stranded "
                        "nodes), or adaptive (push while coverage is low; "
                        "a sim's pull phase runs once its coverage crosses "
                        "--adaptive-switch-threshold)")
    p.add_argument("--adaptive-switch-threshold", type=float, default=0.9,
                   help="adaptive mode: coverage fraction at which a sim "
                        "turns its pull phase on")
    p.add_argument("--adaptive-switch-hysteresis", type=float, default=0.05,
                   help="adaptive mode: the pull phase turns off again only "
                        "when coverage falls below threshold - hysteresis")
    p.add_argument("--pull-fanout", type=int, default=2,
                   help="pull requests each live node sends per pull round "
                        "(stake-weighted peer sampling)")
    p.add_argument("--pull-interval", type=int, default=1,
                   help="rounds between pull exchanges (pull runs when "
                        "iteration %% interval == 0)")
    p.add_argument("--pull-bloom-fp-rate", type=float, default=0.1,
                   help="bloom-filter false-positive probability of the "
                        "pull request digest (a holder wrongly filters "
                        "the value out; Solana's bloom targets 0.1)")
    p.add_argument("--pull-request-cap", type=int, default=0,
                   help="max pull requests a peer serves per round "
                        "(<= 0 = unlimited); excess requests are counted "
                        "as misses")
    p.add_argument("--traffic-values", type=int, default=1,
                   help="concurrent CRDS value slots (traffic.py): > 1 "
                        "switches to the M-value traffic engine — a "
                        "deterministic stake-weighted injection schedule "
                        "where all in-flight values share ONE active-set/"
                        "prune/rotation state and contend for per-node "
                        "queue budgets.  1 with both caps off (default) is "
                        "bit-identical to the single-value simulator")
    p.add_argument("--traffic-rate", type=int, default=1,
                   help="new values injected per round at counter-hashed "
                        "stake-weighted origins (traffic mode; injections "
                        "beyond free slots are counted as dropped)")
    p.add_argument("--node-ingress-cap", type=int, default=0,
                   help="messages a node ACCEPTS per round across all "
                        "in-flight values (<= 0 = unlimited); excess "
                        "arrivals are dropped with a queue_dropped outcome")
    p.add_argument("--node-egress-cap", type=int, default=0,
                   help="messages a node SENDS per round across all "
                        "in-flight values (<= 0 = unlimited); excess "
                        "candidates defer to the next round (a send queue)")
    p.add_argument("--traffic-stall-rounds", type=int, default=3,
                   help="consecutive no-progress rounds before an "
                        "unconverged value retires and frees its slot")
    p.add_argument("--engine-representation", default="dense",
                   choices=["dense", "sparse"],
                   help="gossip-round execution layout: dense keeps the "
                        "full-width round; sparse derives the "
                        "received-cache stake planes from the cluster "
                        "tables instead of carrying two [O,N,C] arrays — "
                        "bit-identical rows and state, roughly half the "
                        "received-cache bytes. Push mode only; traffic "
                        "needs dense")
    p.add_argument("--influx", default="n",
                   help="Influx for reporting metrics. i for "
                        "internal-metrics, l for localhost, n for none")
    p.add_argument("--influx-spool", default="", metavar="PATH",
                   help="durable sink spool: Influx points dropped after "
                        "retry exhaustion or queue overflow are appended "
                        "to PATH as line protocol instead of discarded")
    p.add_argument("--print-stats", action="store_true",
                   help="Print Gossip Stats to console at end of simulation")
    p.add_argument("--seed", type=int, default=42,
                   help="Deterministic RNG seed")
    p.add_argument("--num-synthetic-nodes", type=int, default=0,
                   help=">0: run on a synthetic seeded cluster instead of "
                        "an account file / RPC")
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
    p.add_argument("--sweep-lanes", type=int, default=0,
                   help="run a knob sweep (packet-loss, churn, pull-fanout, "
                        "rotate-probability, prune-stake-threshold, min-"
                        "ingress-nodes, fail-nodes, adaptive-threshold) "
                        "lane-batched: K sweep points run as the lanes of "
                        "ceil(K/lanes) engine batches with a single harvest "
                        "each, bit-identical to the serial sweep "
                        "(engine/lanes.py). 0 = serial. Shape-stepping "
                        "sweeps (active-set-size, push-fanout) and origin-"
                        "rank fall back to their existing paths")
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
    if not 0.0 <= args.pull_bloom_fp_rate <= 1.0:
        raise SystemExit("pull-bloom-fp-rate must be between 0 and 1")
    if args.gossip_mode != "push":
        if args.pull_fanout < 1:
            raise SystemExit("pull-fanout must be >= 1")
        if args.pull_interval < 1:
            raise SystemExit("pull-interval must be >= 1")
    if args.gossip_mode == "adaptive":
        if not 0.0 < args.adaptive_switch_threshold <= 1.0:
            raise SystemExit("adaptive-switch-threshold must be in (0, 1]")
        if not (0.0 <= args.adaptive_switch_hysteresis
                < args.adaptive_switch_threshold):
            raise SystemExit("adaptive-switch-hysteresis must be in "
                             "[0, adaptive-switch-threshold)")
    if args.mesh_node_shards < 1:
        raise SystemExit("mesh-node-shards must be >= 1")
    if args.sweep_lanes < 0:
        raise SystemExit("sweep-lanes must be >= 0")
    return Config(
        gossip_push_fanout=args.push_fanout,
        gossip_active_set_size=args.active_set_size,
        gossip_iterations=args.iterations,
        accounts_from_file=args.accounts_from_yaml,
        account_file=args.account_file,
        origin_rank=args.origin_rank[0],
        probability_of_rotation=prob,
        prune_stake_threshold=args.prune_stake_threshold,
        min_ingress_nodes=args.min_ingress_nodes,
        filter_zero_staked_nodes=args.filter_zero_staked_nodes,
        num_buckets_for_stranded_node_hist=args.num_buckets_stranded,
        num_buckets_for_message_hist=args.num_buckets_message,
        num_buckets_for_hops_stats_hist=args.num_buckets_hops,
        fraction_to_fail=args.fraction_to_fail,
        when_to_fail=args.when_to_fail,
        test_type=Testing.parse(args.test_type),
        num_simulations=args.num_simulations,
        step_size=StepSize.parse(args.step_size),
        warm_up_rounds=args.warm_up_rounds,
        print_stats=args.print_stats,
        packet_loss_rate=args.packet_loss_rate,
        churn_fail_rate=args.churn_fail_rate,
        churn_recover_rate=args.churn_recover_rate,
        partition_at=args.partition_at,
        heal_at=args.heal_at,
        gossip_mode=args.gossip_mode,
        pull_fanout=args.pull_fanout,
        pull_interval=args.pull_interval,
        pull_bloom_fp_rate=args.pull_bloom_fp_rate,
        pull_request_cap=args.pull_request_cap,
        adaptive_switch_threshold=args.adaptive_switch_threshold,
        adaptive_switch_hysteresis=args.adaptive_switch_hysteresis,
        traffic_values=args.traffic_values,
        traffic_rate=args.traffic_rate,
        node_ingress_cap=args.node_ingress_cap,
        node_egress_cap=args.node_egress_cap,
        traffic_stall_rounds=args.traffic_stall_rounds,
        engine_representation=args.engine_representation,
        influx_spool=args.influx_spool,
        seed=args.seed,
        num_synthetic_nodes=args.num_synthetic_nodes,
        all_origins=args.all_origins,
        origin_batch=args.origin_batch,
        mesh_devices=args.mesh_devices,
        mesh_node_shards=args.mesh_node_shards,
        sweep_lanes=args.sweep_lanes,
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


def load_cluster_accounts(config: Config,
                          json_rpc_url: str = API_MAINNET_BETA):
    """Resolve the account source (gossip_main.rs:302-328): the synthetic
    seeded cluster, a YAML account file or the JSON-RPC pull, then the
    zero-stake filter -> ({pk: stake}, source label).  Each synthetic
    cluster draws fresh counter pubkeys, so every point of a serial sweep
    has its own pubkeys and node order, as in the reference."""
    if config.num_synthetic_nodes > 0:
        rng = ChaChaRng.from_seed_byte(config.seed % 256)
        accounts = synthetic_accounts(config.num_synthetic_nodes, rng)
        label = f"synthetic:{config.num_synthetic_nodes}"
    elif config.accounts_from_file:
        if not config.account_file:
            log.error("need --account-file <path> with --accounts-from-yaml")
            raise SystemExit(-1)
        log.info("Reading %s", config.account_file)
        accounts = load_accounts_yaml(config.account_file)
        label = config.account_file
    else:
        url = get_json_rpc_url(json_rpc_url)
        log.info("json_rpc_url: %s", url)
        accounts = fetch_vote_accounts_rpc(url)
        label = url
    accounts = filter_accounts(accounts, config.filter_zero_staked_nodes)
    log_cluster_summary(accounts)
    return accounts, label


def _run_torch_backend(config: Config, accounts, origin_pubkey,
                       stats: GossipStats, dp_queue=None, sim_iter: int = 0,
                       start_ts: str = "0"):
    """The simulation on the PyTorch engine: the warm-up rounds in one
    call, then the measured rounds harvested per iteration into the stats
    layer and the Influx series (the reference's per-iteration loop,
    gossip_main.rs:425-565)."""
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
        # the reference loop's progress logs and config points every 10
        # iterations (gossip_main.rs:426-447)
        for it in range(0, warm, 10):
            log.info("GOSSIP ITERATION: %s", it)
            _push_config_point(config, dp_queue, sim_iter, start_ts)
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
        t_blk = time.perf_counter()
        state, trows = run_rounds(params, tables, origins, state, n_it,
                                  start_it=start_it, detail=True)
        rows = {k: v.cpu().numpy() for k, v in trows.items()}
        blk_wall = time.perf_counter() - t_blk
        _warn_shape_truncation(rows, params)
        if (params.fail_at >= 0
                and start_it <= params.fail_at < start_it + n_it):
            _record_failed()
        for t in range(n_it):
            it = start_it + t
            if it % 10 == 0:
                log.info("GOSSIP ITERATION: %s", it)
                _push_config_point(config, dp_queue, sim_iter, start_ts)
            _feed_measured_round(stats, rows, t, 0, it, config, index,
                                 stakes, origin_pubkey, dp_queue, sim_iter,
                                 start_ts)
        done += n_it
        _push_sim_perf_point(dp_queue, sim_iter, start_ts, blk_wall, n_it, 1)
    if measured > 0:
        _feed_message_counters(stats, state, 0, index)
        if params.has_churn:
            _record_failed()
    return stakes


def _feed_measured_round(stats, rows, t, col, it, config, index, stakes,
                         origin_pubkey, dp_queue=None, sim_iter: int = 0,
                         start_ts: str = "0"):
    """Insert one measured round (origin column ``col`` of harvested rows)
    into the stats layer and push its Influx points (gossip_main.rs:
    480-563)."""
    steady = it - config.warm_up_rounds
    coverage = float(rows["coverage"][t, col])
    if config.heal_at >= 0 and it >= config.heal_at:
        stats.note_post_heal_coverage(it, coverage)
    if coverage < POOR_COVERAGE_THRESHOLD:
        log.warning("WARNING: poor coverage for origin: %s, %s",
                    origin_pubkey, coverage)
    dist = rows["dist"][t, col]            # [N], -1 = unreached (push)
    if "pull_hop" in rows:
        # pull rescues join the per-node hop view (pull.py)
        dist = np.where(dist >= 0, dist, rows["pull_hop"][t, col])
    hops = np.where(dist < 0, UNREACHED, dist.astype(np.uint64))
    stranded_mask = rows["stranded_mask"][t, col]
    stranded = [index.pubkeys[i] for i in np.nonzero(stranded_mask)[0]]
    stats.insert_coverage(coverage)
    stats.insert_hops_stat(hops.tolist())
    stats.insert_stranded_nodes(stranded, stakes)
    stats.insert_branching_factor(float(rows["branching"][t, col]))
    rmr_result = (float(rows["rmr"][t, col]), int(rows["m"][t, col]),
                  int(rows["n"][t, col]))
    stats.insert_rmr(rmr_result[0])
    if config.wants_delivery_stats:
        stats.insert_delivery(int(rows["delivered"][t, col]),
                              int(rows["dropped"][t, col]),
                              int(rows["suppressed"][t, col]),
                              int(rows["failed_count"][t, col]))
    if "pull_requests" in rows:
        stats.insert_pull(int(rows["pull_requests"][t, col]),
                          int(rows["pull_responses"][t, col]),
                          int(rows["pull_misses"][t, col]),
                          int(rows["pull_dropped"][t, col]),
                          int(rows["pull_suppressed"][t, col]),
                          int(rows["pull_rescued"][t, col]))
    if "adaptive_pull_active" in rows:
        stats.insert_adaptive(int(rows["adaptive_pull_active"][t, col]),
                              int(rows["adaptive_switched"][t, col]))
    _push_iteration_points(dp_queue, sim_iter, start_ts, stats, steady,
                           coverage, rmr_result)


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


def _new_stats(config: Config, origin_pubkey, stakes) -> GossipStats:
    """A simulation's stats, before its first round (gossip_main.rs:
    337-352)."""
    stats = GossipStats()
    stats.set_simulation_parameters(config)
    stats.set_origin(origin_pubkey)
    stats.initialize_message_stats(stakes)
    stats.build_validator_stake_distribution_histogram(
        VALIDATOR_STAKE_DISTRIBUTION_NUM_BUCKETS, stakes)
    return stats


def _test_type_point(config: Config, sim_iter, start_ts, num_nodes,
                     source_label, start, stats):
    """The sweep's ``simulation_config`` point and the validator stake
    distribution, in one datapoint (influx_db.rs)."""
    dp = InfluxDataPoint(start_ts, sim_iter)
    dp.create_test_type_point(
        config.num_simulations, config.gossip_iterations,
        config.warm_up_rounds, config.step_size, num_nodes,
        config.probability_of_rotation, source_label, start,
        config.test_type)
    dp.create_validator_stake_distribution_histogram_point(
        stats.get_validator_stake_distribution_histogram())
    return dp


def run_simulation(config: Config, json_rpc_url: str,
                   stats_collection: GossipStatsCollection, dp_queue=None,
                   sim_iter: int = 0, start_ts: str = "0",
                   start_value: float = 0.0) -> None:
    """One simulation (gossip_main.rs:292-647): load the cluster, pick the
    origin, run the engine, finalize the stats into ``stats_collection``.
    Sim 0 of a run pushes the test-type point and the stake distribution;
    every sim pushes the start sentinel before its rounds."""
    log.info("##### SIMULATION ITERATION: %s #####", sim_iter)
    accounts, source_label = load_cluster_accounts(config, json_rpc_url)
    log.info("%s", config)
    if len(accounts) < config.origin_rank:
        raise SystemExit(
            f"ERROR: origin_rank larger than number of simulation nodes. "
            f"nodes: {len(accounts)}, origin_rank: {config.origin_rank}")
    origin_pubkey = find_nth_largest_node(config.origin_rank,
                                          list(accounts.items()))[0]
    stakes = dict(accounts)
    log.info("ORIGIN: %s", origin_pubkey)
    log.info("Calculating the MSTs for origin: %s, stake: %s",
             origin_pubkey, stakes[origin_pubkey])
    stats = _new_stats(config, origin_pubkey, stakes)
    if sim_iter == 0 and dp_queue is not None:
        start = ("N/A" if config.test_type == Testing.NO_TEST
                 else str(start_value))
        dp_queue.push_back(_test_type_point(
            config, sim_iter, start_ts, len(accounts), source_label, start,
            stats))
    if dp_queue is not None:
        dp = InfluxDataPoint(start_ts, sim_iter)
        dp.set_start()
        dp_queue.push_back(dp)
    stakes = _run_torch_backend(config, accounts, origin_pubkey, stats,
                                dp_queue, sim_iter, start_ts)
    _finalize_sim_stats(config, stats, stakes, stats_collection, dp_queue,
                        sim_iter, start_ts)


def _finalize_sim_stats(config, stats, stakes, stats_collection, dp_queue,
                        sim_iter, start_ts):
    """End-of-simulation histograms, calculations, collection push and
    Influx points (gossip_main.rs:567-645)."""
    if stats.is_empty():
        return
    _build_final_stats(config, stats, stakes)
    stats_collection.push(stats)
    _push_end_of_sim_points(dp_queue, sim_iter, start_ts, stats)


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
    """One simulation of ``config`` into a fresh stats collection, without
    Influx."""
    collection = GossipStatsCollection()
    collection.set_number_of_simulations(config.num_simulations)
    run_simulation(config, API_MAINNET_BETA, collection)
    return collection


# --------------------------------------------------------------------------
# sweeps (gossip_main.rs:774-951)
# --------------------------------------------------------------------------

def _stepped_sweep_config(config: Config, i: int, origin_ranks):
    """Sweep point ``i``'s (stepped config, Influx start value): the
    reference's per-sim stepping (gossip_main.rs:774-951), each value
    computed as the reference package computes it (``v0 + i * step``; loss,
    churn and the adaptive threshold clamped at 1.0)."""
    tt = config.test_type
    if tt == Testing.ACTIVE_SET_SIZE:
        v = config.gossip_active_set_size + i * config.step_size.as_int()
        return config.stepped(gossip_active_set_size=v), \
            float(config.gossip_active_set_size)
    if tt == Testing.PUSH_FANOUT:
        v = config.gossip_push_fanout + i * config.step_size.as_int()
        c = config.stepped(gossip_push_fanout=v)
        # fanout beyond the active set would silently cap (gossip_main.rs:812)
        if v > c.gossip_active_set_size:
            c = c.stepped(gossip_active_set_size=v)
        return c, float(config.gossip_push_fanout)
    if tt == Testing.MIN_INGRESS_NODES:
        v = config.min_ingress_nodes + i * config.step_size.as_int()
        # the reference reports the stepped value here
        return config.stepped(min_ingress_nodes=v), float(v)
    if tt == Testing.PRUNE_STAKE_THRESHOLD:
        v = config.prune_stake_threshold + i * config.step_size.as_float()
        return config.stepped(prune_stake_threshold=v), \
            float(config.prune_stake_threshold)
    if tt == Testing.ORIGIN_RANK:
        return config.stepped(origin_rank=origin_ranks[i]), \
            float(origin_ranks[i])
    if tt == Testing.FAIL_NODES:
        v = config.fraction_to_fail + i * config.step_size.as_float()
        return config.stepped(fraction_to_fail=v), \
            float(config.fraction_to_fail)
    if tt == Testing.ROTATE_PROBABILITY:
        v = config.probability_of_rotation + i * config.step_size.as_float()
        return config.stepped(probability_of_rotation=v), \
            float(config.probability_of_rotation)
    if tt == Testing.PACKET_LOSS:
        v = min(config.packet_loss_rate
                + i * config.step_size.as_float(), 1.0)
        return config.stepped(packet_loss_rate=v), \
            float(config.packet_loss_rate)
    if tt == Testing.CHURN:
        # sweep the fail rate; the recover rate rides along unstepped
        v = min(config.churn_fail_rate
                + i * config.step_size.as_float(), 1.0)
        return config.stepped(churn_fail_rate=v), \
            float(config.churn_fail_rate)
    if tt == Testing.PULL_FANOUT:
        v = config.pull_fanout + i * config.step_size.as_int()
        return config.stepped(pull_fanout=v), float(config.pull_fanout)
    if tt == Testing.TRAFFIC_RATE:
        v = config.traffic_rate + i * config.step_size.as_int()
        return config.stepped(traffic_rate=v), float(config.traffic_rate)
    if tt == Testing.NODE_INGRESS_CAP:
        v = config.node_ingress_cap + i * config.step_size.as_int()
        return config.stepped(node_ingress_cap=v), \
            float(config.node_ingress_cap)
    if tt == Testing.ADAPTIVE_THRESHOLD:
        v = min(config.adaptive_switch_threshold
                + i * config.step_size.as_float(), 1.0)
        return config.stepped(adaptive_switch_threshold=v), \
            float(config.adaptive_switch_threshold)
    return config, 0.0  # NO_TEST


#: test types whose stepped Config field is a numeric engine knob: the
#: sweeps whose points can run as lanes of one batch (reference cli.py:
#: 3516-3519).  ACTIVE_SET_SIZE and PUSH_FANOUT step shapes and
#: ORIGIN_RANK has its own batched path, so they stay serial.
LANE_SWEEP_TYPES = (Testing.MIN_INGRESS_NODES, Testing.PRUNE_STAKE_THRESHOLD,
                    Testing.FAIL_NODES, Testing.ROTATE_PROBABILITY,
                    Testing.PACKET_LOSS, Testing.CHURN, Testing.PULL_FANOUT,
                    Testing.ADAPTIVE_THRESHOLD)


def _lane_sweep_blocker(config: Config):
    """None when --sweep-lanes can serve this sweep, else the reason the
    dispatcher logs before it runs the serial sweep (reference cli.py:
    3522-3538)."""
    if config.num_simulations < 2:
        return "nothing to batch (num_simulations < 2)"
    if config.test_type not in LANE_SWEEP_TYPES:
        return (f"--test-type {config.test_type.value} does not step a "
                f"traced engine knob; lane-eligible sweeps: "
                + ", ".join(t.value for t in LANE_SWEEP_TYPES))
    if config.gossip_iterations <= config.warm_up_rounds:
        # nothing measurable to batch; the serial loop keeps its exact
        # degenerate-case behavior
        return "no measured rounds (iterations <= warm-up-rounds)"
    return None


def dispatch_sweeps(config: Config, json_rpc_url: str, origin_ranks,
                    collection: GossipStatsCollection, dp_queue=None,
                    start_ts: str = "0"):
    """``config.num_simulations`` simulations, stepped by
    ``config.test_type`` (gossip_main.rs:774-951): one after another, each
    on a freshly loaded cluster, except an origin-rank sweep of more than
    one rank, which runs its ranks as the origins of one engine batch
    (:func:`run_origin_rank_sweep`), and with ``--sweep-lanes`` a knob
    sweep, whose points run as lanes (:func:`run_lane_sweep`); those two
    return their timings."""
    if (config.test_type == Testing.ORIGIN_RANK
            and config.num_simulations > 1):
        return run_origin_rank_sweep(config, json_rpc_url, origin_ranks,
                                     collection, dp_queue, start_ts)
    if config.sweep_lanes > 0:
        blocker = _lane_sweep_blocker(config)
        if blocker is None:
            return run_lane_sweep(config, json_rpc_url, origin_ranks,
                                  collection, dp_queue, start_ts)
        log.warning("WARNING: --sweep-lanes %s ignored (%s); running the "
                    "serial sweep", config.sweep_lanes, blocker)
    for i in range(config.num_simulations):
        c, start = _stepped_sweep_config(config, i, origin_ranks)
        run_simulation(c, json_rpc_url, collection, dp_queue, i, start_ts,
                       start)
    return None


def run_lane_sweep(config: Config, json_rpc_url: str, origin_ranks,
                   stats_collection: GossipStatsCollection, dp_queue=None,
                   start_ts: str = "0") -> dict:
    """A knob sweep as lane batches (reference cli.py:1495-1691).

    The K sweep points' :class:`EngineKnobs` stack into lanes
    (engine/lanes.py) and the sweep runs as ``ceil(K / lanes)`` batches,
    each the whole run of its lanes (the warm-up, then the measured rounds
    with their per-node rows) and one copy of its rows to the host.  Each
    lane then feeds the serial sweep's per-simulation stats and Influx
    paths, in sweep order, so the results are the serial sweep's.  A batch
    the sweep does not fill is padded with the last point's knobs; padded
    lanes are dropped before any stats or Influx feeding.  The cluster is
    loaded once (a synthetic cluster draws fresh pubkeys per load, so a
    serial arm compared with this one resets the pubkey counter per
    point).  Returns the walls of the cluster build, the engine (rounds
    until their rows are on the host) and the harvest, in seconds."""
    K = config.num_simulations
    L = max(1, min(config.sweep_lanes, K))
    n_batches = -(-K // L)
    sweep = [_stepped_sweep_config(config, i, origin_ranks)
             for i in range(K)]

    t0 = time.perf_counter()
    accounts, source_label = load_cluster_accounts(config, json_rpc_url)
    if len(accounts) < config.origin_rank:
        raise SystemExit(
            f"ERROR: origin_rank larger than number of simulation nodes. "
            f"nodes: {len(accounts)}, origin_rank: {config.origin_rank}")
    origin_pubkey = find_nth_largest_node(config.origin_rank,
                                          list(accounts.items()))[0]
    stakes = dict(accounts)
    index = NodeIndex.from_stakes(accounts)
    N = len(index)
    params_list = [_engine_params(c, N).validate() for c, _ in sweep]
    static = merge_lane_statics([p.static_part() for p in params_list])
    knob_list = [p.knob_values() for p in params_list]
    check_lane_knobs(static, knob_list)
    tables = make_cluster_tables(index.stakes.astype(np.int64),
                                 device=config.device)
    dev = tables.stakes.device
    origins = torch.tensor([index.index_of(origin_pubkey)],
                           dtype=torch.int32, device=dev)
    times = {"cluster_s": time.perf_counter() - t0, "engine_s": 0.0,
             "harvest_s": 0.0, "lanes": L, "batches": n_batches}
    log.info("##### LANE-BATCHED SWEEP: %s sims x %s lanes = %s batched "
             "engine call(s) #####", K, L, n_batches)
    log.info("ORIGIN: %s", origin_pubkey)
    stats_list = [_new_stats(c, origin_pubkey, stakes) for c, _ in sweep]

    total = config.gossip_iterations
    warm = min(config.warm_up_rounds, total)
    measured = total - warm
    if measured <= 0:
        # dispatch_sweeps routes this case to the serial loop; a guard
        # for direct callers
        log.warning("WARNING: no measured rounds (iterations <= warm-up-"
                    "rounds); lane sweep has nothing to harvest")
        return times

    t_engine = time.perf_counter()
    log.info("Simulating Gossip and setting active sets. Please wait.....")
    base_state = init_state(prng_key(config.seed, dev), tables, origins,
                            params_list[0])
    log.info("Simulation Complete!")
    times["engine_s"] += time.perf_counter() - t_engine
    for b in range(n_batches):
        ids = list(range(b * L, min((b + 1) * L, K)))
        padded = ids + [ids[-1]] * (L - len(ids))
        kstack = stack_knobs([knob_list[i] for i in padded])
        t_blk = time.perf_counter()
        states = broadcast_state(base_state, L)
        wrows = {}
        if warm > 0:
            states, wrows = run_rounds_lanes(static, tables, origins, states,
                                             kstack, warm)
        states, mrows = run_rounds_lanes(static, tables, origins, states,
                                         kstack, measured, start_it=warm,
                                         detail=True)
        # the one copy of the batch's rows and final counters to the host
        wrows = {"coverage": wrows["coverage"].cpu().numpy()} if wrows \
            else {}
        mrows = {k: v.cpu().numpy() for k, v in mrows.items()}
        final = {f: getattr(states, f).cpu().numpy()
                 for f in ("failed", "egress_acc", "ingress_acc",
                           "prune_acc")}
        blk_wall = time.perf_counter() - t_blk
        times["engine_s"] += blk_wall
        t_harvest = time.perf_counter()
        for pos, i in enumerate(ids):
            lane_final = SimpleNamespace(
                **{f: torch.from_numpy(a[pos]) for f, a in final.items()})
            _harvest_lane(config, sweep[i], stats_list[i],
                          lane_rows(wrows, pos), lane_rows(mrows, pos),
                          lane_final, params_list[i], index, stakes,
                          origin_pubkey, dp_queue, i, start_ts, warm, total,
                          len(accounts), source_label)
            _finalize_sim_stats(sweep[i][0], stats_list[i], stakes,
                                stats_collection, dp_queue, i, start_ts)
        _push_sim_perf_point(dp_queue, ids[0], start_ts, blk_wall, measured,
                             len(ids))
        times["harvest_s"] += time.perf_counter() - t_harvest
    return times


def _harvest_lane(config, sweep_point, stats, wrows, mrows, lane_final,
                  params, index, stakes, origin_pubkey, dp_queue, sim_iter,
                  start_ts, warm, total, num_accounts, source_label):
    """Feed one harvested lane through the serial per-simulation paths
    (reference cli.py:1694-1743): the Influx preamble
    :func:`run_simulation` emits, the warm-up cadence, every measured round
    via :func:`_feed_measured_round`, and the end-of-run counters.
    ``wrows`` holds the warm-up rounds' ``coverage`` [warm, O], ``mrows``
    the measured rounds' rows [total - warm, O, ...] (the serial path's
    ``detail`` rows), ``lane_final`` the lane's final ``failed`` and
    message counters."""
    c, start_value = sweep_point
    log.info("##### SIMULATION ITERATION: %s #####", sim_iter)
    if sim_iter == 0 and dp_queue is not None:
        start = ("N/A" if c.test_type == Testing.NO_TEST
                 else str(start_value))
        dp = InfluxDataPoint(start_ts, 0)
        dp.create_test_type_point(
            config.num_simulations, config.gossip_iterations,
            config.warm_up_rounds, config.step_size, num_accounts,
            config.probability_of_rotation, source_label, start,
            config.test_type)
        dp.create_validator_stake_distribution_histogram_point(
            stats.get_validator_stake_distribution_histogram())
        dp_queue.push_back(dp)
    if dp_queue is not None:
        dp = InfluxDataPoint(start_ts, sim_iter)
        dp.set_start()
        dp_queue.push_back(dp)

    # the warm-up cadence (progress log and config point every 10 rounds),
    # as the serial path emits it before its warm-up rounds
    for it in range(0, warm, 10):
        log.info("GOSSIP ITERATION: %s", it)
        _push_config_point(c, dp_queue, sim_iter, start_ts)
    if 0 <= c.heal_at < warm:
        # heal inside the warm-up: the recovery metric still sees every
        # post-heal round (iteration-exact, as the serial paths)
        cov_w = wrows["coverage"][:, 0]
        for it in range(c.heal_at, warm):
            stats.note_post_heal_coverage(it, float(cov_w[it]))

    _warn_shape_truncation(mrows, params)
    for it in range(warm, total):
        if it % 10 == 0:
            log.info("GOSSIP ITERATION: %s", it)
            _push_config_point(c, dp_queue, sim_iter, start_ts)
        _feed_measured_round(stats, mrows, it - warm, 0, it, c, index,
                             stakes, origin_pubkey, dp_queue, sim_iter,
                             start_ts)

    if 0 <= params.fail_at < total or params.has_churn:
        # a fail mask never changes after fail_at and churn is reported at
        # the end of the run, so the final lane state carries what the
        # serial path records
        failed_idx = np.nonzero(lane_final.failed[0].numpy())[0]
        stats.set_failed_nodes({index.pubkeys[j] for j in failed_idx})
    _feed_message_counters(stats, lane_final, 0, index)


def run_origin_rank_sweep(config: Config, json_rpc_url: str, origin_ranks,
                          stats_collection: GossipStatsCollection,
                          dp_queue=None, start_ts: str = "0") -> dict:
    """An ORIGIN_RANK sweep as one origin-batched engine run (reference
    package cli.py:1266-1494): the R ranks ride the engine's origin axis
    through one ``init_state``, the warm-up in one ``run_rounds`` call and
    the measured blocks, and each origin column is harvested into its own
    stats and Influx points.  Each origin's draws depend only on its own
    index, so every column equals its rank's serial run.  Returns the
    engine's wall (rounds until their rows are on the host) and the
    harvest's, in seconds."""
    accounts, source_label = load_cluster_accounts(config, json_rpc_url)
    index = NodeIndex.from_stakes(accounts)
    stakes = dict(accounts)
    N = len(index)
    R = config.num_simulations
    configs, origin_pks = [], []
    for i in range(R):
        c = config.stepped(origin_rank=origin_ranks[i])
        if len(accounts) < c.origin_rank:
            raise SystemExit(
                f"ERROR: origin_rank larger than number of simulation "
                f"nodes. nodes: {len(accounts)}, origin_rank: {c.origin_rank}")
        configs.append(c)
        origin_pks.append(
            find_nth_largest_node(c.origin_rank, list(accounts.items()))[0])
    log.info("##### BATCHED ORIGIN-RANK SWEEP: %s origins in one engine "
             "call #####", R)
    params = _engine_params(config, N)
    tables = make_cluster_tables(index.stakes.astype(np.int64),
                                 device=config.device)
    dev = tables.stakes.device
    origins = torch.tensor([index.index_of(pk) for pk in origin_pks],
                           dtype=torch.int32, device=dev)
    t_harvest = time.perf_counter()
    stats_list = []
    for i, c in enumerate(configs):
        log.info("##### SIMULATION ITERATION: %s #####", i)
        log.info("ORIGIN: %s", origin_pks[i])
        stats_list.append(_new_stats(c, origin_pks[i], stakes))
    if dp_queue is not None:
        # the reference's sweep puts the start sentinel into the same
        # datapoint as the test-type point
        dp = _test_type_point(config, 0, start_ts, len(accounts),
                              source_label, str(float(origin_ranks[0])),
                              stats_list[0])
        dp.set_start()
        dp_queue.push_back(dp)
    harvest_s = time.perf_counter() - t_harvest

    warm = min(config.warm_up_rounds, config.gossip_iterations)
    measured = config.gossip_iterations - warm
    t_engine = time.perf_counter()
    log.info("Simulating Gossip and setting active sets. Please wait.....")
    state = init_state(prng_key(config.seed, dev), tables, origins, params)
    log.info("Simulation Complete!")
    if warm > 0:
        for it in range(0, warm, 10):
            log.info("GOSSIP ITERATION: %s", it)
        state, wrows = run_rounds(params, tables, origins, state, warm)
        if 0 <= config.heal_at < warm:
            # heal inside the warm-up: the recovery metric still needs
            # every post-heal round
            cov_w = wrows["coverage"].cpu().numpy()          # [warm, R]
            for it in range(config.heal_at, warm):
                for col in range(R):
                    stats_list[col].note_post_heal_coverage(
                        it, float(cov_w[it, col]))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    engine_s = time.perf_counter() - t_engine
    done = 0
    while done < measured:
        n_it = min(HARVEST_BLOCK, measured - done)
        start_it = warm + done
        t_blk = time.perf_counter()
        state, trows = run_rounds(params, tables, origins, state, n_it,
                                  start_it=start_it, detail=True)
        rows = {k: v.cpu().numpy() for k, v in trows.items()}
        blk_wall = time.perf_counter() - t_blk
        engine_s += blk_wall
        t_harvest = time.perf_counter()
        _warn_shape_truncation(rows, params)
        for t in range(n_it):
            it = start_it + t
            if it % 10 == 0:
                log.info("GOSSIP ITERATION: %s", it)
            for col in range(R):
                if it % 10 == 0:
                    _push_config_point(configs[col], dp_queue, col, start_ts)
                _feed_measured_round(stats_list[col], rows, t, col, it,
                                     configs[col], index, stakes,
                                     origin_pks[col], dp_queue, col,
                                     start_ts)
        done += n_it
        _push_sim_perf_point(dp_queue, 0, start_ts, blk_wall, n_it, R)
        harvest_s += time.perf_counter() - t_harvest
    t_harvest = time.perf_counter()
    for col in range(R):
        _feed_message_counters(stats_list[col], state, col, index)
        _finalize_sim_stats(configs[col], stats_list[col], stakes,
                            stats_collection, dp_queue, col, start_ts)
    harvest_s += time.perf_counter() - t_harvest
    return {"engine_s": engine_s, "harvest_s": harvest_s}


# --------------------------------------------------------------------------
# all-origins mode
# --------------------------------------------------------------------------

#: SimState accumulators the all-origins harvest reads, summed over the
#: batch's valid origins on the device (int64 sums of int32 counts: exact)
HARVEST_STATE = ("hops_hist_acc", "stranded_acc", "egress_acc",
                 "ingress_acc", "prune_acc")
#: and in the pull modes the pull-tagged ones
HARVEST_PULL_STATE = ("pull_hops_hist_acc", "pull_rescued_acc")


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


def _start_copy(rows: dict, state, n_valid: int, fields=HARVEST_STATE):
    """Start moving what the harvest reads of one batch to the host: every
    row of the valid origins, and the accumulators ``fields`` summed over
    them.  On the card the copies go into pinned buffers behind the
    batch's rounds on the stream, and the returned event marks their end,
    so the next batch's launches queue behind them and the harvest waits
    for this batch only.  Returns (host tensors, event or None)."""
    out = {"row." + k: v[:, :n_valid] for k, v in rows.items()}
    for f in fields:
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


def run_all_origins(config: Config, accounts=None, dp_queue=None,
                    start_ts: str = "0", origin_indices=None,
                    json_rpc_url: str = API_MAINNET_BETA) -> dict:
    """Origin-parallel mode (reference: gossip_sim_tpu/cli.py:1800-2209):
    every node (or each of ``origin_indices``) is the origin of its own
    simulation, run in origin batches on one device, and the full aggregate
    stats suite is built from the on-device accumulators.  Returns a
    summary dict (also logged); its ``stats`` key carries the finalized
    ``AllOriginsStats``.  With ``dp_queue``, each batch pushes a
    ``sim_perf`` point at its harvest and the run its aggregate Influx
    point at the end (``AllOriginsStats.emit_influx``).

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
        accounts, _ = load_cluster_accounts(config, json_rpc_url)
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
    harvested = HARVEST_STATE + (HARVEST_PULL_STATE if params.has_pull
                                 else ())
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
        host, ready = _start_copy(rows, state, n_valid, harvested)
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
                                  for f in harvested})
        agg.add_batch(rows, sums, config.warm_up_rounds,
                      heal_at=config.heal_at,
                      impaired=config.impairments_on, pull=config.has_pull)
        rounds_s = _span_s(marks[1], marks[2])
        batches.append({"lo": lo, "n_valid": n_valid,
                        "init_s": _span_s(marks[0], marks[1]),
                        "rounds_s": rounds_s,
                        "dispatch_s": dispatch_s, "copy_wait_s": waited,
                        "harvest_s": time.perf_counter() - t})
        _push_sim_perf_point(dp_queue, 0, start_ts, rounds_s, iters, n_valid)
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
    agg.emit_influx(dp_queue, start_ts)
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
    }
    if config.has_pull:
        summary.update({
            "pull_requests": int(agg.total_pull_requests),
            "pull_responses": int(agg.total_pull_responses),
            "pull_misses": int(agg.total_pull_requests
                               - agg.total_pull_responses),
            "pull_dropped": int(agg.total_pull_dropped),
            "pull_suppressed": int(agg.total_pull_suppressed),
            "pull_rescued": int(agg.total_pull_rescued),
        })
    summary.update({
        # queue-cap drops (traffic runs, ROADMAP A11) ride in every summary
        "queue_dropped": 0,
        "queue_dropped_ingress": 0,
        "queue_deferred_egress": 0,
        **extra,
    })
    log.info("ALL-ORIGINS SUMMARY: %s",
             {k: v for k, v in summary.items()
              if k not in ("stats", "batches")})
    return summary


# --------------------------------------------------------------------------
# concurrent-traffic runs (traffic.py, engine/traffic.py)
# --------------------------------------------------------------------------

#: test types a traffic run can sweep (reference cli.py:2817); the
#: adaptive-threshold sweep steps adaptive traffic's switch threshold
TRAFFIC_SWEEP_TYPES = (Testing.TRAFFIC_RATE, Testing.NODE_INGRESS_CAP,
                       Testing.PACKET_LOSS, Testing.CHURN,
                       Testing.ADAPTIVE_THRESHOLD)


def _push_sim_traffic_point(dp_queue, sim_iter, start_ts, it, vals):
    if dp_queue is None:
        return
    dp = InfluxDataPoint(start_ts, sim_iter)
    dp.create_sim_traffic_point(it, {k: vals[k] for k in ROUND_FIELDS})
    dp_queue.push_back(dp)


def _push_sim_traffic_summary_point(dp_queue, sim_iter, start_ts, summary):
    if dp_queue is None:
        return
    dp = InfluxDataPoint(start_ts, sim_iter)
    dp.create_sim_traffic_summary_point(summary)
    dp_queue.push_back(dp)


def _push_sim_adaptive_point(dp_queue, sim_iter, start_ts, it, vals):
    """One sim_adaptive point per measured round of adaptive traffic: the
    ADAPTIVE_ROUND_FIELDS pull-rescue counters."""
    if dp_queue is None:
        return
    dp = InfluxDataPoint(start_ts, sim_iter)
    dp.create_sim_adaptive_point(it, vals)
    dp_queue.push_back(dp)


def _feed_traffic_rows(stats, dp_queue, sim_iter, start_ts, rows, start_it,
                       n_it, num_nodes, lane=None):
    """Harvested traffic rows (numpy) -> TrafficStats and the sim_traffic
    (and, for adaptive traffic, sim_adaptive) Influx points (measured
    rounds only).  ``lane`` picks one lane of a lane batch's rows
    ``[T, K, ...]``."""
    sel = (lambda arr, t: arr[t]) if lane is None else (
        lambda arr, t: arr[t, lane])
    adaptive = "pull_sent" in rows
    for t in range(n_it):
        it = start_it + t
        vals = {k: int(sel(rows[k], t)) for k in ROUND_FIELDS}
        if adaptive:
            vals.update({k: int(sel(rows[k], t))
                         for k in ADAPTIVE_ROUND_FIELDS})
        stats.feed_round(it, vals)
        recs = []
        for m in np.nonzero(sel(rows["ret_mask"], t))[0]:
            g = lambda name: sel(rows[name], t)[m]
            recs.append(retire_record(
                int(g("ret_vid")), int(g("ret_origin")), int(g("ret_birth")),
                it, int(g("ret_holders")), num_nodes, int(g("ret_m")),
                bool(g("ret_full")), int(g("ret_hops_sum")),
                rescued=int(g("ret_rescued")), qdrops=int(g("ret_qdrop"))))
        if recs:
            stats.feed_records(recs)
        if it % 10 == 0:
            log.info("TRAFFIC ITERATION: %s (live=%s retired=%s)", it,
                     vals["live"], vals["retired"])
        _push_sim_traffic_point(dp_queue, sim_iter, start_ts, it, vals)
        if adaptive:
            _push_sim_adaptive_point(
                dp_queue, sim_iter, start_ts, it,
                {k: vals[k] for k in ADAPTIVE_ROUND_FIELDS})


def _traffic_final_from_state(state) -> dict:
    """End-of-run accumulator summary off a TrafficState."""
    total = lambda t: int(t.sum())
    return {
        "live_at_end": total(state.v_live),
        "injected": int(state.inj_acc),
        "inject_dropped": int(state.injdrop_acc),
        "retired": int(state.ret_acc),
        "converged": int(state.conv_acc),
        "deferred": total(state.defer_acc),
        "queue_dropped": total(state.qdrop_acc),
        "sent": total(state.sent_acc),
        "recv": total(state.recv_acc),
        "prunes": total(state.prune_acc),
    }


def _run_traffic_point(config: Config, params: EngineParams, stakes_np,
                       stats: TrafficStats, dp_queue, sim_iter: int,
                       start_ts: str) -> None:
    """One traffic simulation (reference cli.py:3026-3171 without its
    checkpoint, trace, health and supervisor arms): the warm-up rounds in
    one call, then the measured rounds harvested in blocks."""
    N = len(stakes_np)
    tables = make_cluster_tables(stakes_np, device=config.device)
    dev = tables.stakes.device
    ttables = device_traffic_tables(stakes_np, dev)
    log.info("Building the shared traffic active set....")
    state = init_traffic_state(stakes_np, params, config.seed, dev)
    warm = min(config.warm_up_rounds, config.gossip_iterations)
    if warm > 0:
        state, _ = run_traffic_rounds(params, tables, ttables, state, warm)
    measured = config.gossip_iterations - warm
    done = 0
    while done < measured:
        n_it = min(HARVEST_BLOCK, measured - done)
        start_it = warm + done
        t_blk = time.perf_counter()
        state, trows = run_traffic_rounds(params, tables, ttables, state,
                                          n_it, start_it=start_it)
        rows = {k: v.cpu().numpy() for k, v in trows.items()}
        blk_wall = time.perf_counter() - t_blk
        _feed_traffic_rows(stats, dp_queue, sim_iter, start_ts, rows,
                           start_it, n_it, N)
        done += n_it
        _push_sim_perf_point(dp_queue, sim_iter, start_ts, blk_wall, n_it, 1)
    stats.feed_final(_traffic_final_from_state(state))


def _traffic_lane_blocker(config: Config, n_points: int):
    """None when --sweep-lanes can serve this traffic sweep, else the
    reason the run logs before it runs the serial sweep (reference cli.py:
    3208-3223, without the backend, trace and checkpoint reasons: the port
    has none of those flags yet)."""
    if n_points < 2:
        return "nothing to batch (num_simulations < 2)"
    if config.test_type not in TRAFFIC_SWEEP_TYPES:
        return (f"--test-type {config.test_type.value} does not step a "
                f"traffic-sweepable knob")
    if config.gossip_iterations <= config.warm_up_rounds:
        return "no measured rounds (iterations <= warm-up-rounds)"
    return None


def _run_traffic_lane_sweep(config: Config, point_cfgs, stakes_np,
                            collection, dp_queue, start_ts,
                            point_starts) -> dict:
    """A traffic knob sweep as lane batches (reference cli.py:3226-3310):
    the K points' knobs stack into lanes of ``min(--sweep-lanes, K)`` and
    run as ``ceil(K / lanes)`` batches (engine/traffic.py
    ``run_traffic_lanes``: the warm-up, then the measured rounds, whose
    rows come to the host in one copy).  Each lane then feeds the serial
    path's stats and Influx series in sweep order, so the results are the
    serial sweep's.  A tail batch runs only its points' lanes (the
    reference pads it with the last point's knobs and drops the padded
    lanes).  Returns the walls of the cluster build, the engine and the
    harvest, in seconds, and the lane width and batch count."""
    t0 = time.perf_counter()
    N = len(stakes_np)
    params_list = [_engine_params(c, N).validate() for c in point_cfgs]
    static = merge_lane_statics([p.static_part() for p in params_list])
    knob_list = [p.knob_values() for p in params_list]
    check_lane_knobs(static, knob_list)
    tables = make_cluster_tables(stakes_np, device=config.device)
    dev = tables.stakes.device
    ttables = device_traffic_tables(stakes_np, dev)
    K = len(point_cfgs)
    L = max(1, min(config.sweep_lanes, K))
    n_batches = -(-K // L)
    times = {"cluster_s": time.perf_counter() - t0, "engine_s": 0.0,
             "harvest_s": 0.0, "lanes": L, "batches": n_batches}
    log.info("##### TRAFFIC LANE SWEEP: %s points x %s lanes = %s batched "
             "engine call(s) #####", K, L, n_batches)
    warm = min(config.warm_up_rounds, config.gossip_iterations)
    measured = config.gossip_iterations - warm
    t_engine = time.perf_counter()
    log.info("Building the shared traffic active set....")
    base_state = init_traffic_state(stakes_np, params_list[0], config.seed,
                                    dev)
    times["engine_s"] += time.perf_counter() - t_engine
    for b in range(n_batches):
        ids = list(range(b * L, min((b + 1) * L, K)))
        kstack = stack_knobs([knob_list[i] for i in ids])
        t_blk = time.perf_counter()
        states = broadcast_traffic_state(base_state, len(ids))
        if warm > 0:
            states, _ = run_traffic_lanes(static, tables, ttables, states,
                                          kstack, warm)
        states, trows = run_traffic_lanes(static, tables, ttables, states,
                                          kstack, measured, start_it=warm)
        # the one copy of the batch's rows to the host
        rows = {k: v.cpu().numpy() for k, v in trows.items()}
        times["engine_s"] += time.perf_counter() - t_blk
        t_harvest = time.perf_counter()
        for lane, i in enumerate(ids):
            stats = TrafficStats()
            _feed_traffic_rows(stats, dp_queue, i, start_ts, rows, warm,
                               measured, N, lane=lane)
            stats.feed_final(_traffic_final_from_state(
                traffic_lane_state(states, lane)))
            _push_sim_traffic_summary_point(dp_queue, i, start_ts,
                                            stats.summary())
            collection.push(point_starts[i], stats)
        times["harvest_s"] += time.perf_counter() - t_harvest
    return times


def _log_traffic_summary(label, s):
    """The traffic run summary line: per-value outcomes and the queue caps'
    drops, egress side (sender deferrals) and ingress side (receiver
    drops) apart."""
    qd_in = s.get("queue_dropped_ingress", s["queue_dropped"])
    qd_eg = s.get("queue_deferred_egress", s["queue_deferred"])
    log.info(
        "TRAFFIC SUMMARY%s: %s values injected (%s dropped at injection), "
        "%s retired (%s converged [%s by pull rescue], %s stranded "
        "[%s starved by queue drops], %s unfinished) | "
        "coverage mean %.4f | latency mean %.2f p90 %.2f rounds | "
        "value RMR mean %.3f | queue: %s deferred egress-side (max depth "
        "%s), %s dropped ingress-side (push %s + pull %s) | loss %s, "
        "hop_clamped %s",
        label, s["values_injected"], s["inject_dropped"],
        s["values_retired"], s["values_converged"], s["values_rescued"],
        s["values_stranded"], s["values_starved_queue_drop"],
        s["values_unfinished"], s["value_coverage_mean"],
        s["value_latency_mean"], s["value_latency_p90"],
        s["value_rmr_mean"], qd_eg, s["qdepth_max"],
        qd_in, s["queue_dropped"], qd_in - s["queue_dropped"],
        s["loss_dropped"], s["hop_clamped"])
    if "adaptive_pull_sent" in s:
        log.info(
            "ADAPTIVE SUMMARY%s: %s values switched to pull | rescue "
            "requests %s sent (%s deferred, %s queue-dropped), %s "
            "responses, %s nodes rescued",
            label, s["adaptive_switched_to_pull"], s["adaptive_pull_sent"],
            s["adaptive_pull_deferred"], s["adaptive_pull_queue_dropped"],
            s["adaptive_pull_responses"], s["adaptive_pull_rescued"])


def run_traffic(config: Config, json_rpc_url: str = API_MAINNET_BETA,
                dp_queue=None, start_ts: str = "0", collection=None) -> dict:
    """The concurrent-traffic run path (reference cli.py:3313-3429): one
    run, or a sweep over ``TRAFFIC_SWEEP_TYPES`` on one cluster load,
    serial or, with ``--sweep-lanes``, in lane batches
    (:func:`_run_traffic_lane_sweep`).  Returns the report dict (``traffic``: the whole run's summary,
    ``traffic_points``: each point's, ``num_points``, ``sweep_lanes``, and
    in adaptive mode ``adaptive``);
    ``collection`` (a TrafficStatsCollection) receives each point's
    TrafficStats."""
    is_sweep = (config.test_type in TRAFFIC_SWEEP_TYPES
                and config.num_simulations > 1)
    n_points = config.num_simulations if is_sweep else 1
    lane_mode = False
    if config.sweep_lanes > 0:
        blocker = _traffic_lane_blocker(config, n_points)
        if blocker is None:
            lane_mode = True
        else:
            log.warning("WARNING: --sweep-lanes %s ignored (%s); running "
                        "the serial traffic sweep", config.sweep_lanes,
                        blocker)
    if collection is None:
        collection = TrafficStatsCollection()
    point_cfgs, point_starts = [], []
    for i in range(n_points):
        c, start = (_stepped_sweep_config(config, i, [config.origin_rank])
                    if is_sweep else (config, 0.0))
        point_cfgs.append(c)
        point_starts.append(start)
    accounts, _ = load_cluster_accounts(config, json_rpc_url)
    index = NodeIndex.from_stakes(accounts)
    stakes_np = index.stakes.astype(np.int64)
    if lane_mode:
        _run_traffic_lane_sweep(config, point_cfgs, stakes_np, collection,
                                dp_queue, start_ts, point_starts)
    else:
        for i, c in enumerate(point_cfgs):
            log.info("##### TRAFFIC SIMULATION: %s (%s) #####", i,
                     c.test_type)
            params = _engine_params(c, len(index)).validate()
            stats = TrafficStats()
            _run_traffic_point(c, params, stakes_np, stats, dp_queue, i,
                               start_ts)
            _push_sim_traffic_summary_point(dp_queue, i, start_ts,
                                            stats.summary())
            collection.push(point_starts[i], stats)

    summaries = collection.summaries()
    for i, s in enumerate(summaries):
        _log_traffic_summary(f" (point {i})" if n_points > 1 else "", s)
    if n_points > 1:
        # the whole run's summary: every point's rounds and records in one
        # TrafficStats (per-point summaries stay in traffic_points)
        agg = TrafficStats()
        for st in collection.collection:
            agg.iterations.extend(st.iterations)
            for k in agg.rounds:
                agg.rounds[k].extend(st.rounds[k])
            for k in agg.adaptive_rounds:
                agg.adaptive_rounds[k].extend(st.adaptive_rounds[k])
            agg.records.extend(st.records)
        agg.final = {"live_at_end": sum(
            int(st.final.get("live_at_end", 0))
            for st in collection.collection)}
        out = agg.summary()
    else:
        out = dict(summaries[-1]) if summaries else {}
        out.pop("point", None)
    report = {
        "traffic": out,
        "traffic_points": summaries if n_points > 1 else [],
        "num_points": n_points,
        "sweep_lanes": config.sweep_lanes if lane_mode else 0,
    }
    if config.gossip_mode == "adaptive":
        # the switch configuration, the pull-rescue totals and the
        # per-cause outcome counts
        report["adaptive"] = {
            "switch_threshold": config.adaptive_switch_threshold,
            "switch_hysteresis": config.adaptive_switch_hysteresis,
            "values_rescued": out.get("values_rescued", 0),
            "values_starved_queue_drop":
                out.get("values_starved_queue_drop", 0),
            "nodes_rescued": out.get("nodes_rescued", 0),
            "switched_to_pull": out.get("adaptive_switched_to_pull", 0),
            "pull_sent": out.get("adaptive_pull_sent", 0),
            "pull_responses": out.get("adaptive_pull_responses", 0),
            "pull_rescued": out.get("adaptive_pull_rescued", 0),
            "pull_deferred": out.get("adaptive_pull_deferred", 0),
            "pull_queue_dropped":
                out.get("adaptive_pull_queue_dropped", 0),
        }
    return report


# --------------------------------------------------------------------------
# Influx series (influx_db.rs)
# --------------------------------------------------------------------------

def _push_sim_perf_point(dp_queue, sim_iter, start_ts, block_wall_s, n_iters,
                         n_origins):
    """One point per measured round block: its wall time, origin-rounds/s
    and the sender's queue depth (wall-clock values, left out of the
    deterministic lines)."""
    if dp_queue is None:
        return
    thr = n_origins * n_iters / block_wall_s if block_wall_s > 0 else 0.0
    dp = InfluxDataPoint(start_ts, sim_iter)
    dp.create_sim_perf_point(round(block_wall_s, 6), round(thr, 2),
                             len(dp_queue), n_iters)
    dp_queue.push_back(dp)


def _push_config_point(config, dp_queue, sim_iter, start_ts):
    if dp_queue is None:
        return
    dp = InfluxDataPoint(start_ts, sim_iter)
    dp.create_config_point(
        config.gossip_push_fanout, config.gossip_active_set_size,
        config.origin_rank, config.prune_stake_threshold,
        config.min_ingress_nodes, config.fraction_to_fail,
        config.probability_of_rotation)
    dp_queue.push_back(dp)


def _push_iteration_points(dp_queue, sim_iter, start_ts, stats, steady,
                           coverage, rmr_result):
    """One measured round's series (gossip_main.rs:480-563)."""
    if dp_queue is None:
        return
    dp = InfluxDataPoint(start_ts, sim_iter)
    dp.create_rmr_data_point(rmr_result)
    dp.create_data_point(coverage, "coverage")
    dp.create_hops_stat_point(stats.get_hops_stat_by_iteration(steady))
    dp.create_stranded_node_stat_point(
        stats.get_stranded_node_stats_by_iteration(steady))
    dp.create_data_point(
        stats.get_outbound_branching_factor_by_index(steady),
        "branching_factor")
    if stats.has_delivery_stats():
        dp.create_delivery_point(
            int(stats.delivered_stats.collection[-1]),
            int(stats.dropped_stats.collection[-1]),
            int(stats.suppressed_stats.collection[-1]),
            stats.failed_count_series[-1])
    if stats.has_pull_stats():
        dp.create_sim_pull_point(
            int(stats.pull_requests_stats.collection[-1]),
            int(stats.pull_responses_stats.collection[-1]),
            int(stats.pull_misses_stats.collection[-1]),
            int(stats.pull_dropped_stats.collection[-1]),
            int(stats.pull_suppressed_stats.collection[-1]),
            int(stats.pull_rescued_stats.collection[-1]))
    if stats.has_adaptive_stats():
        dp.create_sim_adaptive_point(steady, {
            "active": stats.adaptive_active_series[-1],
            "switched": stats.adaptive_switched_series[-1]})
    dp.create_iteration_point(steady, sim_iter)
    dp_queue.push_back(dp)


def _push_end_of_sim_points(dp_queue, sim_iter, start_ts, stats):
    """A finished simulation's series (gossip_main.rs:567-645)."""
    if dp_queue is None:
        return
    dp = InfluxDataPoint(start_ts, sim_iter)
    c = stats.stranded_node_collection
    dp.create_stranded_iteration_point(
        c.total_stranded_iterations,
        c.stranded_iterations_per_node,
        c.mean_stranded_per_iteration,
        c.mean_stranded_iterations_per_stranded_node,
        c.median_stranded_iterations_per_stranded_node,
        c.weighted_stranded_node_mean_stake,
        c.weighted_stranded_node_median_stake)
    dp.create_histogram_point("stranded_node_histogram",
                              stats.get_stranded_node_histogram())
    dp.create_histogram_point("aggregate_hops_histogram",
                              stats.get_aggregate_hop_stat_histogram())
    dp.create_messages_point("egress_message_count",
                             stats.get_egress_messages_histogram(), sim_iter)
    dp.create_messages_point("ingress_message_count",
                             stats.get_ingress_messages_histogram(), sim_iter)
    dp.create_messages_point("prune_message_count",
                             stats.get_prune_message_histogram(), sim_iter)
    if stats.recovery_iterations is not None:
        # single-origin run: one recovery sample (mean == max; 0 with
        # unrecovered=1 when coverage never came back)
        rec = stats.recovery_iterations
        dp.create_recovery_point(1, float(max(rec, 0)), max(rec, 0),
                                 int(rec < 0))
    dp.create_iteration_point(0, sim_iter)
    dp_queue.push_back(dp)


def _drain_influx(dp_queue, influx_thread):
    """Push the end sentinel, wait for the reporter thread to drain, and log
    the sender's delivery accounting (points sent / dropped / retries)."""
    if dp_queue is None:
        return None
    dp = InfluxDataPoint()
    dp.set_last_datapoint()
    dp_queue.push_back(dp)
    if influx_thread is None:
        return None
    influx_thread.join()
    sender = influx_thread.sender_stats()
    log.info("influx sender: %s point(s) sent, %s dropped, %s spooled, "
             "%s transient-failure retr%s", sender["points_sent"],
             sender["dropped_points"], sender["spooled_points"],
             sender["retries"], "y" if sender["retries"] == 1 else "ies")
    return sender


def _traffic_startup_checks(config: Config) -> int:
    """The reference's traffic start-up checks (cli.py:3723-3794), with its
    messages and exit codes; 0 when the run may start."""
    if config.traffic_values < 1:
        log.error("ERROR: --traffic-values must be >= 1 (the default 1 "
                  "with both caps off IS the plain single-value "
                  "simulator — there is no separate off value)")
        return 1
    if config.traffic_on and config.traffic_rate < 0:
        log.error("ERROR: --traffic-rate must be >= 0")
        return 1
    if config.traffic_on and config.traffic_stall_rounds < 1:
        log.error("ERROR: --traffic-stall-rounds must be >= 1 (a value "
                  "needs at least one no-progress round to retire)")
        return 1
    if (config.test_type in (Testing.TRAFFIC_RATE, Testing.NODE_INGRESS_CAP)
            and not config.traffic_on):
        log.error("ERROR: --test-type %s requires the traffic subsystem "
                  "(--traffic-values > 1 or a queue cap); every sweep "
                  "point would be identical otherwise",
                  config.test_type.value)
        return 1
    if not config.traffic_on:
        return 0
    if config.all_origins:
        log.error("ERROR: --all-origins and concurrent traffic are "
                  "separate workload modes; traffic injects its own "
                  "stake-weighted origins")
        return 1
    if config.has_pull and config.gossip_mode != "adaptive":
        log.error("ERROR: the traffic subsystem models concurrent "
                  "PUSH streams; fixed --gossip-mode %s is not "
                  "supported with it — per-value pull RESCUES are: "
                  "use --gossip-mode adaptive", config.gossip_mode)
        return 1
    if config.gossip_mode == "adaptive":
        # a node-ingress-cap sweep steps the cap past the base value: its
        # last point must stay under the bound too
        cap_max = config.node_ingress_cap
        if (config.test_type == Testing.NODE_INGRESS_CAP
                and config.num_simulations > 1):
            cap_max += ((config.num_simulations - 1)
                        * config.step_size.as_int())
        if cap_max >= 16384:
            log.error("ERROR: adaptive traffic requires "
                      "--node-ingress-cap < 16384 (engine sort-key "
                      "packing bound; a node-ingress-cap sweep must "
                      "keep every stepped point under it); caps that "
                      "large are equivalent to no cap — use 0")
            return 1
    allowed = TRAFFIC_SWEEP_TYPES + (Testing.NO_TEST,)
    if config.test_type not in allowed:
        log.error("ERROR: --test-type %s is not runnable in traffic "
                  "mode; traffic sweeps: %s", config.test_type.value,
                  ", ".join(t.value for t in TRAFFIC_SWEEP_TYPES))
        return 1
    is_traffic_sweep = (config.test_type in TRAFFIC_SWEEP_TYPES
                        and config.num_simulations > 1)
    if config.num_simulations > 1 and not is_traffic_sweep:
        log.warning("WARNING: --num-simulations %s ignored in traffic "
                    "mode: --test-type %s does not step a "
                    "traffic-sweepable knob (traffic sweeps: %s)",
                    config.num_simulations, config.test_type.value,
                    ", ".join(t.value for t in TRAFFIC_SWEEP_TYPES))
    return 0


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s")
    args = build_parser().parse_args(argv)
    config = config_from_args(args)
    origin_ranks = args.origin_rank
    if any(r < 1 for r in origin_ranks):
        log.error("ERROR: --origin-rank values must be >= 1 (1 = highest "
                  "stake), got: %s", origin_ranks)
        return 1
    # origin-rank count validation (gossip_main.rs:706-716); traffic runs
    # inject their own stake-weighted origins, so the rank list is moot
    if not config.traffic_on:
        if len(origin_ranks) < config.num_simulations:
            log.error("ERROR: not enough origin ranks provided for "
                      "num_simulations! origin_ranks: %s, num_simulations: "
                      "%s", len(origin_ranks), config.num_simulations)
            if config.test_type == Testing.ORIGIN_RANK:
                return 1
        elif len(origin_ranks) > config.num_simulations:
            log.warning("WARNING: more origin ranks than number of "
                        "simulations. Not going to hit all origin ranks")
        elif (len(origin_ranks) > 1
              and config.test_type != Testing.ORIGIN_RANK):
            log.error("ERROR: multiple origin_ranks passed in but test type "
                      "is not OriginRank. This would end up running all "
                      "simulations with origin_rank[0]: %s", origin_ranks[0])
            return 1
    if config.test_type == Testing.PULL_FANOUT and not config.has_pull:
        log.error("ERROR: --test-type pull-fanout requires a pull-capable "
                  "--gossip-mode (pull or push-pull); mode is push, so "
                  "every sweep point would be identical")
        return 1
    if (config.test_type == Testing.ADAPTIVE_THRESHOLD
            and config.gossip_mode != "adaptive"):
        log.error("ERROR: --test-type adaptive-threshold requires "
                  "--gossip-mode adaptive; the switch knobs are inert in "
                  "mode %s, so every sweep point would be identical",
                  config.gossip_mode)
        return 1
    if (config.test_type == Testing.ADAPTIVE_THRESHOLD
            and config.num_simulations > 1):
        # the stepper clamps thresholds at 1.0: warn when the grid
        # collapses into duplicate points
        last = (config.adaptive_switch_threshold
                + (config.num_simulations - 1)
                * config.step_size.as_float())
        if last > 1.0:
            n_dup = sum(
                1 for i in range(config.num_simulations)
                if config.adaptive_switch_threshold
                + i * config.step_size.as_float() > 1.0)
            log.warning("WARNING: adaptive-threshold sweep clamps at 1.0 "
                        "— the last %d of %d points run the identical "
                        "threshold 1.0; shrink --step-size or "
                        "--num-simulations for distinct points",
                        n_dup, config.num_simulations)
    rc = _traffic_startup_checks(config)
    if rc:
        return rc
    if config.gossip_iterations <= config.warm_up_rounds:
        log.warning("WARNING: Gossip Iterations (%s) <= Warm Up Rounds (%s). "
                    "No stats will be recorded....",
                    config.gossip_iterations, config.warm_up_rounds)

    start_ts = str(time.time_ns())
    log.info("############################################")
    log.info("##### START_TIME: %s ######", start_ts)
    log.info("############################################")
    dp_queue = influx_thread = None
    if args.influx in ("l", "i"):
        dp_queue = DatapointQueue()
        load_dotenv()
        try:
            username = os.environ["GOSSIP_SIM_INFLUX_USERNAME"]
            password = os.environ["GOSSIP_SIM_INFLUX_PASSWORD"]
            database = os.environ["GOSSIP_SIM_INFLUX_DATABASE"]
        except KeyError as e:
            log.error("%s is not set", e.args[0])
            return 1
        influx_thread = InfluxThread.spawn(
            get_influx_url(args.influx), username, password, database,
            dp_queue, spool_path=config.influx_spool)

    t0 = time.perf_counter()
    if config.traffic_on:
        run_traffic(config, args.json_rpc_url, dp_queue, start_ts)
    elif config.all_origins:
        if dp_queue is not None:
            log.info("all-origins: emitting run-level aggregate Influx "
                     "series (per-iteration series are a single-origin "
                     "feature)")
        run_all_origins(config, dp_queue=dp_queue, start_ts=start_ts,
                        json_rpc_url=args.json_rpc_url)
    else:
        collection = GossipStatsCollection()
        collection.set_number_of_simulations(config.num_simulations)
        dispatch_sweeps(config, args.json_rpc_url, origin_ranks, collection,
                        dp_queue, start_ts)
    log.info("simulation wall time: %.3f s on %s", time.perf_counter() - t0,
             config.device)
    if config.device != "cpu":
        log.info("kernel launches: %s", dict(kernels.LAUNCHES))
    _drain_influx(dp_queue, influx_thread)
    if config.all_origins or config.traffic_on:
        return 0
    if config.print_stats:
        if not collection.is_empty():
            collection.print_all(config.gossip_iterations,
                                 config.warm_up_rounds, config.test_type)
        else:
            log.warning("WARNING: Gossip Stats Collection is empty. "
                        "Is `Iterations` <= `warm-up-rounds`?")
    log.info("############################################")
    log.info("##### START_TIME: %s ######", start_ts)
    log.info("############################################")
    return 0


if __name__ == "__main__":
    sys.exit(main())
