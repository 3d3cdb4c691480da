#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``gossip_sim_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

  (a) build the fourteen CUDA kernel sources from
      ``gossip_sim_tpu_torch/csrc`` (sixteen kernels: ``rc_merge_prune``'s
      source holds its sparse variant, ``health_round``'s its traffic form)
      with nvcc for sm_90a (one nvcc per source, in parallel); print each
      kernel's registers, shared memory and spills (``-Xptxas -v``; the
      instantiations with and without the flight recorder's trace outputs
      of ``push_targets``, ``rotate`` and ``pull_exchange`` apart), check
      ``rotate``'s static shared memory (the class tables) against ptxas
      and its keys and rows beside them against the block's limit,
      print the launch geometry of the cluster and row kernels (cluster
      size, rows or warps per block, shared memory, ``push_targets``' tiles
      and one-wave grid), and the instructions of one threefry block in the
      SASS (``cuobjdump -sass``) of ``threefry`` and of ``rotate``, by pipe;
  (b) first, in a process of its own (``--profile-calls``), the whole
      calls of ``prune_apply``, ``traffic_admit`` and ``traffic_send``
      (every device activity the wrapper launches) beside their kernels
      alone, on round 19's inputs of each shape the phases time them at
      ((b) O=32, (d) O=1, (f) O=64, (h) push-pull O=64, (i) M=256
      uncapped and capped, M=32; ``traffic_send`` and ``traffic_admit``
      at (i)'s only); then
      capture each kernel's inputs from a real round (round 19, when the
      upsert counters fire) at O=32 origins, N=10,000 nodes (every call of
      the round; it launches no ``threefry``, whose calls are taken from
      ``init_state`` at O=32), and hold the kernel against its plain PyTorch
      version on the card: exact equality (tolerance 0: the data are
      integers and the uniforms are bit patterns); time the calls of
      kernel, plain version and a PyTorch yardstick with CUDA events; then
      run the engine at rc_slots=128 (a row of C + K = 144), at
      inbound_cap=128, and in both threefry layouts unimpaired, under loss
      + partition + churn and in a fail round, and hold ``rc_merge_prune``,
      ``rank_inbound``, ``push_targets`` (with its suppression and loss
      masks), ``rotate``, ``prune_apply`` and the fail round's three
      ``threefry`` draws against their plain versions on their round-19
      inputs;
  (c) run the engine for 50 rounds at O=32, N=10,000: rounds/s, peak
      device memory, every kernel launched, ``threefry`` launched in
      ``init_state`` only; then a 5-round profile: device busy and idle
      share, device time and launches per round of each kernel and of the
      plain PyTorch ops, and ``init_state``'s profile; ``push_targets`` on
      round 19's inputs with a cold L2 beside a copy of as many bytes, and
      on its one-wave grid in turns with the single-pass schedule (a block
      per tile, one buffer); beside the same
      5-round profile with the draws routed to plain versions (``threefry``
      and ``rotate``, whose plain version draws with ``threefry``'s), and
      with verbs 1 and 5 routed to ``push_targets``' and ``rotate``'s plain
      versions (each as the port made it before its kernel, for comparison
      only);
  (d) run the CLI main path in process: 10,000 synthetic nodes,
      --iterations 300 --warm-up-rounds 200 on cuda; wall time, coverage
      and RMR means, ``threefry``'s launches (``init_state``'s only); the
      run's kernel launch counts go into the ``kernels`` line, and each
      kernel is held against its plain version on this run's own inputs of
      rounds 19 and 299 (O=1; ``threefry`` on ``init_state``'s) and timed
      on those of round 19 (CUDA events, and device time under the
      profiler); ``init_state`` at O=1 is timed alone, with the kernel and
      with the plain draws;
  (e) run the CLI on cuda and on cpu at 2,000 nodes for 60 rounds and
      require equal ``parity_snapshot()``s;
  (f) run all-origins mode in process: origins 0-199 of the 10,000-node
      cluster, --iterations 300 --warm-up-rounds 200 on cuda, at the auto
      origin batch of 64 (three full batches and a tail of 8 valid origins
      padded with origin 0) with its launch counts set to 0 just before and
      read just after, and again at --origin-batch 256 (one batch of the
      200, as the batch is clamped to the number of origins); per batch the
      ``init_state``, rounds and harvest walls, origin-rounds/s, peak
      device memory with two batches in flight, and equal aggregates at
      both widths; a 5-round profile at O=64 in a process of its own
      (``--profile-all-origins``); each kernel held against its plain
      version on round 19's inputs of the padded tail batch; every sixth
      origin of a 500-node cluster on cuda and on cpu with equal
      aggregates and summaries; and the full 10,000-origin run's time,
      extrapolated;
  (g) the experiment harness on the 10,000-node cluster (300 iterations,
      200 warm-up, cuda), each run with the launch counts set to 0 just
      before it and read just after: an active-set sweep (S = 12, 16, 20,
      24) and a fanout sweep (F = 6, 9, 12, so K = 16, 18, 24) through
      ``cli.main``, each point's wall and coverage and RMR means; every
      kernel held against its plain version on round 19's inputs at
      S=24/F=6 and S=12/F=12 (O=16) and timed (CUDA events, and device
      time from a profile in a process of its own,
      ``--profile-wide-shapes``) beside its bound; the
      batched origin-rank sweep of ranks 1-16 (engine and harvest walls),
      whose columns 0 and 15 must equal ranks 1 and 16 run alone; the
      cluster written as an account file and run from it (the card's
      machine has no PyYAML: the port's own reader), equal to the
      synthetic run; a prune-stake-threshold sweep at N=500 on cuda and on
      cpu with equal deterministic Influx lines, one of them sent through
      ``InfluxThread`` to a capture server on 127.0.0.1, dequeued ==
      sent and none dropped;
  (h) the pull, push-pull and adaptive modes at N=10,000 (300 iterations,
      200 warm-up, cuda), each run with the launch counts set to 0 just
      before it and read just after: ``pull_exchange`` held against its
      plain version (tolerance 0) on round 19's inputs at O=64 in
      push-pull under loss 0.1 + partition + churn at request caps 0 and 2,
      in pull mode (with ``push_targets`` at ``push_on=False``), in
      adaptive mode with the bit on, and at O=32 and O=1 (and each case's
      ``prune_apply`` call); each case's
      launch geometry (cluster size, slice, threads, shared memory) printed,
      timed with CUDA events, and under the profiler in a process of its
      own (``--profile-pull``, which also profiles 5 push-pull rounds at
      O=32: the launches a pull round adds), beside its bound; the
      single-origin
      CLI in push-pull (loss 0.1), adaptive and push (wall,
      coverage, RMR, pull counters, launches), and each mode's cuda run
      equal to its cpu run at N=2,000 (``parity_snapshot()`` and
      deterministic Influx lines); all-origins in push-pull (origins
      0-199 at the auto batch of 64 and at ``--origin-batch 256``, one
      batch of the 200, with equal aggregates: origin-rounds/s, peak
      memory), and on every sixth origin of N=500 on cuda and cpu with
      equal aggregates; a
      pull-fanout sweep
      (F_pull = 2, 5, 8) and an adaptive-threshold sweep (0.5, 0.7, 0.9)
      through ``cli.main``, each point's wall;
  (i) the concurrent-traffic engine in push mode at N=10,000 with M=256
      value slots at rate 16: ``traffic_send``, ``traffic_admit``,
      ``rank_inbound``, ``rc_merge_prune`` (with the live mask) and
      ``prune_apply`` (on the shared active set) held against their plain
      versions (tolerance 0) on round 19's inputs, uncapped and with both
      queue caps binding under loss 0.1 + churn + a partition (and
      ``traffic_admit`` at ingress caps 1 and one above every target's
      arrivals, ``traffic_send`` at egress caps 1 and one crossed inside
      the first value of a later 32-value chunk), and at M=32; each timed
      with CUDA events beside its plain version, its bound and a PyTorch
      yardstick, and under the profiler in a process of its own
      (``--profile-traffic``: device ms per call, and 5-round profiles at
      M=256 and M=32); the full-width CLI run (``--traffic-values 256
      --traffic-rate 16``, 300 iterations, 200 warm-up) uncapped and
      capped, with the launch counts set to 0 just before each and read
      just after (wall, traffic rounds/s, value-rounds/s, peak memory, the
      TRAFFIC SUMMARY counts); cuda == cpu at N=2,000, M=32 (20
      iterations, capped and impaired: ``parity_snapshot()``,
      ``summary()`` and the deterministic Influx lines) and for a 3-point
      ``traffic-rate`` sweep (12 iterations); then adaptive traffic (``--gossip-mode
      adaptive``, threshold 0.9): the first round from 39 on with values in
      their pull phase (capped: and pull requests deferred or
      queue-dropped), uncapped and capped + impaired, its six kernels held
      against their plain versions and ``traffic_rescue`` also at ingress
      cap 1, ``traffic_rescue`` timed beside its plain version, its bound
      and a stable ``torch.sort`` of the arrived requests' packed (peer,
      flat index) keys, and under the profiler in the ``--profile-traffic``
      process (with a 5-round adaptive profile beside the push one); the
      full-width adaptive CLI uncapped and capped (rounds/s, value-rounds/s,
      peak memory, launches, the TRAFFIC and ADAPTIVE SUMMARY counts); cuda
      == cpu at N=2,000, M=32 adaptive, capped and impaired (20 iterations);
  (j) the sparse layout (``--engine-representation sparse``): in a
      process of its own (``--profile-sparse``), 5-round profiles of both
      layouts (O=32 and O=64 of N=10,000, O=41 of N=100,000) and
      ``rc_merge_prune`` and ``bfs_relax`` on the inputs of round 19 (rows
      fire) and round 20 (rows do not): ``rc_merge_prune`` dense and
      sparse at O=1, 32 and 64 of N=10,000 and O=41 of N=100,000 and its
      traffic form at (i)'s M=256, ``bfs_relax`` at the same push shapes
      and on (k)'s 8 lanes x 4 origins, each exact vs plain (tolerance 0),
      timed (device ms and CUDA events) beside its bytes bound and, for
      ``bfs_relax``, its latency floor (the geometry's cluster barriers,
      compaction and DSMEM passes for the call's hop count, no edge work);
      ``rc_merge_prune``'s sparse variant on round 19's inputs
      at O=32 held against its plain version and against the dense kernel
      given the planes ``shi/slo[rc_src]`` (tolerance 0), timed in turns
      with the dense kernel beside its plain version, its bound and the
      sort of the row keys; the engine at O=32, 50 rounds of each layout in
      turns (rows and states equal, wall, peak memory, launches);
      all-origins on origins 0-199 at the auto batch and in one batch of
      200, each in both layouts in turns (``AllOriginsStats`` equal,
      origin-rounds/s, peak memory; every peak of (j) is read above the
      memory allocated just before its run, which earlier phases hold);
      at N=100,000 the engine at O=41, 20 rounds of each
      layout (rows and states equal) and the sparse variant exact vs plain
      on its round 19, then the single-origin CLI, 100 iterations, sparse
      (launch counts set to 0 just before, read just after: the ``kernels``
      line's launches of the variant) and dense, equal
      ``parity_snapshot()``s; cuda == cpu sparse at N=2,000 under loss +
      churn + partition (snapshot and Influx lines), an active-set sweep
      (S = 12, 16) sparse == dense, and sparse with push-pull and with
      traffic refused on the card;
  (k) sweep lanes (``--sweep-lanes``, ``engine/lanes.py``): round 19 of
      8 lanes x 4 origins (32 rows), each lane with knobs of its own (loss
      0-0.35, prune threshold 0.05-0.4, ``min_ingress_nodes`` 1-4,
      rotation 1/75-1/5, a partition in half the lanes; in push-pull pull
      fanouts 2-8 and bloom rates): ``push_targets``, ``rc_merge_prune``
      (dense and sparse), ``rotate`` and ``pull_exchange`` held against
      their plain versions and each lane against its one-lane call
      (tolerance 0), timed in turns beside the one-lane call on the same
      rows, device times and 5-round profiles (8 lanes of one origin, the
      serial round at O=1 and at O=8) in a process of its own
      (``--profile-lanes``); the engine, 8 lanes of one origin, 50 rounds
      beside the serial O=1 and O=8 rounds in turns (wall, peak memory,
      launches per round equal to the serial round's; every lane equal to
      its serial run); the CLI: an 8-point packet-loss sweep (100
      iterations, 60 warm-up) with ``--sweep-lanes 8`` and serially in
      turns (snapshots and deterministic Influx lines equal; the wall split
      into cluster build, engine and harvest), a 5-point fail-nodes sweep
      at 4 lanes (its tail padded), pull-fanout and adaptive-threshold lane
      sweeps (60 iterations) each equal to its serial sweep, a sparse
      prune-stake-threshold lane sweep equal to the dense one;
      ``run_rounds_lanes_dyn`` with 4 lanes at their own origins and start
      iterations against each lane's solo run, and a splice that leaves
      the other lanes' bits unchanged; a churn lane sweep at N=2,000 on
      cuda and cpu; a small traffic lane sweep (``--sweep-lanes 2``, a
      tail batch of one point) equal to its serial sweep; a 66-point
      packet-loss sweep at N=500 with ``--sweep-lanes 66`` (one batch,
      run as groups of at most 64 lane records), points 0, 63, 64 and 65
      equal to their serial runs;
  (l) traffic lanes (``engine/traffic.py`` ``run_traffic_lanes``): round 19
      of 4 lanes at M=256 (rate 16; loss, caps, churn and a partition
      differing by lane; the rescue on 4 adaptive lanes' first round from
      39 with values in their pull phase): each of the six traffic
      kernels' lane calls held, lane by lane, against its one-lane call and
      its plain version (tolerance 0), timed in turns beside the sum of
      the 4 one-lane calls, its bound the sum of the lanes', and the lane
      batch's peak memory; device ms of both and 5-round profiles of the
      4-lane round and the 4 lanes' serial rounds, and of 8 lanes and 8
      serial rounds at M=32, in a process of its own
      (``--profile-traffic-lanes``); the engine (a lane batch, then its
      lanes' serial rounds: wall, peak memory, kernel launches per round;
      the end lanes equal to their serial runs); the CLI: a 4-point
      traffic-rate sweep at M=256 (100 iterations, 60 warm-up,
      ``--sweep-lanes 4``) and an 8-point packet-loss sweep at M=32 (60
      iterations, 30 warm-up, ``--sweep-lanes 8``), each beside the serial
      sweep (every point's summary, parity snapshot and deterministic
      Influx lines equal; walls split into cluster build, engine and
      harvest; peak memory), an adaptive-threshold lane sweep (0.5, 0.7,
      0.9; 60 iterations) equal to its serial sweep, and a packet-loss lane
      sweep at N=2,000, M=32 (8 iterations) with caps, churn and a
      partition, cuda equal to cpu;
  (m) checkpoints, the run journal, ``--resume`` and the device
      supervisor, in a process of its own (``--resume-phase``, which runs
      ``cli.main`` and sends itself SIGTERM through the kill hook), each
      case at tolerance 0 against its uninterrupted run: the single-origin
      CLI at N=10,000 (300 straight against 200 resumed to 300, every
      array of the final ``.npz`` files), 20 against 10 resumed to 20
      at N=100,000 sparse,
      and a sparse file resumed dense; all-origins on origins 0-199 of
      N=10,000 at batch 64 stopped after 2 committed batches (exit 75)
      and resumed, a failed attempt retried, ``--on-device-failure
      abort`` (exit 75) and resumed, ``cpu-fallback`` refused, and
      ``--device-timeout-s 60`` timed beside the unsupervised run;
      traffic at N=10,000, M=256 (150 rounds, resumed to 300: the TRAFFIC
      SUMMARY and every state field), in a second process (``--resume-phase
      traffic``) started after the timed turns, whose two saves overlap
      the cases that follow; the serial active-set, 8-point
      packet-loss lane (4 lanes) and origin-rank (ranks 1-16) sweeps at
      N=2,000, each stopped after one unit and resumed (parity snapshots
      and the deterministic Influx lines a capture server on 127.0.0.1
      received); ``python -m gossip_sim_tpu_torch`` killed (process exit
      75) and resumed; a card file continued on the CPU; the reference
      package's fixtures ``tests/fixtures/checkpoints/v1-v8.npz`` (read as
      data) on the card and on the CPU; the walls and sizes of
      ``save_state`` and ``restore_sim_state`` at O=1 and O=16 of
      N=10,000 and O=1 of N=100,000 sparse, and of a journal commit
      (``chiprun_out/resume.json``);
  (n) the node-health observatory (``--health``): in a process of its own
      (``--health-phase``, its first profiler sessions) ``health_round``
      on round 19 (rows fire) and round 20 (none fires) at O=32 of
      N=10,000, dense and sparse, and on (k)'s 8 lanes x 4 origins; its
      traffic form on (i)'s M=256 round 19, on the same round with its
      value rows firing (the upsert counters set to 18-20) and on the
      adaptive round from 39 with pull rescues; ``health_digest`` on the
      sim, all-origins (int64) and traffic stacks, on N=100,000 and on a
      crafted stack of ties and int64-range values (its radix passes and
      launch geometry printed); each exact against its plain version
      (tolerance 0), timed (CUDA events and device ms; the digest's also
      as every device activity of the call) beside its bytes bound and a
      PyTorch call (``index_add_`` of the round's pairs; a stable
      ``torch.sort`` of the stack); the 5-round profiles of the
      O=32 push round without (117 launches, required) and with the gate;
      then, in this process, the full-width CLI with ``--health`` against
      the same run without it (the 10k single origin, all-origins on
      origins 0-199 at the auto batch, the M=256 traffic run, N=100,000
      sparse at 20 iterations), with the
      launch counts set to 0 just
      before each and read just after: the stats and deterministic
      Influx lines unchanged by the gate, every digest of the run exact
      against its plain version; cuda == cpu at N=2,000 (push under loss
      + churn + partition, push-pull, adaptive traffic: the
      ``sim_node_health`` points, the ``node_health`` section, the stats
      and the lines); an all-origins ``--health`` run stopped after 2
      batches and resumed, equal to the straight run;
  (o) the flight recorder (``--trace-dir``): in a process of its own
      (``--trace-phase``, its first profiler sessions) the 5-round
      profiles of the O=32 push round from round 19 without (117
      launches, required) and with the trace; on round 19 of O=32 of
      N=10,000, push under loss 0.1 + partition + churn and push-pull at
      pull cap 2, the traced calls of ``push_targets``, ``rotate`` and
      ``pull_exchange`` exact against their plain versions and the same
      calls with the trace off bit for bit the calls without it, each
      timed (CUDA events, device ms); ``trace_prune_pairs`` on round 19
      (rows fire) and round 20 (none fires) at the auto cap and at a cap
      that truncates, exact and timed beside its bytes bound and
      ``torch.nonzero`` of the pruned slots with a gather of their
      prunees; then, in this process, the full-width CLI with
      ``--trace-dir`` against the same run without it (the 10k single
      origin in push and push-pull under loss 0.1, all-origins on origins
      0-199 at the auto batch with ``--trace-origins 4``), the launch
      counts set to 0 just before each and read just after: the walls,
      the replay's wall, the segment writes and bytes, the stats and
      deterministic Influx lines unchanged, ``validate_trace_dir`` with no
      errors, one ``trace_prune_pairs`` launch a traced round and every
      other launch unchanged, the last call exact; cuda == cpu trace
      directories at N=2,000 (push under loss + churn + partition over a
      fail round, and adaptive; 30 iterations);
  (p) print each phase's wall, the total wall, the card's name and power
      limit, the
      ``kernels`` JSON line (the four knob kernels with a ``lanes`` object:
      K, O, max_abs_err, the lane call's ms beside the one-lane call's;
      the six traffic kernels with a ``traffic_lanes`` object: K, M,
      max_abs_err, the lane call's ms and device ms beside the sum of the
      one-lane calls', the bound; a ``trace`` object on ``push_targets``,
      ``rotate`` and ``pull_exchange``: their traced call's times beside
      the trace-off call's, and ``trace_prune_pairs``' entry) and the final
      ``{"ok": true, ...}`` line.

Imports nothing of JAX and nothing of the reference package.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import http.server
import importlib
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate (data sheet)
# Integer issue of the H100 SXM: 132 SMs at the 1.98 GHz boost clock (data
# sheet); per SM and clock, 64 lanes of the INT32 (ALU) pipe, 64 lanes of
# the FMA pipe, which runs IMAD, and 128 thread-instructions issued (four
# schedulers of one warp instruction each; Hopper architecture white paper)
SM_CLOCKS_PER_S = 132 * 1.98e9
ALU_LANES, FMA_LANES, ISSUE_LANES = 64, 64, 128
O_KERNEL, N_FULL = 32, 10_000
# all-origins (f): the auto origin batch at N=10,000, min(64, 2^22 // N),
# and a wider one; the first 200 node indices; a 500-node run on cuda and cpu
O_BATCH, O_WIDE, AO_ORIGINS, N_SMALL = 64, 256, 200, 500
# every SMALL_STRIDE-th origin of the N=500 cluster (84 origins: a full
# batch of 64 and a padded tail of 20)
SMALL_STRIDE = 6
# the experiment harness (g): the batched origin-rank sweep's origins, and
# the widest shapes its sweeps reach, (S, F): K = max(16, 2F)
O_RANKS, WIDE_SHAPES = 16, ((24, 6), (12, 12))
SOURCES = {"bfs_relax": ("gossip_sim_tpu/engine/core.py:620",
                         "round/bfs_propagate"),
           "rank_inbound": ("gossip_sim_tpu/engine/core.py:663",
                            "round/verb2_consume"),
           "rc_merge_prune": ("gossip_sim_tpu/engine/core.py:743",
                              "round/rc_merge + round/verb3_prune_decide"),
           "prune_apply": ("gossip_sim_tpu/engine/core.py:894",
                           "round/verb4_prune_apply"),
           "threefry": ("gossip_sim_tpu/engine/core.py:328",
                        "jax.random fold_in/split/uniform at core.py:328-339,"
                        " 507-509, 522, 952-958"),
           "push_targets": ("gossip_sim_tpu/engine/core.py:559",
                            "round/verb1_push_targets + the loss hash of "
                            "faults.py:76-121"),
           "rotate": ("gossip_sim_tpu/engine/core.py:950",
                      "round/verb5_rotate + _sample_fast at core.py:274"),
           "pull_exchange": ("gossip_sim_tpu/engine/core.py:1012",
                             "round/pull"),
           "traffic_send": ("gossip_sim_tpu/engine/traffic.py:255",
                            "traffic/candidates + traffic/egress_cap + "
                            "traffic/network"),
           "traffic_admit": ("gossip_sim_tpu/engine/traffic.py:316",
                             "traffic/ingress_cap"),
           "traffic_rescue": ("gossip_sim_tpu/engine/traffic.py:424",
                              "traffic/pull_rescue")}
# the pull modes (h): round 19's pull_exchange calls at O=64, O=32 and O=1
O_PULL = 64
# the traffic engine (i): value slots, injection rate, the kernels of its
# round, and the capped case's queue caps (ingress, egress) per node and
# round, under which the full-width CLI run defers and drops messages and
# still converges a value (a value converges only when all 10,000 nodes
# hold it); M=32 and N=2,000 for the profile's narrow shape and cuda == cpu
M_TRAFFIC, TRAFFIC_RATE, M_NARROW, N_PARITY = 256, 16, 32, 2000
TRAFFIC_KERNELS = ("traffic_send", "traffic_admit", "rank_inbound",
                   "rc_merge_prune", "prune_apply")
TRAFFIC_CAPS = (192, 256)
TRAFFIC_IMPAIRED = dict(packet_loss_rate=0.1, churn_fail_rate=0.01,
                        churn_recover_rate=0.2, partition_at=10, heal_at=30)
# adaptive traffic (i): the six kernels of its round, the reference's
# default switch threshold; the kernels only traffic runs launch
ADAPTIVE_KERNELS = TRAFFIC_KERNELS + ("traffic_rescue",)
ADAPTIVE_THRESHOLD = 0.9
TRAFFIC_ONLY = ("traffic_send", "traffic_admit", "traffic_rescue")
# the integer operations of one counter hash (faults.py): fmix32's three
# shifts, three xors and two multiplies, and the lane products (two
# multiplies and two xors for an edge hash, one of each for a node hash)
EDGE_HASH_OPS = dict(alu=8, fma=4, total=12)
NODE_HASH_OPS = dict(alu=7, fma=3, total=10)
# the sparse layout (j): rc_merge_prune's variant (its launch count), and
# N=100,000 at the reference's auto origin batch there, min(64, 2^22 // N)
SPARSE = "rc_merge_prune_sparse"
N_HUGE, O_HUGE = 100_000, 41


def stop_process(proc) -> None:
    """Kill ``proc`` (a ``subprocess.Popen``) if it still runs."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


SECTOR = 32  # bytes: the unit in which the card reads device memory


def sector_bytes(starts, length: int) -> int:
    """Bytes of the distinct 32-byte sectors that hold the ``length``-byte
    spans at byte offsets ``starts`` (an int64 tensor): what a kernel that
    reads only those spans must fetch."""
    import torch
    if starts.numel() == 0:
        return 0
    span = (length + SECTOR - 1) // SECTOR + 1
    sec = starts[:, None] // SECTOR + torch.arange(span, device=starts.device)
    keep = sec <= (starts[:, None] + length - 1) // SECTOR
    return int(torch.unique(sec[keep]).numel()) * SECTOR


def prune_apply_bytes(args, out) -> int:
    """Bytes ``prune_apply`` must move on these inputs: the pruned bits in
    and out and the ``pruned_slot`` plane once; of ``src_sorted`` only the
    sectors that hold a set slot's prunee, and of the active set only the
    sectors of the rows that a live (pruner, prunee) pair scans."""
    pruned, active, src_sorted, pruned_slot = args[:4]
    N, S = pruned.shape[1:]
    C = src_sorted.shape[-1]
    idx = pruned_slot.reshape(-1).nonzero().squeeze(1)
    src = src_sorted.reshape(-1)[idx].long()
    ok = (src >= 0) & (src < N)
    rows = src if active.dim() == 2 else idx // (N * C) * N + src
    return (nbytes(pruned, pruned_slot, out) + sector_bytes(4 * idx, 4)
            + sector_bytes(4 * S * rows[ok], 4 * S))


def max_abs_err(got, want) -> int:
    """Largest absolute difference over every output tensor (-1 if a shape
    or dtype differs, or an output is None in one version only)."""
    got = tuple(got) if isinstance(got, tuple) else (got,)
    want = tuple(want) if isinstance(want, tuple) else (want,)
    err = 0
    for x, y in zip(got, want):
        if x is None or y is None:
            if x is not y:
                return -1
            continue
        if x.shape != y.shape or x.dtype != y.dtype:
            return -1
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def snapshot_strings(snap: dict) -> dict:
    """A parity snapshot with Pubkey keys as base58 strings."""
    def key(k):
        return k.to_string() if hasattr(k, "to_string") else k
    out = {}
    for name, v in snap.items():
        if isinstance(v, dict):
            v = {key(k): x for k, x in v.items()}
        elif isinstance(v, set):
            v = {key(k) for k in v}
        out[name] = v
    return out


KERNEL_SYMBOLS = {"bfs_relax": ("bfs_relax_kernel",),
                  "rank_inbound": ("rank_inbound_kernel",),
                  "rc_merge_prune": ("rc_merge_prune_kernel",),
                  "prune_apply": ("prune_apply_kernel",),
                  "threefry": ("threefry_kernel",),
                  "push_targets": ("push_targets_kernel",),
                  "rotate": ("rotate_kernel",),
                  "pull_exchange": ("pull_exchange_kernel",),
                  "traffic_send": ("traffic_send_kernel",),
                  # the three kernels of its cut design, and the one of
                  # the per-target walk before it (an older tree's, read
                  # by round_turns.py)
                  "traffic_admit": ("traffic_admit_tally_kernel",
                                    "traffic_admit_cut_kernel",
                                    "traffic_admit_write_kernel",
                                    "traffic_admit_kernel"),
                  "traffic_rescue": ("traffic_rescue_walk_kernel",
                                     "traffic_rescue_select_kernel"),
                  # the sparse layout's variant of rc_merge_prune
                  SPARSE: ("rc_merge_prune_sparse_kernel",),
                  # the node-health kernels (phase (n)); the traffic form
                  # of health_round is counted apart
                  "health_round": ("health_round_kernel",),
                  "health_round_traffic": ("health_round_traffic_kernel",),
                  "health_digest": ("health_digest_kernel",),
                  # the flight recorder's prune pairs (phase (o))
                  "trace_prune_pairs": ("trace_prune_pairs_kernel",)}


def device_ms(fn, symbols, reps: int = 10):
    """Mean device milliseconds per call of ``fn`` spent in the kernels whose
    names contain one of ``symbols`` (``None``: in every device activity it
    records, kernels, memsets and copies: the whole call of a wrapper),
    under torch.profiler (None if the profiler recorded no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(float(getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0.0)))
             for ev in prof.key_averages()
             if (ev.device_type == torch.autograd.DeviceType.CUDA
                 if symbols is None else any(sym in ev.key
                                             for sym in symbols)))
    return us / 1e3 / reps if us > 0 else None


def cold_device_ms(fn, symbols, flush, reps: int = 20):
    """Mean device milliseconds of the kernels whose names contain one of
    ``symbols`` per call of ``fn``, each call after ``flush.zero_()`` (a
    buffer past the L2 cache) so that it finds its inputs in device memory,
    as a round does; under torch.profiler (None if it recorded none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(float(getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0.0)))
             for ev in prof.key_averages()
             if any(sym in ev.key for sym in symbols))
    return us / 1e3 / reps if us > 0 else None


def ptxas_summary(log: str) -> list:
    """One line per kernel function of an ``nvcc -Xptxas -v`` log:
    registers, static shared memory, stack and spills."""
    lines, name, frame = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = next((sym for syms in KERNEL_SYMBOLS.values()
                         for sym in syms if sym in m.group(1)), m.group(1))
            # a template's arguments (bool flags: Lb0E / Lb1E)
            flags = re.findall(r"Lb([01])E", m.group(1).split("kernel")[-1])
            if flags:
                name += "<" + ", ".join("true" if f == "1" else "false"
                                        for f in flags) + ">"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = (f"stack {m.group(1)} B, spills {m.group(2)} B stored / "
                     f"{m.group(3)} B loaded")
            continue
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            lines.append(f"{name}: {m.group(1)} registers, static shared "
                         f"memory {smem.group(1) if smem else 0} B, {frame}")
            name, frame = None, ""
    return lines


def profile_rounds(run_rounds, params, tables, origins, state, out_dir,
                   rounds: int = 5, tag: str = "", phase: str = "(c)") -> dict:
    """Where a round's time goes: device time and launches per kernel group
    and for the plain PyTorch ops, over ``rounds`` rounds under
    torch.profiler, against the host wall clock (device idle share = 1 -
    busy / wall); printed under ``phase``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_rounds(params, tables, origins, state, rounds)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {name: 0.0 for name in KERNEL_SYMBOLS}
    counts = {name: 0 for name in KERNEL_SYMBOLS}
    other, n_other = {}, 0
    for ev in prof.key_averages():
        us = float(getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0.0)))
        if us <= 0 or getattr(ev, "device_type", None) not in (
                None, torch.autograd.DeviceType.CUDA):
            continue
        for name, syms in KERNEL_SYMBOLS.items():
            if any(s in ev.key for s in syms):
                groups[name] += us
                counts[name] += ev.count
                break
        else:
            other[ev.key] = other.get(ev.key, 0.0) + us
            n_other += ev.count
    busy_ms = (sum(groups.values()) + sum(other.values())) / 1e3
    if busy_ms <= 0:
        say(f"{phase}{tag} profiler: no device time recorded; breakdown not "
            f"measured")
        return {"device": {name: None for name in groups}}
    top = sorted(other.items(), key=lambda kv: -kv[1])[:16]
    launches = (sum(counts.values()) + n_other) / rounds
    lines = [f"{rounds} rounds at O={origins.numel()}{tag}: wall "
             f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
             f"{launches:.1f} device launches per round"]
    lines += [f"  {k:>16}: {v / 1e3 / rounds:.4f} ms/round in "
              f"{counts[k] / rounds:.1f} launches" for k, v in groups.items()]
    lines += [f"  other PyTorch kernels: "
              f"{sum(other.values()) / 1e3 / rounds:.4f} ms/round "
              f"({n_other / rounds:.1f} launches/round)"]
    lines += [f"    {v / 1e3 / rounds:.4f} ms/round  {k[:100]}"
              for k, v in top]
    name = "profile_round" + tag.strip().replace(" ", "_") + ".txt"
    (out_dir / name).write_text("\n".join(lines) + "\n")
    say(f"{phase}{tag} profile over {rounds} rounds: per round wall "
        f"{wall_ms / rounds:.3f} ms, device busy {busy_ms / rounds:.4f} ms "
        f"(idle share {1 - busy_ms / wall_ms:.3f}), {launches:.1f} device "
        f"launches; kernels "
        + ", ".join(f"{k} {v / 1e3 / rounds:.4f} ms in "
                    f"{counts[k] / rounds:.0f}" for k, v in groups.items())
        + f"; other PyTorch kernels {sum(other.values()) / 1e3 / rounds:.4f}"
        f" ms in {n_other / rounds:.0f} launches")
    for line in lines[len(groups) + 2:]:
        say(f"{phase}{tag}   {line.strip()}")
    return {"device": {k: v / 1e3 / rounds for k, v in groups.items()},
            "busy_ms": busy_ms / rounds, "wall_ms": wall_ms / rounds,
            "launches": launches}


@contextlib.contextmanager
def single_pass_schedule(pt_mod):
    """``push_targets`` launched on the single-pass schedule while inside:
    a block per tile with shared memory for one input buffer, so each
    block loads its tile, scans it and stores it, with no load in flight
    across tiles (for timing against the one-wave grid only)."""
    geometry, grid = pt_mod.launch_geometry, pt_mod.persistent_grid

    def one_buffer(s, f, smem_limit):
        rows, _ = geometry(s, f, smem_limit)
        return rows, pt_mod.stage_bytes(rows, s, f, buffers=1)

    def block_per_tile(rows, rows_per_block, sms, blocks_per_sm):
        tiles, _ = grid(rows, rows_per_block, sms, blocks_per_sm)
        return tiles, tiles

    pt_mod.launch_geometry, pt_mod.persistent_grid = one_buffer, block_per_tile
    try:
        yield
    finally:
        pt_mod.launch_geometry, pt_mod.persistent_grid = geometry, grid


#: (library, kernel symbol in its SASS) whose inlined threefry block is
#: counted: threefry's uniform mode, and rotate's trace-free instantiation
#: (csrc/threefry.cuh in both)
SASS_BLOCKS = {"threefry": ("threefry", "threefry_kernelILi3E"),
               "rotate": ("rotate", "rotate_kernelILb0E")}


def sass_block_ops(name: str, out_dir) -> dict:
    """Instructions of one threefry block as the card runs it inside kernel
    ``name``, counted per pipe in the SASS (``cuobjdump -sass``) of the
    kernel (:func:`count_block_ops`); the SASS goes to
    ``chiprun_out/sass_<name>.txt``."""
    from gossip_sim_tpu_torch.kernels import _build
    lib_name, symbol = SASS_BLOCKS[name]
    lib = _build._build_dir() / f"lib{lib_name}.so"
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120)
    if sass.returncode != 0:
        fail(f"cuobjdump failed: {sass.stderr.strip()}")
    (out_dir / f"sass_{name}.txt").write_text(sass.stdout)
    ops = count_block_ops(sass.stdout, symbol)
    if ops is None:
        fail(f"{name} SASS: found no threefry block (20 rotations and 3 "
             f"key-injection instructions after them, from a key load) in "
             f"{symbol}")
    return ops


def sass_body(sass: str, symbol: str) -> list:
    """(opcode, registers) of each instruction of the kernel whose name
    contains ``symbol``."""
    body, on = [], False
    for line in sass.splitlines():
        if "Function" in line:
            on = symbol in line
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9.]*)"
                      r"\s*([^;]*);", line)
        if on and m:
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", m.group(3))]
            body.append((m.group(2), regs))
    return body


def block_from(body: list, start: int):
    """The threefry block fed by the key load at ``body[start]`` (with the
    loads among the next three instructions: a key's two words), or None.

    Counted are the instructions that read a value derived from those
    loads, up to the block's last key injection, the third such
    instruction after the 20th rotation (``SHF.L.W``, one funnel shift
    each); index and address arithmetic reads no key word and is left
    out."""
    tainted = set()
    for op, regs in body[start:start + 4]:
        if op.startswith("LDG") and regs:
            tainted |= set(range(regs[0], regs[0] + (2 if ".64" in op else 1)))
    block, rot, after = [], 0, 0
    for op, regs in body[start + 1:]:
        if not regs:
            continue
        # a 64-bit result (IMAD.WIDE, LDG.E.64) writes a register pair
        width = 2 if ".WIDE" in op or ".64" in op else 1
        dst, srcs = set(range(regs[0], regs[0] + width)), regs[1:]
        if op.startswith("LDG") or not any(r in tainted for r in srcs):
            tainted -= dst
            continue
        tainted |= dst
        block.append(op)
        if op.startswith("SHF.L.W"):
            rot += 1
        elif rot == 20:
            after += 1
            if after == 3:
                return block
    return None


def count_block_ops(sass: str, symbol: str):
    """The instructions of the first threefry block of kernel ``symbol``
    that a key load feeds, by pipe: ``{"alu": n, "fma": n, "total": n}``
    (None if there is none).  ``IMAD*`` runs on the FMA pipe, every other
    integer instruction on the ALU pipe."""
    body = sass_body(sass, symbol)
    for i, (op, _) in enumerate(body):
        if op.startswith("LDG"):
            block = block_from(body, i)
            if block is not None:
                fma = sum(o.startswith("IMAD") for o in block)
                return {"alu": len(block) - fma, "fma": fma,
                        "total": len(block)}
    return None


def issue_s(ops: dict, blocks: int) -> float:
    """Seconds the card's integer pipes need for ``blocks`` threefry blocks
    of ``ops`` instructions each: the busiest of the ALU pipe, the FMA pipe
    and the issue of all of them."""
    per_sm_clock = max(ops["alu"] / ALU_LANES, ops["fma"] / FMA_LANES,
                       ops["total"] / ISSUE_LANES)
    return blocks * per_sm_clock / SM_CLOCKS_PER_S


def push_targets_bytes(args, outs) -> int:
    """Bytes ``push_targets`` must move on these inputs: the three slot
    planes and the origins in, the targets (and each mask that is on) out,
    and the sides while the partition window is on (in any lane)."""
    import numpy as np
    active, pruned, tfail, origins, side, _, partition = args[:7]
    return (nbytes(active, pruned, tfail, origins, *outs)
            + (nbytes(side) if partition is not None and np.any(partition)
               else 0))


def rotate_work(args, outs, rot_mod) -> tuple[int, int, int]:
    """What ``rotate`` must do on these inputs: (bytes moved, threefry
    blocks hashed, rows that rotate).

    Bytes: the three slot planes in and out, the keys, the class tables,
    ``rot_failed``; and for each row that rotates, its origin's and its
    own bucket, the ``perm`` entry of each try it takes (up to its first
    new peer) and the new peer's ``failed`` byte.  Blocks: each origin's
    round key and its T + 1 sub keys (one block a key in the partitionable
    layout, two in the original one), each row's rotation uniform, and two
    words for each try a rotating row takes.  ``it`` and ``prob`` may be
    per lane (each lane's for its rows)."""
    import numpy as np
    import torch
    (active, pruned, tfail, failed, key, it, origins, buckets, perm,
     start, count, cdf, prob, tries, part) = args
    O, N, _ = active.shape
    rows_of = lambda v, dt: torch.as_tensor(np.repeat(
        np.ravel(v), O // np.size(v)).astype(dt), device=active.device)
    it, prob = rows_of(it, np.int64), rows_of(prob, np.float32)[:, None]
    rot_u, u_all = rot_mod.draws_plain(key, it, N, tries, part)
    u = u_all.permute(0, 2, 1, 3)
    members = rot_mod.sample_members_plain(buckets, origins, cdf, start,
                                           count, u[..., 0], u[..., 1])
    cands = perm[members.clamp(max=N - 1).long()]                 # [O, N, T]
    iota = torch.arange(N, device=active.device)[None, :, None]
    fresh = (cands != iota) & ~(active[:, :, None, :]
                                == cands[..., None]).any(-1)
    found = fresh.any(-1)
    taken = torch.where(found, fresh.int().argmax(-1) + 1, tries)
    rot = rot_u < prob
    per_row = (8 + 4 * taken + found.int()).masked_fill(~rot, 0)
    moved = (nbytes(active, pruned, tfail, key, origins, start, count, cdf,
                    *outs) + int(per_row.sum()))
    blocks = (O * (1 + (tries + 1) * (1 if part else 2)) + O * N
              + 2 * int(taken.masked_fill(~rot, 0).sum()))
    return moved, blocks, int(rot.sum())


def by_origin(sd: dict, sizes: list, measured: int) -> dict:
    """An all-origins ``state_dict`` with each per-point chunk in (measured
    round, origin) order: a batched run's chunk holds each batch's
    [measured, n] block in turn (``sizes``: the valid origins of each)."""
    import numpy as np
    out = dict(sd)
    for k, v in sd.items():
        if k.startswith("chunk.") and v.size:
            ends = np.cumsum([0] + [measured * n for n in sizes])
            out[k] = np.concatenate(
                [v[a:b].reshape(measured, n) for a, b, n
                 in zip(ends[:-1], ends[1:], sizes)], axis=1).ravel()
    return out


def as_builtins(x):
    """``x`` as nested builtins, objects as their attribute dicts and NaN
    as "nan", so that two finalized aggregates compare with ``==``."""
    import numpy as np
    if hasattr(x, "to_string"):
        return x.to_string()
    if isinstance(x, dict):
        return {as_builtins(k): as_builtins(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [as_builtins(v) for v in x]
    if isinstance(x, np.ndarray):
        return as_builtins(x.tolist())
    if isinstance(x, (float, np.floating)):
        return "nan" if math.isnan(x) else float(x)
    if isinstance(x, (np.integer, np.bool_)):
        return x.item()
    if hasattr(x, "__dict__"):
        return {k: as_builtins(v) for k, v in vars(x).items()}
    return x


def kernel_work(calls: dict, outs: dict, tf_mod, rot_mod):
    """What each kernel must do on a round's captured ``calls`` (the first
    call of each; ``threefry``: all of its calls) with their ``outs``:
    (bytes moved, threefry blocks hashed, keys ``threefry`` hashes, rows
    that rotate).  Bytes: each input read once and each output written
    once."""
    tgt, org = calls["bfs_relax"][0][0]
    r_tgt, r_del, r_hop1 = calls["rank_inbound"][0][0][:3]
    tf_calls = calls["threefry"]
    tf_keys = sum(int(math.prod(a[0].shape[:-1])) for a, _ in tf_calls)
    tf_blocks = sum(int(math.prod(a[0].shape[:-1]))
                    * tf_mod.pairs(a[1], int(a[2]) if a[1] != "fold_in"
                                   else 1, a[3] if len(a) > 3 else True)
                    for a, _ in tf_calls)
    moved = {
        "bfs_relax": nbytes(tgt, org, *outs["bfs_relax"][0]),
        "rank_inbound": nbytes(r_tgt, r_del, r_hop1,
                               *outs["rank_inbound"][0]),
        "rc_merge_prune": nbytes(*calls["rc_merge_prune"][0][0],
                                 *outs["rc_merge_prune"][0]),
        "prune_apply": prune_apply_bytes(calls["prune_apply"][0][0],
                                         outs["prune_apply"][0]),
        # the keys read once (two words each) and every output written
        "threefry": 16 * tf_keys + nbytes(*outs["threefry"]),
        "push_targets": push_targets_bytes(calls["push_targets"][0][0],
                                           outs["push_targets"][0]),
    }
    moved["rotate"], rot_blocks, n_rot = rotate_work(
        calls["rotate"][0][0], outs["rotate"][0], rot_mod)
    blocks = {name: 0 for name in moved}
    blocks.update(threefry=tf_blocks, rotate=rot_blocks)
    return moved, blocks, tf_keys, n_rot


def bound(moved: int, blocks: int, ops: dict):
    """(bound ms, "bytes" or "operations", bytes ms, operations ms): the
    larger of ``moved`` bytes at the card's memory rate and ``blocks``
    threefry blocks of ``ops`` instructions (None for a kernel that hashes
    nothing) at its integer issue rate."""
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = issue_s(ops, blocks) * 1e3 if blocks else 0.0
    return (max(bytes_ms, ops_ms),
            "operations" if ops_ms > bytes_ms else "bytes", bytes_ms, ops_ms)


def pull_cases(EngineParams) -> dict:
    """Phase (h)'s ``pull_exchange`` cases: name -> (origins, params).
    The impaired push-pull case runs at request caps 0 and 2 (2 binds on
    the high-stake peers), the adaptive case has its bit on by round 19."""
    imp = dict(packet_loss_rate=0.1, churn_fail_rate=0.01,
               churn_recover_rate=0.2, partition_at=10, heal_at=30,
               impair_seed=7)
    base = dict(num_nodes=N_FULL, warm_up_rounds=0)
    return {
        "push-pull impaired cap 0": (O_PULL, EngineParams(
            **base, gossip_mode="push-pull", **imp)),
        "push-pull impaired cap 2": (O_PULL, EngineParams(
            **base, gossip_mode="push-pull", pull_request_cap=2, **imp)),
        "pull": (O_PULL, EngineParams(**base, gossip_mode="pull")),
        "adaptive": (O_PULL, EngineParams(
            **base, gossip_mode="adaptive", packet_loss_rate=0.1,
            impair_seed=7)),
        "push-pull impaired O=32": (O_KERNEL, EngineParams(
            **base, gossip_mode="push-pull", **imp)),
        "push-pull O=1": (1, EngineParams(
            **base, gossip_mode="push-pull", packet_loss_rate=0.1,
            impair_seed=7)),
    }


def pull_bytes(args, kw, out) -> int:
    """Bytes ``pull_exchange`` must move on these inputs: reached, failed
    and dist, the sampler's perm and class tables and the CDF, the
    adaptive bits and, while the partition window is on, the sides; its
    five [O, N] planes (pull hop, egress, ingress, and the stats' delivery
    view reached_all and dist_all) and the counts out."""
    (reached, dist, failed, side, perm, start, count, cdf,
     adaptive_on) = args
    import numpy as np
    return (nbytes(reached, dist, failed, perm, start, count, cdf,
                   adaptive_on, *out)
            + (nbytes(side) if kw["partition"] is not None
               and np.any(kw["partition"]) else 0))


def pull_geometry(g, px_mod) -> str:
    """``pull_exchange``'s launch geometry ``g`` in words."""
    return (f"cluster size {g.cs} ({px_mod.max_clusters(g)} such clusters "
            f"fit the card at once), slice {g.slice_len} nodes, {g.threads} "
            f"threads, {g.smem} B shared memory per CTA ("
            + (f"{4 * g.bitmap_words} B bitmaps, {4 * g.state_words} B node "
               f"words, {4 * g.draw_words} B kept draws"
               if not g.scratch_words else
               f"per-peer words in device memory, {g.scratch_words} words")
            + ")")


def traffic_params(EngineParams, case: str, m: int = M_TRAFFIC,
                   n: int = N_FULL):
    """Phase (i)'s engine parameters: ``uncapped`` (no cap, no
    impairment) or ``capped`` (both caps, loss, churn, a partition)."""
    extra = {} if case == "uncapped" else dict(
        node_ingress_cap=TRAFFIC_CAPS[0], node_egress_cap=TRAFFIC_CAPS[1],
        **TRAFFIC_IMPAIRED)
    return EngineParams(num_nodes=n, traffic_values=m,
                        traffic_rate=TRAFFIC_RATE, warm_up_rounds=0, **extra)


def traffic_round19(kernels, prm, tables, ttables, stakes_np, dev):
    """Rounds 0-18 of a traffic run; round 19's rows and the calls of the
    five traffic kernels in it (the wrappers themselves run)."""
    from gossip_sim_tpu_torch.engine.traffic import (init_traffic_state,
                                                     run_traffic_rounds,
                                                     traffic_round_step)
    st = init_traffic_state(stakes_np, prm, 42, dev)
    st, _ = run_traffic_rounds(prm, tables, ttables, st, 19)
    calls = {name: [] for name in TRAFFIC_KERNELS}
    real = {name: getattr(kernels, name) for name in TRAFFIC_KERNELS}

    def recorder(name):
        def rec(*a, **kw):
            calls[name].append((a, kw))
            return real[name](*a, **kw)
        return rec

    for name in TRAFFIC_KERNELS:
        setattr(kernels, name, recorder(name))
    try:
        st, rows = traffic_round_step(prm, tables, ttables, st, 19)
    finally:
        for name in TRAFFIC_KERNELS:
            setattr(kernels, name, real[name])
    return st, rows, one_run_calls(calls, prm.traffic_values)


def one_run_calls(calls: dict, v: int) -> dict:
    """The serial round's kernel calls (the lane form with one lane: every
    traffic kernel takes a leading lane axis since traffic lanes) in each
    kernel's one-run form, the shapes (i) times and bounds."""
    try:
        from gossip_sim_tpu_torch.kernels._lanes import one_lane_call
    except ImportError:  # a tree before traffic lanes: one-run calls
        return calls
    return {name: [one_lane_call(name, a, kw, 0, v) for a, kw in recorded]
            for name, recorded in calls.items()}


def adaptive_params(EngineParams, case: str, m: int = M_TRAFFIC,
                    n: int = N_FULL):
    """Phase (i)'s adaptive traffic parameters: :func:`traffic_params` in
    ``gossip_mode="adaptive"`` at the reference's default threshold."""
    return traffic_params(EngineParams, case, m, n)._replace(
        gossip_mode="adaptive", adaptive_switch_threshold=ADAPTIVE_THRESHOLD)


def adaptive_round(kernels, prm, tables, ttables, stakes_np, dev,
                   capped: bool, first: int = 39, last: int = 139):
    """An adaptive traffic run up to the first round from ``first`` on (past
    the first values' lifetimes: a steady mix of push and pull phases) in
    which values are in their pull phase (and, ``capped``, the rescue
    defers or queue-drops requests).  Returns (that round, the state before
    it, its rows, the calls of the six kernels in it)."""
    from gossip_sim_tpu_torch.engine.traffic import (init_traffic_state,
                                                     run_traffic_rounds,
                                                     traffic_round_step)
    st = init_traffic_state(stakes_np, prm, 42, dev)
    st, _ = run_traffic_rounds(prm, tables, ttables, st, first)
    real = {name: getattr(kernels, name) for name in ADAPTIVE_KERNELS}
    for it in range(first, last + 1):
        calls = {name: [] for name in ADAPTIVE_KERNELS}

        def recorder(name):
            def rec(*a, **kw):
                calls[name].append((a, kw))
                return real[name](*a, **kw)
            return rec

        for name in ADAPTIVE_KERNELS:
            setattr(kernels, name, recorder(name))
        try:
            nxt, rows = traffic_round_step(prm, tables, ttables, st, it)
        finally:
            for name in ADAPTIVE_KERNELS:
                setattr(kernels, name, real[name])
        if int(rows["pull_active_values"]) > 0 and (
                not capped or int(rows["pull_deferred"])
                + int(rows["pull_queue_dropped"]) > 0):
            return it, st, rows, one_run_calls(calls, prm.traffic_values)
        st = nxt
    fail(f"(i) adaptive traffic: no value in its pull phase (capped "
         f"{capped}: and no pull request deferred or queue-dropped) by "
         f"round {last}")


def rescue_work(args, kw, out, tr_mod):
    """What ``traffic_rescue`` must do on these inputs: (bytes moved, edge
    hashes, node hashes).  Bytes: the pull-phase values' rows of
    holder_pre, hop_pre and the holders, the node tables it gathers (failed,
    perm, push sends and acceptances, the sides while the partition is on),
    every output once.  Hashes: the class and member draws of each wanted
    (value, requester, slot) of a live requester missing a pull-phase
    value, the loss hash of each request that reaches the loss gate, and a
    bloom hash per (pull-phase value, live requester missing it)."""
    (pull_on, vid, holder_pre, hop_pre, holder, failed, side, perm, cs, cc,
     cdf, push_out, acc) = args[:13]
    fanout = args[13]
    N = holder_pre.shape[1]
    rows = int(pull_on.sum())
    req = tr_mod.rescue_requests(*args, **kw)
    pairs = int((pull_on[:, None] & ~holder_pre & ~failed[None, :]).sum())
    at_loss = (int((req.sent & ~req.failed_target & ~req.suppressed).sum())
               if kw.get("loss") is not None else 0)
    moved = (rows * N * (holder_pre.element_size() + hop_pre.element_size()
                         + holder.element_size())
             + nbytes(pull_on, vid, failed, perm, cs, cc, cdf, push_out, acc,
                      *out)
             + (nbytes(side) if kw.get("partition") else 0))
    return moved, 2 * pairs * fanout + at_loss, pairs


def rescue_bound(moved: int, edge_hashes: int, node_hashes: int):
    """(bound ms, "bytes" or "operations") of ``traffic_rescue``: the
    larger of the bytes at the memory rate and the hashes at the integer
    issue rate."""
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = (issue_s(EDGE_HASH_OPS, edge_hashes)
              + issue_s(NODE_HASH_OPS, node_hashes)) * 1e3
    return max(bytes_ms, ops_ms), ("operations" if ops_ms > bytes_ms
                                   else "bytes")


def traffic_bytes(name, args, kw, out) -> int:
    """Bytes a traffic-round kernel call must move on these inputs: its
    outputs once and what it must read once.  ``traffic_send`` reads the
    prune bits only in the rows of live holders and writes the peers and
    codes (its slot bitmasks are counted once, as ``traffic_admit``'s
    input: ``arr_bits`` whole, ``cand_bits`` only at the words of senders
    whose message arrived); ``prune_apply`` as in :func:`prune_apply_bytes`;
    the other two every input and output once."""
    if name == "traffic_send":
        active, pruned, failed, v_live, v_holder, v_origin, v_vid, side = (
            args[:8])
        S = pruned.shape[-1]
        rows = (v_live[:, None] & v_holder & ~failed).reshape(-1).nonzero()
        return (nbytes(active, failed, v_live, v_holder, v_origin, out.peer,
                       out.code)
                + (nbytes(side) if kw.get("partition") else 0)
                + (nbytes(v_vid) if kw.get("loss") is not None else 0)
                + sector_bytes(S * rows.squeeze(1), S))
    if name == "traffic_admit":
        cand_bits, arr_bits, active = args[:3]
        hit = (arr_bits.reshape(-1) != 0).nonzero().squeeze(1)
        return nbytes(arr_bits, active, *out) + sector_bytes(4 * hit, 4)
    if name == "prune_apply":
        return prune_apply_bytes(args, out)
    ins = [a for a in args if hasattr(a, "element_size")]
    return nbytes(*ins, *(tuple(out) if isinstance(out, tuple) else (out,)))


CALLS_FLAG = "--profile-calls"
#: the kernels timed as whole calls against an older tree (calls_child)
REDESIGNED = ("prune_apply", "traffic_admit", "traffic_send")


def calls_child(tree: Path) -> int:
    """``chip_smoke.py --profile-calls [TREE]``: the device ms per call of
    the kernels in ``REDESIGNED``, kernel only (their kernels' events) and
    whole (every device activity of the wrapper: a copy, a memset or an
    index build included), and the CUDA-event ms, on round 19's inputs of
    each shape the phases time them at: ``prune_apply`` at (b) O=32, (d)
    O=1, (f) O=64 (origins 0-63, all-origins parameters), (h) push-pull
    O=64 (impaired, request cap 0), and all three at (i) M=256 uncapped
    and capped, and M=32.
    The package comes from TREE (default: this checkout), so that
    ``round_turns.py --calls`` can compare a parent and a change in turns.
    The inputs are captured first and the profiler sessions run back to
    back (later sessions of a process record no device time).  Prints a
    JSON line, last."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    sys.path.insert(0, str(tree.resolve()))
    import numpy as np
    from gossip_sim_tpu_torch import cli, kernels, rng
    from gossip_sim_tpu_torch.engine import (EngineParams, init_state,
                                             make_cluster_tables, run_rounds)
    from gossip_sim_tpu_torch.engine.traffic import device_traffic_tables
    from gossip_sim_tpu_torch.identity import NodeIndex
    dev = torch.device("cuda")
    kernels.build_all()
    cfg = cli.Config(num_synthetic_nodes=N_FULL, all_origins=True)
    accounts, _ = cli.load_cluster_accounts(cfg)
    stakes_np = NodeIndex.from_stakes(accounts).stakes.astype(np.int64)
    tables = make_cluster_tables(stakes_np, device=dev)
    top = np.argsort(-stakes_np, kind="stable").astype(np.int32)

    def push_round19(prm, orgs):
        state = init_state(rng.prng_key(42, dev), tables, orgs, prm)
        state, _ = run_rounds(prm, tables, orgs, state, 19)
        calls, real = [], kernels.prune_apply

        def rec(*a, **kw):
            calls.append((a, kw))
            return real(*a, **kw)

        kernels.prune_apply = rec
        try:
            run_rounds(prm, tables, orgs, state, 1, start_it=19)
        finally:
            kernels.prune_apply = real
        return {"prune_apply": calls[0]}

    at = lambda o: torch.as_tensor(top[:o], device=dev)
    base = EngineParams(num_nodes=N_FULL, warm_up_rounds=0)
    o_pp, prm_pp = pull_cases(EngineParams)["push-pull impaired cap 0"]
    shapes = {
        "(b) O=32": push_round19(base, at(O_KERNEL)),
        "(d) O=1": push_round19(base, at(1)),
        "(f) O=64": push_round19(cli.all_origins_params(cfg, N_FULL),
                                 torch.arange(O_BATCH, dtype=torch.int32,
                                              device=dev)),
        "(h) push-pull O=64": push_round19(prm_pp, at(o_pp)),
    }
    ttables = device_traffic_tables(stakes_np, dev)
    for case, m in (("uncapped", M_TRAFFIC), ("capped", M_TRAFFIC),
                    ("uncapped", M_NARROW)):
        _, _, calls = traffic_round19(kernels, traffic_params(
            EngineParams, case, m), tables, ttables, stakes_np, dev)
        shapes[f"(i) {case} M={m}"] = {n: calls[n][0] for n in REDESIGNED}
        del calls
    torch.cuda.synchronize()
    out = {}
    for shape, calls in shapes.items():
        out[shape] = {}
        for name, (a, kw) in calls.items():
            fn = getattr(kernels, name)
            call = lambda: fn(*a, **kw)
            out[shape][name] = {
                "kernel_ms": device_ms(call, KERNEL_SYMBOLS[name], reps=20),
                "whole_ms": device_ms(call, None, reps=20),
                "ms": cuda_ms(call, reps=20)}
    print(json.dumps({"tree": str(tree), "device": torch.cuda.get_device_name(
        0), "shapes": out}), flush=True)
    return 0


def whole_calls(tree: Path = ROOT) -> dict:
    """Run :func:`calls_child` for ``tree`` in a process of its own; its
    JSON line (its other output is printed)."""
    run = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), CALLS_FLAG, str(tree)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    for line in run.stdout.splitlines()[:-1]:
        print(line, flush=True)
    if run.returncode != 0:
        fail(f"the whole-call profile process of {tree} failed (exit "
             f"{run.returncode}): {run.stderr[-2000:]}")
    return json.loads(run.stdout.splitlines()[-1])


PROFILE_FLAG = "--profile-all-origins"
WIDE_FLAG = "--profile-wide-shapes"
PULL_FLAG = "--profile-pull"
TRAFFIC_FLAG = "--profile-traffic"
SPARSE_FLAG = "--profile-sparse"


# sweep lanes (k): K lanes of O origins each on round 19 (32 rows), the
# engine's K lanes of one origin, and the kernels that read a sweep knob
LANE_K, LANE_O = 8, 4
LANE_KERNELS = ("push_targets", "rc_merge_prune", "rotate", "pull_exchange")
LANES_FLAG = "--profile-lanes"


def lane_params(EngineParams, mode: str = "push", n: int = N_FULL) -> list:
    """Phase (k)'s ``LANE_K`` lanes, each with knobs of its own: packet loss
    0 to 0.35, prune stake threshold 0.05 to 0.4, ``min_ingress_nodes`` 1
    to 4, rotation probability 1/75 to 1/5, and a partition (rounds 10-29)
    in the even lanes; ``push-pull`` adds pull fanouts 2 to 8 and bloom
    rates 0.05 to 0.4, ``sparse`` runs the push lanes in the sparse
    layout."""
    out = []
    for j in range(LANE_K):
        kw = dict(num_nodes=n, warm_up_rounds=0, impair_seed=7,
                  packet_loss_rate=0.05 * j,
                  prune_stake_threshold=0.05 + 0.05 * j,
                  min_ingress_nodes=1 + j % 4,
                  probability_of_rotation=(1 / 75 + j * (1 / 5 - 1 / 75)
                                           / (LANE_K - 1)),
                  partition_at=10 if j % 2 == 0 else -1,
                  heal_at=30 if j % 2 == 0 else -1)
        if mode == "push-pull":
            kw.update(gossip_mode="push-pull",
                      pull_fanout=2 + 6 * j // (LANE_K - 1),
                      pull_bloom_fp_rate=0.05 * (j + 1))
        if mode == "sparse":
            kw.update(representation="sparse")
        out.append(EngineParams(**kw))
    return out


def lane_round19(kernels, engine, plist, tables, orgs, which, dev):
    """Rounds 0-18 of the lanes ``plist`` at origins ``orgs`` (each lane's),
    then round 19 with the calls of the kernels ``which`` recorded:
    {name: [(args, kw), ...]}."""
    from gossip_sim_tpu_torch import rng
    static = engine.merge_lane_statics([p.static_part() for p in plist])
    kstack = engine.stack_knobs([p.knob_values() for p in plist])
    st = engine.broadcast_state(engine.init_state(
        rng.prng_key(42, dev), tables, orgs, plist[0]), len(plist))
    st, _ = engine.run_rounds_lanes(static, tables, orgs, st, kstack, 19)
    return record_calls(kernels, which, engine.run_rounds_lanes, static,
                        tables, orgs, st, kstack, 1, 19)[1]


def record_calls(kernels, which, fn, *args):
    """``fn(*args)`` with the calls of the kernels ``which`` recorded:
    (its result, {name: [(args, kw), ...]})."""
    real = {name: getattr(kernels, name) for name in which}
    calls = {name: [] for name in which}

    def recorder(name):
        def rec(*a, **kw):
            calls[name].append((a, kw))
            return real[name](*a, **kw)
        return rec

    for name in which:
        setattr(kernels, name, recorder(name))
    try:
        out = fn(*args)
    finally:
        for name, f in real.items():
            setattr(kernels, name, f)
    return out, calls


def lane_call(args, kw, lane, k):
    """A lane kernel call's arguments for lane ``lane`` of ``k`` alone:
    each per-lane knob (a numpy array) as that lane's scalar and each
    origin-row tensor cut to the lane's rows; ``lane=None`` keeps every row
    and takes lane 0's knobs (the one-lane call on the same rows)."""
    import numpy as np
    import torch
    rows = args[0].shape[0]
    per = rows // k
    cut = (slice(None) if lane is None
           else slice(lane * per, (lane + 1) * per))
    j = 0 if lane is None else lane

    def pick(v):
        if isinstance(v, np.ndarray):
            a = v.reshape(-1)
            return (a[0] if a.size == 1 else a[j]).item()
        if isinstance(v, tuple):
            return tuple(pick(x) for x in v)
        if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == rows:
            return v[cut]
        return v

    return tuple(pick(a) for a in args), {n: pick(v) for n, v in kw.items()}


def same_knobs(args, kw, k):
    """A lane kernel call with every per-lane knob set to lane 0's in all
    ``k`` lanes: the lane call's work of the one-lane call (lane 0's
    knobs on every row), through the per-lane struct."""
    import numpy as np

    def same(v):
        if isinstance(v, np.ndarray):
            return np.repeat(v.reshape(-1)[:1], k)
        if isinstance(v, tuple):
            return tuple(same(x) for x in v)
        return v

    return tuple(same(a) for a in args), {n: same(v) for n, v in kw.items()}


def lanes_child(dev) -> int:
    """``chip_smoke.py --profile-lanes`` (see :func:`profile_child`)."""
    import numpy as np
    import torch
    from gossip_sim_tpu_torch import cli, engine, kernels
    from gossip_sim_tpu_torch.engine import EngineParams
    from gossip_sim_tpu_torch.identity import NodeIndex
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    accounts, _ = cli.load_cluster_accounts(
        cli.Config(num_synthetic_nodes=N_FULL))
    stakes_np = NodeIndex.from_stakes(accounts).stakes.astype(np.int64)
    tables = engine.make_cluster_tables(stakes_np, device=dev)
    top = np.argsort(-stakes_np, kind="stable").astype(np.int32)
    orgs = torch.as_tensor(top[:LANE_O], device=dev)
    real = {name: getattr(kernels, name) for name in LANE_KERNELS}
    captured = {}
    for mode, name in (("push", "push_targets"), ("push", "rc_merge_prune"),
                       ("push", "rotate"), ("sparse", "rc_merge_prune"),
                       ("push-pull", "pull_exchange")):
        calls = lane_round19(kernels, engine, lane_params(EngineParams, mode),
                             tables, orgs, [name], dev)
        captured[f"{name} {mode}"] = (name, calls[name][0])
    # the engine's rounds: K lanes of one origin, the serial round at O=1
    # and at O=K (all-origins), each from round 20 of its own run
    plist = lane_params(EngineParams)
    static = engine.merge_lane_statics([p.static_part() for p in plist])
    kstack = engine.stack_knobs([p.knob_values() for p in plist])
    one = torch.as_tensor(top[:1], device=dev)
    wide = torch.as_tensor(top[:LANE_K], device=dev)
    runs = {}
    st = engine.broadcast_state(engine.init_state(
        engine_key(dev), tables, one, plist[0]), LANE_K)
    st, _ = engine.run_rounds_lanes(static, tables, one, st, kstack, 20)
    runs[f"lanes K={LANE_K} O=1"] = (
        lambda p, t, o_, s_, r: engine.run_rounds_lanes(
            static, t, o_, s_, kstack, r, start_it=20), one, st)
    for tag, orgs_ in (("serial O=1", one), (f"serial O={LANE_K}", wide)):
        s1 = engine.init_state(engine_key(dev), tables, orgs_, plist[1])
        s1, _ = engine.run_rounds(static, tables, orgs_, s1, 20,
                                  knobs=plist[1].knob_values())
        runs[tag] = (lambda p, t, o_, s_, r: engine.run_rounds(
            static, t, o_, s_, r, start_it=20,
            knobs=plist[1].knob_values()), orgs_, s1)
    torch.cuda.synchronize()
    out = {"kernels": {}, "rounds": {}}
    for key, (name, (a, kw)) in captured.items():
        sym = KERNEL_SYMBOLS[SPARSE if "sparse" in key else name]
        a1, kw1 = lane_call(a, kw, None, LANE_K)
        au, kwu = same_knobs(a, kw, LANE_K)
        out["kernels"][key] = {
            "device_ms": device_ms(lambda: real[name](*a, **kw), sym),
            "one_lane_device_ms": device_ms(lambda: real[name](*a1, **kw1),
                                            sym),
            "same_knobs_device_ms": device_ms(
                lambda: real[name](*au, **kwu), sym)}
    for tag, (run, orgs_, st_) in runs.items():
        prof = profile_rounds(run, None, tables, orgs_, st_, out_dir,
                              tag=" " + tag.replace("=", ""), phase="(k)")
        out["rounds"][tag] = {k: prof.get(k) for k in ("busy_ms", "wall_ms",
                                                       "launches")}
        out["rounds"][tag]["device"] = prof["device"]
    print(json.dumps(out), flush=True)
    return 0


# traffic lanes (l): a batch of 4 lanes at M=256 (about four fit the 80 GB
# card: a full-width traffic run peaked at ~15 GB) and 8 at M=32, each
# lane with its own loss, caps, churn and partition
TL_K, TL_K_NARROW = 4, 8
TRAFFIC_LANES_FLAG = "--profile-traffic-lanes"


def traffic_lane_params(EngineParams, k: int, m: int = M_TRAFFIC,
                        n: int = N_FULL, adaptive: bool = False) -> list:
    """Phase (l)'s ``k`` traffic lanes at ``m`` value slots, rate 16: lane
    0 uncapped and unimpaired, lane 1 loss 0.1 with (i)'s caps, lane 2
    churn with caps 64/128, lane 3 a partition (rounds 10-29), loss 0.05
    and caps 1/96, repeating, each with a hash seed of its own;
    ``adaptive``: in adaptive mode at thresholds 0.5, 0.7, 0.9, 0.9."""
    out = []
    for j in range(k):
        kw = dict(num_nodes=n, traffic_values=m, traffic_rate=TRAFFIC_RATE,
                  warm_up_rounds=0, impair_seed=7 + j)
        kw.update([{}, dict(packet_loss_rate=0.1,
                            node_ingress_cap=TRAFFIC_CAPS[0],
                            node_egress_cap=TRAFFIC_CAPS[1]),
                   dict(churn_fail_rate=0.01, churn_recover_rate=0.2,
                        node_ingress_cap=64, node_egress_cap=128),
                   dict(partition_at=10, heal_at=30, packet_loss_rate=0.05,
                        node_ingress_cap=1, node_egress_cap=96)][j % 4])
        if adaptive:
            kw.update(gossip_mode="adaptive",
                      adaptive_switch_threshold=(0.5, 0.7, 0.9, 0.9)[j % 4])
        out.append(EngineParams(**kw))
    return out


def traffic_lanes_at(kernels, plist, tables, ttables, stakes_np, dev,
                     which, first: int = 19, last: int = 19):
    """The lanes ``plist`` run to round ``first``; then their rounds up to
    ``last`` with the calls of the kernels ``which`` recorded, up to the
    first whose rows show values in their pull phase (adaptive lanes) or
    the first round (push lanes).  Returns (that round, its rows, the
    calls)."""
    from gossip_sim_tpu_torch import engine
    from gossip_sim_tpu_torch.engine import traffic as tr
    static = engine.merge_lane_statics([p.static_part() for p in plist])
    kstack = engine.stack_knobs([p.knob_values() for p in plist])
    st = tr.broadcast_traffic_state(tr.init_traffic_state(
        stakes_np, plist[0], 42, dev), len(plist))
    st, _ = tr.run_traffic_lanes(static, tables, ttables, st, kstack, first)
    for it in range(first, last + 1):
        (st, rows), calls = record_calls(kernels, which, tr.run_traffic_lanes,
                                         static, tables, ttables, st, kstack,
                                         1, it)
        if "pull_active_values" not in rows or int(
                rows["pull_active_values"].sum()) > 0:
            return it, rows, calls
    fail(f"(l) adaptive lanes: no value in its pull phase by round {last}")


def traffic_lanes_child(dev) -> int:
    """``chip_smoke.py --profile-traffic-lanes``, started by phase (l): the
    device ms of each traffic kernel's lane call (4 lanes, M=256; the
    rescue on the adaptive lanes' first round from 39 with values in their
    pull phase) beside the sum of its 4 one-lane calls, then 5-round
    profiles (from round 20) of the 4-lane round and of the 4 lanes' serial
    rounds, and of the 8-lane round and 8 serial rounds at M=32."""
    import numpy as np
    import torch
    from gossip_sim_tpu_torch import cli, engine, kernels
    from gossip_sim_tpu_torch.engine import EngineParams
    from gossip_sim_tpu_torch.engine import traffic as tr
    from gossip_sim_tpu_torch.identity import NodeIndex
    from gossip_sim_tpu_torch.kernels import _lanes
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    accounts, _ = cli.load_cluster_accounts(
        cli.Config(num_synthetic_nodes=N_FULL))
    stakes_np = NodeIndex.from_stakes(accounts).stakes.astype(np.int64)
    tables = engine.make_cluster_tables(stakes_np, device=dev)
    ttables = tr.device_traffic_tables(stakes_np, dev)
    real = {name: getattr(kernels, name) for name in ADAPTIVE_KERNELS}
    out = {"kernels": {}, "rounds": {}}
    # the kernels' calls first, then their profiler sessions back to back
    _, _, calls = traffic_lanes_at(
        kernels, traffic_lane_params(EngineParams, TL_K), tables, ttables,
        stakes_np, dev, TRAFFIC_KERNELS)
    _, _, rcalls = traffic_lanes_at(
        kernels, traffic_lane_params(EngineParams, TL_K, adaptive=True),
        tables, ttables, stakes_np, dev, ["traffic_rescue"], 39, 139)
    calls.update(rcalls)
    torch.cuda.synchronize()
    for name in ADAPTIVE_KERNELS:
        a, kw = calls[name][0]
        ones = [_lanes.one_lane_call(name, a, kw, j, M_TRAFFIC)
                for j in range(TL_K)]
        out["kernels"][name] = {
            "device_ms": device_ms(lambda: real[name](*a, **kw),
                                   KERNEL_SYMBOLS[name]),
            "one_lane_sum_device_ms": device_ms(
                lambda: [real[name](*a1, **k1) for a1, k1 in ones],
                KERNEL_SYMBOLS[name])}
    del calls, rcalls, a, kw, ones
    torch.cuda.empty_cache()
    # the rounds: each lane batch and its lanes' serial runs from round 20
    runs = []
    for k, m in ((TL_K, M_TRAFFIC), (TL_K_NARROW, M_NARROW)):
        plist = traffic_lane_params(EngineParams, k, m)
        static = engine.merge_lane_statics([p.static_part() for p in plist])
        kstack = engine.stack_knobs([p.knob_values() for p in plist])
        st0 = tr.init_traffic_state(stakes_np, plist[0], 42, dev)
        st, _ = tr.run_traffic_lanes(static, tables, ttables,
                                     tr.broadcast_traffic_state(st0, k),
                                     kstack, 20)
        runs.append((f"lanes K={k} M={m}", lambda p, t, _o, s_, r, static=(
            static), kstack=kstack: tr.run_traffic_lanes(
                static, t, ttables, s_, kstack, r, start_it=20), st))
        serial = [tr.run_traffic_rounds(p, tables, ttables, st0, 20)[0]
                  for p in plist]

        def serial_rounds(_p, t, _o, sts, r, plist=plist):
            for p, s1 in zip(plist, sts):
                tr.run_traffic_rounds(p, t, ttables, s1, r, start_it=20)

        runs.append((f"serial x{k} M={m}", serial_rounds, serial))
    torch.cuda.synchronize()
    for tag, fn, st in runs:
        prof = profile_rounds(fn, None, tables, torch.zeros(1), st, out_dir,
                              tag=" traffic " + tag.replace("=", ""),
                              phase="(l)")
        out["rounds"][tag] = {k: prof.get(k) for k in ("busy_ms", "wall_ms",
                                                       "launches")}
        out["rounds"][tag]["device"] = prof["device"]
    print(json.dumps(out), flush=True)
    return 0


def engine_key(dev):
    from gossip_sim_tpu_torch import rng
    return rng.prng_key(42, dev)


def profile_child(flag: str) -> int:
    """``chip_smoke.py --profile-all-origins``: the 5-round profile of one
    all-origins batch (origins 0-63 of the 10,000-node cluster, after 20
    rounds), started by phase (f).  ``chip_smoke.py
    --profile-wide-shapes``: at each of ``WIDE_SHAPES``, the 5-round
    profile from round 19 of the 16 highest-stake origins, and
    ``init_state``'s (``threefry``), started by phase (g).  ``chip_smoke.py
    --profile-pull``: ``pull_exchange``'s device time on round 19's
    inputs of each of phase (h)'s cases, and the 5-round profile of
    push-pull at O=32 from round 19, started by phase (h).  ``chip_smoke.py
    --profile-traffic``: each traffic kernel's device time on round 19's
    inputs at M=256 (both cases) and M=32 (uncapped), and the 5-round
    traffic profiles from round 19 at M=256 and M=32, started by phase
    (i), and the same for adaptive traffic at M=256 (uncapped and capped,
    on the first round from 39 on with values in their pull phase; the
    5-round adaptive profile from round 20, as push mode's).
    ``chip_smoke.py --profile-sparse``: see :func:`sparse_child`.
    ``chip_smoke.py --profile-lanes``: the device
    time of each kernel that reads a sweep knob on phase (k)'s round 19 of
    ``LANE_K`` lanes of ``LANE_O`` origins (push, sparse, push-pull), and of
    its one-lane call on the same rows, and the 5-round profiles from round
    20 of ``LANE_K`` lanes of one origin, of the serial round at O=1 and of
    the serial round at O=``LANE_K``, started by phase (k).  Each runs in a
    process whose first profiler sessions they are (later sessions of a
    process record no device time) and prints a JSON line, last."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from gossip_sim_tpu_torch import cli, rng
    from gossip_sim_tpu_torch.engine import (EngineParams, init_state,
                                             make_cluster_tables, run_rounds)
    from gossip_sim_tpu_torch.identity import NodeIndex
    dev = torch.device("cuda")
    if flag == LANES_FLAG:
        return lanes_child(dev)
    if flag == TRAFFIC_LANES_FLAG:
        return traffic_lanes_child(dev)
    cfg = cli.Config(num_synthetic_nodes=N_FULL, all_origins=True)
    accounts, _ = cli.load_cluster_accounts(cfg)
    index = NodeIndex.from_stakes(accounts)
    stakes_np = index.stakes.astype(np.int64)
    tables = make_cluster_tables(stakes_np, device=dev)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    if flag == PROFILE_FLAG:
        params = cli.all_origins_params(cfg, N_FULL)
        origins = torch.arange(O_BATCH, dtype=torch.int32, device=dev)
        state = init_state(rng.prng_key(cfg.seed, dev), tables, origins,
                           params)
        state, _ = run_rounds(params, tables, origins, state, 20)
        prof = profile_rounds(run_rounds, params, tables, origins, state,
                              out_dir, tag=" all-origins", phase="(f)")
        print(json.dumps(prof), flush=True)
        return 0
    if flag == TRAFFIC_FLAG:
        from gossip_sim_tpu_torch import kernels
        from gossip_sim_tpu_torch.engine.traffic import (device_traffic_tables,
                                                         run_traffic_rounds)
        ttables = device_traffic_tables(stakes_np, dev)
        # every case's inputs first, then the profiler sessions back to back
        captured = []
        for case, m, adaptive in (("uncapped", M_TRAFFIC, False),
                                  ("capped", M_TRAFFIC, False),
                                  ("uncapped", M_NARROW, False),
                                  ("uncapped", M_TRAFFIC, True),
                                  ("capped", M_TRAFFIC, True)):
            if adaptive:
                # the kernels on a round with values in their pull phase;
                # the profile from round 20, as push mode's
                prm = adaptive_params(EngineParams, case, m)
                _, _, _, calls = adaptive_round(
                    kernels, prm, tables, ttables, stakes_np, dev,
                    case == "capped")
                st = (traffic_round19(kernels, prm, tables, ttables,
                                      stakes_np, dev)[0]
                      if case == "uncapped" else None)
                it0, key = 20, f"adaptive {case} M={m}"
                tag = f" traffic adaptive M={m}"
            else:
                prm = traffic_params(EngineParams, case, m)
                st, _, calls = traffic_round19(kernels, prm, tables, ttables,
                                               stakes_np, dev)
                it0, key, tag = 20, f"{case} M={m}", f" traffic M={m}"
            captured.append((key, tag, prm, it0, calls,
                             st if case == "uncapped" else None))
            del st
        torch.cuda.synchronize()
        out = {}
        for key, tag, prm, it0, calls, st in captured:
            out[key] = {}
            for name, recorded in calls.items():
                a, kw = recorded[0]
                fn = getattr(kernels, name)
                out[key][name] = device_ms(lambda: fn(*a, **kw),
                                           KERNEL_SYMBOLS[name], reps=10)
            if st is not None:
                out["profile" + tag.replace(" traffic", "")] = profile_rounds(
                    lambda p, t, _o, s_, r, it0=it0: run_traffic_rounds(
                        p, t, ttables, s_, r, start_it=it0),
                    prm, tables, torch.zeros(prm.traffic_values), st,
                    out_dir, tag=tag, phase="(i)")
        print(json.dumps(out), flush=True)
        return 0
    if flag == PULL_FLAG:
        from gossip_sim_tpu_torch import kernels
        real = kernels.pull_exchange
        top = np.argsort(-stakes_np, kind="stable").astype(np.int32)
        out = {}
        for case, (o, prm) in pull_cases(EngineParams).items():
            orgs = torch.as_tensor(top[:o], device=dev)
            state = init_state(rng.prng_key(42, dev), tables, orgs, prm)
            state, _ = run_rounds(prm, tables, orgs, state, 19)
            calls = []

            def rec(*a, **kw):
                calls.append((a, kw))
                return real(*a, **kw)

            kernels.pull_exchange = rec
            try:
                run_rounds(prm, tables, orgs, state, 1, start_it=19)
            finally:
                kernels.pull_exchange = real
            a, kw = calls[0]
            out[case] = device_ms(lambda: real(*a, **kw),
                                  KERNEL_SYMBOLS["pull_exchange"], reps=20)
        prm = EngineParams(num_nodes=N_FULL, warm_up_rounds=0,
                           gossip_mode="push-pull")
        orgs = torch.as_tensor(top[:O_KERNEL], device=dev)
        state = init_state(rng.prng_key(7, dev), tables, orgs, prm)
        state, _ = run_rounds(prm, tables, orgs, state, 19)
        out["profile"] = profile_rounds(
            lambda p, t, o_, st, r: run_rounds(p, t, o_, st, r, start_it=19),
            prm, tables, orgs, state, out_dir, tag=" push-pull", phase="(h)")
        print(json.dumps(out), flush=True)
        return 0
    top = np.argsort(-stakes_np, kind="stable")[:O_RANKS].astype(np.int32)
    origins = torch.as_tensor(top, device=dev)
    out = {}
    for s_, f_ in WIDE_SHAPES:
        prm = EngineParams(num_nodes=N_FULL, warm_up_rounds=0,
                           active_set_size=s_, push_fanout=f_)
        state = init_state(rng.prng_key(42, dev), tables, origins, prm)
        state, _ = run_rounds(prm, tables, origins, state, 19)
        tag = f" S={s_} F={f_}"
        dev_ms = profile_rounds(
            lambda p, t, o, st, r: run_rounds(p, t, o, st, r, start_it=19),
            prm, tables, origins, state, out_dir, tag=tag,
            phase="(g)")["device"]
        dev_ms["threefry"] = profile_rounds(
            lambda p, t, o, _st, _r: init_state(rng.prng_key(42, dev), t, o,
                                                p),
            prm, tables, origins, None, out_dir, rounds=1,
            tag=tag + " init_state", phase="(g)")["device"]["threefry"]
        out[f"S={s_} F={f_}"] = dev_ms
    print(json.dumps(out), flush=True)
    return 0


#: the push round's shapes (N, O) at which ``--profile-sparse`` takes
#: rc_merge_prune and bfs_relax on rounds 19 and 20; the round profiles are
#: taken at those with O > 1
SPARSE_SHAPES = ((N_FULL, 1), (N_FULL, O_KERNEL), (N_FULL, O_PULL),
                 (N_HUGE, O_HUGE))


def sparse_child(tree: Path) -> int:
    """``chip_smoke.py --profile-sparse [TREE]``, started by phase (j): on
    the inputs of rounds 19 (the first whose upsert counters fire) and 20
    of the push round at each of ``SPARSE_SHAPES`` (the highest-stake
    origins), ``rc_merge_prune`` in both layouts and ``bfs_relax``;
    ``rc_merge_prune``'s traffic form (live mask) on rounds 19 and 20 of
    (i)'s uncapped M=256 run (no value row fires in either); ``bfs_relax``
    on rounds 19 and 20 of (k)'s 8 lanes x 4 origins (lanes of unequal hop
    counts); and ``rc_merge_prune`` at O=32 (both layouts) and in the
    traffic form on round 20's inputs with the upsert counters set to 18,
    19 and 20 across rows (fired and unfired rows in one call).  First
    every call's device ms under the profiler, ``bfs_relax``'s latency
    floor at the call's geometry and hop count
    (``kernels.bfs_relax._latency_floor``; where TREE is this checkout:
    the floor is of this design's geometry) and the 5-round profiles of
    both layouts from round 19 at the shapes with O > 1; then each call
    held against its plain version (max abs err), timed with CUDA events,
    its bytes counted (inputs once, outputs once) and its hops or fired
    rows.  The package comes from TREE (default: this checkout), so that
    ``round_turns.py --merge-bfs`` can compare a parent and a change in
    turns.  Prints a JSON line, last: {"profiles": {"N=n O=o layout":
    ...}, "cases": {...}}."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    sys.path.insert(0, str(tree.resolve()))
    import numpy as np
    from gossip_sim_tpu_torch import cli, engine, kernels, rng
    from gossip_sim_tpu_torch.engine import EngineParams
    from gossip_sim_tpu_torch.engine.traffic import (device_traffic_tables,
                                                     traffic_round_step)
    from gossip_sim_tpu_torch.identity import NodeIndex
    dev = torch.device("cuda")
    kernels.build_all()
    bfs_mod = importlib.import_module("gossip_sim_tpu_torch.kernels.bfs_relax")
    floor = (bfs_mod._latency_floor if tree.resolve() == ROOT.resolve()
             else None)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    names = ("rc_merge_prune", "bfs_relax")
    real = {n: getattr(kernels, n) for n in names}
    plain = {n: getattr(kernels, f"{n}_plain") for n in names}
    cases = []     # (key, kernel, profiler symbol key, (args, kw))
    profiled = []  # (key, params, tables, origins, state after round 19)
    for n in (N_FULL, N_HUGE):
        accounts, _ = cli.load_cluster_accounts(
            cli.Config(num_synthetic_nodes=n))
        stakes_np = NodeIndex.from_stakes(accounts).stakes.astype(np.int64)
        tables = engine.make_cluster_tables(stakes_np, device=dev)
        top = np.argsort(-stakes_np, kind="stable").astype(np.int32)
        for o in (o for n_, o in SPARSE_SHAPES if n_ == n):
            orgs = torch.as_tensor(top[:o], device=dev)
            for rep in ("dense", "sparse"):
                prm = EngineParams(num_nodes=n, warm_up_rounds=0,
                                   representation=rep)
                st = engine.init_state(rng.prng_key(42, dev), tables, orgs,
                                       prm)
                st, _ = engine.run_rounds(prm, tables, orgs, st, 19)
                _, calls = record_calls(kernels, names, engine.run_rounds,
                                        prm, tables, orgs, st, 2, 19)
                if o > 1:
                    profiled.append((f"N={n} O={o} {rep}", prm, tables, orgs,
                                     st))
                del st
                for r in (0, 1):
                    cases.append((f"rc_merge_prune {rep} N={n} O={o} "
                                  f"round {19 + r}", "rc_merge_prune",
                                  SPARSE if rep == "sparse"
                                  else "rc_merge_prune",
                                  calls["rc_merge_prune"][r]))
                    if rep == "dense":  # the layouts' targets are equal
                        cases.append((f"bfs_relax N={n} O={o} round "
                                      f"{19 + r}", "bfs_relax", "bfs_relax",
                                      calls["bfs_relax"][r]))
                del calls
        if n == N_FULL:
            # the traffic form: (i)'s uncapped M=256 run, rounds 19 and 20
            ttables = device_traffic_tables(stakes_np, dev)
            prm = traffic_params(EngineParams, "uncapped")
            st, _, c19 = traffic_round19(kernels, prm, tables, ttables,
                                         stakes_np, dev)
            _, c20 = record_calls(kernels, ["rc_merge_prune"],
                                  traffic_round_step, prm, tables, ttables,
                                  st, 20)
            c20 = one_run_calls(c20, prm.traffic_values)
            del st
            for r, c in ((19, c19), (20, c20)):
                cases.append((f"rc_merge_prune traffic M={M_TRAFFIC} round "
                              f"{r}", "rc_merge_prune", "rc_merge_prune",
                              c["rc_merge_prune"][0]))
            del c19, c20, ttables
            # (k)'s lanes: 8 lanes x 4 origins, rounds 19 and 20
            plist = lane_params(EngineParams)
            static = engine.merge_lane_statics([p.static_part()
                                                for p in plist])
            kstack = engine.stack_knobs([p.knob_values() for p in plist])
            lorgs = torch.as_tensor(top[:LANE_O], device=dev)
            st = engine.broadcast_state(engine.init_state(
                rng.prng_key(42, dev), tables, lorgs, plist[0]), LANE_K)
            st, _ = engine.run_rounds_lanes(static, tables, lorgs, st,
                                            kstack, 19)
            _, calls = record_calls(kernels, ["bfs_relax"],
                                    engine.run_rounds_lanes, static, tables,
                                    lorgs, st, kstack, 2, 19)
            del st
            for r in (0, 1):
                cases.append((f"bfs_relax lanes K={LANE_K} x O={LANE_O} "
                              f"N={n} round {19 + r}", "bfs_relax",
                              "bfs_relax", calls["bfs_relax"][r]))
            del calls
        del tables
    # round 20's inputs with the upsert counters set to 18, 19 and 20
    # across rows (seeded): about two rows in three fire, the rest do not
    gen = torch.Generator(device=dev).manual_seed(20)
    for key, name, sym, (a, kw) in list(cases):
        if name == "rc_merge_prune" and key.endswith("round 20") and (
                "traffic" in key or f"N={N_FULL} O={O_KERNEL} " in key):
            ups = torch.tensor([18, 19, 20], dtype=torch.int32, device=dev)[
                torch.randint(0, 3, a[4].shape, generator=gen, device=dev)]
            cases.append((key + ", counters 18-20", name, sym,
                          (a[:4] + (ups,) + a[5:], kw)))
    torch.cuda.synchronize()
    # the profiler sessions back to back
    out = {"profiles": {}, "cases": {key: {} for key, *_ in cases}}
    for key, name, sym, (a, kw) in cases:
        d = out["cases"][key]
        d["device_ms"] = device_ms(lambda: real[name](*a, **kw),
                                   KERNEL_SYMBOLS[sym], reps=10)
        if name == "bfs_relax" and floor is not None:
            reached, dist = real[name](*a, **kw)
            d["hops"] = int(dist[reached].max())
            d["floor_ms"] = device_ms(lambda: floor(a[0], a[1], d["hops"]),
                                      KERNEL_SYMBOLS[sym], reps=10)
            del reached, dist
    for key, prm, tables, orgs, st in profiled:
        prof = profile_rounds(
            lambda p, t, o_, s_, r: engine.run_rounds(p, t, o_, s_, r,
                                                      start_it=19),
            prm, tables, orgs, st, out_dir,
            tag=(" " if floor is not None else
                 " turns " + re.sub(r"\W", "_", str(tree)) + " ")
            + key.replace("=", ""), phase="(j)")
        which = SPARSE if "sparse" in key else "rc_merge_prune"
        n_o, rep = key.rsplit(" ", 1)
        out["profiles"][key] = {
            "device_ms": out["cases"][
                f"rc_merge_prune {rep} {n_o} round 19"]["device_ms"],
            **{k: prof.get(k) for k in ("busy_ms", "wall_ms", "launches")},
            "kernel_ms_per_round": prof["device"].get(which)}
    del profiled
    torch.cuda.empty_cache()
    # exactness, CUDA-event times, bytes, hops and fired rows
    for key, name, _, (a, kw) in cases:
        got = real[name](*a, **kw)
        d = out["cases"][key]
        d.update(max_abs_err=max_abs_err(got, plain[name](*a, **kw)),
                 bytes=nbytes(*a, *got, kw.get("live")),
                 ms=cuda_ms(lambda: real[name](*a, **kw)))
        if name == "bfs_relax":
            reached, dist = got
            d["hops"] = int(dist[reached].max())
            d["rows"] = int(reached.shape[0])
            d["row_hops"] = [int(dist[i][reached[i]].max())
                             for i in range(reached.shape[0])]
        else:
            n_ = a[0].shape[1]
            ups = a[4] + (a[5][..., 0] < n_).to(torch.int32)
            fired = ups >= kw["min_num_upserts"]
            if kw.get("live") is not None:
                fired &= kw["live"][:, None]
            d["fired_rows"] = int(fired.sum())
            d["rows"] = int(fired.numel())
        del got
        torch.cuda.empty_cache()
    print(json.dumps({"tree": str(tree), "device": torch.cuda.get_device_name(
        0), **out}), flush=True)
    return 0


RESUME_FLAG = "--resume-phase"
#: ``--resume-phase traffic``: phase (m)'s traffic case alone
TRAFFIC_PART = "traffic"
#: phase (m)'s sweeps and cross-device run: N=2,000
N_RESUME = 2000


def traffic_child_argv(device: str) -> list:
    """The command of phase (m)'s traffic case, a process of its own."""
    return [sys.executable, str(ROOT / "chip_smoke.py"), RESUME_FLAG,
            TRAFFIC_PART] + ([] if device == "cuda" else [device])


def resume_child(device: str = "cuda", part: str = "main") -> int:
    """``chip_smoke.py --resume-phase``, started by phase (m): checkpoints,
    the run journal, ``--resume`` and the device supervisor, through
    ``cli.main`` in this process (the kill hook sends SIGTERM to it), each
    case against its uninterrupted run at tolerance 0.  Prints its findings
    as ``chip_smoke: (m) ...`` lines and, last, one ``RESUME {json}``
    line.  Deterministic Influx lines are caught by a capture server on
    127.0.0.1 as in phase (g); their ``start_time`` tag, the run's start
    time, is masked (a resumed run replays its committed units' lines with
    the interrupted run's).  ``device`` is where the runs go (``cpu``
    only to rehearse the control flow at a small size).

    ``part`` ``"traffic"`` runs case (3) alone (``--resume-phase
    traffic``): the main part starts it as a process of its own once the
    timed all-origins turns are done, so that its two M=256 saves (one
    host core's deflate each, ~30 s) overlap the cases after them, and
    waits for it before it reports."""
    import logging

    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    logging.basicConfig(level=logging.WARNING)
    from gossip_sim_tpu_torch import checkpoint, cli, resilience
    from gossip_sim_tpu_torch.engine import (EngineParams, init_state,
                                             make_cluster_tables, run_rounds)
    from gossip_sim_tpu_torch.identity import reset_unique_pubkeys
    from gossip_sim_tpu_torch.rng import prng_key
    from gossip_sim_tpu_torch.sinks import deterministic_wire_lines

    # the cases' files (a traffic state at M=256 is ~2.7 GB of arrays) go
    # to the git-ignored build/ and are removed at the end
    out = ROOT / "build" / ("resume" if part == "main"
                            else f"resume_{part}")
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    p = lambda name: str(out / name)
    res = {"saves": [], "restores": [], "commits": {}}
    dev = torch.device(device)
    other = "cpu" if dev.type == "cuda" else device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # timing wrappers: every save and restore of the package, every commit
    real_save, real_rs = checkpoint.save_state, checkpoint.restore_sim_state
    real_rt, real_commit = (checkpoint.restore_traffic_state,
                            resilience.RunJournal.commit)

    def save_state(path, state, *a, **kw):
        t0 = time.perf_counter()
        real_save(path, state, *a, **kw)
        res["saves"].append({
            "kind": kw.get("kind", "sim"), "s": time.perf_counter() - t0,
            "shape": list(state.active.shape),
            "bytes": os.path.getsize(path), "raw_bytes": sum(
                t.numel() * t.element_size() for t in state)})
    checkpoint.save_state = save_state

    def timed_restore(real):
        def restore(path, *a, **kw):
            t0 = time.perf_counter()
            got = real(path, *a, **kw)
            sync()
            res["restores"].append({"s": time.perf_counter() - t0,
                                    "bytes": os.path.getsize(path)})
            return got
        return restore
    checkpoint.restore_sim_state = timed_restore(real_rs)
    checkpoint.restore_traffic_state = timed_restore(real_rt)

    def commit(self, unit, payload):
        t0 = time.perf_counter()
        real_commit(self, unit, payload)
        res["commits"].setdefault(self.run_key["kind"], []).append(
            time.perf_counter() - t0)
    resilience.RunJournal.commit = commit

    # what the entry points saw: all-origins' summary (on origins 0-199),
    # a sweep's collection, a traffic run's report and final state
    seen = {}
    real_ao, real_ds = cli.run_all_origins, cli.dispatch_sweeps
    real_tr, real_final = cli.run_traffic, cli._traffic_final_from_state
    origin_idx = {"idx": np.arange(AO_ORIGINS, dtype=np.int32)}

    def run_all_origins(config, *a, **kw):
        kw.setdefault("origin_indices", origin_idx["idx"])
        seen["ao"] = real_ao(config, *a, **kw)
        return seen["ao"]

    def dispatch_sweeps(config, url, ranks, collection, *a, **kw):
        seen["coll"] = collection
        return real_ds(config, url, ranks, collection, *a, **kw)

    def run_traffic(*a, **kw):
        seen["traffic"] = real_tr(*a, **kw)
        return seen["traffic"]

    def traffic_final(state):
        seen["traffic_state"] = state
        return real_final(state)
    cli.run_all_origins, cli.dispatch_sweeps = run_all_origins, \
        dispatch_sweeps
    cli.run_traffic, cli._traffic_final_from_state = run_traffic, \
        traffic_final

    received = []

    class Capture(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            received.append(self.rfile.read(
                int(self.headers.get("Content-Length", 0))).decode())
            self.send_response(204)
            self.end_headers()

        def log_message(self, *a):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Capture)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    cli.get_influx_url = lambda moniker: url
    os.environ.update(GOSSIP_SIM_INFLUX_USERNAME="u",
                      GOSSIP_SIM_INFLUX_PASSWORD="p",
                      GOSSIP_SIM_INFLUX_DATABASE="gossip")

    def run(argv, kill_after=0, hook=None, influx=False, want_rc=0):
        """``cli.main`` on the card with the pubkey counter reset: (wall,
        the deterministic Influx lines caught)."""
        reset_unique_pubkeys()
        received.clear()
        seen.pop("ao", None)
        if kill_after:
            os.environ[resilience.KILL_AFTER_ENV] = str(kill_after)
        resilience.set_fault_hook(hook)
        try:
            t0 = time.perf_counter()
            rc = cli.main(argv + ["--device", device]
                          + (["--influx", "l"] if influx else []))
            sync()
            wall = time.perf_counter() - t0
        finally:
            os.environ.pop(resilience.KILL_AFTER_ENV, None)
            resilience.set_fault_hook(None)
        if rc != want_rc:
            fail(f"(m) cli.main {' '.join(argv)}: exit {rc}, not {want_rc}")
        lines = deterministic_wire_lines(
            [ln for body in received for ln in body.splitlines()])
        return wall, [re.sub(r"start_time=\d+", "start_time=T", ln)
                      for ln in lines]

    def same_npz(a, b, what):
        with np.load(a) as za, np.load(b) as zb:
            if set(za.files) != set(zb.files):
                fail(f"(m) {what}: arrays {sorted(za.files)} vs "
                     f"{sorted(zb.files)}")
            diff = [k for k in za.files if k != "__meta__"
                    and not np.array_equal(za[k], zb[k])]
            metas = [json.loads(bytes(z["__meta__"]).decode())
                     for z in (za, zb)]
        if diff:
            fail(f"(m) {what}: arrays differ: {diff}")
        if metas[0]["iteration"] != metas[1]["iteration"]:
            fail(f"(m) {what}: iterations {metas[0]['iteration']} and "
                 f"{metas[1]['iteration']}")
        return metas[1]

    def units(path):
        with open(resilience.journal_path(path)) as f:
            return [json.loads(ln)["unit"] for ln in f.read().splitlines()[1:]]

    if part == TRAFFIC_PART:
        # (3) traffic at N=10,000, M=256, rate 16: 150 rounds, then resumed
        tr = ["--num-synthetic-nodes", str(N_FULL), "--traffic-values",
              str(M_TRAFFIC), "--traffic-rate", str(TRAFFIC_RATE),
              "--warm-up-rounds", "200"]
        w_t0, _ = run(tr + ["--iterations", "300"])
        want_tr = seen["traffic"]["traffic"]
        want_state = seen["traffic_state"]
        w_t1, _ = run(tr + ["--iterations", "150", "--checkpoint-path",
                            p("traffic.npz")])
        w_t2, _ = run(tr + ["--iterations", "300", "--resume",
                            p("traffic.npz")])
        got_state = seen["traffic_state"]
        diff = [f for f in want_state._fields if not torch.equal(
            getattr(want_state, f), getattr(got_state, f))]
        if diff or seen["traffic"]["traffic"] != want_tr:
            fail(f"(m) traffic resumed: state differs in {diff}, or summary "
                 f"{seen['traffic']['traffic']} != {want_tr}")
        del want_state, got_state
        seen.pop("traffic_state")
        t_saves = [v for v in res["saves"] if v["kind"] == "traffic"]
        res["traffic"] = {"straight_s": w_t0, "first_150_s": w_t1,
                          "resume_s": w_t2, "saves": t_saves,
                          "restore": res["restores"][-1]}
        say(f"(m) traffic N={N_FULL} M={M_TRAFFIC} rate {TRAFFIC_RATE}: "
            f"300 straight {w_t0:.3f} s; 150 then --resume to 300: "
            f"{w_t1:.3f} + {w_t2:.3f} s; TRAFFIC SUMMARY and every "
            f"TrafficState field equal; save_state of the traffic state "
            f"({t_saves[0]['raw_bytes']} bytes of arrays, file "
            f"{t_saves[0]['bytes']} bytes): "
            + " / ".join(f"{v['s']:.3f}" for v in t_saves)
            + f" s; restore_traffic_state {res['restores'][-1]['s']:.3f} s")
        server.shutdown()
        server.server_close()
        shutil.rmtree(out, ignore_errors=True)
        print("RESUME " + json.dumps({"traffic": res["traffic"]}),
              flush=True)
        return 0

    # (1) single origin: 300 straight against 200 resumed to 300 at
    # N=10,000 dense, 20 against 10 resumed to 20 at N=100,000 sparse,
    # and a sparse file resumed dense
    walls = {}
    for tag, n, layout, (warm, total) in (
            ("N=10,000 dense", N_FULL, [], (200, 300)),
            ("N=100,000 sparse", N_HUGE,
             ["--engine-representation", "sparse"], (10, 20))):
        base = ["--num-synthetic-nodes", str(n), "--warm-up-rounds",
                str(warm), "--checkpoint-every-s", "3600"] + layout
        key = tag.split()[0]
        straight, part = p(f"straight_{key}.npz"), p(f"part_{key}.npz")
        w0, _ = run(base + ["--iterations", str(total), "--checkpoint-path",
                            straight])
        w1, _ = run(base + ["--iterations", str(warm), "--checkpoint-path",
                            part])
        w2, _ = run(base + ["--iterations", str(total), "--resume", part,
                            "--checkpoint-path", part])
        meta = same_npz(straight, part, f"single origin {tag}")
        if meta["repr"]["representation"] != (
                "sparse" if layout else "dense"):
            fail(f"(m) single origin {tag}: meta {meta['iteration']} "
                 f"{meta['repr']}")
        walls[tag] = {"iterations": total, "straight_s": w0,
                      "first_part_s": w1, "resume_s": w2}
        say(f"(m) single origin {tag}, rank 1: {total} straight {w0:.3f} "
            f"s; {warm} then --resume to {total}: {w1:.3f} + {w2:.3f} s; "
            f"every array of the two final .npz files equal")
    sparse_part = p("sparse_10k_200.npz")
    run(["--num-synthetic-nodes", str(N_FULL), "--warm-up-rounds", "200",
         "--checkpoint-every-s", "3600", "--engine-representation",
         "sparse", "--iterations", "200", "--checkpoint-path", sparse_part])
    run(["--num-synthetic-nodes", str(N_FULL), "--warm-up-rounds", "200",
         "--checkpoint-every-s", "3600", "--iterations", "300", "--resume",
         sparse_part, "--checkpoint-path", p("sparse_to_dense.npz")])
    same_npz(p("straight_N=10,000.npz"), p("sparse_to_dense.npz"),
             "a sparse file resumed dense")
    say("(m) a sparse-written file (N=10,000, 200 iterations) resumed dense "
        "to 300: every array equal to the dense straight run's")
    res["single"] = walls

    # (2) all-origins on origins 0-199 of N=10,000 at the auto batch 64;
    # (6) the supervisor on the same run
    ao = ["--num-synthetic-nodes", str(N_FULL), "--iterations", "300",
          "--warm-up-rounds", "200", "--all-origins"]

    def same_aggregate(want, got, what):
        a, b = want["stats"].state_dict(), got["stats"].state_dict()
        diff = [k for k in a if k not in b or not np.array_equal(
            np.asarray(a[k]), np.asarray(b[k]))]
        keys = ("coverage_mean", "rmr_mean", "measured_points",
                "padded_sims", "hop_clamped", "num_origins")
        if diff or any(want[k] != got[k] for k in keys):
            fail(f"(m) {what}: the aggregate differs in {diff} "
                 f"{[(k, want[k], got[k]) for k in keys]}")

    w_ao, _ = run(ao)
    want_ao = seen["ao"]
    ck = p("ao.npz")
    w_kill, _ = run(ao + ["--checkpoint-path", ck], kill_after=2,
                    want_rc=75)
    if units(ck) != [0, 1]:
        fail(f"(m) all-origins killed after 2 commits: units {units(ck)}")
    w_res, _ = run(ao + ["--checkpoint-path", ck, "--resume", ck])
    same_aggregate(want_ao, seen["ao"], "all-origins resumed")
    say(f"(m) all-origins origins 0-{AO_ORIGINS - 1} of N={N_FULL}, batch "
        f"{O_BATCH}: straight {w_ao:.3f} s; SIGTERM after 2 committed "
        f"batches: exit 75 in {w_kill:.3f} s, journal units [0, 1]; "
        f"--resume {w_res:.3f} s: the ALL-ORIGINS aggregate equal")
    res["all_origins"] = {"straight_s": w_ao, "killed_s": w_kill,
                          "resume_s": w_res}

    def fail_first_of_unit_1(label, attempt):
        if label == "origin-batch-1" and attempt == 0:
            raise RuntimeError("injected device failure")

    resilience.reset_counts()
    run(ao, hook=fail_first_of_unit_1)
    failures = resilience.COUNTS["resilience/device_failures"]
    same_aggregate(want_ao, seen["ao"], "all-origins with a retried unit")

    def dead_after_unit_0(label, attempt):
        if label != "origin-batch-0":
            raise RuntimeError("injected dead device")

    ck2 = p("ao_abort.npz")
    run(ao + ["--on-device-failure", "abort", "--device-retries", "1",
              "--checkpoint-path", ck2], hook=dead_after_unit_0, want_rc=75)
    if units(ck2) != [0]:
        fail(f"(m) abort: journal units {units(ck2)}, not [0]")
    run(ao + ["--checkpoint-path", ck2, "--resume", ck2])
    same_aggregate(want_ao, seen["ao"], "all-origins aborted and resumed")
    say(f"(m) supervisor: a failed first attempt of unit 1 retried "
        f"({failures} device failure counted), aggregate equal; "
        f"--on-device-failure abort with every later attempt failing: "
        f"exit 75 with unit 0 committed, --resume: aggregate equal")
    turns = []
    for sup in (False, True):
        run(ao + (["--device-timeout-s", "60"] if sup else []))
        same_aggregate(want_ao, seen["ao"], "all-origins supervised")
        s = seen["ao"]
        turns.append({"supervised": sup, "elapsed_s": s["elapsed_s"],
                      "origin_rounds_s": AO_ORIGINS * 300 / s["elapsed_s"],
                      "rounds_s": sum(b["rounds_s"] for b in s["batches"])})
    res["supervised_turns"] = turns
    say(f"(m) all-origins batch {O_BATCH} in turns, unsupervised / "
        f"--device-timeout-s 60 (each batch a unit on a worker thread, one "
        f"batch in flight): " + ", ".join(
            f"{'supervised' if t['supervised'] else 'plain'} "
            f"{t['origin_rounds_s']:.1f} origin-rounds/s "
            f"({t['elapsed_s']:.3f} s)" for t in turns))
    # a unit never leaves the card after its kernels fail: the start-up
    # checks refuse cpu-fallback there, before any engine work or journal
    ck3 = p("ao_fallback.npz")
    run(ao + ["--on-device-failure", "cpu-fallback", "--checkpoint-path",
              ck3], want_rc=1)
    if "ao" in seen or os.path.exists(resilience.journal_path(ck3)):
        fail("(m) --on-device-failure cpu-fallback on the card: the run "
             "started")
    say("(m) --on-device-failure cpu-fallback on the card: refused at "
        "start-up (exit 1, no journal, no unit run)")

    # (3) traffic, in a process of its own (the TRAFFIC_PART branch above),
    # started after the timed turns; its output goes to files, read before
    # the report, and atexit stops it if this process fails first
    with (out / "traffic.out").open("w") as t_out, \
            (out / "traffic.err").open("w") as t_err:
        traffic = subprocess.Popen(traffic_child_argv(device), stdout=t_out,
                                   stderr=t_err, text=True, cwd=ROOT)
    atexit.register(stop_process, traffic)

    # (4) sweeps at N=2,000, snapshots and Influx lines.  The origin-rank
    # sweep's Influx sender paces itself at 0.1 s a point (the reference's
    # reporter loop until a lone start sentinel, which this sweep folds
    # into its test-type point), so it measures 2 rounds, in blocks of 1
    sw = ["--num-synthetic-nodes", str(N_RESUME), "--iterations", "60",
          "--warm-up-rounds", "30"]
    ranks = [str(r) for r in range(1, O_RANKS + 1)]
    sweeps = {
        "active-set serial (S 12, 16)": ["--test-type", "active-set-size",
                                         "--num-simulations", "2",
                                         "--step-size", "4"],
        "packet-loss, 8 points, --sweep-lanes 4": [
            "--test-type", "packet-loss", "--num-simulations", "8",
            "--step-size", "0.05", "--sweep-lanes", "4"],
        f"origin-rank 1-{O_RANKS}, 2 measured rounds in blocks of 1": [
            "--test-type", "origin-rank", "--num-simulations",
            str(O_RANKS), "--origin-rank", *ranks, "--iterations", "32"],
    }
    real_block = cli.HARVEST_BLOCK
    for i, (tag, extra) in enumerate(sweeps.items()):
        cli.HARVEST_BLOCK = 1 if "origin-rank" in tag else real_block
        try:
            w0, want_lines = run(sw + extra, influx=True)
            want_snaps = [snapshot_strings(s.parity_snapshot())
                          for s in seen["coll"].collection]
            ck = p(f"sweep{i}.npz")
            run(sw + extra + ["--checkpoint-path", ck], kill_after=1,
                influx=True, want_rc=75)
            w2, got_lines = run(sw + extra + ["--checkpoint-path", ck,
                                              "--resume", ck], influx=True)
        finally:
            cli.HARVEST_BLOCK = real_block
        got_snaps = [snapshot_strings(s.parity_snapshot())
                     for s in seen["coll"].collection]
        if got_snaps != want_snaps or got_lines != want_lines \
                or not want_lines:
            fail(f"(m) {tag}: the resumed sweep differs from the straight "
                 f"one ({len(got_snaps)} vs {len(want_snaps)} sims, "
                 f"{len(got_lines)} vs {len(want_lines)} lines)")
        say(f"(m) sweep {tag} at N={N_RESUME}: stopped after unit 0 "
            f"(exit 75), --resume in {w2:.3f} s (straight {w0:.3f} s): "
            f"{len(want_snaps)} parity snapshots and {len(want_lines)} "
            f"deterministic Influx lines (capture server) equal")
    env = dict(os.environ, **{resilience.KILL_AFTER_ENV: "1"})
    argv = ([sys.executable, "-m", "gossip_sim_tpu_torch"] + sw
            + sweeps["active-set serial (S 12, 16)"]
            + ["--checkpoint-path", p("process.npz"), "--device", device])
    rcs = [subprocess.run(argv, env=env, capture_output=True, text=True,
                          timeout=300, cwd=ROOT).returncode]
    env.pop(resilience.KILL_AFTER_ENV)
    rcs.append(subprocess.run(argv + ["--resume", p("process.npz")],
                              env=env, capture_output=True, text=True,
                              timeout=300, cwd=ROOT).returncode)
    if rcs != [75, 0] or units(p("process.npz")) != [0, 1]:
        fail(f"(m) python -m gossip_sim_tpu_torch killed then resumed: "
             f"exit codes {rcs}, units {units(p('process.npz'))}")
    say("(m) python -m gossip_sim_tpu_torch (the active-set sweep) SIGTERM "
        "after unit 0: process exit 75; --resume: exit 0, units [0, 1]")

    # (5) across devices: a card file continued on the CPU, the reference
    # package's fixtures on both
    x = ["--num-synthetic-nodes", str(N_RESUME), "--warm-up-rounds", "20",
         "--packet-loss-rate", "0.1", "--churn-fail-rate", "0.01",
         "--churn-recover-rate", "0.2", "--checkpoint-every-s", "3600"]
    run(x + ["--iterations", "40", "--checkpoint-path", p("card40.npz")])
    run(x + ["--iterations", "60", "--resume", p("card40.npz"),
             "--checkpoint-path", p("card60.npz")])
    reset_unique_pubkeys()
    if cli.main(x + ["--iterations", "60", "--resume", p("card40.npz"),
                     "--checkpoint-path", p("cpu60.npz"), "--device",
                     other]) != 0:
        fail("(m) the CPU continuation failed")
    same_npz(p("card60.npz"), p("cpu60.npz"), "card file continued on cpu")
    say(f"(m) a card-written file (N={N_RESUME}, 40 iterations, loss + "
        f"churn) continued 20 rounds with --device cpu: every array equal "
        f"to the card's continuation")
    fixtures = sorted((ROOT / "tests" / "fixtures" / "checkpoints").glob(
        "v*.npz"))
    if [f.name for f in fixtures] != [f"v{v}.npz" for v in range(1, 9)]:
        fail(f"(m) the reference's fixtures v1-v8 are not all there: "
             f"{[f.name for f in fixtures]}")
    prm = EngineParams(num_nodes=16, warm_up_rounds=0)
    for f in fixtures:
        with np.load(f) as z:
            stakes = z["fixture.stakes"].astype(np.int64)
        runs = {}
        for d in (device, other):
            tables = make_cluster_tables(stakes, device=d)
            st, _, meta = checkpoint.restore_sim_state(str(f), prm, tables,
                                                       device=d)
            st, rows = run_rounds(prm, tables, torch.zeros(
                1, dtype=torch.int32, device=d), st, 10,
                start_it=int(meta.get("iteration", 3)), detail=True)
            runs[d] = [t.cpu() for t in st] + [
                rows[k].cpu() for k in sorted(rows)]
        if not all(torch.equal(a, b) for a, b in zip(runs[device],
                                                      runs[other])):
            fail(f"(m) fixture {f.name}: cuda != cpu after 10 rounds")
    say("(m) the reference's fixtures v1-v8 restored on cuda and on cpu "
        "with tables from fixture.stakes, 10 rounds each: every field and "
        "row equal")

    # (7) walls and sizes of save_state and restore_sim_state: the O=1
    # files of (1), and the origin-rank block's state, O=16 of N=10,000
    res["saves"].clear()
    res["restores"].clear()
    reset_unique_pubkeys()
    accts, _ = cli.load_cluster_accounts(cli.config_from_args(
        cli.build_parser().parse_args(["--num-synthetic-nodes",
                                       str(N_FULL)])))
    from gossip_sim_tpu_torch.identity import NodeIndex
    prm10 = EngineParams(num_nodes=N_FULL)
    tables = make_cluster_tables(
        NodeIndex.from_stakes(accts).stakes.astype(np.int64), device=dev)
    orgs = torch.arange(O_RANKS, dtype=torch.int32, device=dev)
    st, _ = run_rounds(prm10, tables, orgs, init_state(
        prng_key(42, dev), tables, orgs, prm10), 30)
    checkpoint.save_state(p("o16.npz"), st, prm10, iteration=30)
    del st, tables
    sizes = {}
    for tag, path, prm_ in (
            ("O=1 N=10,000", p("straight_N=10,000.npz"), prm10),
            (f"O={O_RANKS} N=10,000", p("o16.npz"), prm10),
            ("O=1 N=100,000 sparse", p("straight_N=100,000.npz"),
             EngineParams(num_nodes=N_HUGE, representation="sparse"))):
        res["saves"].clear()
        res["restores"].clear()
        for _ in range(2):
            st, _, meta = checkpoint.restore_sim_state(path, prm_,
                                                       device=dev)
            checkpoint.save_state(p("walls.npz"), st, prm_,
                                  iteration=meta["iteration"])
            del st
        s_ = sizes[tag] = {
            "save_s": [v["s"] for v in res["saves"]],
            "restore_s": [v["s"] for v in res["restores"]],
            "file_bytes": res["saves"][-1]["bytes"],
            "state_bytes": res["saves"][-1]["raw_bytes"]}
        say(f"(m) {tag}: save_state {s_['save_s'][0]:.3f} / "
            f"{s_['save_s'][1]:.3f} s, restore_sim_state (to {device}) "
            f"{s_['restore_s'][0]:.3f} / {s_['restore_s'][1]:.3f} s; state "
            f"{s_['state_bytes']} bytes, file {s_['file_bytes']} bytes "
            f"(np.savez_compressed)")
    res["walls"] = sizes
    try:
        traffic.wait(timeout=900)
    except subprocess.TimeoutExpired:
        fail("(m) the traffic case's process did not end within 900 s")
    if traffic.returncode != 0:
        fail(f"(m) the traffic case's process failed (exit "
             f"{traffic.returncode}): "
             f"{(out / 'traffic.err').read_text()[-3000:]}")
    t_res = None
    for ln in (out / "traffic.out").read_text().splitlines():
        if ln.startswith("chip_smoke: (m)"):
            print(ln, flush=True)
        elif ln.startswith("RESUME "):
            t_res = json.loads(ln[len("RESUME "):])
    if t_res is None:
        fail("(m) the traffic case's process printed no result")
    res["traffic"] = t_res["traffic"]
    commits = {k: {"n": len(v), "mean_s": sum(v) / len(v), "max_s": max(v)}
               for k, v in res["commits"].items()}
    res["commits"] = commits
    say("(m) journal commit per unit (write + flush + fsync): " + ", ".join(
        f"{k} {v['n']} units, mean {v['mean_s'] * 1e3:.3f} ms, max "
        f"{v['max_s'] * 1e3:.3f} ms" for k, v in commits.items()))
    server.shutdown()
    server.server_close()
    shutil.rmtree(out, ignore_errors=True)
    res.pop("saves")
    res.pop("restores")
    print("RESUME " + json.dumps(res), flush=True)
    return 0


#: ``--health-phase``: phase (n)'s kernel checks and timings, in a process
#: whose first profiler sessions they are
HEALTH_FLAG = "--health-phase"
#: the node-health kernels (phase (n)), and what each replaces
HEALTH_SOURCES = {
    "health_round": ("gossip_sim_tpu/engine/core.py:1255",
                     "the p.health arm of round_step, core.py:1255-1283"),
    "health_round_traffic": ("gossip_sim_tpu/engine/traffic.py:857",
                             "the p.health arm of traffic_round_step, "
                             "traffic.py:857-895"),
    "health_digest": ("gossip_sim_tpu/obs/health.py:125",
                      "_device_digest_fn / digest_stack, health.py:125-146"),
}


def health_round_bytes(args, traffic: bool) -> int:
    """Bytes a ``health_round`` call must move on these inputs: the planes
    in and out, the delivery view (traffic: both [K, V, N] delivery planes
    and the birth rounds), ``n_pruned`` once, and of the firing rows (gated
    in) their ``pruned_slot`` bytes and ``src_sorted`` at the pruned slots."""
    import numpy as np
    import torch
    if traffic:
        planes, view = args[:4], args[4:7]
        n_pruned, src, slot, gates = args[8], args[9], args[10], args[11]
    else:
        planes, view = args[:2], args[5:6]
        n_pruned, src, slot, gates = args[2], args[3], args[4], args[7]
    g = torch.as_tensor(np.atleast_1d(np.asarray(gates)).astype(np.int32),
                        device=n_pruned.device)
    rows = n_pruned.shape[0]
    per = rows // g.numel()
    fire = (n_pruned > 0) & (g.repeat_interleave(per)[:, None] > 0)
    c = src.shape[-1]
    pairs = int((slot & fire[..., None]).sum())
    return (2 * nbytes(*planes) + nbytes(*view, n_pruned)
            + int(fire.sum()) * c + 4 * pairs)


def health_child() -> int:
    """``chip_smoke.py --health-phase``, started by phase (n): first the
    5-round profiles of the O=32 push round from round 19 without and with
    the health gate (launches and device busy per round; a count the
    profiler cut short is taken again, up to three times); then both forms
    of ``health_round`` and ``health_digest`` held against their plain
    versions (tolerance 0) and timed (CUDA events; device ms under the
    profiler, among this process's first sessions), beside
    their bytes bound and a PyTorch yardstick: the round form on round 19
    (rows fire) and 20 (none fires) at O=32 of N=10,000, dense and sparse,
    and on phase (k)'s 8 lanes x 4 origins; the traffic form on phase
    (i)'s M=256 round 19, the same round with the upsert counters set to
    18-20 (value rows fire), and its adaptive round from 39 with values in
    their pull phase; the round form again at O=41 of N=100,000 sparse
    (its counts in device memory) on the round of its first 20 where most
    rows fire and on round 19; the digest on the sim, all-origins (int64) and
    traffic stacks of those states, on N=100,000 (O=41 sparse, 20 rounds)
    and on a crafted stack of ties and int64-range values.  Prints
    ``chip_smoke: (n)`` lines and, last, one ``HEALTH {json}`` line."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from gossip_sim_tpu_torch import cli, engine, kernels
    from gossip_sim_tpu_torch.engine import EngineParams
    from gossip_sim_tpu_torch.engine.traffic import (device_traffic_tables,
                                                     init_traffic_state,
                                                     run_traffic_rounds,
                                                     traffic_round_step)
    from gossip_sim_tpu_torch.identity import NodeIndex
    dev = torch.device("cuda")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    accounts, _ = cli.load_cluster_accounts(
        cli.Config(num_synthetic_nodes=N_FULL))
    stakes_np = NodeIndex.from_stakes(accounts).stakes.astype(np.int64)
    tables = engine.make_cluster_tables(stakes_np, device=dev)
    top = np.argsort(-stakes_np, kind="stable").astype(np.int32)
    hd_mod = importlib.import_module(
        "gossip_sim_tpu_torch.kernels.health_digest")
    hr_mod = importlib.import_module(
        "gossip_sim_tpu_torch.kernels.health_round")
    res = {"round": {}, "traffic": {}, "digest": {}, "worst": {}}
    forms = {"round": ("health_round", "health_round_plain"),
             "traffic": ("health_round_traffic",
                         "health_round_traffic_plain")}

    def check_time(form, key, args):
        """One call of a form held against its plain version and timed."""
        name, plain_name = forms[form]
        fn, plain = getattr(kernels, name), getattr(kernels, plain_name)
        err = max_abs_err(fn(*args), plain(*args))
        res["worst"][name] = max(res["worst"].get(name, 0), err)
        if err:
            fail(f"(n) {name} {key}: differs from its plain version "
                 f"(max_abs_err {err})")
        traffic = form == "traffic"
        moved = health_round_bytes(args, traffic)
        n_pruned, src, slot = (args[8:11] if traffic else args[2:5])
        groups = args[0].shape[0]
        n = n_pruned.shape[1]
        seg = (torch.where(slot, src, n).long()
               + (torch.arange(slot.shape[0], device=dev)
                  // (slot.shape[0] // groups) * (n + 1))[:, None, None])
        seg = seg.reshape(-1)
        ones = slot.reshape(-1).to(torch.int32)
        scratch = torch.zeros(groups * (n + 1), dtype=torch.int32,
                              device=dev)
        r = {"ms": cuda_ms(lambda: fn(*args), reps=20),
             "device_ms": device_ms(lambda: fn(*args),
                                    KERNEL_SYMBOLS[name], reps=20),
             "plain_ms": cuda_ms(lambda: plain(*args), reps=3, warm=1),
             "library_ms": cuda_ms(lambda: scratch.index_add_(0, seg, ones),
                                   reps=20),
             "bytes": moved, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
             "bound_by": "bytes", "max_abs_err": err,
             "fired_rows": int((n_pruned > 0).sum()),
             "pairs": int(slot.sum())}
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        if traffic:
            k_, v_, n_ = args[4].shape
            r["geometry"] = {"blocks": hr_mod.traffic_grid(
                k_, v_, n_, sms, hr_mod.blocks_per_sm(dev))}
        else:
            r["geometry"] = hr_mod.round_geometry(
                n_pruned.shape[0], n, sms,
                torch.cuda.get_device_properties(
                    dev).shared_memory_per_block_optin)._asdict()
        res[form][key] = r
        say(f"(n) {name} {key}: exact; wrapper {r['ms']:.4f} ms, device "
            f"{r['device_ms'] if r['device_ms'] is None else round(r['device_ms'], 4)} ms, "
            f"bound {r['bound_ms']:.4f} ms ({moved} bytes), plain "
            f"{r['plain_ms']:.4f} ms, index_add_ of the pairs "
            f"{r['library_ms']:.4f} ms; {r['fired_rows']} firing rows, "
            f"{r['pairs']} pairs; launch {r['geometry']}")

    def rounds_calls(prm, orgs, upto=(19, 20)):
        """The engine's rounds 0-20 of ``prm`` at ``orgs``: the state after
        round 19 and the health_round calls of rounds ``upto``."""
        st = engine.init_state(engine_key(dev), tables, orgs, prm)
        st, _ = engine.run_rounds(prm, tables, orgs, st, 19)
        st19 = st
        _, calls = record_calls(kernels, ["health_round"], engine.run_rounds,
                                prm, tables, orgs, st, 2, 19)
        return st19, dict(zip(upto, calls["health_round"]))

    o32 = torch.as_tensor(top[:O_KERNEL], device=dev)
    base = EngineParams(num_nodes=N_FULL, warm_up_rounds=0, health=True)
    # first (this process's first profiler sessions): the O=32 push round
    # from round 19, without and with the gate; the profiler may drop an
    # event, never add one, so a count short of a whole number, or short
    # of the round's 117 launches (118 with the gate), is taken again, up
    # to three times, and the most is kept
    prof = {}
    for gate in (False, True):
        prm = base._replace(health=gate)
        st = engine.init_state(engine_key(dev), tables, o32, prm)
        st, _ = engine.run_rounds(prm, tables, o32, st, 19)
        runs_p = []
        while len(runs_p) < 3 and not any(
                float(r.get("launches") or 0).is_integer()
                and (r.get("launches") or 0) >= 117 + gate
                for r in runs_p):
            runs_p.append(profile_rounds(
                lambda p_, t_, o_, s_, n_: engine.run_rounds(
                    p_, t_, o_, s_, n_, start_it=19),
                prm, tables, o32, st, out_dir, rounds=5,
                tag=" health" if gate else " no health", phase="(n)"))
        prof[gate] = max(runs_p, key=lambda r: r.get("launches") or 0)
        prof[gate]["profiles"] = len(runs_p)
    res["round_profile"] = {
        ("health" if g else "no health"): {k: v.get(k) for k in (
            "launches", "busy_ms", "wall_ms", "profiles")}
        for g, v in prof.items()}
    st19 = None
    for rep in ("dense", "sparse"):
        prm = base._replace(representation=rep)
        st, calls = rounds_calls(prm, o32)
        if rep == "dense":
            st19 = st
        for it, (args, kw) in calls.items():
            check_time("round", f"O={O_KERNEL} {rep} round {it}", args)
    # (k)'s lanes, round 19
    plist = [p._replace(health=True) for p in lane_params(EngineParams)]
    lcalls = lane_round19(kernels, engine, plist, tables,
                          torch.as_tensor(top[:LANE_O], device=dev),
                          ["health_round"], dev)
    check_time("round", f"{LANE_K} lanes x {LANE_O} origins round 19",
               lcalls["health_round"][0][0])
    # the traffic form: (i)'s M=256 round 19, and its adaptive round from
    # 39 with values in their pull phase
    ttables = device_traffic_tables(stakes_np, dev)
    tprm = traffic_params(EngineParams, "uncapped")._replace(health=True)
    tst = init_traffic_state(stakes_np, tprm, 42, dev)
    tst, _ = run_traffic_rounds(tprm, tables, ttables, tst, 19)
    (tst, _), tcalls = record_calls(
        kernels, ["health_round_traffic", "rc_merge_prune"],
        traffic_round_step, tprm, tables, ttables, tst, 19)
    # the digest's traffic stack, then the state goes (the round's
    # rc_merge_prune inputs are the state before it: [K V, N, C] planes)
    t_stack = cli._health_stack(tst, traffic=True)
    del tst
    (h_args, _), = tcalls.pop("health_round_traffic")
    check_time("traffic", f"M={M_TRAFFIC} round 19", h_args)
    # the same round with its value rows firing: rc_merge_prune's inputs
    # again with the upsert counters set to 18, 19 and 20 across rows
    # (seeded; the threshold is 20), its prune decision into the call
    (m_args, m_kw), = tcalls.pop("rc_merge_prune")
    gen = torch.Generator(device=dev).manual_seed(20)
    ups = torch.tensor([18, 19, 20], dtype=torch.int32, device=dev)[
        torch.randint(0, 3, m_args[4].shape, generator=gen, device=dev)]
    mp = kernels.rc_merge_prune(*(m_args[:4] + (ups,) + m_args[5:]), **m_kw)
    h_args = h_args[:8] + (mp.n_pruned, mp.src_sorted,
                           mp.pruned_slot) + h_args[11:]
    del m_args, m_kw, ups, mp
    check_time("traffic", f"M={M_TRAFFIC} round 19, counters 18-20", h_args)
    del h_args
    aprm = adaptive_params(EngineParams, "uncapped")._replace(health=True)
    ast = init_traffic_state(stakes_np, aprm, 42, dev)
    ast, _ = run_traffic_rounds(aprm, tables, ttables, ast, 39)
    for it in range(39, 140):
        (nxt, rows), acalls = record_calls(
            kernels, ["health_round_traffic"], traffic_round_step, aprm,
            tables, ttables, ast, it)
        args = acalls["health_round_traffic"][0][0]
        if args[5] is not None and int(args[5].sum()) > 0:
            check_time("traffic", f"adaptive M={M_TRAFFIC} round {it} "
                       f"({int(rows['pull_active_values'])} values pulling)",
                       args)
            break
        ast = nxt
    else:
        fail("(n) adaptive traffic: no pull rescue delivered by round 139")

    # the digest: the sim, all-origins (int64) and traffic stacks of those
    # states, N=100,000, and a crafted stack
    h_prm = EngineParams(num_nodes=N_HUGE, warm_up_rounds=0, health=True,
                         representation="sparse")
    h_acc, _ = cli.load_cluster_accounts(
        cli.Config(num_synthetic_nodes=N_HUGE))
    h_stakes = NodeIndex.from_stakes(h_acc).stakes.astype(np.int64)
    h_tables = engine.make_cluster_tables(h_stakes, device=dev)
    h_org = torch.as_tensor(np.argsort(-h_stakes, kind="stable")[:O_HUGE]
                            .astype(np.int32), device=dev)
    h_st = engine.init_state(engine_key(dev), h_tables, h_org, h_prm)
    # its rounds one at a time, keeping the health_round call of the round
    # where most rows fire and of the last (the counts in device memory)
    h_calls = {}
    for it in range(20):
        (h_st, _), calls = record_calls(kernels, ["health_round"],
                                        engine.run_rounds, h_prm, h_tables,
                                        h_org, h_st, 1, it)
        (args, _), = calls["health_round"]
        h_calls[it] = (int((args[2] > 0).sum()), args)
        busiest = max(h_calls, key=lambda i: h_calls[i][0])
        h_calls = {i: c for i, c in h_calls.items() if i in (busiest, it)}
    for it, (_, args) in sorted(h_calls.items()):
        check_time("round", f"O={O_HUGE} N={N_HUGE} sparse round {it}",
                   args)
    del h_calls, calls, args
    r = np.random.default_rng(7)
    crafted = torch.as_tensor(
        np.where(r.random((9, N_FULL)) < 0.5, r.integers(0, 4, (9, N_FULL)),
                 r.integers(-(1 << 36), 1 << 36, (9, N_FULL))),
        dtype=torch.int64, device=dev)
    stacks = {
        f"sim O={O_KERNEL}": (cli._health_stack(st19, traffic=False),
                              tables.stake_decile),
        f"all-origins O={O_KERNEL} (int64)": (cli._sim_health_stack_valid(
            st19, O_KERNEL), tables.stake_decile),
        f"traffic M={M_TRAFFIC}": (t_stack, tables.stake_decile),
        f"N={N_HUGE} O={O_HUGE} sparse": (
            cli._health_stack(h_st, traffic=False), h_tables.stake_decile),
        "crafted ties + int64 range": (crafted, tables.stake_decile),
    }
    for key, (stack, ids) in stacks.items():
        p_, n_ = stack.shape
        k = min(10, n_)
        fn = lambda s=stack, i=ids: kernels.health_digest(s, i, k)
        err = max_abs_err(fn(), kernels.health_digest_plain(stack, ids, k))
        res["worst"]["health_digest"] = max(
            res["worst"].get("health_digest", 0), err)
        if err:
            fail(f"(n) health_digest {key}: differs from its plain version "
                 f"(max_abs_err {err})")
        moved = nbytes(stack, ids) + p_ * (12 * 8 + k * 12)
        wide = stack.dtype == torch.int64
        lo, hi = stack.min(-1).values, stack.max(-1).values
        bits = [(int(h) - int(l_)).bit_length() for l_, h in zip(lo, hi)]
        d = {"p": p_, "n": n_, "dtype": str(stack.dtype).split(".")[-1],
             "ms": cuda_ms(fn, reps=10),
             "device_ms": device_ms(fn, KERNEL_SYMBOLS["health_digest"],
                                    reps=10),
             "whole_ms": device_ms(fn, None, reps=10),
             "plain_ms": cuda_ms(lambda: kernels.health_digest_plain(
                 stack, ids, k), reps=3, warm=1),
             "library_ms": cuda_ms(lambda: torch.sort(stack, dim=-1,
                                                      stable=True),
                                   reps=10),
             "bytes": moved, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
             "bound_by": "bytes", "max_abs_err": err,
             "radix_passes": max(-(-b // 8) for b in bits),
             "geometry": list(hd_mod.launch_geometry(
                 p_, n_, torch.cuda.get_device_properties(
                     dev).multi_processor_count,
                 hd_mod.blocks_per_sm(dev, wide)))}
        res["digest"][key] = d
        say(f"(n) health_digest {key} [{p_}, {n_}] {d['dtype']}: exact; "
            f"wrapper {d['ms']:.4f} ms, device {d['device_ms']} ms (every "
            f"device activity of the call {d['whole_ms']} ms), bound "
            f"{d['bound_ms']:.5f} ms ({moved} bytes), "
            f"{d['radix_passes']} radix passes, (tiles a row, blocks) "
            f"{tuple(d['geometry'])}, plain {d['plain_ms']:.4f} ms, "
            f"stable torch.sort of the stack {d['library_ms']:.4f} ms")

    print("HEALTH " + json.dumps(as_builtins(res)), flush=True)
    return 0


def health_phase(exact, worst, out_dir):
    """Phase (n), the node-health observatory: the ``--health-phase``
    child's kernel checks, timings and round profiles; the full-width CLI
    runs with ``--health`` against the same runs without it (the 10k
    single origin, all-origins on origins 0-199 at the auto batch, the
    M=256 traffic run, N=100,000 sparse at 20 iterations), each
    digest held against its plain version (``exact``, which keeps
    ``worst``); cuda == cpu at N=2,000; an all-origins ``--health`` run
    stopped and resumed.  Returns (the child's result, the CLI runs, the
    main path's digests timed, the round profiles)."""
    import numpy as np
    import torch
    from gossip_sim_tpu_torch import cli, kernels
    from gossip_sim_tpu_torch.identity import reset_unique_pubkeys
    from gossip_sim_tpu_torch.sinks import (DatapointQueue,
                                            deterministic_wire_lines)
    # the kernels against their plain versions, timed and profiled, in a
    # process of its own (its first profiler sessions)
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           HEALTH_FLAG], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    (out_dir / "health_phase.txt").write_text(
        proc.stdout + "\n--- stderr ---\n" + proc.stderr[-200_000:])
    if proc.returncode != 0:
        fail(f"(n) the {HEALTH_FLAG} process failed (exit "
             f"{proc.returncode}): {proc.stderr[-3000:]}")
    health_res = None
    for ln in proc.stdout.splitlines():
        if ln.startswith("chip_smoke: (n)"):
            print(ln, flush=True)
        elif ln.startswith("HEALTH "):
            health_res = json.loads(ln[len("HEALTH "):])
    if health_res is None:
        fail("(n) the health process printed no result")
    h_prof = health_res["round_profile"]
    if h_prof["no health"]["launches"] != 117:
        fail(f"(n) the O={O_KERNEL} push round launches "
             f"{h_prof['no health']['launches']} a round without --health, "
             f"not 117")
    say(f"(n) O={O_KERNEL} push round from round 19: without --health "
        f"{h_prof['no health']['launches']:.1f} launches, "
        f"{h_prof['no health']['busy_ms']:.4f} ms busy; with --health "
        f"{h_prof['health']['launches']:.1f} launches, "
        f"{h_prof['health']['busy_ms']:.4f} ms busy")
    from gossip_sim_tpu_torch import resilience
    from gossip_sim_tpu_torch.stats.gossip_stats import GossipStatsCollection
    from gossip_sim_tpu_torch.stats.traffic import TrafficStatsCollection
    for name in ("health_round", "health_round_traffic", "health_digest"):
        worst[name] = max(worst.get(name, 0),
                          health_res["worst"].get(name, 0))
    real_digest = kernels.health_digest
    digest_calls = []

    def recording_digest(*a, **kw):
        digest_calls.append((a, kw))
        return real_digest(*a, **kw)

    def health_run(kind, argv, device="cuda", **kw):
        """One CLI run through its entry point with an Influx queue and
        the launch counts set to 0 just before it: (wall, what the stats
        give to compare, deterministic lines, sim_node_health lines
        without their timestamps, the node_health section, launches)."""
        reset_unique_pubkeys()
        resilience.reset_counts()
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            argv + ["--device", device]))
        q = DatapointQueue()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        if kind == "single":
            coll = GossipStatsCollection()
            cli.run_simulation(cfg, "", coll, q, 0, "0", 0.0)
            got = [snapshot_strings(s.parity_snapshot())
                   for s in coll.collection]
        elif kind == "traffic":
            coll = TrafficStatsCollection()
            cli.run_traffic(cfg, "u", q, "0", collection=coll)
            got = [(s.parity_snapshot(), s.summary())
                   for s in coll.collection]
        else:
            summ = cli.run_all_origins(cfg, dp_queue=q, start_ts="0",
                                       **kw)
            got = {k: (v.tolist() if hasattr(v, "tolist") else v)
                   for k, v in summ["stats"].state_dict().items()}
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        raw = []
        while len(q):
            raw.extend(q.pop_front().data().splitlines())
        return dict(wall=wall, got=got, lines=deterministic_wire_lines(raw),
                    health=[ln.rsplit(" ", 1)[0] for ln in raw
                            if ln.startswith("sim_node_health")],
                    section=resilience.RUN_INFO.get("node_health"),
                    launches=dict(kernels.LAUNCHES))

    h_base = ["--num-synthetic-nodes", str(N_FULL), "--iterations", "300",
              "--warm-up-rounds", "200"]
    h_cases = {
        "single 10k": ("single", h_base, {}),
        f"all-origins 0-{AO_ORIGINS - 1}": (
            "all-origins", h_base + ["--all-origins"],
            dict(origin_indices=np.arange(AO_ORIGINS, dtype=np.int32))),
        f"traffic M={M_TRAFFIC}": (
            "traffic", h_base + ["--traffic-values", str(M_TRAFFIC),
                                 "--traffic-rate", str(TRAFFIC_RATE)], {}),
        f"sparse N={N_HUGE}": (
            "single", ["--num-synthetic-nodes", str(N_HUGE), "--iterations",
                       "20", "--warm-up-rounds", "10",
                       "--engine-representation", "sparse"], {}),
    }
    h_runs, h_digest = {}, {}
    for case, (kind, argv_h, kw) in h_cases.items():
        off = health_run(kind, argv_h, **kw)
        digest_calls.clear()
        kernels.health_digest = recording_digest
        try:
            on = health_run(kind, argv_h + ["--health"], **kw)
        finally:
            kernels.health_digest = real_digest
        if on["got"] != off["got"] or on["lines"] != off["lines"]:
            fail(f"(n) {case}: --health moved the stats or the "
                 f"deterministic Influx lines")
        if off["health"] or off["section"] is not None or not on["health"]:
            fail(f"(n) {case}: sim_node_health points {len(on['health'])} "
                 f"with --health, {len(off['health'])} without")
        iters = int(argv_h[argv_h.index("--iterations") + 1])
        # all-origins runs its engine without the health gate, as the
        # reference does (cli.all_origins_params); its digests run
        want_round = {"single": ("health_round", iters),
                      "traffic": ("health_round_traffic", iters),
                      "all-origins": ("health_round", 0)}[kind]
        if (on["launches"][want_round[0]] != want_round[1]
                or on["launches"]["health_digest"] != len(digest_calls)
                or off["launches"]["health_digest"]
                or off["launches"]["health_round"]
                or off["launches"]["health_round_traffic"]):
            fail(f"(n) {case}: launches {on['launches']} with --health, "
                 f"{off['launches']} without")
        for args, kw_ in digest_calls:
            exact("health_digest", args, kw_, f"(n) {case}'s digests")
        stack, ids, k = digest_calls[-1][0]
        reps = 10
        moved = nbytes(stack, ids) + stack.shape[0] * (12 * 8 + k * 12)
        h_digest[case] = {
            "p": int(stack.shape[0]), "n": int(stack.shape[1]),
            "dtype": str(stack.dtype).split(".")[-1], "calls":
            len(digest_calls),
            "ms": cuda_ms(lambda: real_digest(stack, ids, k), reps=reps),
            "plain_ms": cuda_ms(lambda: kernels.health_digest_plain(
                stack, ids, k), reps=3, warm=1),
            "library_ms": cuda_ms(lambda: torch.sort(stack, dim=-1,
                                                     stable=True), reps=reps),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bytes": moved}
        h_runs[case] = {"on": on, "off": off}
        sec = on["section"]
        say(f"(n) {case} --health: wall {on['wall']:.3f} s against "
            f"{off['wall']:.3f} s without; stats and deterministic Influx "
            f"lines equal; {len(on['health'])} sim_node_health points, "
            f"section totals "
            + ", ".join(f"{m} {v['total']}" for m, v in
                        sec["metrics"].items())
            + f"; launches health_round {on['launches']['health_round']}, "
            f"traffic form {on['launches']['health_round_traffic']}, "
            f"health_digest {on['launches']['health_digest']} (each "
            f"exact vs plain; the last, [{h_digest[case]['p']}, "
            f"{h_digest[case]['n']}] {h_digest[case]['dtype']}, "
            f"{h_digest[case]['ms']:.4f} ms)")
    # cuda == cpu at N=2,000
    n2 = ["--num-synthetic-nodes", str(N_PARITY), "--iterations", "20",
          "--warm-up-rounds", "10", "--health"]
    impaired = ["--packet-loss-rate", "0.1", "--churn-fail-rate", "0.01",
                "--churn-recover-rate", "0.2", "--partition-at", "12",
                "--heal-at", "18"]
    for case, (kind, argv_p) in {
            "push impaired": ("single", n2 + impaired),
            "push-pull": ("single", n2 + ["--gossip-mode", "push-pull",
                                          "--packet-loss-rate", "0.1"]),
            "adaptive traffic": ("traffic", n2 + [
                "--gossip-mode", "adaptive", "--traffic-values",
                str(M_NARROW), "--traffic-rate", "2",
                "--node-ingress-cap", "40", "--node-egress-cap", "60"]),
    }.items():
        a, b = (health_run(kind, argv_p, device=d) for d in ("cuda", "cpu"))
        if (a["health"] != b["health"] or a["section"] != b["section"]
                or a["got"] != b["got"] or a["lines"] != b["lines"]):
            fail(f"(n) N={N_PARITY} {case}: cuda and cpu differ")
        say(f"(n) N={N_PARITY} {case} --health: cuda == cpu "
            f"({len(a['health'])} sim_node_health points, the section, "
            f"the stats and the deterministic lines); walls "
            f"{a['wall']:.3f} / {b['wall']:.3f} s")
    # an all-origins --health run stopped after 2 batches and resumed
    ck_dir = ROOT / "build" / "health"
    shutil.rmtree(ck_dir, ignore_errors=True)
    ck_dir.mkdir(parents=True)
    ao_case = f"all-origins 0-{AO_ORIGINS - 1}"
    ao_kind, ao_argv, ao_kw = h_cases[ao_case]
    ck = ["--checkpoint-path", str(ck_dir / "ao.npz")]
    resilience.reset_shutdown()
    resilience.set_kill_after_units(2)
    try:
        health_run(ao_kind, ao_argv + ["--health"] + ck, **ao_kw)
        fail("(n) the all-origins --health run was not stopped")
    except resilience.ResumableInterrupt:
        pass
    finally:
        resilience.set_kill_after_units(0)
        resilience.reset_shutdown()
    resumed = health_run(ao_kind, ao_argv + ["--health"] + ck
                         + ["--resume", ck[1]], **ao_kw)
    straight = h_runs[ao_case]["on"]
    if (resumed["section"] != straight["section"]
            or resumed["health"] != straight["health"]
            or resumed["got"] != straight["got"]):
        fail("(n) the resumed all-origins --health run differs from the "
             "straight run")
    shutil.rmtree(ck_dir, ignore_errors=True)
    say(f"(n) all-origins --health stopped after 2 batches and resumed: "
        f"the final digest, every sim_node_health point and the aggregates "
        f"equal the straight run's (resumed wall {resumed['wall']:.3f} s)")

    return health_res, h_runs, h_digest, h_prof


#: ``--trace-phase``: phase (o)'s kernel checks and timings, in a process
#: whose first profiler sessions they are
TRACE_FLAG = "--trace-phase"
#: the flight recorder's new kernel (phase (o)), and what it replaces
TRACE_SOURCES = {
    "trace_prune_pairs": ("gossip_sim_tpu/engine/core.py:864",
                          "the prune-pair capture of round_step's trace "
                          "arm, core.py:864-892"),
}
#: the kernels that gained a trace output, and the reference's trace block
#: each computes
TRACED_SOURCES = {"push_targets": "core.py:606-618 (slot codes)",
                  "rotate": "core.py:1371 (rotation events)",
                  "pull_exchange": "core.py:1165-1180 (pull codes)"}


def prune_pairs_bytes(args, out) -> int:
    """Bytes ``trace_prune_pairs`` must move on these inputs: ``n_pruned``
    once, of each firing pruner whose pairs start below the cap its C
    ``pruned_slot`` bytes, the prunee of each captured pair, and the two
    [R, cap] outputs."""
    import torch
    n_pruned, slot = args[0], args[1]
    cap = int(args[3])
    offs = torch.cumsum(n_pruned, -1) - n_pruned
    reading = (n_pruned > 0) & (offs < cap)
    pairs = int(torch.clamp(n_pruned.sum(-1), max=cap).sum())
    return (nbytes(n_pruned) + int(reading.sum()) * slot.shape[-1]
            + 4 * pairs + nbytes(*out))


def trace_child() -> int:
    """``chip_smoke.py --trace-phase``, started by phase (o): first the
    5-round profiles of the O=32 push round from round 19 without and with
    the trace (launches and device busy per round; a count the profiler
    cut short is taken again, up to three times); then, on round 19 of
    O=32 of N=10,000, push under loss 0.1 + partition + churn and
    push-pull at pull cap 2, each traced call of ``push_targets``,
    ``rotate`` and ``pull_exchange`` held against its plain version
    (tolerance 0), the same call with the trace off against the call
    without the argument (bit for bit), both timed (CUDA events and
    device ms); ``trace_prune_pairs`` on the push round's round 19 (rows
    fire) and round 20 (none fires) at the auto cap and at a cap that
    truncates, exact and timed beside its bytes bound and ``torch.nonzero``
    of the pruned slots with a gather of their prunees.  Prints
    ``chip_smoke: (o)`` lines and, last, one ``TRACE {json}`` line."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from gossip_sim_tpu_torch import cli, engine, kernels
    from gossip_sim_tpu_torch.engine import EngineParams
    from gossip_sim_tpu_torch.identity import NodeIndex
    dev = torch.device("cuda")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    accounts, _ = cli.load_cluster_accounts(
        cli.Config(num_synthetic_nodes=N_FULL))
    stakes_np = NodeIndex.from_stakes(accounts).stakes.astype(np.int64)
    tables = engine.make_cluster_tables(stakes_np, device=dev)
    o32 = torch.as_tensor(np.argsort(-stakes_np, kind="stable")[:O_KERNEL]
                          .astype(np.int32), device=dev)
    base = EngineParams(num_nodes=N_FULL, warm_up_rounds=0)
    res = {"calls": {}, "pairs": {}, "worst": {}}

    def state19(prm):
        st = engine.init_state(engine_key(dev), tables, o32, prm)
        return engine.run_rounds(prm, tables, o32, st, 19)[0]

    # first (this process's first profiler sessions): the O=32 push round
    # from round 19 without and with the trace; the profiler may drop an
    # event, never add one, so a count short of a whole number is taken
    # again, up to three times, and the most is kept
    prof = {}
    st19 = state19(base)
    for gate in (False, True):
        runs_p = []
        # the traced run's count is not a whole number: its stacked trace
        # rows add launches once a call, so it is taken once
        while len(runs_p) < (1 if gate else 3) and not any(
                float(r.get("launches", 0)).is_integer()
                and r.get("launches") for r in runs_p):
            runs_p.append(profile_rounds(
                lambda p_, t_, o_, s_, n_: engine.run_rounds(
                    p_, t_, o_, s_, n_, start_it=19, trace=gate),
                base, tables, o32, st19, out_dir, rounds=5,
                tag=" trace" if gate else " no trace", phase="(o)"))
        prof[gate] = max(runs_p, key=lambda r: r.get("launches") or 0)
        prof[gate]["profiles"] = len(runs_p)
    res["round_profile"] = {
        ("trace" if g else "no trace"): {k: v.get(k) for k in (
            "launches", "busy_ms", "wall_ms", "profiles")}
        for g, v in prof.items()}

    def traced_calls(prm, which):
        """The traced engine's rounds 19 and 20 of ``prm``: the calls of
        the kernels ``which``, {name: {19: (args, kw), 20: ...}}."""
        _, calls = record_calls(kernels, which, engine.run_rounds, prm,
                                tables, o32, state19(prm), 2, 19, False,
                                False, True)
        return {name: dict(zip((19, 20), c)) for name, c in calls.items()}

    def check_traced(name, key, args, kw):
        """A traced call against its plain version; the call with the trace
        off against the call without the argument; both timed."""
        fn, plain = getattr(kernels, name), getattr(kernels, f"{name}_plain")
        off_kw = dict(kw, trace=False)
        bare_kw = {k: v for k, v in kw.items() if k != "trace"}
        got = fn(*args, **kw)
        err = max_abs_err(got, plain(*args, **kw))
        bare = fn(*args, **bare_kw)
        off_err = max_abs_err(fn(*args, **off_kw), bare)
        # the outputs that are set: the untraced call's, then the trace's
        outs = lambda x: tuple(t for t in x if t is not None)
        n_bare = len(outs(bare))
        head_err = max_abs_err(outs(got)[:n_bare], outs(bare))
        if err or off_err or head_err:
            fail(f"(o) {name} {key}: traced call differs from its plain "
                 f"version (max_abs_err {err}), or the trace changed the "
                 f"call (off {off_err})")
        res["worst"][name] = max(res["worst"].get(name, 0), err)
        sym = KERNEL_SYMBOLS[name]
        r = {"ms": cuda_ms(lambda: fn(*args, **kw), reps=20),
             "device_ms": device_ms(lambda: fn(*args, **kw), sym, reps=20),
             "off_ms": cuda_ms(lambda: fn(*args, **off_kw), reps=20),
             "off_device_ms": device_ms(lambda: fn(*args, **off_kw), sym,
                                        reps=20),
             "plain_ms": cuda_ms(lambda: plain(*args, **kw), reps=3,
                                 warm=1),
             "max_abs_err": err,
             "trace_bytes": nbytes(*outs(got)[n_bare:])}
        res["calls"][f"{name} {key}"] = r
        say(f"(o) {name} {key} traced: exact vs plain, trace off == no "
            f"argument; wrapper {r['ms']:.4f} ms (off {r['off_ms']:.4f}), "
            f"device {r['device_ms']} ms (off {r['off_device_ms']}), plain "
            f"{r['plain_ms']:.4f} ms; {r['trace_bytes']} trace bytes")

    impaired = base._replace(packet_loss_rate=0.1, churn_fail_rate=0.01,
                             churn_recover_rate=0.2, partition_at=10,
                             heal_at=40, impair_seed=5)
    calls = traced_calls(impaired, ["push_targets", "rotate"])
    for name in ("push_targets", "rotate"):
        args, kw = calls[name][19]
        check_traced(name, f"O={O_KERNEL} impaired round 19", args, kw)
    pp = base._replace(gossip_mode="push-pull", pull_request_cap=2)
    args, kw = traced_calls(pp, ["pull_exchange"])["pull_exchange"][19]
    check_traced("pull_exchange", f"O={O_KERNEL} push-pull cap 2 round 19",
                 args, kw)

    # the prune pairs: rounds 19 (rows fire) and 20 (none fires) of the
    # push round, at the auto cap and at one that truncates
    pairs = traced_calls(base, ["trace_prune_pairs"])["trace_prune_pairs"]
    fired19 = int((pairs[19][0][0] > 0).sum())
    fired20 = int((pairs[20][0][0] > 0).sum())
    if fired19 == 0 or 100 * fired20 > fired19:
        fail(f"(o) trace_prune_pairs: {fired19} firing rows in round 19, "
             f"{fired20} in round 20 (want many, then a few at most)")
    totals = pairs[19][0][0].sum(-1)
    small = max(1, int(totals.max()) // 2)
    fn, plain = kernels.trace_prune_pairs, kernels.trace_prune_pairs_plain
    for it, cap in ((19, None), (20, None), (19, small)):
        (n_pruned, slot, src, auto), _ = pairs[it]
        cap = auto if cap is None else cap
        a = (n_pruned, slot, src, cap)
        out = fn(*a)
        err = max_abs_err(out, plain(*a))
        res["worst"]["trace_prune_pairs"] = max(
            res["worst"].get("trace_prune_pairs", 0), err)
        if err:
            fail(f"(o) trace_prune_pairs round {it} cap {cap}: differs from "
                 f"its plain version (max_abs_err {err})")
        moved = prune_pairs_bytes(a, out)
        flat_slot, flat_src = slot.reshape(slot.shape[0], -1), src.reshape(
            src.shape[0], -1)

        def library():
            idx = torch.nonzero(flat_slot)
            return idx, flat_src[idx[:, 0], idx[:, 1]]

        r = {"round": it, "cap": cap,
             "ms": cuda_ms(lambda: fn(*a), reps=20),
             "device_ms": device_ms(lambda: fn(*a), ("trace_prune_pairs",),
                                    reps=20),
             "plain_ms": cuda_ms(lambda: plain(*a), reps=3, warm=1),
             "library_ms": cuda_ms(library, reps=20),
             "bytes": moved, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
             "bound_by": "bytes", "max_abs_err": err,
             "fired_rows": int((n_pruned > 0).sum()),
             "pairs": int(n_pruned.sum()),
             "truncated_rows": int((n_pruned.sum(-1) > cap).sum())}
        key = f"O={O_KERNEL} round {it} cap {cap}"
        res["pairs"][key] = r
        say(f"(o) trace_prune_pairs {key}: exact; wrapper {r['ms']:.4f} ms, "
            f"device {r['device_ms']} ms, bound {r['bound_ms']:.4f} ms "
            f"({moved} bytes), plain {r['plain_ms']:.4f} ms, torch.nonzero "
            f"+ gather {r['library_ms']:.4f} ms; {r['fired_rows']} firing "
            f"rows, {r['pairs']} pairs, {r['truncated_rows']} rows "
            f"truncated")
    if res["pairs"][f"O={O_KERNEL} round 19 cap {small}"][
            "truncated_rows"] == 0:
        fail("(o) trace_prune_pairs: the small cap truncated no row")
    print("TRACE " + json.dumps(as_builtins(res)), flush=True)
    return 0


def trace_dirs_equal(a: Path, b: Path) -> list:
    """Where two trace directories differ: every segment array, and the
    manifests but for each segment's ``bytes`` and the config's
    ``device`` and ``trace_dir``."""
    import numpy as np
    ma = json.loads((a / "manifest.json").read_text())
    mb = json.loads((b / "manifest.json").read_text())
    strip = lambda m: dict(
        m, segments=[{k: v for k, v in s.items() if k != "bytes"}
                     for s in m["segments"]],
        config={k: v for k, v in m["config"].items()
                if k not in ("device", "trace_dir")})
    diff = [] if strip(ma) == strip(mb) else ["manifest"]
    for seg in ma["segments"]:
        with np.load(a / seg["file"]) as za, np.load(b / seg["file"]) as zb:
            diff += [f"{seg['file']}:{k}" for k in za.files
                     if k not in zb.files or za[k].dtype != zb[k].dtype
                     or not np.array_equal(za[k], zb[k])]
    return diff


def trace_phase(exact, worst, out_dir):
    """Phase (o), the flight recorder: the ``--trace-phase`` child's kernel
    checks, timings and round profiles; the full-width CLI runs with
    ``--trace-dir`` against the same runs without it (the 10k single
    origin in push and in push-pull under loss 0.1, all-origins on origins
    0-199 at the auto batch with ``--trace-origins 4``), with the launch
    counts set to 0 just before each and read just after; the last
    ``trace_prune_pairs`` call of each held against its plain version
    (``exact``); each trace directory validated by the port's
    ``validate_trace_dir``; cuda == cpu trace directories at N=2,000.
    Returns (the child's result, the CLI runs)."""
    import numpy as np
    import torch
    from gossip_sim_tpu_torch import cli, kernels, resilience
    from gossip_sim_tpu_torch.identity import reset_unique_pubkeys
    from gossip_sim_tpu_torch.obs import trace as trace_mod
    from gossip_sim_tpu_torch.sinks import (DatapointQueue,
                                            deterministic_wire_lines)
    from gossip_sim_tpu_torch.stats.gossip_stats import GossipStatsCollection
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           TRACE_FLAG], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    (out_dir / "trace_phase.txt").write_text(
        proc.stdout + "\n--- stderr ---\n" + proc.stderr[-200_000:])
    if proc.returncode != 0:
        fail(f"(o) the {TRACE_FLAG} process failed (exit "
             f"{proc.returncode}): {proc.stderr[-3000:]}")
    trace_res = None
    for ln in proc.stdout.splitlines():
        if ln.startswith("chip_smoke: (o)"):
            print(ln, flush=True)
        elif ln.startswith("TRACE "):
            trace_res = json.loads(ln[len("TRACE "):])
    if trace_res is None:
        fail("(o) the trace process printed no result")
    t_prof = trace_res["round_profile"]
    if t_prof["no trace"]["launches"] != 117:
        fail(f"(o) the O={O_KERNEL} push round launches "
             f"{t_prof['no trace']['launches']} a round without the trace, "
             f"not 117")
    say(f"(o) O={O_KERNEL} push round from round 19: without the trace "
        f"{t_prof['no trace']['launches']:.1f} launches, "
        f"{t_prof['no trace']['busy_ms']:.4f} ms busy; with it "
        f"{t_prof['trace']['launches']:.1f} launches, "
        f"{t_prof['trace']['busy_ms']:.4f} ms busy")
    for name, err in trace_res["worst"].items():
        worst[name] = max(worst.get(name, 0), err)

    real_add = trace_mod.TraceWriter.add_block
    real_replay = cli._trace_replay_origins
    real_pairs = kernels.trace_prune_pairs
    seen = {"writes": [], "replay": [], "pairs": None}

    def timed_add(self, start, block):
        t0 = time.perf_counter()
        out = real_add(self, start, block)
        seen["writes"].append((time.perf_counter() - t0, out["bytes"]))
        return out

    def timed_replay(*a, **kw):
        # the batches' launches, before the replay adds its own
        seen["batch_launches"] = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        real_replay(*a, **kw)
        seen["replay"].append(time.perf_counter() - t0)

    def last_pairs(*a, **kw):
        seen["pairs"] = (a, kw)
        return real_pairs(*a, **kw)

    def trace_run(kind, argv, device="cuda", trace_dir=None, **kw):
        """One CLI run through its entry point with an Influx queue and the
        launch counts set to 0 just before it: (wall, the stats, the
        deterministic lines but the sim_trace points, those points, the
        launches, the segment writes and the replay's wall)."""
        reset_unique_pubkeys()
        resilience.reset_counts()
        extra = ["--device", device]
        if trace_dir is not None:
            shutil.rmtree(trace_dir, ignore_errors=True)
            extra += ["--trace-dir", str(trace_dir)]
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            argv + extra))
        q = DatapointQueue()
        seen.update(writes=[], replay=[], pairs=None, batch_launches=None)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        if kind == "single":
            coll = GossipStatsCollection()
            cli.run_simulation(cfg, "", coll, q, 0, "0", 0.0)
            got = [snapshot_strings(s.parity_snapshot())
                   for s in coll.collection]
        else:
            summ = cli.run_all_origins(cfg, dp_queue=q, start_ts="0", **kw)
            got = {k: (v.tolist() if hasattr(v, "tolist") else v)
                   for k, v in summ["stats"].state_dict().items()}
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        raw = []
        while len(q):
            raw.extend(q.pop_front().data().splitlines())
        lines = deterministic_wire_lines(raw)
        return dict(wall=wall, got=got,
                    lines=[ln for ln in lines
                           if not ln.startswith("sim_trace")],
                    trace_lines=[ln for ln in lines
                                 if ln.startswith("sim_trace")],
                    launches=dict(kernels.LAUNCHES),
                    batch_launches=seen["batch_launches"] or dict(
                        kernels.LAUNCHES),
                    writes=list(seen["writes"]), replay=list(seen["replay"]),
                    pairs=seen["pairs"])

    trace_mod.TraceWriter.add_block = timed_add
    cli._trace_replay_origins = timed_replay
    kernels.trace_prune_pairs = last_pairs
    t_base = ["--num-synthetic-nodes", str(N_FULL), "--iterations", "300",
              "--warm-up-rounds", "200"]
    t_cases = {
        "single 10k push": ("single", t_base, {}),
        "single 10k push-pull": ("single", t_base + [
            "--gossip-mode", "push-pull", "--packet-loss-rate", "0.1"], {}),
        f"all-origins 0-{AO_ORIGINS - 1}": (
            "all-origins", t_base + ["--all-origins", "--trace-origins", "4"],
            dict(origin_indices=np.arange(AO_ORIGINS, dtype=np.int32))),
    }
    t_dir = ROOT / "build" / "trace"
    t_runs = {}
    try:
        for case, (kind, argv_t, kw) in t_cases.items():
            off = trace_run(kind, argv_t, **kw)
            d = t_dir / case.replace(" ", "_")
            on = trace_run(kind, argv_t, trace_dir=d, **kw)
            if on["got"] != off["got"] or on["lines"] != off["lines"]:
                fail(f"(o) {case}: --trace-dir moved the stats or the "
                     f"deterministic Influx lines")
            problems = trace_mod.validate_trace_dir(str(d))
            if problems:
                fail(f"(o) {case}: validate_trace_dir: {problems[:5]}")
            man = json.loads((d / "manifest.json").read_text())
            rounds = sum(s["end_round"] - s["start_round"]
                         for s in man["segments"])
            if (off["launches"]["trace_prune_pairs"]
                    or on["launches"]["trace_prune_pairs"] != rounds
                    or len(on["trace_lines"]) != len(man["segments"])
                    or off["trace_lines"]):
                fail(f"(o) {case}: trace_prune_pairs launched "
                     f"{on['launches']['trace_prune_pairs']} times with "
                     f"--trace-dir ({rounds} traced rounds), "
                     f"{off['launches']['trace_prune_pairs']} without; "
                     f"{len(on['trace_lines'])} sim_trace points")
            a_, kw_ = on["pairs"]
            exact("trace_prune_pairs", a_, kw_, f"(o) {case}'s last call")
            # the engine's launches but the trace's (all-origins: the
            # batches', before the replay)
            same = {k: v == on["batch_launches"][k] for k, v in
                    off["launches"].items() if k != "trace_prune_pairs"}
            on["bytes"] = sum(s["bytes"] for s in man["segments"])
            on["segments"] = len(man["segments"])
            on["rounds"] = rounds
            on["truncated"] = sum(len(s["truncated_prune_rounds"])
                                  for s in man["segments"])
            t_runs[case] = {"on": on, "off": off}
            write_s = sum(w for w, _ in on["writes"])
            say(f"(o) {case} --trace-dir: wall {on['wall']:.3f} s against "
                f"{off['wall']:.3f} s without"
                + (f" (the replay of {len(man['origins'])} origins "
                   f"{on['replay'][0]:.3f} s of it)" if on["replay"] else "")
                + f"; stats and deterministic Influx lines equal; "
                f"{on['segments']} segment(s), {rounds} rounds, "
                f"{on['bytes']} bytes, written in {write_s:.3f} s; "
                f"{on['truncated']} truncated prune rounds; "
                f"validate_trace_dir: no errors; trace_prune_pairs "
                f"{on['launches']['trace_prune_pairs']} launches; every "
                f"other kernel's launches "
                f"{'unchanged' if all(same.values()) else 'CHANGED'}")
            if not all(same.values()):
                fail(f"(o) {case}: --trace-dir changed the launches of "
                     f"{[k for k, v in same.items() if not v]}")
        # cuda == cpu at N=2,000: push under loss + churn + partition over a
        # fail round, and adaptive
        n2 = ["--num-synthetic-nodes", str(N_PARITY), "--iterations", "30",
              "--warm-up-rounds", "20"]
        for case, argv_p in {
                "push impaired + fail round": n2 + [
                    "--packet-loss-rate", "0.1", "--churn-fail-rate", "0.01",
                    "--churn-recover-rate", "0.2", "--partition-at", "22",
                    "--heal-at", "27", "--test-type", "fail-nodes",
                    "--when-to-fail", "24", "--fraction-to-fail", "0.1"],
                "adaptive": n2 + ["--gossip-mode", "adaptive",
                                  "--adaptive-switch-threshold", "0.5"],
        }.items():
            dirs = {dv: t_dir / f"n2000_{case.split()[0]}_{dv}"
                    for dv in ("cuda", "cpu")}
            runs = {dv: trace_run("single", argv_p, device=dv,
                                  trace_dir=dirs[dv]) for dv in dirs}
            diff = trace_dirs_equal(dirs["cuda"], dirs["cpu"])
            if diff or runs["cuda"]["got"] != runs["cpu"]["got"]:
                fail(f"(o) N={N_PARITY} {case}: cuda and cpu traces differ: "
                     f"{diff[:8]}")
            say(f"(o) N={N_PARITY} {case} --trace-dir: cuda == cpu (every "
                f"segment array; the manifests but for the bytes written); "
                f"walls {runs['cuda']['wall']:.3f} / "
                f"{runs['cpu']['wall']:.3f} s")
    finally:
        trace_mod.TraceWriter.add_block = real_add
        cli._trace_replay_origins = real_replay
        kernels.trace_prune_pairs = real_pairs
        shutil.rmtree(t_dir, ignore_errors=True)
    return trace_res, t_runs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    if not (ROOT / "gossip_sim_tpu_torch" / "csrc").is_dir():
        fail("gossip_sim_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from gossip_sim_tpu_torch import cli, kernels, rng
    from gossip_sim_tpu_torch.engine import (EngineParams, init_state,
                                             make_cluster_tables, round_step,
                                             run_rounds)
    from gossip_sim_tpu_torch.identity import NodeIndex, reset_unique_pubkeys
    from gossip_sim_tpu_torch.ingest import write_accounts_yaml
    from gossip_sim_tpu_torch.kernels import _build
    from gossip_sim_tpu_torch.sinks import (DatapointQueue, InfluxDataPoint,
                                            InfluxThread,
                                            deterministic_wire_lines)
    core_mod = importlib.import_module("gossip_sim_tpu_torch.engine.core")
    bfs_mod = importlib.import_module("gossip_sim_tpu_torch.kernels.bfs_relax")
    merge_mod = importlib.import_module(
        "gossip_sim_tpu_torch.kernels.rc_merge_prune")
    rank_mod = importlib.import_module(
        "gossip_sim_tpu_torch.kernels.rank_inbound")
    tf_mod = importlib.import_module("gossip_sim_tpu_torch.kernels.threefry")
    rot_mod = importlib.import_module("gossip_sim_tpu_torch.kernels.rotate")
    pt_mod = importlib.import_module(
        "gossip_sim_tpu_torch.kernels.push_targets")
    px_mod = importlib.import_module(
        "gossip_sim_tpu_torch.kernels.pull_exchange")

    for mod in list(sys.modules):
        if mod == "jax" or mod == "gossip_sim_tpu" or mod.startswith(
                ("jax.", "gossip_sim_tpu.")):
            fail(f"{mod} was imported")
    # the push path's kernels; pull_exchange runs in the pull modes, (h),
    # and the two traffic kernels in the traffic round, (i)
    names = tuple(n for n in _build.KERNEL_NAMES
                  if n not in ("pull_exchange",) + TRAFFIC_ONLY
                  + tuple(HEALTH_SOURCES) + tuple(TRACE_SOURCES))
    dev = torch.device("cuda")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t_all = time.perf_counter()
    phase_walls = {}
    current = {"name": None, "t": t_all}

    def phase(name):
        """Close the running phase (printing its wall) and start ``name``."""
        now = time.perf_counter()
        if current["name"] is not None:
            phase_walls[current["name"]] = now - current["t"]
            say(f"({current['name']}) phase wall "
                f"{phase_walls[current['name']]:.1f} s")
        current.update(name=name, t=now)

    # ---- (a) build -------------------------------------------------------
    phase("a")
    build_s = kernels.build_all(force=True)
    say(f"(a) built {len(_build.KERNEL_NAMES)} kernels with nvcc (sm_90a) "
        f"in {build_s:.2f} s")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ptxas.txt").write_text(
        "\n".join(f"--- {k}\n{v}" for k, v in _build.BUILD_LOG.items()))
    for name in _build.KERNEL_NAMES:
        for line in ptxas_summary(_build.BUILD_LOG[name]):
            say(f"(a) ptxas {line}")
    sms, smem_limit = _build.sm_count(dev), _build.smem_optin(dev)
    # rotate's shared memory: ptxas's static bytes are the class tables, and
    # the keys and the rows (dynamic) fit beside them at every shape
    table = re.search(r"rotate_kernel<false>: \d+ registers, static shared "
                      r"memory "
                      r"(\d+) B", "\n".join(ptxas_summary(
                          _build.BUILD_LOG["rotate"])))
    if not table or int(table.group(1)) != rot_mod.TABLE_BYTES:
        fail(f"rotate_kernel's static shared memory per ptxas "
             f"({table and table.group(1)} B) is not kernels/rotate.py "
             f"TABLE_BYTES ({rot_mod.TABLE_BYTES} B)")
    for s_, t_, n_, o_ in ((12, 8, N_FULL, O_KERNEL), (12, 8, N_FULL, 1),
                           (24, 8, N_FULL, 1), (24, 8, N_FULL, O_RANKS),
                           (25, 32, 40, 5), (12, 8, 1, 200),
                           (12, 8, N_FULL, O_BATCH),
                           (12, 8, N_FULL, AO_ORIGINS),
                           (12, 8, N_SMALL, O_BATCH)):
        g = rot_mod.launch_geometry(s_, t_, n_, o_, smem_limit)
        total = int(table.group(1)) + g.smem
        if total > smem_limit:
            fail(f"rotate at S={s_} T={t_} N={n_} O={o_}: {total} B of "
                 f"shared memory per block, past the {smem_limit} B limit")
        say(f"(a) rotate at S={s_} T={t_} N={n_} O={o_}: {g.rows} rows "
            f"per block, {g.key_bytes} B of keys "
            f"({rot_mod.key_origins(g.rows, n_, o_)} origins x {t_ + 2}: "
            f"the round key and {t_ + 1} sub keys) + "
            f"{g.smem - g.key_bytes} B of staged rows + "
            f"{table.group(1)} B of class tables (ptxas) = {total} B of "
            f"{smem_limit} B")
    for o, n_ in ((1, N_FULL), (LANE_K, N_FULL), (O_RANKS, N_FULL),
                  (O_KERNEL, N_FULL), (O_BATCH, N_FULL),
                  (LANE_K * LANE_O, N_FULL), (AO_ORIGINS, N_FULL),
                  (O_HUGE, N_HUGE)):
        g = bfs_mod.geometry_for(o, n_, dev)
        say(f"(a) bfs_relax at O={o} N={n_} on {sms} SMs: cluster size "
            f"{g.cs} ({bfs_mod.max_clusters(g)} such clusters fit the card "
            f"at once), slice {g.slice_len} nodes, {g.chunk} frontier words "
            f"a compaction pass, {g.smem} B shared memory per CTA (of "
            f"{smem_limit} B), state in "
            f"{'device memory' if g.scratch_words else 'shared memory'}")
    for c, k in ((64, 16), (64, 24), (128, 16)):
        g = merge_mod.launch_geometry(c, k, smem_limit)
        say(f"(a) rc_merge_prune at C={c} K={k}: {g.rows_per_block} rows "
            f"(warps) per block, {g.smem} B shared memory per block")
    for o, k in ((1, 16), (1, 24), (O_RANKS, 16), (O_RANKS, 24),
                 (O_KERNEL, 16), (8, 128), (O_BATCH, 16), (AO_ORIGINS, 16)):
        g = rank_mod.launch_geometry(o, N_FULL, k, sms, smem_limit,
                                     rank_mod.max_clusters)
        say(f"(a) rank_inbound at O={o} N={N_FULL} K={k}: cluster size "
            f"{g.cs} ({rank_mod.max_clusters(g)} such clusters fit the "
            f"card at once), slice {g.slice_len} nodes, {g.threads} "
            f"threads, {g.smem} B shared memory per CTA ({g.csr_cap} CSR "
            f"keys), counts in "
            f"{'device memory' if g.scratch_words else 'shared memory'}")
    for o in (1, O_KERNEL, O_PULL, AO_ORIGINS):
        for cap in (0, 2):
            g = px_mod.geometry_for(o, N_FULL, 2, cap, dev)
            say(f"(a) pull_exchange at O={o} N={N_FULL} pull fanout 2 cap "
                f"{cap}: {pull_geometry(g, px_mod)}")
    for s_, f_ in ((12, 6), (25, 6)) + WIDE_SHAPES:
        pt_rows, pt_smem = pt_mod.launch_geometry(s_, f_, smem_limit)
        per_sm = pt_mod.blocks_per_sm(dev, pt_rows, pt_smem)
        for o in (1, O_RANKS, O_KERNEL, O_BATCH):
            tiles, grid = pt_mod.persistent_grid(o * N_FULL, pt_rows, sms,
                                                 per_sm)
            say(f"(a) push_targets at S={s_} F={f_} O={o}: tiles of "
                f"{pt_rows} rows, {pt_smem} B shared memory per block "
                f"(two input buffers), {per_sm} blocks per SM: {tiles} "
                f"tiles on a grid of {grid} blocks")
    tf_ops = {name: sass_block_ops(name, out_dir) for name in SASS_BLOCKS}
    for name, ops in tf_ops.items():
        say(f"(a) {name} SASS: {ops['total']} integer instructions per "
            f"threefry block, {ops['alu']} on the ALU pipe and "
            f"{ops['fma']} on the FMA pipe (chiprun_out/sass_{name}.txt)")

    # ---- (b) kernels vs plain on a real round's inputs -------------------
    phase("b")
    # the whole calls of prune_apply, traffic_admit and traffic_send at
    # every shape the phases time them at, in a process of its own (its
    # first profiler sessions); printed under each shape's phase
    calls_prof = whole_calls()["shapes"]
    show = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    for shape, per in calls_prof.items():
        for name, t in per.items():
            say(f"{shape.split()[0]} whole call of {name} at "
                f"{shape.split(' ', 1)[1]}, round 19: device "
                f"{show(t['whole_ms'])} (its kernels alone "
                f"{show(t['kernel_ms'])}; CUDA events {t['ms']:.4f} ms)")
    reset_unique_pubkeys()
    accounts, _ = cli.load_cluster_accounts(
        cli.Config(num_synthetic_nodes=N_FULL))
    index = NodeIndex.from_stakes(accounts)
    stakes_np = index.stakes.astype(np.int64)
    tables = make_cluster_tables(stakes_np, device=dev)
    top = np.argsort(-stakes_np, kind="stable")[:O_KERNEL].astype(np.int32)
    origins = torch.as_tensor(top, device=dev)
    params = EngineParams(num_nodes=N_FULL, warm_up_rounds=0)
    real = {name: getattr(kernels, name) for name in _build.KERNEL_NAMES}
    plain = {name: getattr(kernels, f"{name}_plain")
             for name in _build.KERNEL_NAMES}

    def recording(which, calls, fn, *args):
        """``fn(*args)`` with the calls of the kernels ``which`` appended
        to ``calls[name]``."""
        def recorder(name):
            def rec(*a, **kw):
                calls[name].append((a, kw))
                return real[name](*a, **kw)
            return rec

        for name in which:
            setattr(kernels, name, recorder(name))
        try:
            return fn(*args)
        finally:
            for name in which:
                setattr(kernels, name, real[name])

    def round19_calls(prm, orgs, which, part=True):
        """Run rounds 0-18 of ``prm`` at origins ``orgs`` in threefry layout
        ``part``; return round 19's rows and the calls of the kernels
        ``which`` in it."""
        rng.set_partitionable(part)
        try:
            st = init_state(rng.prng_key(42, dev), tables, orgs, prm)
            for it in range(19):
                st, _ = round_step(prm, tables, orgs, st, it)
            calls = {name: [] for name in which}
            _, rows_ = recording(which, calls, round_step, prm, tables, orgs,
                                 st, 19)
        finally:
            rng.set_partitionable(True)
        torch.cuda.synchronize()
        return rows_, calls

    worst = {name: 0 for name in _build.KERNEL_NAMES}

    def exact(name, args, kw, where, key=None):
        """The kernel's output on ``args``, after holding it against the
        plain version's (exit on any difference); ``worst[key or name]``
        keeps the largest error measured."""
        got = real[name](*args, **kw)
        err = max_abs_err(got, plain[name](*args, **kw))
        torch.cuda.synchronize()
        key = key or name
        worst[key] = max(worst.get(key, 0), err)
        if err != 0:
            scalars = [a for a in args if not torch.is_tensor(a)]
            fail(f"{where}: {name} differs from its plain version "
                 f"(max_abs_err {err}; call arguments {scalars} {kw})")
        return got

    rows19, captured = round19_calls(params, origins, names)
    say(f"(b) round 19 at O={O_KERNEL} N={N_FULL}: prunes "
        f"{int(rows19['prunes_sent'].sum())}, rc_overflow "
        f"{int(rows19['rc_overflow'].sum())}, inb_dropped "
        f"{int(rows19['inb_dropped'].sum())}, rot_failed "
        f"{int(rows19['rot_failed'].sum())}; threefry calls in the round "
        f"{len(captured['threefry'])}")
    if captured["threefry"]:
        fail("(b) an unimpaired round launched the threefry kernel")
    round_calls = {name: len(captured[name]) for name in names}
    # threefry's work is init_state's draws: held and timed on its calls
    captured["threefry"] = []
    recording(["threefry"], captured, init_state, rng.prng_key(42, dev),
              tables, origins, params)

    res = {}
    for name in names:
        calls = captured[name]
        outs = [exact(name, args, kw, "(b)") for args, kw in calls]

        def run_all(fn, calls=calls):
            for args, kw in calls:
                fn(*args, **kw)

        res[name] = dict(
            out=outs[0], outs=outs, calls=len(calls),
            calls_per_round=round_calls[name],
            ms=cuda_ms(lambda: run_all(real[name])),
            plain_ms=cuda_ms(lambda: run_all(plain[name]), reps=3, warm=1))
    say(f"(b) calls in round 19: " + ", ".join(
        f"{n} {round_calls[n]}" for n in names) + f"; threefry held and "
        f"timed on init_state's {res['threefry']['calls']} draws at "
        f"O={O_KERNEL}")

    # PyTorch yardsticks (timed here, used nowhere in the port) and bounds
    tgt, org = captured["bfs_relax"][0][0]
    reached, dist = res["bfs_relax"]["out"]
    O, N, F = tgt.shape
    hops = int(dist[reached].max())
    hop_idx = torch.where(tgt < N, tgt, N).reshape(O, N * F).long()
    hop_val = torch.ones((O, N * F), dtype=torch.int32, device=dev)
    hop_out = torch.zeros((O, N + 1), dtype=torch.int32, device=dev)

    def bfs_library():
        for _ in range(hops):
            hop_out.scatter_reduce_(1, hop_idx, hop_val, "amax")

    r_args = captured["rank_inbound"][0][0]
    r_tgt, r_del, r_hop1 = r_args[:3]
    packed = ((torch.where(r_del, r_tgt, N).reshape(O, -1).long() << 32)
              | r_hop1.long().repeat_interleave(F, dim=1))
    mp_args = captured["rc_merge_prune"][0][0]
    row_keys = torch.cat([mp_args[0], mp_args[5]], -1)
    pt_args = captured["push_targets"][0][0]
    S = pt_args[0].shape[-1]
    slot_key = torch.where(pt_args[0] < N, torch.arange(
        S, device=dev, dtype=torch.int32), S)
    slot_sort_ms = cuda_ms(lambda: torch.sort(slot_key, dim=-1, stable=True))
    library = {
        "bfs_relax": (cuda_ms(bfs_library),
                      f"{hops} x scatter_reduce_ amax (one per hop)"),
        "rank_inbound": (cuda_ms(lambda: torch.sort(packed, dim=1)),
                         "torch.sort of the packed (target, key) edges"),
        "rc_merge_prune": (cuda_ms(lambda: torch.sort(row_keys, dim=-1)),
                           "torch.sort of the [O, N, C+K] row keys"),
        "prune_apply": (None, "none"),
        "threefry": (None, "none: no PyTorch call computes JAX's threefry"),
        "push_targets": (None, "none: no one PyTorch call takes the first F "
                         "valid slots and gates them (the stable slot sort "
                         f"it replaces alone: {slot_sort_ms:.4f} ms)"),
        "rotate": (None, "none: no one PyTorch call draws, dedups and "
                   "shifts in a stake-weighted peer"),
    }
    moved, blocks, tf_keys, n_rot = kernel_work(
        captured, {name: res[name]["outs"] for name in names}, tf_mod,
        rot_mod)
    tf_blocks, rot_blocks = blocks["threefry"], blocks["rotate"]
    int_ops = {name: blocks[name] * tf_ops[name]["total"] if blocks[name]
               else 0 for name in names}
    for name in names:
        r = res[name]
        r["bound_ms"], r["bound_by"], bytes_ms, ops_ms = bound(
            moved[name], blocks[name], tf_ops.get(name))
        r["library_ms"], what = library[name]
        lib_txt = ("null" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f} ms")
        say(f"(b) {name}: exact vs plain on its {r['calls']} call(s); "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {lib_txt} ({what}), bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']} ({moved[name]} bytes: {bytes_ms:.4f} ms; "
            f"{int_ops[name]} int32 operations: {ops_ms:.4f} ms)")
    say(f"(b) threefry in init_state at O={O_KERNEL}: {tf_keys} keys, "
        f"{tf_blocks} threefry blocks x {tf_ops['threefry']['total']} "
        f"instructions ({tf_ops['threefry']['alu']} ALU, "
        f"{tf_ops['threefry']['fma']} FMA)")
    say(f"(b) rotate in round 19: {n_rot} of {O * N} rows rotate; "
        f"{rot_blocks} threefry blocks (keys, rotation uniforms and the "
        f"tries taken) x {tf_ops['rotate']['total']} instructions "
        f"({tf_ops['rotate']['alu']} ALU, {tf_ops['rotate']['fma']} FMA)")
    pt_call = captured["push_targets"][0]
    del captured, packed, row_keys, hop_idx, hop_val, hop_out, slot_key
    del pt_args
    for r in res.values():
        del r["out"], r["outs"]
    torch.cuda.empty_cache()

    # rc_slots = 128 with the default k_inbound: a row of C + K = 144
    wide = EngineParams(num_nodes=N_FULL, warm_up_rounds=0, rc_slots=128)
    wide_o = origins[:8]
    rows_w, calls = round19_calls(wide, wide_o,
                                  ["rc_merge_prune", "prune_apply"])
    args, kw = calls["rc_merge_prune"][0]
    exact("rc_merge_prune", args, kw, "(b) rc_slots=128")
    exact("prune_apply", *calls["prune_apply"][0], "(b) rc_slots=128")
    if args[0].shape[-1] + args[5].shape[-1] != 144:
        fail("(b) rc_slots=128: the row is not 144 wide")
    say(f"(b) rc_slots=128 K=16 (row 144) at O={wide_o.numel()} N={N_FULL}, "
        f"round 19: rc_merge_prune and prune_apply (C=128) exact vs plain; "
        f"rc_merge_prune kernel "
        f"{cuda_ms(lambda: real['rc_merge_prune'](*args, **kw)):.4f} ms; "
        f"prunes {int(rows_w['prunes_sent'].sum())}")
    del calls, args, rows_w

    # inbound_cap = 128: past the former 64-entry limit of rank_inbound
    wide = EngineParams(num_nodes=N_FULL, warm_up_rounds=0, inbound_cap=128)
    _, calls = round19_calls(wide, wide_o, ["rank_inbound", "prune_apply"])
    args, kw = calls["rank_inbound"][0]
    got = exact("rank_inbound", args, kw, "(b) inbound_cap=128")
    exact("prune_apply", *calls["prune_apply"][0], "(b) inbound_cap=128")
    if args[4] != 128:
        fail("(b) inbound_cap=128: K is not 128")
    g = rank_mod.launch_geometry(wide_o.numel(), N_FULL, 128, sms,
                                 smem_limit, rank_mod.max_clusters)
    say(f"(b) inbound_cap=128 at O={wide_o.numel()} N={N_FULL}, round 19: "
        f"rank_inbound and prune_apply exact vs plain; rank_inbound kernel "
        f"{cuda_ms(lambda: real['rank_inbound'](*args, **kw)):.4f} ms "
        f"({g.threads} threads, {g.smem} B shared memory per CTA); largest "
        f"ingress {int(got[1].max())}, dropped {int(got[2].sum())}")
    del calls, args, got

    # loss + partition + churn: push_targets' suppression and loss masks
    impaired = EngineParams(
        num_nodes=N_FULL, warm_up_rounds=0, packet_loss_rate=0.1,
        churn_fail_rate=0.01, churn_recover_rate=0.2, partition_at=10,
        heal_at=30, impair_seed=7)
    # verbs 1 and 5 in both threefry layouts, unimpaired (round 19 again in
    # the original layout) and impaired; the fail round's three draws
    fail_prm = EngineParams(num_nodes=N_FULL, warm_up_rounds=0, fail_at=19,
                            fail_fraction=0.1)
    for part in (True, False):
        lay = "partitionable" if part else "original"
        if not part:
            _, calls = round19_calls(params, origins,
                                     ["push_targets", "rotate",
                                      "prune_apply"], part)
            for name in ("push_targets", "rotate", "prune_apply"):
                exact(name, *calls[name][0], f"(b) {lay} layout")
        rows_i, calls = round19_calls(impaired, origins,
                                      ["push_targets", "rotate", "threefry",
                                       "prune_apply"], part)
        args, kw = calls["push_targets"][0]
        _, sup, drop = exact("push_targets", args, kw,
                             f"(b) impaired, {lay} layout")
        exact("rotate", *calls["rotate"][0], f"(b) impaired, {lay} layout")
        exact("prune_apply", *calls["prune_apply"][0],
              f"(b) impaired, {lay} layout")
        if calls["threefry"]:
            fail("(b) the impaired round launched the threefry kernel")
        if not (bool(sup.any()) and bool(drop.any())):
            fail("(b) impaired round: no edge was suppressed or dropped")
        say(f"(b) loss 0.1 + partition + churn at O={O_KERNEL} "
            f"N={N_FULL}, round 19, {lay} layout: push_targets (masks on), "
            f"rotate and prune_apply exact vs plain, no threefry launch; "
            f"push_targets "
            f"kernel {cuda_ms(lambda: real['push_targets'](*args, **kw)):.4f}"
            f" ms; suppressed {int(sup.sum())}, dropped {int(drop.sum())}, "
            f"failed nodes {int(rows_i['failed_count'].sum())}")
        rows_f, calls = round19_calls(fail_prm, origins,
                                      ["threefry", "rotate"], part)
        for args, kw in calls["threefry"]:
            exact("threefry", args, kw, f"(b) fail round, {lay} layout")
        exact("rotate", *calls["rotate"][0], f"(b) fail round, {lay} layout")
        if len(calls["threefry"]) != 3:
            fail(f"(b) the fail round made {len(calls['threefry'])} threefry "
                 f"draws, not 3")
        say(f"(b) fail round (fail_at=19, fraction 0.1), {lay} layout: "
            f"threefry's 3 draws and rotate exact vs plain; failed nodes "
            f"{int(rows_f['failed_count'].sum())}")
    del calls, args, sup, drop, rows_i, rows_f
    torch.cuda.empty_cache()

    # ---- (c) engine, 50 rounds at O=32, N=10,000 -------------------------
    phase("c")
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    state = init_state(rng.prng_key(7, dev), tables, origins, params)
    torch.cuda.synchronize()
    init_tf = kernels.LAUNCHES["threefry"]
    t0 = time.perf_counter()
    state, rows = run_rounds(params, tables, origins, state, 50)
    torch.cuda.synchronize()
    eng_s = time.perf_counter() - t0
    engine_launches = dict(kernels.LAUNCHES)
    tf_per_round = (engine_launches["threefry"] - init_tf) / 50
    if tf_per_round:
        fail(f"(c) the engine's rounds launched threefry {tf_per_round} "
             f"times a round")
    cov = rows["coverage"]
    if cov.shape != (50, O_KERNEL) or not bool(torch.isfinite(cov).all()):
        fail(f"(c) coverage rows malformed: {tuple(cov.shape)}")
    if not bool(((cov > 0) & (cov <= 1)).all()):
        fail("(c) coverage outside (0, 1]")
    missing = [n for n in names if engine_launches[n] <= 0]
    if missing:
        fail(f"(c) kernels never launched by the engine: {missing}")
    if engine_launches["pull_exchange"]:
        fail("(c) the push round launched pull_exchange")
    say(f"(c) engine O={O_KERNEL} N={N_FULL}: 50 rounds in {eng_s:.3f} s = "
        f"{50 / eng_s:.2f} rounds/s ({50 * O_KERNEL / eng_s:.1f} "
        f"origin-rounds/s), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, mean coverage "
        f"{float(cov.double().mean()):.6f}, launches {engine_launches} "
        f"(threefry: {init_tf} in init_state, {tf_per_round:g} a round)")
    engine_prof = profile_rounds(run_rounds, params, tables, origins,
                                 state, out_dir)
    engine_device = engine_prof["device"]
    # threefry's work now: init_state's draws, profiled once at O=32
    init_prof = profile_rounds(
        lambda prm, tab, orgs, _st, _r: init_state(rng.prng_key(7, dev), tab,
                                                   orgs, prm),
        params, tables, origins, None, out_dir, rounds=1,
        tag=" init_state")
    engine_device["threefry"] = init_prof["device"]["threefry"]
    # push_targets on round 19's inputs, and a device-to-device copy that
    # moves as many bytes (half read, half written), both with a cold L2:
    # the practical floor for that traffic on this card
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    copy_src = torch.zeros(moved["push_targets"] // 2, dtype=torch.uint8,
                           device=dev)
    copy_dst = torch.empty_like(copy_src)
    pt_cold = cold_device_ms(lambda: real["push_targets"](*pt_call[0],
                                                          **pt_call[1]),
                             KERNEL_SYMBOLS["push_targets"], flush)
    copy_cold = cold_device_ms(lambda: copy_dst.copy_(copy_src),
                               ("Memcpy DtoD",), flush)
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    say(f"(c) cold L2 at O={O_KERNEL}: push_targets {fmt(pt_cold)} on "
        f"round 19's inputs ({moved['push_targets']} bytes to move, bound "
        f"{res['push_targets']['bound_ms']:.4f} ms); a device-to-device "
        f"copy moving as many bytes {fmt(copy_cold)}")
    # push_targets' schedules on the same inputs, cold L2, in turns: the
    # one-wave grid with two buffers, and the single pass (a block per
    # tile, one buffer, no load in flight while a tile is scanned)
    with single_pass_schedule(pt_mod):
        exact("push_targets", *pt_call, "(c) single-pass schedule")
    sched = {"one wave": [], "single pass": []}
    for which in ("one wave", "single pass", "single pass", "one wave"):
        with (single_pass_schedule(pt_mod) if which == "single pass"
              else contextlib.nullcontext()):
            sched[which].append(cold_device_ms(
                lambda: real["push_targets"](*pt_call[0], **pt_call[1]),
                KERNEL_SYMBOLS["push_targets"], flush))
    say(f"(c) push_targets schedules, cold L2 at O={O_KERNEL}, in turns "
        f"(one wave, single pass, single pass, one wave): one wave "
        + " and ".join(fmt(v) for v in sched["one wave"])
        + ", single pass (exact vs plain) "
        + " and ".join(fmt(v) for v in sched["single pass"]))
    del flush, copy_src, copy_dst, pt_call
    # the same rounds with kernels routed to their plain versions on the
    # card, as the port made those blocks before the kernels (comparisons
    # only): the draws (rotate's with threefry's plain version, inside
    # rotate_plain), and verbs 1 and 5 (and verb 5's draws)
    for tag, swap in ((" plain draws", ("threefry", "rotate")),
                      (" plain verbs 1 and 5", ("push_targets", "rotate"))):
        for name in swap:
            setattr(kernels, name, plain[name])
        try:
            other = profile_rounds(run_rounds, params, tables, origins,
                                   state, out_dir, tag=tag)
        finally:
            for name in swap:
                setattr(kernels, name, real[name])
        if "busy_ms" in engine_prof and "busy_ms" in other:
            say(f"(c) device busy per round {engine_prof['busy_ms']:.4f} ms "
                f"with the kernels, {other['busy_ms']:.4f} ms with the"
                f"{tag}; launches per round {engine_prof['launches']:.1f} "
                f"against {other['launches']:.1f}; wall per round "
                f"{engine_prof['wall_ms']:.3f} against "
                f"{other['wall_ms']:.3f} ms")
    del state, rows
    torch.cuda.empty_cache()

    # ---- (d) CLI main path at N=10,000 on cuda ---------------------------
    phase("d")
    argv = ["--num-synthetic-nodes", str(N_FULL), "--iterations", "300",
            "--warm-up-rounds", "200", "--device", "cuda"]
    # keep the main path's own kernel inputs of two rounds (every call of
    # the round, found by the round the engine is in): the first round the
    # upsert counters fire, and the last one; and threefry's draws outside
    # the rounds (init_state's)
    check_at = (19, 299)
    main_args = {(name, k): [] for name in names for k in check_at}
    main_args[("threefry", "init")] = []
    in_round = [None]
    real_lane_round = core_mod.lane_round

    def tagged_lane_round(static_, lanes_, tables_, origins_, state_, r,
                          *a, **kw):
        # the round body every runner calls, here one lane: its iteration
        in_round[0] = int(lanes_.its(r)[0])
        try:
            return real_lane_round(static_, lanes_, tables_, origins_,
                                   state_, r, *a, **kw)
        finally:
            in_round[0] = None

    def main_recorder(name):
        def rec(*args, **kw):
            if in_round[0] in check_at:
                main_args[(name, in_round[0])].append((args, kw))
            elif in_round[0] is None and name == "threefry":
                main_args[(name, "init")].append((args, kw))
            return real[name](*args, **kw)
        return rec

    reset_unique_pubkeys()
    core_mod.lane_round = tagged_lane_round
    for name in names:
        setattr(kernels, name, main_recorder(name))
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        coll = cli.simulate(cli.config_from_args(
            cli.build_parser().parse_args(argv)))
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        core_mod.lane_round = real_lane_round
        for name in names:
            setattr(kernels, name, real[name])
    missing = [n for n in names if launches[n] <= 0]
    if missing:
        fail(f"(d) kernels never launched on the main path: {missing}")
    # calls in each captured round: one per kernel, no threefry draw; and
    # init_state's draws: two fold_ins, then a fold_in and a uniform for
    # each of the 64 init draws
    init_draws = 2 + 2 * params.init_draws
    per_round = {("threefry", 19): 0, ("threefry", 299): 0,
                 ("threefry", "init"): init_draws}
    short = [key for key, c in main_args.items()
             if len(c) != per_round.get(key, 1)]
    if short:
        fail(f"(d) expected each kernel's calls in rounds {check_at} and "
             f"init_state, got "
             f"{ {key: len(main_args[key]) for key in short} }")
    if launches["threefry"] != init_draws:
        fail(f"(d) threefry launched {launches['threefry']} times on the "
             f"main path, not only init_state's {init_draws}")
    say(f"(d) threefry launches: {init_draws} in init_state, "
        f"{(launches['threefry'] - init_draws) / 300:g} per round")
    for (name, k), calls in sorted(main_args.items(),
                                     key=lambda kv: str(kv[0])):
        for args, kw in calls:
            exact(name, args, kw, f"(d) the main path's round {k} inputs")
    torch.cuda.synchronize()
    say(f"(d) each kernel exact vs plain on the main path's own inputs of "
        f"rounds {check_at} (O=1, N={N_FULL}, shapes "
        f"{tuple(main_args[('rc_merge_prune', 19)][0][0][0].shape)})")
    main_t = {}
    for name in names:
        calls = main_args[(name, "init" if name == "threefry" else 19)]

        def run_all(calls=calls, fn=real[name]):
            for args, kw in calls:
                fn(*args, **kw)

        main_t[name] = (cuda_ms(run_all, reps=50),
                        device_ms(run_all, KERNEL_SYMBOLS[name], reps=50))
        dev_txt = ("not measured" if main_t[name][1] is None
                   else f"{main_t[name][1]:.4f} ms")
        say(f"(d) {name} on the main path's "
            f"{'init_state' if name == 'threefry' else 'round-19'} inputs "
            f"(O=1, {len(calls)} call(s)): wrapper {main_t[name][0]:.4f} ms, "
            f"device {dev_txt}")
    del main_args
    stats = coll.collection[0]
    cov_mean, rmr_mean = stats.coverage_stats.mean, stats.rmr_stats.mean
    if len(stats.coverage_stats.collection) != 100:
        fail("(d) expected 100 measured rounds")
    if not (0.0 < cov_mean <= 1.0 and math.isfinite(rmr_mean)):
        fail(f"(d) implausible means: coverage {cov_mean}, rmr {rmr_mean}")
    say(f"(d) CLI {' '.join(argv)}: wall {cli_s:.3f} s, coverage mean "
        f"{cov_mean:.6f}, RMR mean {rmr_mean:.6f}, launches {launches}")
    # parts of the main path timed alone, after it: the host-side cluster
    # build, and the engine's 300 rounds for one origin without the harvest
    reset_unique_pubkeys()
    t0 = time.perf_counter()
    accounts, _ = cli.load_cluster_accounts(
        cli.Config(num_synthetic_nodes=N_FULL))
    index = NodeIndex.from_stakes(accounts)
    build_cluster_s = time.perf_counter() - t0
    one = origins[:1]
    t0 = time.perf_counter()
    state = init_state(rng.prng_key(42, dev), tables, one, params)
    state, _ = run_rounds(params, tables, one, state, 300)
    torch.cuda.synchronize()
    engine_300_s = time.perf_counter() - t0
    del state
    init_s = {}
    for what, fn in (("kernel", real["threefry"]),
                     ("plain draws", kernels.threefry_plain),
                     ("kernel again", real["threefry"])):
        kernels.threefry = fn
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            init_state(rng.prng_key(42, dev), tables, one, params)
            torch.cuda.synchronize()
            init_s[what] = time.perf_counter() - t0
        finally:
            kernels.threefry = real["threefry"]
    say(f"(d) parts: cluster build (ChaCha stakes + index) "
        f"{build_cluster_s:.3f} s; engine init + 300 rounds at O=1 "
        f"{engine_300_s:.3f} s; init_state alone at O=1 "
        + ", ".join(f"{k} {v:.4f} s" for k, v in init_s.items()))

    # ---- (e) cuda vs cpu parity at N=2,000, 60 rounds --------------------
    phase("e")
    snaps = {}
    for device in ("cuda", "cpu"):
        reset_unique_pubkeys()
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            ["--num-synthetic-nodes", "2000", "--iterations", "60",
             "--warm-up-rounds", "20", "--device", device]))
        t0 = time.perf_counter()
        c = cli.simulate(cfg)
        snaps[device] = snapshot_strings(c.collection[0].parity_snapshot())
        say(f"(e) N=2000 60 rounds on {device}: "
            f"{time.perf_counter() - t0:.3f} s")
    diff = [k for k in snaps["cuda"] if snaps["cuda"][k] != snaps["cpu"][k]]
    if diff:
        fail(f"(e) cuda and cpu parity snapshots differ in {diff}")
    say("(e) cuda == cpu parity_snapshot at N=2000")

    # ---- (f) all-origins at N=10,000 in origin batches -------------------
    phase("f")
    ao_argv = ["--num-synthetic-nodes", str(N_FULL), "--iterations", "300",
               "--warm-up-rounds", "200", "--all-origins", "--device", "cuda"]
    ao_cfg = cli.config_from_args(cli.build_parser().parse_args(ao_argv))
    ao_idx = np.arange(AO_ORIGINS, dtype=np.int32)
    reset_unique_pubkeys()
    ao_accounts, _ = cli.load_cluster_accounts(ao_cfg)
    ao_runs = {}
    for width in (0, O_WIDE):
        cfg = dataclasses.replace(ao_cfg, origin_batch=width)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        summary = cli.run_all_origins(cfg, accounts=ao_accounts,
                                      origin_indices=ao_idx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ao_runs[width] = (summary, wall, dict(kernels.LAUNCHES),
                          torch.cuda.max_memory_allocated())
    ao, ao_wall, ao_launches, ao_peak = ao_runs[0]
    sizes = [b["n_valid"] for b in ao["batches"]]
    tail = AO_ORIGINS % O_BATCH
    if sizes != [O_BATCH] * (AO_ORIGINS // O_BATCH) + [tail]:
        fail(f"(f) batches of {sizes} valid origins, not the auto batch "
             f"{O_BATCH}")
    if ao["padded_sims"] != O_BATCH - tail:
        fail(f"(f) padded_sims {ao['padded_sims']}, not {O_BATCH - tail}")
    n_batches = len(sizes)
    want = {name: 0 for name in kernels.LAUNCHES}
    want.update({name: n_batches * 300 for name in names})
    want["threefry"] = n_batches * (2 + 2 * params.init_draws)
    if ao_launches != want:
        fail(f"(f) all-origins launches {ao_launches}, expected {want} (every "
             f"kernel each round of each batch, threefry in init_state only)")
    if ao["measured_points"] != AO_ORIGINS * 100 or not (
            0.0 < ao["coverage_mean"] <= 1.0
            and math.isfinite(ao["rmr_mean"])):
        fail(f"(f) implausible aggregate: {ao['measured_points']} measured "
             f"points, coverage {ao['coverage_mean']}, rmr {ao['rmr_mean']}")
    rounds_s = sum(b["rounds_s"] for b in ao["batches"])
    for b in ao["batches"]:
        say(f"(f) batch at origin {b['lo']} ({b['n_valid']} valid of "
            f"{O_BATCH}): init_state {b['init_s']:.4f} s, rounds "
            f"{b['rounds_s']:.4f} s (spans on the stream), host dispatch "
            f"{b['dispatch_s']:.4f} s, harvest waited {b['copy_wait_s']:.6f}"
            f" s for its copy and took {b['harvest_s']:.4f} s")
    say(f"(f) all-origins {' '.join(ao_argv)}, origins 0-{AO_ORIGINS - 1} "
        f"at the auto batch {O_BATCH}: wall {ao_wall:.3f} s, "
        f"{AO_ORIGINS * 300 / rounds_s:.1f} origin-rounds/s (valid origins "
        f"x iterations / rounds spans), padded_sims {ao['padded_sims']}, "
        f"coverage mean {ao['coverage_mean']:.6f}, RMR mean "
        f"{ao['rmr_mean']:.6f}, peak device memory with two batches in "
        f"flight {ao_peak / 2**20:.1f} MiB, launches {ao_launches}")
    wide, wide_wall, wide_launches, wide_peak = ao_runs[O_WIDE]
    wb = wide["batches"]
    # the batch is clamped to the number of origins (reference
    # cli.py:1882-1883): one batch of all 200, none padded
    if [b["n_valid"] for b in wb] != [AO_ORIGINS] or wide["padded_sims"]:
        fail(f"(f) --origin-batch {O_WIDE}: batches {wb}, padded_sims "
             f"{wide['padded_sims']}")
    if any(wide_launches[n] <= 0 for n in names):
        fail(f"(f) --origin-batch {O_WIDE}: a kernel never launched "
             f"({wide_launches})")
    measured = 100
    sd_auto = by_origin(ao["stats"].state_dict(), sizes, measured)
    sd_wide = wide["stats"].state_dict()
    diff = [k for k in sd_wide
            if not np.array_equal(sd_wide[k], sd_auto[k])]
    if diff:
        fail(f"(f) batch {O_BATCH} and batch {O_WIDE} aggregates differ in "
             f"{diff}")
    say(f"(f) the same origins at --origin-batch {O_WIDE} (one batch of "
        f"{AO_ORIGINS}, clamped to the origins): wall {wide_wall:.3f} s, "
        f"init_state {wb[0]['init_s']:.4f} s, rounds {wb[0]['rounds_s']:.4f}"
        f" s = {AO_ORIGINS * 300 / wb[0]['rounds_s']:.1f} origin-rounds/s, "
        f"harvest {wb[0]['harvest_s']:.4f} s, peak device memory "
        f"{wide_peak / 2**20:.1f} MiB; aggregate state_dict equal to batch "
        f"{O_BATCH}'s (per-point chunks in (round, origin) order)")
    full = [b for b in ao["batches"] if b["n_valid"] == O_BATCH]
    per_batch = (sum(b["init_s"] + b["rounds_s"] for b in full)
                 / len(full))
    n_full = math.ceil(N_FULL / O_BATCH)
    say(f"(f) extrapolated, not measured: all {N_FULL} origins x 300 "
        f"iterations at batch {O_BATCH} = {n_full} batches x {per_batch:.3f}"
        f" s (mean init_state + rounds of the full batches above) = "
        f"{n_full * per_batch:.1f} s")
    del ao_runs, wide, sd_auto, sd_wide
    torch.cuda.empty_cache()

    # the 5-round profile at O=64, in a process of its own (its first
    # profiler session: later sessions of a process record no device time)
    prof_run = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), PROFILE_FLAG],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    for line in prof_run.stdout.splitlines()[:-1]:
        print(line, flush=True)
    if prof_run.returncode != 0:
        fail(f"(f) the O={O_BATCH} profile process failed "
             f"(exit {prof_run.returncode}): {prof_run.stderr[-2000:]}")
    ao_prof = json.loads(prof_run.stdout.splitlines()[-1])

    # each kernel on round 19's inputs of the padded tail batch (8 origins
    # and 56 copies of origin 0), and threefry on its init_state's draws
    ao_params = cli.all_origins_params(ao_cfg, N_FULL)
    tail_o = torch.as_tensor(np.concatenate(
        [ao_idx[AO_ORIGINS - tail:], np.zeros(O_BATCH - tail, np.int32)]),
        device=dev)
    rows_t, ao_calls = round19_calls(ao_params, tail_o, names)
    ao_calls["threefry"] = []
    recording(["threefry"], ao_calls, init_state, rng.prng_key(42, dev),
              tables, tail_o, ao_params)
    ao_outs, ao_ms = {}, {}
    for name in names:
        calls = ao_calls[name]
        ao_outs[name] = [exact(name, args, kw, "(f) tail batch")
                         for args, kw in calls]

        def run_all(calls=calls, fn=real[name]):
            for args, kw in calls:
                fn(*args, **kw)

        ao_ms[name] = cuda_ms(run_all)
    ao_moved, ao_blocks, _, ao_rot = kernel_work(ao_calls, ao_outs, tf_mod,
                                                 rot_mod)
    ao_bound = {name: bound(ao_moved[name], ao_blocks[name],
                            tf_ops.get(name))[0] for name in names}
    say(f"(f) each kernel exact vs plain on round 19's inputs of the padded "
        f"tail batch (O={O_BATCH}, {tail} origins and {O_BATCH - tail} "
        f"copies of origin 0; threefry on its init_state's "
        f"{len(ao_calls['threefry'])} draws; {ao_rot} rows rotate): "
        + ", ".join(f"{n} {ao_ms[n]:.4f} ms (bound {ao_bound[n]:.4f})"
                    for n in names)
        + f"; prunes {int(rows_t['prunes_sent'].sum())}")
    del ao_calls, ao_outs, rows_t
    torch.cuda.empty_cache()

    # cuda == cpu: every sixth origin of a 500-node cluster at the auto
    # batch (a full batch and a padded tail)
    small = {}
    for device in ("cuda", "cpu"):
        reset_unique_pubkeys()
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            ["--num-synthetic-nodes", str(N_SMALL), "--iterations", "30",
             "--warm-up-rounds", "10", "--all-origins", "--device", device]))
        t0 = time.perf_counter()
        small[device] = cli.run_all_origins(
            cfg, origin_indices=np.arange(0, N_SMALL, SMALL_STRIDE,
                                          dtype=np.int32))
        say(f"(f) all-origins N={N_SMALL}, origins 0, {SMALL_STRIDE}, ..., "
            f"{len(range(0, N_SMALL, SMALL_STRIDE)) * SMALL_STRIDE - SMALL_STRIDE}"
            f", 30 rounds on {device}: "
            f"{time.perf_counter() - t0:.3f} s")
    sizes = [b["n_valid"] for b in small["cuda"]["batches"]]
    n_small = len(range(0, N_SMALL, SMALL_STRIDE))
    if sizes != [O_BATCH, n_small - O_BATCH] or (
            small["cuda"]["padded_sims"] != 2 * O_BATCH - n_small):
        fail(f"(f) N={N_SMALL}: batches of {sizes} valid origins")
    sd = {d: small[d]["stats"].state_dict() for d in small}
    diff = [k for k in sd["cuda"] if not np.array_equal(sd["cuda"][k],
                                                        sd["cpu"][k])]
    skip = ("elapsed_s", "origin_iters_per_sec", "stats", "batches")
    diff += [k for k in small["cuda"]
             if k not in skip and small["cuda"][k] != small["cpu"][k]]
    if (as_builtins(small["cuda"]["stats"])
            != as_builtins(small["cpu"]["stats"])):
        diff.append("finalized stats")
    if diff:
        fail(f"(f) all-origins cuda and cpu differ in {diff}")
    say(f"(f) cuda == cpu all-origins at N={N_SMALL} (batches {sizes}): "
        f"aggregate state_dict, finalized stats and summary equal")

    # ---- (g) the experiment harness at N=10,000 on cuda ----------------
    phase("g")
    t_g = time.perf_counter()
    drv_argv = ["--num-synthetic-nodes", str(N_FULL), "--iterations", "300",
                "--warm-up-rounds", "200", "--device", "cuda"]
    points = []
    real_run_simulation = cli.run_simulation

    def timed_run_simulation(config, url, collection, *a, **kw):
        """cli.run_simulation, its wall and its stats kept in ``points``."""
        t0 = time.perf_counter()
        real_run_simulation(config, url, collection, *a, **kw)
        torch.cuda.synchronize()
        points.append((config, time.perf_counter() - t0,
                       collection.collection[-1]))

    def counted(what, fn, *args, **kw):
        """``fn(*args)`` with the launch counts set to 0 just before it and
        read just after; every kernel must have launched."""
        kernels.reset_launch_counts()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        got = dict(kernels.LAUNCHES)
        if any(got[n] <= 0 for n in names):
            fail(f"(g) {what}: a kernel never launched ({got})")
        return out, got

    sweeps = {}
    cli.run_simulation = timed_run_simulation
    try:
        for tt, n_sims, step, field in (
                ("active-set-size", 4, 4, "gossip_active_set_size"),
                ("push-fanout", 3, 3, "gossip_push_fanout")):
            points.clear()
            reset_unique_pubkeys()
            argv = drv_argv + ["--test-type", tt, "--num-simulations",
                               str(n_sims), "--step-size", str(step),
                               "--print-stats"]
            t0 = time.perf_counter()
            rc, got = counted(tt, cli.main, argv)
            wall = time.perf_counter() - t0
            if rc != 0 or len(points) != n_sims:
                fail(f"(g) {tt} sweep: exit {rc}, {len(points)} points")
            for cfg_, w, st in points:
                cov, rmr = st.coverage_stats.mean, st.rmr_stats.mean
                if (len(st.coverage_stats.collection) != 100
                        or not 0.0 < cov <= 1.0 or not math.isfinite(rmr)):
                    fail(f"(g) {tt} point {getattr(cfg_, field)}: "
                         f"implausible coverage {cov}, rmr {rmr}")
                say(f"(g) {tt} sweep point S={cfg_.gossip_active_set_size} "
                    f"F={cfg_.gossip_push_fanout}: wall {w:.3f} s (cluster "
                    f"build included), coverage mean {cov:.6f}, RMR mean "
                    f"{rmr:.6f}")
            say(f"(g) {' '.join(argv)}: exit 0, wall {wall:.3f} s, "
                f"launches {got}")
            sweeps[tt] = list(points)
    finally:
        cli.run_simulation = real_run_simulation
    if [c.gossip_active_set_size for c, _, _ in sweeps["active-set-size"]] \
            != [12, 16, 20, 24] or [
                c.gossip_push_fanout for c, _, _ in sweeps["push-fanout"]] \
            != [6, 9, 12]:
        fail("(g) the sweeps did not step S to 12-24 and F to 6-12")

    # every kernel against its plain version on round 19's inputs at the
    # widest shapes of the sweeps, O=16 (threefry on init_state's draws),
    # timed with CUDA events, beside its device time from a profile in a
    # process of its own and its bound
    wide_run = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), WIDE_FLAG],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    for line in wide_run.stdout.splitlines()[:-1]:
        print(line, flush=True)
    if wide_run.returncode != 0:
        fail(f"(g) the wide-shape profile process failed (exit "
             f"{wide_run.returncode}): {wide_run.stderr[-2000:]}")
    wide_dev = json.loads(wide_run.stdout.splitlines()[-1])
    wide = {name: {} for name in names}
    top16 = origins[:O_RANKS]
    for s_, f_ in WIDE_SHAPES:
        prm = EngineParams(num_nodes=N_FULL, warm_up_rounds=0,
                           active_set_size=s_, push_fanout=f_)
        rows_w, w_calls = round19_calls(prm, top16, names)
        w_calls["threefry"] = []
        recording(["threefry"], w_calls, init_state, rng.prng_key(42, dev),
                  tables, top16, prm)
        w_outs, w_ms = {}, {}
        for name in names:
            calls = w_calls[name]
            w_outs[name] = [exact(name, args, kw,
                                  f"(g) S={s_} F={f_} O={O_RANKS}")
                            for args, kw in calls]

            def run_all(calls=calls, fn=real[name]):
                for args, kw in calls:
                    fn(*args, **kw)

            w_ms[name] = cuda_ms(run_all)
        if w_calls["rank_inbound"][0][0][4] != max(16, 2 * f_):
            fail(f"(g) S={s_} F={f_}: rank_inbound's K is not "
                 f"{max(16, 2 * f_)}")
        w_moved, w_blocks, _, _ = kernel_work(w_calls, w_outs, tf_mod,
                                              rot_mod)
        key = f"S={s_} F={f_}"
        for n in names:
            wide[n][key] = {
                "ms": w_ms[n], "device_ms": wide_dev[key][n],
                "bound_ms": bound(w_moved[n], w_blocks[n], tf_ops.get(n))[0]}
        say(f"(g) each kernel exact vs plain on round 19's inputs at S={s_} "
            f"F={f_} (K={max(16, 2 * f_)}) O={O_RANKS} N={N_FULL} (threefry "
            f"on init_state's {len(w_calls['threefry'])} draws); kernel ms "
            f"(CUDA events) / device ms (profile of rounds 19-23, per round; "
            f"threefry per init_state) / bound ms: " + ", ".join(
                f"{n} {w_ms[n]:.4f} / "
                + ("not measured" if wide[n][key]["device_ms"] is None
                   else f"{wide[n][key]['device_ms']:.4f}")
                + " / "
                f"{wide[n][key]['bound_ms']:.4f}" for n in names)
            + f"; prunes {int(rows_w['prunes_sent'].sum())}")
        del w_calls, w_outs, rows_w
    torch.cuda.empty_cache()

    # the batched origin-rank sweep (O=16) through cli.main, then ranks 1
    # and 16 alone
    rank_runs = []
    real_rank_sweep = cli.run_origin_rank_sweep

    def kept_rank_sweep(config, url, ranks, collection, *a, **kw):
        """cli.run_origin_rank_sweep, its walls and its stats kept."""
        walls = real_rank_sweep(config, url, ranks, collection, *a, **kw)
        rank_runs.append((walls, collection))
        return walls

    rank_argv = drv_argv + ["--test-type", "origin-rank", "--num-simulations",
                            str(O_RANKS), "--print-stats", "--origin-rank",
                            *map(str, range(1, O_RANKS + 1))]
    reset_unique_pubkeys()
    cli.run_origin_rank_sweep = kept_rank_sweep
    try:
        t0 = time.perf_counter()
        rc, rank_launches = counted("origin-rank sweep", cli.main, rank_argv)
        rank_wall = time.perf_counter() - t0
    finally:
        cli.run_origin_rank_sweep = real_rank_sweep
    if rc != 0 or len(rank_runs) != 1:
        fail(f"(g) origin-rank sweep: exit {rc}, {len(rank_runs)} batched "
             f"runs")
    walls, rank_coll = rank_runs[0]
    if len(rank_coll.collection) != O_RANKS:
        fail(f"(g) origin-rank sweep: {len(rank_coll.collection)} sims")
    say(f"(g) {' '.join(rank_argv)}: exit 0, wall {rank_wall:.3f} s, batched "
        f"(O={O_RANKS}): engine {walls['engine_s']:.3f} s (init_state + 300 "
        f"rounds until their rows are on the host), harvest "
        f"{walls['harvest_s']:.3f} s (stats and finalize of {O_RANKS} "
        f"columns x 100 measured rounds), launches {rank_launches}")
    for col, rank in ((0, 1), (O_RANKS - 1, O_RANKS)):
        reset_unique_pubkeys()
        t0 = time.perf_counter()
        one = cli.simulate(cli.config_from_args(cli.build_parser().parse_args(
            drv_argv + ["--origin-rank", str(rank)])))
        alone = snapshot_strings(one.collection[0].parity_snapshot())
        diff = [k for k, v in snapshot_strings(
            rank_coll.collection[col].parity_snapshot()).items()
            if alone[k] != v]
        if diff:
            fail(f"(g) batched column {col} differs from rank {rank} run "
                 f"alone in {diff}")
        say(f"(g) rank {rank} alone: wall {time.perf_counter() - t0:.3f} s; "
            f"parity_snapshot equal to the batched column {col}")
    del rank_runs, rank_coll

    # the 10,000-node cluster as an account file, written and read with
    # PyYAML hidden (the port's own writer and reader; where PyYAML is
    # installed, its file must have the same bytes), and a run from it
    # through cli.main
    reset_unique_pubkeys()
    accounts, _ = cli.load_cluster_accounts(
        cli.Config(num_synthetic_nodes=N_FULL))
    acct_path = out_dir / "accounts_10k.yaml"
    has_yaml = importlib.util.find_spec("yaml") is not None
    if has_yaml:
        write_accounts_yaml(str(acct_path), accounts)
        pyyaml_bytes = acct_path.read_bytes()
    hidden = sys.modules.get("yaml", False)
    sys.modules["yaml"] = None                  # `import yaml` now fails
    try:
        write_accounts_yaml(str(acct_path), accounts)
        if has_yaml and acct_path.read_bytes() != pyyaml_bytes:
            fail("(g) the port's account-file writer and PyYAML's differ")
        points.clear()
        cli.run_simulation = timed_run_simulation
        t0 = time.perf_counter()
        rc, acct_launches = counted(
            "account-file run", cli.main,
            drv_argv[2:] + ["--account-file", str(acct_path),
                            "--accounts-from-yaml"])
        acct_wall = time.perf_counter() - t0
    finally:
        cli.run_simulation = real_run_simulation
        if hidden is False:
            del sys.modules["yaml"]
        else:
            sys.modules["yaml"] = hidden
    if rc != 0 or len(points) != 1:
        fail(f"(g) account-file run: exit {rc}, {len(points)} simulations")
    synth = sweeps["active-set-size"][0][2]       # S=12: the default run
    got = snapshot_strings(points[0][2].parity_snapshot())
    diff = [k for k, v in snapshot_strings(synth.parity_snapshot()).items()
            if got[k] != v]
    if diff:
        fail(f"(g) the account-file run differs from the synthetic run in "
             f"{diff}")
    say(f"(g) account file {acct_path.name} ({acct_path.stat().st_size} "
        f"bytes; PyYAML {'installed' if has_yaml else 'not installed'} and "
        f"hidden: the port's own writer"
        f"{', bytes equal to PyYAML' if has_yaml else ''} and reader): "
        f"cli.main from it in {acct_wall:.3f} s, parity_snapshot equal to "
        f"the synthetic run; launches {acct_launches}")

    # Influx: a prune-stake-threshold sweep at N=500 on cuda and on cpu
    inf_lines, inf_points = {}, {}
    for device in ("cuda", "cpu"):
        reset_unique_pubkeys()
        a = cli.build_parser().parse_args(
            ["--num-synthetic-nodes", str(N_SMALL), "--iterations", "30",
             "--warm-up-rounds", "10", "--test-type",
             "prune-stake-threshold", "--num-simulations", "3",
             "--step-size", "0.05", "--device", device])
        q = DatapointQueue()
        t0 = time.perf_counter()
        cli.dispatch_sweeps(cli.config_from_args(a), "", a.origin_rank,
                            cli.GossipStatsCollection(), q, "1")
        pts = []
        while len(q):
            pts.append(q.pop_front())
        inf_points[device] = pts
        inf_lines[device] = deterministic_wire_lines(
            [ln for p in pts for ln in p.data().splitlines()])
        say(f"(g) prune-stake-threshold sweep N={N_SMALL}, 3 points x 30 "
            f"rounds on {device}: {time.perf_counter() - t0:.3f} s, "
            f"{len(pts)} points, {len(inf_lines[device])} deterministic "
            f"lines")
    if inf_lines["cuda"] != inf_lines["cpu"] or not inf_lines["cuda"]:
        fail("(g) cuda and cpu deterministic Influx lines differ")
    received = []

    class Capture(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            received.append(self.rfile.read(
                int(self.headers.get("Content-Length", 0))).decode())
            self.send_response(204)
            self.end_headers()

        def log_message(self, *a):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Capture)
    srv = threading.Thread(target=server.serve_forever, daemon=True)
    srv.start()
    try:
        q = DatapointQueue()
        for p in inf_points["cuda"]:
            q.push_back(p)
        end = InfluxDataPoint()
        end.set_last_datapoint()
        q.push_back(end)
        sender = InfluxThread.spawn(
            f"http://127.0.0.1:{server.server_address[1]}", "u", "p",
            "gossip", q)
        sender.join(timeout=120)
        if sender.is_alive():
            fail("(g) the Influx sender did not drain")
    finally:
        server.shutdown()
        server.server_close()
        srv.join(timeout=10)
    sent = [p.data() for p in inf_points["cuda"] if not p.is_start()]
    st = sender.sender_stats()
    if (sender.tracker.dequeued != sender.tracker.sent
            or st["dropped_points"] or received != sent):
        fail(f"(g) Influx sender: dequeued {sender.tracker.dequeued}, sent "
             f"{sender.tracker.sent}, {st}, {len(received)} of {len(sent)} "
             f"points received in order")
    say(f"(g) cuda == cpu deterministic Influx lines "
        f"({len(inf_lines['cuda'])}); InfluxThread to 127.0.0.1: dequeued "
        f"{sender.tracker.dequeued} == sent {sender.tracker.sent}, "
        f"{st['points_sent']} acknowledged in order, 0 dropped")
    say(f"(g) experiment harness phase: {time.perf_counter() - t_g:.1f} s")

    # ---- (h) pull, push-pull and adaptive at N=10,000 on cuda -----------
    phase("h")
    t_h = time.perf_counter()
    PX = "pull_exchange"
    top_all = np.argsort(-stakes_np, kind="stable").astype(np.int32)
    pull_res, pull_case_calls = {}, {}
    for case, (o, prm) in pull_cases(EngineParams).items():
        orgs = torch.as_tensor(top_all[:o], device=dev)
        rows_p, calls = round19_calls(prm, orgs,
                                      [PX, "push_targets", "prune_apply"])
        if len(calls[PX]) != 1 or len(calls["push_targets"]) != 1:
            fail(f"(h) {case}: round 19 called pull_exchange "
                 f"{len(calls[PX])} times")
        exact("prune_apply", *calls["prune_apply"][0], f"(h) {case}")
        args, kw = calls[PX][0]
        got = exact(PX, args, kw, f"(h) {case}")
        if case == "pull":
            pt_args, pt_kw = calls["push_targets"][0]
            if pt_kw.get("push_on", True):
                fail("(h) pull mode: push_targets was called with push_on")
            tgt_p = exact("push_targets", pt_args, pt_kw, "(h) pull mode")[0]
            if bool((tgt_p < N_FULL).any()):
                fail("(h) pull mode: push_targets sent a push")
        if case == "adaptive" and not bool(args[8].any()):
            fail("(h) adaptive: no origin's bit is on at round 19")
        counts = got.counts.sum(0).tolist()
        pull_res[case] = dict(
            o=o, counts=counts,
            ms=cuda_ms(lambda: real[PX](*args, **kw), reps=20),
            plain_ms=cuda_ms(lambda: plain[PX](*args, **kw), reps=3, warm=1),
            bytes=pull_bytes(args, kw, got))
        pull_res[case]["bound_ms"] = bound(pull_res[case]["bytes"], 0,
                                           None)[0]
        g = px_mod.geometry_for(o, N_FULL, int(np.max(kw["fanout"])),
                                int(np.max(kw["cap"])), dev)
        pull_res[case]["geometry"] = g._asdict()
        pull_case_calls[case] = (args, kw)
        say(f"(h) {case}: pull_exchange geometry {pull_geometry(g, px_mod)}")
        say(f"(h) {case} (O={o}, N={N_FULL}), round 19: pull_exchange (and "
            f"prune_apply) exact vs plain; kernel "
            f"{pull_res[case]['ms']:.4f} ms, plain "
            f"{pull_res[case]['plain_ms']:.4f} ms, bound "
            f"{pull_res[case]['bound_ms']:.4f} ms ({pull_res[case]['bytes']}"
            f" bytes); requests, responses, misses, dropped, suppressed, "
            f"rescued {counts}; coverage mean "
            f"{float(rows_p['coverage'].double().mean()):.6f}")
    cap0 = pull_res["push-pull impaired cap 0"]["counts"]
    cap2 = pull_res["push-pull impaired cap 2"]["counts"]
    if not cap2[1] < cap0[1]:
        fail(f"(h) the request cap 2 served as many responses as no cap "
             f"({cap2[1]} and {cap0[1]})")
    # the PyTorch yardstick: the sort that ranks the requests per peer
    # (the plain version's), of the packed (peer, flat) keys of the main
    # case's [O, N * PS] requests
    args, kw = pull_case_calls["push-pull impaired cap 0"]
    peers = px_mod.pull_peers_plain(
        N_FULL, kw["slots"], *(int(np.ravel(b)[0]) for b in kw["bases"][:2]),
        *args[4:8])
    packed_req = ((peers.reshape(1, -1).long() << 32)
                  | torch.arange(peers.numel(), device=dev)).expand(
                      O_PULL, -1).contiguous()
    pull_library_ms = cuda_ms(lambda: torch.sort(packed_req, dim=1))
    del peers, packed_req, pull_case_calls, calls, args, got
    torch.cuda.empty_cache()
    pull_prof_run = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), PULL_FLAG],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    for line in pull_prof_run.stdout.splitlines()[:-1]:
        print(line, flush=True)
    if pull_prof_run.returncode != 0:
        fail(f"(h) the pull profile process failed (exit "
             f"{pull_prof_run.returncode}): {pull_prof_run.stderr[-2000:]}")
    pull_dev = json.loads(pull_prof_run.stdout.splitlines()[-1])
    say("(h) pull_exchange device ms (profile, per call) / CUDA-event ms / "
        "bound ms: " + "; ".join(
            f"{c} {fmt(pull_dev[c])} / {r['ms']:.4f} / {r['bound_ms']:.4f}"
            for c, r in pull_res.items())
        + f"; library (torch.sort of the packed (peer, flat) request keys, "
        f"[{O_PULL}, {N_FULL * 8}] int64) {pull_library_ms:.4f} ms")
    pp_prof = pull_dev["profile"]
    if "launches" in pp_prof and "launches" in engine_prof:
        say(f"(h) push-pull round at O={O_KERNEL}: "
            f"{pp_prof['launches']:.1f} device launches a round against "
            f"push's {engine_prof['launches']:.1f} ((c)); busy "
            f"{pp_prof['busy_ms']:.4f} ms against {engine_prof['busy_ms']:.4f}"
            f" ms; wall {pp_prof['wall_ms']:.3f} against "
            f"{engine_prof['wall_ms']:.3f} ms")

    # the single-origin CLI in each mode, in turns, with the launch counts
    # of each run; the push-pull run is this slice's main path
    mode_argv = {
        "push-pull": ["--gossip-mode", "push-pull", "--packet-loss-rate",
                      "0.1"],
        "adaptive": ["--gossip-mode", "adaptive"],
        "push": [],
    }
    cli_runs = {}
    for mode in ("push-pull", "adaptive", "push"):
        argv_m = drv_argv + mode_argv[mode]
        reset_unique_pubkeys()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        coll_m = cli.simulate(cli.config_from_args(
            cli.build_parser().parse_args(argv_m)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(kernels.LAUNCHES)
        want_px = 0 if mode == "push" else 300
        if any(got[n] <= 0 for n in names) or got[PX] != want_px:
            fail(f"(h) CLI {mode}: launches {got} (pull_exchange should be "
                 f"{want_px})")
        st = coll_m.collection[0]
        cov, rmr = st.coverage_stats.mean, st.rmr_stats.mean
        if (len(st.coverage_stats.collection) != 100
                or not 0.0 < cov <= 1.0 or not math.isfinite(rmr)):
            fail(f"(h) CLI {mode}: implausible coverage {cov}, rmr {rmr}")
        pulls = ""
        if mode != "push":
            pulls = ", pull means: " + ", ".join(
                f"{k} {getattr(st, f'pull_{k}_stats').mean:.3f}"
                for k in ("requests", "responses", "misses", "dropped",
                          "suppressed", "rescued"))
            if st.pull_requests_stats.mean <= 0:
                fail(f"(h) CLI {mode}: no pull request arrived")
        if mode == "adaptive":
            pulls += (f", rounds with the pull phase on "
                      f"{sum(st.adaptive_active_series)}, switches "
                      f"{sum(st.adaptive_switched_series)}")
        prev = cli_runs.get(mode)
        if prev is not None and (prev["coverage"], prev["rmr"]) != (cov, rmr):
            fail(f"(h) CLI {mode}: a second run gave other means")
        cli_runs.setdefault(mode, {"coverage": cov, "rmr": rmr, "walls": [],
                                   "launches": got})
        cli_runs[mode]["walls"].append(wall)
        say(f"(h) CLI {' '.join(argv_m)}: wall {wall:.3f} s, coverage mean "
            f"{cov:.6f}, RMR mean {rmr:.6f}{pulls}; launches {got}")
    say("(h) CLI wall (push-pull, adaptive, push): "
        + "; ".join(f"{m} " + ", ".join(f"{w:.3f}" for w in r["walls"])
                    + " s" for m, r in cli_runs.items()))
    # cuda == cpu at N=2,000 in each pull mode: snapshots and Influx lines
    for mode in ("push-pull", "adaptive"):
        snaps, lines = {}, {}
        for device in ("cuda", "cpu"):
            reset_unique_pubkeys()
            a = cli.build_parser().parse_args(
                ["--num-synthetic-nodes", "2000", "--iterations", "40",
                 "--warm-up-rounds", "20", "--device", device]
                + mode_argv[mode])
            q = DatapointQueue()
            c = cli.GossipStatsCollection()
            t0 = time.perf_counter()
            cli.dispatch_sweeps(cli.config_from_args(a), "", a.origin_rank,
                                c, q, "1")
            snaps[device] = snapshot_strings(c.collection[0].parity_snapshot())
            lines[device] = q.drain_deterministic_lines()
            say(f"(h) {mode} N=2000 40 rounds on {device}: "
                f"{time.perf_counter() - t0:.3f} s")
        diff = [k for k in snaps["cuda"] if snaps["cuda"][k] != snaps["cpu"][k]]
        series = "sim_adaptive," if mode == "adaptive" else "sim_pull,"
        if diff or lines["cuda"] != lines["cpu"] or not any(
                ln.startswith(series) for ln in lines["cuda"]):
            fail(f"(h) {mode}: cuda and cpu differ (snapshot {diff}, lines "
                 f"equal {lines['cuda'] == lines['cpu']})")
        say(f"(h) {mode}: cuda == cpu parity_snapshot and "
            f"{len(lines['cuda'])} deterministic Influx lines at N=2000")

    # all-origins in push-pull: origins 0-199 at the auto batch of 64
    pp_cfg = dataclasses.replace(ao_cfg, gossip_mode="push-pull")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    pp_ao = cli.run_all_origins(pp_cfg, accounts=ao_accounts,
                                origin_indices=ao_idx)
    torch.cuda.synchronize()
    pp_wall = time.perf_counter() - t0
    pp_launches = dict(kernels.LAUNCHES)
    pp_peak = torch.cuda.max_memory_allocated()
    n_b = len(pp_ao["batches"])
    if (pp_launches[PX] != n_b * 300 or any(pp_launches[n] <= 0
                                             for n in names)
            or pp_ao["pull_requests"] <= 0):
        fail(f"(h) all-origins push-pull: launches {pp_launches}, "
             f"pull requests {pp_ao.get('pull_requests')}")
    pp_rounds_s = sum(b["rounds_s"] for b in pp_ao["batches"])
    say(f"(h) all-origins push-pull, origins 0-{AO_ORIGINS - 1} at the auto "
        f"batch {O_BATCH}: wall {pp_wall:.3f} s, "
        f"{AO_ORIGINS * 300 / pp_rounds_s:.1f} origin-rounds/s (push, (f): "
        f"{AO_ORIGINS * 300 / rounds_s:.1f}), peak device memory "
        f"{pp_peak / 2**20:.1f} MiB, coverage mean "
        f"{pp_ao['coverage_mean']:.6f}, pull requests "
        f"{pp_ao['pull_requests']}, rescued {pp_ao['pull_rescued']}; "
        f"launches {pp_launches}")
    # the same origins in one batch (the batch is clamped to the 200)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    pp_wide = cli.run_all_origins(
        dataclasses.replace(pp_cfg, origin_batch=O_WIDE),
        accounts=ao_accounts, origin_indices=ao_idx)
    torch.cuda.synchronize()
    pp_wide_wall = time.perf_counter() - t0
    pp_wide_launches = dict(kernels.LAUNCHES)
    pp_wide_peak = torch.cuda.max_memory_allocated()
    pwb = pp_wide["batches"]
    if ([b["n_valid"] for b in pwb] != [AO_ORIGINS]
            or pp_wide_launches[PX] != 300
            or any(pp_wide_launches[n] <= 0 for n in names)):
        fail(f"(h) all-origins push-pull at --origin-batch {O_WIDE}: "
             f"batches {[b['n_valid'] for b in pwb]}, launches "
             f"{pp_wide_launches}")
    sd_auto = by_origin(pp_ao["stats"].state_dict(),
                        [b["n_valid"] for b in pp_ao["batches"]], 100)
    sd_wide = pp_wide["stats"].state_dict()
    diff = [k for k in sd_wide if not np.array_equal(sd_wide[k], sd_auto[k])]
    if diff:
        fail(f"(h) all-origins push-pull: batch {O_BATCH} and batch "
             f"{O_WIDE} aggregates differ in {diff}")
    pp_wide_rounds_s = AO_ORIGINS * 300 / pwb[0]["rounds_s"]
    say(f"(h) all-origins push-pull, the same origins at --origin-batch "
        f"{O_WIDE} (one batch of {AO_ORIGINS}): wall {pp_wide_wall:.3f} s, "
        f"init_state {pwb[0]['init_s']:.4f} s, rounds "
        f"{pwb[0]['rounds_s']:.4f} s = {pp_wide_rounds_s:.1f} "
        f"origin-rounds/s, peak device memory {pp_wide_peak / 2**20:.1f} "
        f"MiB; aggregate state_dict equal to batch {O_BATCH}'s; launches "
        f"{pp_wide_launches}")
    small_pp = {}
    for device in ("cuda", "cpu"):
        reset_unique_pubkeys()
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            ["--num-synthetic-nodes", str(N_SMALL), "--iterations", "30",
             "--warm-up-rounds", "10", "--all-origins", "--device", device,
             "--gossip-mode", "push-pull", "--packet-loss-rate", "0.1"]))
        q = DatapointQueue()
        t0 = time.perf_counter()
        small_pp[device] = (cli.run_all_origins(
            cfg, dp_queue=q, start_ts="1",
            origin_indices=np.arange(0, N_SMALL, SMALL_STRIDE,
                                     dtype=np.int32)),
            q.drain_deterministic_lines())
        say(f"(h) all-origins push-pull N={N_SMALL}, every "
            f"{SMALL_STRIDE}th origin, 30 rounds on {device}: "
            f"{time.perf_counter() - t0:.3f} s")
    (s_cuda, l_cuda), (s_cpu, l_cpu) = small_pp["cuda"], small_pp["cpu"]
    sd_c, sd_p = s_cuda["stats"].state_dict(), s_cpu["stats"].state_dict()
    diff = [k for k in sd_c if not np.array_equal(sd_c[k], sd_p[k])]
    diff += [k for k in s_cuda if k not in skip and s_cuda[k] != s_cpu[k]]
    if as_builtins(s_cuda["stats"]) != as_builtins(s_cpu["stats"]):
        diff.append("finalized stats")
    if l_cuda != l_cpu:
        diff.append("Influx lines")
    if diff:
        fail(f"(h) all-origins push-pull cuda and cpu differ in {diff}")
    say(f"(h) cuda == cpu all-origins push-pull at N={N_SMALL}: aggregate "
        f"state_dict, finalized stats, summary (pull_* keys: "
        f"{ {k: v for k, v in s_cuda.items() if k.startswith('pull_')} }) "
        f"and {len(l_cuda)} Influx lines equal")

    # the two pull sweeps through cli.main, each point's wall
    pull_sweeps = {}
    cli.run_simulation = timed_run_simulation
    try:
        for tt, extra, field, want_vals in (
                ("pull-fanout", ["--gossip-mode", "push-pull",
                                 "--packet-loss-rate", "0.1",
                                 "--pull-fanout", "2", "--step-size", "3"],
                 "pull_fanout", [2, 5, 8]),
                ("adaptive-threshold", ["--gossip-mode", "adaptive",
                                        "--adaptive-switch-threshold", "0.5",
                                        "--step-size", "0.2"],
                 "adaptive_switch_threshold", [0.5, 0.7, 0.9])):
            points.clear()
            reset_unique_pubkeys()
            argv_s = drv_argv + extra + ["--test-type", tt,
                                         "--num-simulations", "3"]
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main(argv_s)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = dict(kernels.LAUNCHES)
            vals = [getattr(c, field) for c, _, _ in points]
            if (rc != 0 or len(points) != 3 or got[PX] != 3 * 300
                    or any(got[n] <= 0 for n in names)
                    or [round(v, 9) for v in vals] != want_vals):
                fail(f"(h) {tt} sweep: exit {rc}, points {vals}, launches "
                     f"{got}")
            for cfg_, w, st in points:
                say(f"(h) {tt} point {getattr(cfg_, field):g}: wall {w:.3f} s"
                    f" (cluster build included), coverage mean "
                    f"{st.coverage_stats.mean:.6f}, RMR mean "
                    f"{st.rmr_stats.mean:.6f}, pull requests mean "
                    f"{st.pull_requests_stats.mean:.3f}, rescued mean "
                    f"{st.pull_rescued_stats.mean:.3f}")
            say(f"(h) {' '.join(argv_s)}: exit 0, wall {wall:.3f} s, "
                f"launches {got}")
            pull_sweeps[tt] = wall
    finally:
        cli.run_simulation = real_run_simulation
    say(f"(h) pull modes phase: {time.perf_counter() - t_h:.1f} s")

    # ---- (i) the traffic engine at N=10,000, M=256 on cuda --------------
    phase("i")
    t_i = time.perf_counter()
    from gossip_sim_tpu_torch.engine.traffic import device_traffic_tables
    from gossip_sim_tpu_torch.stats.traffic import TrafficStatsCollection
    ttables = device_traffic_tables(stakes_np, dev)
    traffic_res = {}
    for case in ("uncapped", "capped"):
        prm = traffic_params(EngineParams, case)
        _, rows_t, calls = traffic_round19(kernels, prm, tables, ttables,
                                           stakes_np, dev)
        torch.cuda.synchronize()
        if any(len(calls[n]) != 1 for n in TRAFFIC_KERNELS):
            fail(f"(i) {case}: round 19 called the traffic kernels "
                 f"{ {n: len(c) for n, c in calls.items()} } times")
        send_args = calls["traffic_send"][0][0]
        res_c = {}
        for name in TRAFFIC_KERNELS:
            args, kw = calls[name][0]
            got = exact(name, args, kw, f"(i) {case}")
            moved = traffic_bytes(name, args, kw, got)
            res_c[name] = dict(
                ms=cuda_ms(lambda: real[name](*args, **kw), reps=10),
                plain_ms=cuda_ms(lambda: plain[name](*args, **kw), reps=2,
                                 warm=1),
                bytes=moved, bound_ms=bound(moved, 0, None)[0],
                shapes=[tuple(a.shape) for a in args if torch.is_tensor(a)])
            if name == "traffic_send":
                send_out = got
            del got
        # the cut at its two ends: an ingress cap of 1, and one above
        # every target's arrivals
        a_args, a_kw = calls["traffic_admit"][0]
        top = int(plain["traffic_admit"](*a_args, **a_kw).arrived_node.max())
        for cap in (1, top + 1):
            exact("traffic_admit", a_args[:4] + (cap,), a_kw,
                  f"(i) {case}, ingress cap {cap}")
        say(f"(i) {case}: traffic_admit exact vs plain at ingress caps 1 and "
            f"{top + 1} (one above the largest arrivals at a target)")
        # traffic_send's egress count across its value chunks: a cap of 1,
        # and one that a sender's running count crosses inside the first
        # row of a later 32-value chunk
        s_kw = calls["traffic_send"][0][1]
        cw = send_out.cand_bits.T.long() & 0xFFFFFFFF
        counts = ((cw[..., None] >> torch.arange(32, device=dev)) & 1).sum(-1)
        row = next(v for v in range(32, counts.shape[0], 32)
                   if bool((counts[v] > 1).any()))
        before = counts[:row].sum(0)
        sender = int(torch.argmax(torch.where(counts[row] > 1, before, -1)))
        for cap in (1, int(before[sender]) + 1):
            exact("traffic_send", send_args[:9] + (cap,), s_kw,
                  f"(i) {case}, egress cap {cap}")
        say(f"(i) {case}: traffic_send exact vs plain at egress caps 1 and "
            f"{int(before[sender]) + 1} (sender {sender}'s count crosses it "
            f"in value {row}, the first of a chunk)")
        del cw, counts, before
        # the PyTorch yardsticks (timed here, used nowhere in the port)
        peer, code = send_out.peer, send_out.code
        V_, N_, F_ = peer.shape
        L = V_ * N_ * F_
        adm_keys = (torch.where(code == 1, peer, N_).reshape(-1).long() * L
                    + torch.arange(L, device=dev))
        res_c["traffic_admit"]["library_ms"] = cuda_ms(
            lambda: torch.sort(adm_keys, stable=True))
        S_ = send_args[0].shape[-1]
        slot_key = torch.where(send_args[1], S_, torch.arange(
            S_, device=dev, dtype=torch.int32))
        slot_ms = cuda_ms(lambda: torch.sort(slot_key, dim=-1, stable=True))
        res_c["traffic_send"]["library_ms"] = None
        res_c["traffic_send"]["slot_sort_ms"] = slot_ms
        r_tgt, r_del, r_hop1 = calls["rank_inbound"][0][0][:3]
        packed = ((torch.where(r_del, r_tgt, N_).reshape(V_, -1).long() << 32)
                  | r_hop1.long().repeat_interleave(F_, dim=1))
        res_c["rank_inbound"]["library_ms"] = cuda_ms(
            lambda: torch.sort(packed, dim=1))
        m_args = calls["rc_merge_prune"][0][0]
        row_keys = torch.cat([m_args[0], m_args[5]], -1)
        res_c["rc_merge_prune"]["library_ms"] = cuda_ms(
            lambda: torch.sort(row_keys, dim=-1))
        res_c["prune_apply"]["library_ms"] = None
        del adm_keys, slot_key, packed, row_keys
        rt = {k: int(rows_t[k]) for k in ("live", "sends", "deferred",
                                          "arrived", "queue_dropped",
                                          "accepted", "delivered",
                                          "prunes_sent", "dropped",
                                          "suppressed", "failed_target")}
        if case == "capped" and not (rt["deferred"] > 0
                                     and rt["queue_dropped"] > 0):
            fail(f"(i) capped round 19 defers or drops nothing: {rt}")
        traffic_res[case] = res_c
        say(f"(i) {case} (M={M_TRAFFIC}, N={N_FULL}, rate {TRAFFIC_RATE}"
            + ("" if case == "uncapped" else
               f", caps ingress {TRAFFIC_CAPS[0]} egress {TRAFFIC_CAPS[1]}, "
               f"{TRAFFIC_IMPAIRED}") + f"), round 19: {rt}")
        for name, r in res_c.items():
            lib = r["library_ms"]
            say(f"(i) {case}: {name} exact vs plain; kernel {r['ms']:.4f} ms,"
                f" plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bytes']} bytes), library "
                + ("null" if lib is None else f"{lib:.4f} ms")
                + (f" (the stable slot sort alone: {slot_ms:.4f} ms)"
                   if name == "traffic_send" else "")
                + f"; shapes {r['shapes']}")
        del calls, rows_t, send_args, send_out, m_args, peer, code
        del r_tgt, r_del, r_hop1
        torch.cuda.empty_cache()
    prm = traffic_params(EngineParams, "uncapped", M_NARROW)
    _, _, calls = traffic_round19(kernels, prm, tables, ttables, stakes_np,
                                  dev)
    narrow_bound = {}
    for name in TRAFFIC_KERNELS:
        args, kw = calls[name][0]
        got = exact(name, args, kw, f"(i) uncapped M={M_NARROW}")
        narrow_bound[name] = bound(traffic_bytes(name, args, kw, got), 0,
                                   None)[0]
        del got
    say(f"(i) uncapped M={M_NARROW}, round 19: "
        + ", ".join(TRAFFIC_KERNELS) + " exact vs plain; bound ms "
        + ", ".join(f"{n} {narrow_bound[n]:.4f}" for n in TRAFFIC_KERNELS))
    del calls
    tr_prof_run = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), TRAFFIC_FLAG],
        capture_output=True, text=True, timeout=400, cwd=ROOT)
    for line in tr_prof_run.stdout.splitlines()[:-1]:
        print(line, flush=True)
    if tr_prof_run.returncode != 0:
        fail(f"(i) the traffic profile process failed (exit "
             f"{tr_prof_run.returncode}): {tr_prof_run.stderr[-2000:]}")
    tr_dev = json.loads(tr_prof_run.stdout.splitlines()[-1])
    say("(i) traffic kernels' device ms per call (profile) / CUDA-event ms "
        "/ bound ms at M=256 uncapped: " + "; ".join(
            f"{n} {fmt(tr_dev['uncapped M=256'][n])} / "
            f"{traffic_res['uncapped'][n]['ms']:.4f} / "
            f"{traffic_res['uncapped'][n]['bound_ms']:.4f}"
            for n in TRAFFIC_KERNELS)
        + "; capped: " + ", ".join(f"{n} {fmt(tr_dev['capped M=256'][n])}"
                                   for n in TRAFFIC_KERNELS)
        + f"; M={M_NARROW}: " + ", ".join(
            f"{n} {fmt(tr_dev[f'uncapped M={M_NARROW}'][n])}"
            for n in TRAFFIC_KERNELS))

    # the full-width CLI run, uncapped then capped, through cli.main, with
    # the launch counts set to 0 just before each and read just after; the
    # rounds timed per engine call (a synchronize at each call's end)
    tr_argv = ["--num-synthetic-nodes", str(N_FULL), "--traffic-values",
               str(M_TRAFFIC), "--traffic-rate", str(TRAFFIC_RATE),
               "--iterations", "300", "--warm-up-rounds", "200",
               "--device", "cuda"]
    real_rt, real_rounds = cli.run_traffic, cli.run_traffic_rounds
    traffic_cli = {}
    for case, extra in (("uncapped", []),
                        ("capped", ["--node-ingress-cap",
                                    str(TRAFFIC_CAPS[0]), "--node-egress-cap",
                                    str(TRAFFIC_CAPS[1])])):
        reports, spans = [], []

        def rt_capture(*a, **kw):
            reports.append(real_rt(*a, **kw))
            return reports[-1]

        def timed_rounds(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_rounds(*a, **kw)
            torch.cuda.synchronize()
            spans.append((time.perf_counter() - t0,
                          int(out[1]["live"].sum())))
            return out

        cli.run_traffic, cli.run_traffic_rounds = rt_capture, timed_rounds
        try:
            reset_unique_pubkeys()
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rc = cli.main(tr_argv + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = dict(kernels.LAUNCHES)
        finally:
            cli.run_traffic, cli.run_traffic_rounds = real_rt, real_rounds
        if rc != 0 or len(reports) != 1:
            fail(f"(i) CLI {case}: exit {rc}")
        if (any(got[n] != 300 for n in TRAFFIC_KERNELS)
                or any(got[n] for n in got if n not in TRAFFIC_KERNELS)):
            fail(f"(i) CLI {case}: launches {got}")
        summ = reports[0]["traffic"]
        span = sum(w for w, _ in spans)
        value_rounds = sum(v for _, v in spans)
        if not (summ["values_injected"] > 0 and summ["delivered"] > 0
                and 0.0 < summ["value_coverage_mean"] <= 1.0):
            fail(f"(i) CLI {case}: implausible summary {summ}")
        traffic_cli[case] = dict(
            wall=wall, rounds_s=300 / span, value_rounds_s=value_rounds / span,
            peak_mib=torch.cuda.max_memory_allocated() / 2**20,
            launches=got, summary=summ)
        say(f"(i) CLI {' '.join(tr_argv + extra)}: exit 0, wall {wall:.3f} s;"
            f" {len(spans)} engine calls of 300 rounds in {span:.3f} s = "
            f"{300 / span:.2f} traffic rounds/s, {value_rounds} live "
            f"value-rounds = {value_rounds / span:.1f} value-rounds/s; peak "
            f"device memory {traffic_cli[case]['peak_mib']:.1f} MiB; "
            f"launches {got}")
        say(f"(i) CLI {case} TRAFFIC SUMMARY: {summ}")
    capped_s = traffic_cli["capped"]["summary"]
    if not (capped_s["queue_deferred"] > 0 and capped_s["queue_dropped"] > 0
            and capped_s["values_converged"] > 0):
        fail(f"(i) the capped CLI run deferred or dropped nothing, or no "
             f"value converged: {capped_s}")
    say(f"(i) values converged: uncapped "
        f"{traffic_cli['uncapped']['summary']['values_converged']}, capped "
        f"{capped_s['values_converged']} (a value converges when all "
        f"{N_FULL} nodes hold it)")

    # cuda == cpu at N=2,000: a capped, impaired run of M=32, and a 3-point
    # traffic-rate sweep
    par_argv = ["--num-synthetic-nodes", str(N_PARITY), "--traffic-values",
                str(M_NARROW), "--traffic-rate", "4"]
    for what, extra in (
            ("capped + impaired, 20 iterations",
             ["--iterations", "20", "--warm-up-rounds", "10",
              "--node-ingress-cap", "40", "--node-egress-cap", "60",
              "--packet-loss-rate", "0.1", "--churn-fail-rate", "0.01",
              "--churn-recover-rate", "0.2", "--partition-at", "12",
              "--heal-at", "18"]),
            ("traffic-rate sweep (4, 8, 12), 12 iterations",
             ["--iterations", "12", "--warm-up-rounds", "8",
              "--node-ingress-cap", "40", "--test-type", "traffic-rate",
              "--num-simulations", "3", "--step-size", "4"])):
        outs = {}
        for device in ("cuda", "cpu"):
            reset_unique_pubkeys()
            cfg = cli.config_from_args(cli.build_parser().parse_args(
                par_argv + extra + ["--device", device]))
            coll_t, q = TrafficStatsCollection(), DatapointQueue()
            t0 = time.perf_counter()
            report = cli.run_traffic(cfg, "", q, "0", collection=coll_t)
            outs[device] = (report, [st.parity_snapshot()
                                     for st in coll_t.collection],
                            [st.summary() for st in coll_t.collection],
                            q.drain_deterministic_lines())
            say(f"(i) N={N_PARITY} {what} on {device}: "
                f"{time.perf_counter() - t0:.3f} s")
        for i, part in enumerate(("report", "parity_snapshot()", "summary()",
                                  "Influx lines")):
            if outs["cuda"][i] != outs["cpu"][i]:
                fail(f"(i) N={N_PARITY} {what}: cuda and cpu {part} differ")
        summ = outs["cuda"][0]["traffic"]
        say(f"(i) N={N_PARITY} {what}: cuda == cpu report, "
            f"parity_snapshot(), summary() and {len(outs['cuda'][3])} "
            f"deterministic Influx lines; {summ['values_injected']} values "
            f"injected, {summ['values_converged']} converged, queue deferred "
            f"{summ['queue_deferred']} dropped {summ['queue_dropped']}")

    # adaptive traffic (the per-value pull rescue) at N=10,000, M=256: the
    # six kernels against their plain versions on the first round with
    # values in their pull phase, uncapped and capped + impaired, and
    # traffic_rescue also at ingress cap 1
    tr_mod = importlib.import_module(
        "gossip_sim_tpu_torch.kernels.traffic_rescue")
    t_ad = time.perf_counter()
    rescue_res = {}
    for case in ("uncapped", "capped"):
        prm = adaptive_params(EngineParams, case)
        it_a, _, rows_a, calls = adaptive_round(
            kernels, prm, tables, ttables, stakes_np, dev, case == "capped")
        torch.cuda.synchronize()
        if any(len(calls[n]) != 1 for n in ADAPTIVE_KERNELS):
            fail(f"(i) adaptive {case}: round {it_a} called the kernels "
                 f"{ {n: len(c) for n, c in calls.items()} } times")
        for name in TRAFFIC_KERNELS:
            exact(name, *calls[name][0], f"(i) adaptive {case}")
        args, kw = calls["traffic_rescue"][0]
        got = exact("traffic_rescue", args, kw, f"(i) adaptive {case}")
        exact("traffic_rescue", args[:17] + (1,) + args[18:], kw,
              f"(i) adaptive {case}, ingress cap 1")
        moved, edge_h, node_h = rescue_work(args, kw, got, tr_mod)
        b_ms, b_by = rescue_bound(moved, edge_h, node_h)
        req = tr_mod.rescue_requests(*args, **kw)
        flat = req.arrived.reshape(-1).nonzero().squeeze(1)
        keys = req.peer.reshape(-1)[flat].long() * req.arrived.numel() + flat
        del req
        pa = {k: int(rows_a[k]) for k in tr_mod.COUNT_NAMES[:-1]}
        pa["switched_to_pull"] = int(rows_a["switched_to_pull"])
        rescue_res[case] = dict(
            round=it_a, rows=pa,
            ms=cuda_ms(lambda: real["traffic_rescue"](*args, **kw), reps=10),
            plain_ms=cuda_ms(lambda: plain["traffic_rescue"](*args, **kw),
                             reps=2, warm=1),
            bound_ms=b_ms, bound_by=b_by, bytes=moved, edge_hashes=edge_h,
            node_hashes=node_h,
            library_ms=cuda_ms(lambda: torch.sort(keys, stable=True)),
            library_keys=int(keys.numel()))
        r = rescue_res[case]
        say(f"(i) adaptive {case} (threshold {ADAPTIVE_THRESHOLD}), round "
            f"{it_a}: pull_active_values {pa['pull_active_values']}; {pa}")
        say(f"(i) adaptive {case}: the six kernels exact vs plain, "
            f"traffic_rescue also at ingress cap 1; traffic_rescue kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{b_ms:.4f} ms by {b_by} ({moved} bytes, {edge_h} edge and "
            f"{node_h} node hashes), library (stable sort of "
            f"{r['library_keys']} packed (peer, flat index) keys) "
            f"{r['library_ms']:.4f} ms")
        del calls, rows_a, args, kw, got, keys, flat
        torch.cuda.empty_cache()
    if rescue_res["capped"]["rows"]["pull_deferred"] + rescue_res["capped"][
            "rows"]["pull_queue_dropped"] == 0:
        fail("(i) adaptive capped: no pull request deferred or dropped")

    # the full-width adaptive CLI run, uncapped then capped, with the
    # launch counts set to 0 just before each and read just after
    ad_argv = tr_argv + ["--gossip-mode", "adaptive"]
    adaptive_cli = {}
    for case, extra in (("uncapped", []),
                        ("capped", ["--node-ingress-cap",
                                    str(TRAFFIC_CAPS[0]), "--node-egress-cap",
                                    str(TRAFFIC_CAPS[1])])):
        reports, spans = [], []

        def rt_capture(*a, **kw):
            reports.append(real_rt(*a, **kw))
            return reports[-1]

        def timed_rounds(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_rounds(*a, **kw)
            torch.cuda.synchronize()
            spans.append((time.perf_counter() - t0,
                          int(out[1]["live"].sum())))
            return out

        cli.run_traffic, cli.run_traffic_rounds = rt_capture, timed_rounds
        try:
            reset_unique_pubkeys()
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rc = cli.main(ad_argv + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = dict(kernels.LAUNCHES)
        finally:
            cli.run_traffic, cli.run_traffic_rounds = real_rt, real_rounds
        if rc != 0 or len(reports) != 1:
            fail(f"(i) adaptive CLI {case}: exit {rc}")
        if (any(got[n] != 300 for n in ADAPTIVE_KERNELS)
                or any(got[n] for n in got if n not in ADAPTIVE_KERNELS)):
            fail(f"(i) adaptive CLI {case}: launches {got}")
        summ, ad = reports[0]["traffic"], reports[0]["adaptive"]
        span = sum(w for w, _ in spans)
        value_rounds = sum(v for _, v in spans)
        if not (summ["values_injected"] > 0 and ad["switched_to_pull"] > 0
                and ad["pull_rescued"] > 0
                and 0.0 < summ["value_coverage_mean"] <= 1.0):
            fail(f"(i) adaptive CLI {case}: implausible summary {summ} {ad}")
        adaptive_cli[case] = dict(
            wall=wall, rounds_s=300 / span, value_rounds_s=value_rounds / span,
            peak_mib=torch.cuda.max_memory_allocated() / 2**20,
            launches=got, summary=summ, adaptive=ad)
        say(f"(i) adaptive CLI {' '.join(ad_argv + extra)}: exit 0, wall "
            f"{wall:.3f} s; {len(spans)} engine calls of 300 rounds in "
            f"{span:.3f} s = {300 / span:.2f} traffic rounds/s, "
            f"{value_rounds} live value-rounds = {value_rounds / span:.1f} "
            f"value-rounds/s; peak device memory "
            f"{adaptive_cli[case]['peak_mib']:.1f} MiB; launches {got}")
        say(f"(i) adaptive CLI {case} TRAFFIC SUMMARY: {summ}")
        say(f"(i) adaptive CLI {case} ADAPTIVE SUMMARY: {ad}")
    if not (adaptive_cli["capped"]["adaptive"]["pull_deferred"]
            + adaptive_cli["capped"]["adaptive"]["pull_queue_dropped"]) > 0:
        fail("(i) the capped adaptive CLI run deferred or dropped no pull "
             "request")

    # cuda == cpu at N=2,000, M=32: adaptive, capped and impaired
    ad_par = par_argv + ["--gossip-mode", "adaptive", "--iterations", "20",
                         "--warm-up-rounds", "10", "--node-ingress-cap", "40",
                         "--node-egress-cap", "60", "--packet-loss-rate",
                         "0.1", "--churn-fail-rate", "0.01",
                         "--churn-recover-rate", "0.2", "--partition-at",
                         "12", "--heal-at", "18"]
    outs = {}
    for device in ("cuda", "cpu"):
        reset_unique_pubkeys()
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            ad_par + ["--device", device]))
        coll_t, q = TrafficStatsCollection(), DatapointQueue()
        t0 = time.perf_counter()
        report = cli.run_traffic(cfg, "", q, "0", collection=coll_t)
        outs[device] = (report, [st.parity_snapshot()
                                 for st in coll_t.collection],
                        [st.summary() for st in coll_t.collection],
                        q.drain_deterministic_lines())
        say(f"(i) N={N_PARITY} adaptive, capped + impaired on {device}: "
            f"{time.perf_counter() - t0:.3f} s")
    for i, part in enumerate(("report", "parity_snapshot()", "summary()",
                              "Influx lines")):
        if outs["cuda"][i] != outs["cpu"][i]:
            fail(f"(i) N={N_PARITY} adaptive: cuda and cpu {part} differ")
    lines_ad = outs["cuda"][3]
    if not ("adaptive_rounds" in outs["cuda"][1][0]
            and any(ln.startswith("sim_adaptive,") for ln in lines_ad)):
        fail(f"(i) N={N_PARITY} adaptive: no adaptive series")
    # the 20 rounds must reach the pull rescue and its caps
    ad_sec = outs["cuda"][0]["adaptive"]
    if not (ad_sec["switched_to_pull"] > 0 and ad_sec["pull_rescued"] > 0
            and ad_sec["pull_deferred"] + ad_sec["pull_queue_dropped"] > 0):
        fail(f"(i) N={N_PARITY} adaptive: no value in its pull phase, no "
             f"rescue or no capped pull request: {ad_sec}")
    say(f"(i) N={N_PARITY} adaptive: cuda == cpu report (adaptive section "
        f"{outs['cuda'][0]['adaptive']}), parity_snapshot() with "
        f"adaptive_rounds, summary() and {len(lines_ad)} deterministic Influx "
        f"lines ({sum(ln.startswith('sim_adaptive,') for ln in lines_ad)} "
        f"sim_adaptive)")
    del outs
    prof_push = tr_dev.get(f"profile M={M_TRAFFIC}", {})
    prof_ad = tr_dev.get(f"profile adaptive M={M_TRAFFIC}", {})
    say("(i) traffic_rescue device ms per call (profile): uncapped "
        + fmt(tr_dev[f"adaptive uncapped M={M_TRAFFIC}"]["traffic_rescue"])
        + ", capped "
        + fmt(tr_dev[f"adaptive capped M={M_TRAFFIC}"]["traffic_rescue"])
        + f"; the round at M={M_TRAFFIC} uncapped, adaptive vs push (same "
        f"process): device busy {prof_ad.get('busy_ms')} vs "
        f"{prof_push.get('busy_ms')} ms, launches "
        f"{prof_ad.get('launches')} vs {prof_push.get('launches')}")
    say(f"(i) adaptive traffic: {time.perf_counter() - t_ad:.1f} s")
    say(f"(i) traffic phase: {time.perf_counter() - t_i:.1f} s")

    # ---- (j) the sparse layout at N=10,000 and N=100,000 on cuda ---------
    phase("j")
    t_j = time.perf_counter()
    PLANES = ("rc_shi", "rc_slo")

    def bits(t):
        """A tensor's bit pattern, so that equal NaNs compare equal."""
        return (t.view(torch.int32) if t.dtype == torch.float32 else
                t.view(torch.int64) if t.dtype == torch.float64 else t)

    def rows_differ(a: dict, b: dict) -> list:
        return [k for k in a if k not in b
                or not torch.equal(bits(a[k]), bits(b[k]))]

    def states_differ(a, b) -> list:
        return [f for f in a._fields if f not in PLANES
                and not torch.equal(getattr(a, f), getattr(b, f))]

    def fresh() -> int:
        """Zero the launch counts and the peak; the bytes allocated now,
        above which the next run's peak is read (earlier phases hold
        tensors)."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        return torch.cuda.memory_allocated()

    peak_above = lambda base: (torch.cuda.max_memory_allocated()
                               - base) / 2**20

    # device times and both layouts' round profiles, in a process of its own
    sp_run = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), SPARSE_FLAG],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    for line in sp_run.stdout.splitlines()[:-1]:
        print(line, flush=True)
    if sp_run.returncode != 0:
        fail(f"(j) the --profile-sparse process failed (exit "
             f"{sp_run.returncode}): {sp_run.stderr[-2000:]}")
    sp_out = json.loads(sp_run.stdout.splitlines()[-1])
    sp_dev, rd = sp_out["profiles"], sp_out["cases"]

    def dev_line(n, o):
        d, s_ = sp_dev[f"N={n} O={o} dense"], sp_dev[f"N={n} O={o} sparse"]
        return (f"N={n} O={o}: rc_merge_prune device ms dense "
                f"{fmt(d['device_ms'])}, sparse {fmt(s_['device_ms'])}; a "
                f"round (5 from round 19) dense / sparse: busy "
                f"{d['busy_ms']} / {s_['busy_ms']} ms, wall {d['wall_ms']} / "
                f"{s_['wall_ms']} ms, launches {d['launches']} / "
                f"{s_['launches']}")

    for n, o in ((N_FULL, O_KERNEL), (N_FULL, O_PULL), (N_HUGE, O_HUGE)):
        say("(j) " + dev_line(n, o))

    # rc_merge_prune and bfs_relax on rounds 19 (rows fire) and 20 at every
    # shape (the same child), exact vs plain, beside their bytes bound and
    # bfs_relax's latency floor
    for key, v in rd.items():
        which = (SPARSE if key.startswith("rc_merge_prune sparse")
                 else key.split()[0])
        worst[which] = max(worst.get(which, 0), v["max_abs_err"])
        if v["max_abs_err"] != 0:
            fail(f"(j) {key}: differs from its plain version (max_abs_err "
                 f"{v['max_abs_err']})")
        bytes_ms = v["bytes"] / HBM_BYTES_PER_S * 1e3
        txt = (f"(j) {key}: exact vs plain; device {fmt(v['device_ms'])}, "
               f"CUDA events {v['ms']:.4f} ms; {v['bytes']} bytes, "
               f"{bytes_ms:.4f} ms at {HBM_BYTES_PER_S / 1e12} TB/s")
        if key.startswith("bfs_relax"):
            fl = v.get("floor_ms")
            v["bound_ms"] = max(bytes_ms, fl or 0.0)
            v["bound_by"] = "latency floor" if (fl or 0) > bytes_ms \
                else "bytes"
            txt += (f"; {v['hops']} hops (rows: "
                    f"{sorted(set(v['row_hops']))}); latency floor "
                    f"{fmt(fl)} ({v['hops']} hops of cluster barriers, "
                    f"compaction and DSMEM passes, no edge work); bound "
                    f"{v['bound_ms']:.4f} ms by {v['bound_by']}")
        else:
            v["bound_ms"], v["bound_by"] = bytes_ms, "bytes"
            txt += f"; fired rows {v['fired_rows']} of {v['rows']}"
        say(txt)

    # the kernel on round 19's inputs at O=32: against its plain version,
    # and against the dense kernel given the planes shi/slo[rc_src]
    sparse_prm = params._replace(representation="sparse")
    rows_sp, calls = round19_calls(sparse_prm, origins, ["rc_merge_prune"])
    args, kw = calls["rc_merge_prune"][0]
    if args[2] is not None or args[3] is not None or kw.get("live") is not None:
        fail("(j) the sparse round passed stake planes or a live mask to "
             "rc_merge_prune")
    got = exact("rc_merge_prune", args, kw, "(j) sparse O=32", key=SPARSE)
    src = args[0].long()
    d_args = (args[0], args[1], args[6][src], args[7][src]) + tuple(args[4:])
    del src
    dense_out = real["rc_merge_prune"](*d_args, **kw)
    diff = [f for f in got._fields if f not in PLANES
            and not torch.equal(getattr(got, f), getattr(dense_out, f))]
    new_src = dense_out.rc_src.long()
    if (diff or not torch.equal(dense_out.rc_shi, args[6][new_src])
            or not torch.equal(dense_out.rc_slo, args[7][new_src])
            or got.rc_shi.shape != (O_KERNEL, N_FULL, 0)
            or got.rc_slo.shape != (O_KERNEL, N_FULL, 0)):
        fail(f"(j) sparse rc_merge_prune differs from the dense kernel in "
             f"{diff} (or the dense planes are not shi/slo[rc_src], or the "
             f"sparse planes are not zero-width)")
    del new_src
    sp_moved = nbytes(*args, *got)
    sp_res = dict(bytes=sp_moved, bound_ms=bound(sp_moved, 0, None)[0],
                  dense_bytes=nbytes(*d_args, *dense_out))
    del got, dense_out
    # in turns: dense, sparse, sparse, dense (CUDA events, warm L2)
    turns = {"dense": [], "sparse": []}
    for which in ("dense", "sparse", "sparse", "dense"):
        a_ = d_args if which == "dense" else args
        turns[which].append(cuda_ms(lambda: real["rc_merge_prune"](*a_,
                                                                   **kw)))
    sp_res["ms"] = min(turns["sparse"])
    sp_res["dense_ms"] = min(turns["dense"])
    sp_res["plain_ms"] = cuda_ms(lambda: plain["rc_merge_prune"](*args, **kw),
                                 reps=3, warm=1)
    row_keys = torch.cat([args[0], args[5]], -1)
    sp_res["library_ms"] = cuda_ms(lambda: torch.sort(row_keys, dim=-1))
    del row_keys, d_args, args, kw, calls
    say(f"(j) rc_merge_prune sparse at O={O_KERNEL} N={N_FULL}, round 19 "
        f"(prunes {int(rows_sp['prunes_sent'].sum())}): exact vs plain and "
        f"equal to the dense kernel on shi/slo[rc_src] (rc_src, rc_score, "
        f"src_sorted, pruned_slot, n_pruned, rc_upserts, rc_overflow); "
        f"CUDA events in turns (dense, sparse, sparse, dense): sparse "
        + " / ".join(f"{v:.4f}" for v in turns["sparse"]) + " ms, dense "
        + " / ".join(f"{v:.4f}" for v in turns["dense"])
        + f" ms; plain {sp_res['plain_ms']:.4f} ms; library "
        f"{sp_res['library_ms']:.4f} ms (torch.sort of the [O, N, C+K] row "
        f"keys); bound {sp_res['bound_ms']:.4f} ms by bytes ({sp_moved} "
        f"bytes; dense {sp_res['dense_bytes']} bytes)")
    del rows_sp

    # the engine at O=32: 50 rounds of each layout, in turns
    eng_sp, kept = {"dense": [], "sparse": []}, {}
    for which in ("dense", "sparse", "sparse", "dense"):
        prm = params._replace(representation=which)
        base = fresh()
        st = init_state(rng.prng_key(7, dev), tables, origins, prm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, rows_e = run_rounds(prm, tables, origins, st, 50)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eng_sp[which].append(dict(
            wall_ms=wall / 50 * 1e3,
            peak_mib=peak_above(base), launches=dict(kernels.LAUNCHES)))
        kept.setdefault(which, (st, rows_e))
    (st_d, rows_d), (st_s, rows_s) = kept["dense"], kept["sparse"]
    diff = rows_differ(rows_d, rows_s) + states_differ(st_d, st_s)
    if diff or st_s.rc_shi.shape[-1] or st_s.rc_slo.shape[-1]:
        fail(f"(j) engine O={O_KERNEL}: dense and sparse differ in {diff} "
             f"(sparse planes {tuple(st_s.rc_shi.shape)})")
    la_d, la_s = (eng_sp["dense"][0]["launches"],
                  eng_sp["sparse"][0]["launches"])
    if (la_s["rc_merge_prune"] or la_s[SPARSE] != 50
            or la_d[SPARSE] or la_d["rc_merge_prune"] != 50
            or any(la_s[n] != la_d[n] for n in names
                   if n != "rc_merge_prune")):
        fail(f"(j) engine launches: dense {la_d}, sparse {la_s}")
    del kept, st_d, st_s, rows_d, rows_s, st, rows_e
    say(f"(j) engine O={O_KERNEL} N={N_FULL}, 50 rounds each, in turns "
        f"(dense, sparse, sparse, dense): rows and final states equal (but "
        f"the stake planes: [{O_KERNEL}, {N_FULL}, 0] sparse); per-round "
        f"wall dense "
        + " / ".join(f"{r['wall_ms']:.3f}" for r in eng_sp["dense"])
        + " ms, sparse "
        + " / ".join(f"{r['wall_ms']:.3f}" for r in eng_sp["sparse"])
        + " ms; peak memory dense "
        + " / ".join(f"{r['peak_mib']:.1f}" for r in eng_sp["dense"])
        + ", sparse "
        + " / ".join(f"{r['peak_mib']:.1f}" for r in eng_sp["sparse"])
        + f" MiB above what was held before each; rc_merge_prune {la_d['rc_merge_prune']} launches dense, "
        f"its sparse variant {la_s[SPARSE]} sparse")

    # all-origins: origins 0-199 at the auto batch and in one batch, each
    # width in both layouts in turns
    ao_sp = {}
    for width, order in ((0, ("dense", "sparse")),
                         (O_WIDE, ("sparse", "dense"))):
        for which in order:
            cfg = dataclasses.replace(ao_cfg, origin_batch=width,
                                      engine_representation=which)
            base = fresh()
            t0 = time.perf_counter()
            summ = cli.run_all_origins(cfg, accounts=ao_accounts,
                                       origin_indices=ao_idx)
            torch.cuda.synchronize()
            ao_sp.setdefault((width, which), []).append(dict(
                summary=summ, wall=time.perf_counter() - t0,
                launches=dict(kernels.LAUNCHES), peak_mib=peak_above(base),
                origin_rounds_s=AO_ORIGINS * 300 / sum(
                    b["rounds_s"] for b in summ["batches"])))
        d_, s_ = ao_sp[(width, "dense")][0], ao_sp[(width, "sparse")][0]
        sd_d, sd_s = (d_["summary"]["stats"].state_dict(),
                      s_["summary"]["stats"].state_dict())
        diff = [k for k in sd_d if not np.array_equal(sd_d[k], sd_s[k])]
        keys = set(d_["summary"]) - {"stats", "batches", "elapsed_s",
                                     "origin_iters_per_sec"}
        diff += [k for k in keys if d_["summary"][k] != s_["summary"][k]]
        n_b = len(s_["summary"]["batches"])
        if (diff or s_["launches"][SPARSE] != n_b * 300
                or s_["launches"]["rc_merge_prune"]):
            fail(f"(j) all-origins batch {width or O_BATCH}: dense and "
                 f"sparse differ in {diff}, or launches {s_['launches']}")
        runs_w = lambda which, k, f: " / ".join(
            format(r[k], f) for r in ao_sp[(width, which)])
        say(f"(j) all-origins origins 0-{AO_ORIGINS - 1} at "
            + (f"the auto batch {O_BATCH}" if not width
               else f"one batch of {AO_ORIGINS}")
            + f", in turns ({', '.join(order)}): AllOriginsStats and "
            f"summary equal; origin-rounds/s dense "
            f"{runs_w('dense', 'origin_rounds_s', '.1f')}, sparse "
            f"{runs_w('sparse', 'origin_rounds_s', '.1f')}; wall dense "
            f"{runs_w('dense', 'wall', '.3f')} s, sparse "
            f"{runs_w('sparse', 'wall', '.3f')} s; peak device memory "
            f"above what was held before each run: dense "
            f"{runs_w('dense', 'peak_mib', '.1f')} MiB, sparse "
            f"{runs_w('sparse', 'peak_mib', '.1f')} MiB")
    for runs_ in ao_sp.values():
        for r in runs_:
            del r["summary"]
    torch.cuda.empty_cache()

    # N=100,000: the engine at O=41 (the auto batch there), 20 rounds of
    # each layout, and the sparse kernel on its round 19 against its plain
    # version
    t0 = time.perf_counter()
    reset_unique_pubkeys()
    acc_h, _ = cli.load_cluster_accounts(cli.Config(
        num_synthetic_nodes=N_HUGE))
    stakes_h = NodeIndex.from_stakes(acc_h).stakes.astype(np.int64)
    tables_h = make_cluster_tables(stakes_h, device=dev)
    build_h = time.perf_counter() - t0
    orgs_h = torch.as_tensor(np.argsort(-stakes_h, kind="stable")[:O_HUGE]
                             .astype(np.int32), device=dev)
    huge, h_call = {}, None
    for which in ("dense", "sparse"):
        prm = EngineParams(num_nodes=N_HUGE, warm_up_rounds=0,
                           representation=which)
        base = fresh()
        st = init_state(rng.prng_key(42, dev), tables_h, orgs_h, prm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, rows_a = run_rounds(prm, tables_h, orgs_h, st, 19)
        cap = {"rc_merge_prune": []}
        st, rows_b = recording(["rc_merge_prune"], cap, run_rounds, prm,
                               tables_h, orgs_h, st, 1, 19)
        torch.cuda.synchronize()
        huge[which] = dict(
            wall_ms=(time.perf_counter() - t0) / 20 * 1e3,
            peak_mib=peak_above(base), launches=dict(kernels.LAUNCHES),
            state=st,
            rows={k: torch.cat([rows_a[k], rows_b[k]]) for k in rows_a})
        if which == "sparse":
            h_call = cap["rc_merge_prune"][0]
        del st, rows_a, rows_b, cap
    hd, hs = huge["dense"], huge["sparse"]
    diff = (rows_differ(hd["rows"], hs["rows"])
            + states_differ(hd["state"], hs["state"]))
    if diff or hs["launches"][SPARSE] != 20:
        fail(f"(j) engine N={N_HUGE} O={O_HUGE}: dense and sparse differ in "
             f"{diff}, or launches {hs['launches']}")
    cov_h = float(hs["rows"]["coverage"][-1].double().mean())
    prunes_h = int(hs["rows"]["prunes_sent"][-1].sum())
    for v in huge.values():
        del v["state"], v["rows"]
    torch.cuda.empty_cache()
    exact("rc_merge_prune", *h_call, f"(j) sparse N={N_HUGE} O={O_HUGE}",
          key=SPARSE)
    h_ms = cuda_ms(lambda: real["rc_merge_prune"](*h_call[0], **h_call[1]))
    h_bound = bound(nbytes(*h_call[0], *real["rc_merge_prune"](
        *h_call[0], **h_call[1])), 0, None)[0]
    del h_call
    torch.cuda.empty_cache()
    say(f"(j) N={N_HUGE} (cluster built in {build_h:.2f} s), engine at "
        f"O={O_HUGE}, 20 rounds each: rows and states equal; per-round wall"
        f" dense {hd['wall_ms']:.3f} ms, sparse {hs['wall_ms']:.3f} ms; "
        f"peak device memory above what was held before dense "
        f"{hd['peak_mib']:.1f} MiB, sparse {hs['peak_mib']:.1f} MiB; round "
        f"19 coverage mean {cov_h:.6f}, "
        f"prunes {prunes_h}; rc_merge_prune sparse exact vs plain on round "
        f"19, {h_ms:.4f} ms (CUDA events), bound {h_bound:.4f} ms")

    # N=100,000 through the CLI, one origin, 100 iterations: sparse then
    # dense; the sparse run's launches are this slice's main path's
    cli_h = {}
    for which in ("sparse", "dense"):
        reset_unique_pubkeys()
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            ["--num-synthetic-nodes", str(N_HUGE), "--iterations", "100",
             "--warm-up-rounds", "60", "--engine-representation", which,
             "--device", "cuda"]))
        base = fresh()
        t0 = time.perf_counter()
        coll = cli.simulate(cfg)
        torch.cuda.synchronize()
        cli_h[which] = dict(
            wall=time.perf_counter() - t0,
            launches=dict(kernels.LAUNCHES), peak_mib=peak_above(base),
            snap=snapshot_strings(coll.collection[0].parity_snapshot()),
            cov=coll.collection[0].coverage_stats.mean,
            rmr=coll.collection[0].rmr_stats.mean)
    ls = cli_h["sparse"]["launches"]
    if (ls[SPARSE] != 100 or ls["rc_merge_prune"]
            or any(ls[n] <= 0 for n in names if n != "rc_merge_prune")):
        fail(f"(j) the sparse CLI at N={N_HUGE}: launches {ls}")
    diff = [k for k in cli_h["dense"]["snap"]
            if cli_h["dense"]["snap"][k] != cli_h["sparse"]["snap"][k]]
    if diff:
        fail(f"(j) the CLI at N={N_HUGE}: dense and sparse parity snapshots "
             f"differ in {diff}")
    say(f"(j) CLI --num-synthetic-nodes {N_HUGE} --iterations 100 "
        f"--warm-up-rounds 60: sparse wall {cli_h['sparse']['wall']:.3f} s"
        f" (cluster build included), dense {cli_h['dense']['wall']:.3f} s; "
        f"parity_snapshot() equal; coverage mean "
        f"{cli_h['sparse']['cov']:.6f}, RMR mean {cli_h['sparse']['rmr']:.6f}"
        f"; peak device memory above what was held before: sparse "
        f"{cli_h['sparse']['peak_mib']:.1f} MiB, dense "
        f"{cli_h['dense']['peak_mib']:.1f} MiB; sparse launches {ls}")
    for v in cli_h.values():
        del v["snap"]

    # cuda == cpu at N=2,000 sparse under loss + churn + partition, and a
    # two-point active-set sweep sparse == dense; the refusals on the card
    par_argv = ["--num-synthetic-nodes", str(N_PARITY), "--iterations", "60",
                "--warm-up-rounds", "20", "--engine-representation",
                "sparse", "--packet-loss-rate", "0.1", "--churn-fail-rate",
                "0.01", "--churn-recover-rate", "0.2", "--partition-at", "25",
                "--heal-at", "40"]
    sw_argv = ["--num-synthetic-nodes", str(N_PARITY), "--iterations", "60",
               "--warm-up-rounds", "20", "--test-type", "active-set-size",
               "--num-simulations", "2", "--step-size", "4"]

    def sweep(argv):
        reset_unique_pubkeys()
        args_ = cli.build_parser().parse_args(argv)
        cfg = cli.config_from_args(args_)
        coll, q = cli.GossipStatsCollection(), DatapointQueue()
        coll.set_number_of_simulations(cfg.num_simulations)
        t0 = time.perf_counter()
        cli.dispatch_sweeps(cfg, "", args_.origin_rank, coll, q, "0")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0,
                [snapshot_strings(st.parity_snapshot())
                 for st in coll.collection], q.drain_deterministic_lines())

    runs = {(dv, "sparse"): sweep(par_argv + ["--device", dv])
            for dv in ("cuda", "cpu")}
    if runs[("cuda", "sparse")][1:] != runs[("cpu", "sparse")][1:]:
        fail(f"(j) N={N_PARITY} sparse: cuda and cpu parity_snapshot() or "
             f"Influx lines differ")
    sw = {rep_: sweep(sw_argv + ["--engine-representation", rep_,
                                 "--device", "cuda"])
          for rep_ in ("sparse", "dense")}
    if sw["sparse"][1:] != sw["dense"][1:] or len(sw["sparse"][1]) != 2:
        fail("(j) the active-set sweep: sparse and dense snapshots or "
             "Influx lines differ")
    refused = []
    for extra in (["--gossip-mode", "push-pull"], ["--traffic-values", "4"]):
        try:
            cli.main(["--num-synthetic-nodes", "200", "--iterations", "4",
                      "--warm-up-rounds", "2", "--engine-representation",
                      "sparse", "--device", "cuda"] + extra)
        except ValueError as e:
            refused.append(str(e))
            continue
        fail(f"(j) sparse with {extra} ran on the card")
    say(f"(j) N={N_PARITY} sparse, loss 0.1 + churn + partition, 60 "
        f"iterations: cuda == cpu parity_snapshot() and "
        f"{len(runs[('cuda', 'sparse')][2])} deterministic Influx lines "
        f"(cuda {runs[('cuda', 'sparse')][0]:.3f} s, cpu "
        f"{runs[('cpu', 'sparse')][0]:.3f} s); active-set sweep S = 12, 16 "
        f"at N={N_PARITY}: sparse == dense snapshots and "
        f"{len(sw['sparse'][2])} lines; refused on the card: {refused}")
    del runs, sw
    say(f"(j) sparse phase: {time.perf_counter() - t_j:.1f} s")

    # ---- (k) sweep lanes at N=10,000 on cuda ------------------------------
    phase("k")
    t_k = time.perf_counter()
    from gossip_sim_tpu_torch import engine as eng
    reset_unique_pubkeys()
    accounts_k, _ = cli.load_cluster_accounts(
        cli.Config(num_synthetic_nodes=N_FULL))
    stakes_k = NodeIndex.from_stakes(accounts_k).stakes.astype(np.int64)
    tables_k = make_cluster_tables(stakes_k, device=dev)
    top_k = np.argsort(-stakes_k, kind="stable").astype(np.int32)

    def all_equal(a, b) -> list:
        """The fields (or row names) of two states (or row dicts) that
        differ, NaN equal to NaN."""
        if isinstance(a, dict):
            return rows_differ(a, b) + [k for k in b if k not in a]
        return [f for f in a._fields
                if not torch.equal(getattr(a, f), getattr(b, f))]

    # the kernels on round 19 of K lanes of O origins (32 rows), each lane
    # with knobs of its own: against the plain version, against each lane's
    # one-lane call, and timed beside the one-lane call on the same rows
    orgs_k = torch.as_tensor(top_k[:LANE_O], device=dev)
    lane_k = {}
    for mode, name in (("push", "push_targets"), ("push", "rc_merge_prune"),
                       ("push", "rotate"), ("sparse", "rc_merge_prune"),
                       ("push-pull", "pull_exchange")):
        key = SPARSE if mode == "sparse" else name
        calls = lane_round19(kernels, eng, lane_params(EngineParams, mode),
                             tables_k, orgs_k, [name], dev)[name]
        if len(calls) != 1:
            fail(f"(k) {mode}: {len(calls)} {name} calls in a lane round")
        a, kw = calls[0]
        got = exact(name, a, kw, f"(k) {key} lanes", key=key)
        outs = [t for t in (got if isinstance(got, tuple) else (got,))
                if t is not None]
        for j in range(LANE_K):
            aj, kwj = lane_call(a, kw, j, LANE_K)
            one = real[name](*aj, **kwj)
            one = [t for t in (one if isinstance(one, tuple) else (one,))
                   if t is not None]
            per = LANE_O
            if any(not torch.equal(x[j * per:(j + 1) * per], y)
                   for x, y in zip(outs, one)):
                fail(f"(k) {key}: lane {j}'s rows differ from its one-lane "
                     f"call")
        a1, kw1 = lane_call(a, kw, None, LANE_K)
        au, kwu = same_knobs(a, kw, LANE_K)
        if max_abs_err(real[name](*au, **kwu),
                       real[name](*a1, **kw1)) != 0:
            fail(f"(k) {key}: {LANE_K} lanes of lane 0's knobs differ from "
                 f"the one-lane call")
        if name == "push_targets":
            moved, blocks = push_targets_bytes(a, outs), 0
        elif name == "rc_merge_prune":
            moved, blocks = nbytes(*a, *outs), 0
        elif name == "rotate":
            moved, blocks, _ = rotate_work(a, outs, rot_mod)
        else:
            moved, blocks = pull_bytes(a, kw, outs), 0
        ms = {"lanes": [], "one_lane": [], "same_knobs": []}
        for _ in range(2):
            for what, (x, y) in (("lanes", (a, kw)), ("one_lane", (a1, kw1)),
                                 ("same_knobs", (au, kwu))):
                ms[what].append(cuda_ms(lambda: real[name](*x, **y),
                                        reps=20))
        lane_k[key] = dict(
            k=LANE_K, o=LANE_O, max_abs_err=worst[key], ms=ms["lanes"],
            one_lane_ms=ms["one_lane"], same_knobs_ms=ms["same_knobs"],
            bound_ms=bound(moved, blocks, tf_ops.get(name))[0])
        say(f"(k) {key} on round 19 of {LANE_K} lanes x {LANE_O} origins "
            f"({mode}): exact vs plain and vs each lane's one-lane call; "
            f"CUDA-event ms, in turns: lane call "
            + " / ".join(f"{v:.4f}" for v in ms["lanes"])
            + ", one-lane call (lane 0's knobs) on the same rows "
            + " / ".join(f"{v:.4f}" for v in ms["one_lane"])
            + f", {LANE_K} lanes of lane 0's knobs "
            + " / ".join(f"{v:.4f}" for v in ms["same_knobs"])
            + f"; bound {lane_k[key]['bound_ms']:.4f} ms")
        del calls, a, kw, got, outs, one, a1, kw1, au, kwu
    torch.cuda.empty_cache()

    # device times and round profiles in a process of its own
    ln_run = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), LANES_FLAG],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    for line in ln_run.stdout.splitlines()[:-1]:
        print(line, flush=True)
    if ln_run.returncode != 0:
        fail(f"(k) the --profile-lanes process failed (exit "
             f"{ln_run.returncode}): {ln_run.stderr[-2000:]}")
    ln_dev = json.loads(ln_run.stdout.splitlines()[-1])
    for ck, v in ln_dev["kernels"].items():
        key = SPARSE if ck.endswith("sparse") else ck.split()[0]
        lane_k[key].update(v)
        say(f"(k) {ck}: device ms lane call {fmt(v['device_ms'])}, one-lane "
            f"call on the same rows {fmt(v['one_lane_device_ms'])}, "
            f"{LANE_K} lanes of lane 0's knobs "
            f"{fmt(v['same_knobs_device_ms'])}")
    for tag, v in ln_dev["rounds"].items():
        say(f"(k) a round of {tag} (5 from round 20): busy {v['busy_ms']} "
            f"ms, wall {v['wall_ms']} ms, launches {v['launches']}")
    # the profiler's device launches are reported, not held: they have
    # varied by a few in 5 rounds between runs of the same round (and a
    # run_rounds_lanes call adds one launch of its own, the lanes' origin
    # rows); the kernels' launches are held exactly below
    say(f"(k) device launches a round under the profiler: lanes "
        f"{ln_dev['rounds'][f'lanes K={LANE_K} O=1']['launches']}, serial "
        f"O=1 {ln_dev['rounds']['serial O=1']['launches']}")

    # the engine: K lanes of one origin, 50 rounds, beside the serial round
    # at O=1 and at O=K, in turns; launches per round; every lane against
    # its serial run
    plist = lane_params(EngineParams)
    static = eng.merge_lane_statics([p.static_part() for p in plist])
    kstack = eng.stack_knobs([p.knob_values() for p in plist])
    one_k = torch.as_tensor(top_k[:1], device=dev)
    wide_k = torch.as_tensor(top_k[:LANE_K], device=dev)
    st1 = init_state(rng.prng_key(42, dev), tables_k, one_k, plist[0])
    ENG_ROUNDS = 50
    eng_runs = {}

    def timed(tag, fn):
        base = fresh()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eng_runs.setdefault(tag, []).append(dict(
            wall_ms=wall / ENG_ROUNDS * 1e3, peak_mib=peak_above(base),
            launches={n: v / ENG_ROUNDS for n, v in kernels.LAUNCHES.items()
                      if v}))
        return out

    for turn in range(2):
        timed(f"lanes K={LANE_K} O=1", lambda: eng.run_rounds_lanes(
            static, tables_k, one_k, eng.broadcast_state(st1, LANE_K),
            kstack, ENG_ROUNDS))
        timed("serial O=1", lambda: run_rounds(
            static, tables_k, one_k, st1, ENG_ROUNDS,
            knobs=plist[1].knob_values()))
        st_w = init_state(rng.prng_key(42, dev), tables_k, wide_k, plist[1])
        timed(f"serial O={LANE_K}", lambda: run_rounds(
            static, tables_k, wide_k, st_w, ENG_ROUNDS,
            knobs=plist[1].knob_values()))
    lane_wrapper = eng_runs[f"lanes K={LANE_K} O=1"][0]["launches"]
    serial_wrapper = eng_runs["serial O=1"][0]["launches"]
    if lane_wrapper != serial_wrapper:
        fail(f"(k) kernel launches per lane round {lane_wrapper} differ from "
             f"the serial round's {serial_wrapper}")
    states_l, rows_l = eng.run_rounds_lanes(
        static, tables_k, one_k, eng.broadcast_state(st1, LANE_K), kstack,
        ENG_ROUNDS, detail=True)
    for j, p in enumerate(plist):
        s_j, r_j = run_rounds(static, tables_k, one_k, st1, ENG_ROUNDS,
                              detail=True, knobs=p.knob_values())
        bad = (all_equal({k: v[:, j] for k, v in rows_l.items()}, r_j)
               + all_equal(eng.lane_state(states_l, j), s_j))
        if bad:
            fail(f"(k) lane {j} differs from its serial run on the card in "
                 f"{bad}")
    del states_l, rows_l, st_w
    for tag, runs_ in eng_runs.items():
        say(f"(k) engine {tag}, {ENG_ROUNDS} rounds (in turns): per round "
            + " / ".join(f"{r['wall_ms']:.3f}" for r in runs_)
            + " ms wall, peak "
            + " / ".join(f"{r['peak_mib']:.1f}" for r in runs_)
            + " MiB above what was held; kernel launches per round "
            f"{sum(runs_[0]['launches'].values()):.0f}")
    say(f"(k) every lane's {ENG_ROUNDS} rounds equal its serial run (rows "
        f"and state); launches per lane round equal the serial round's")

    # the CLI: lane sweeps against the serial sweep run point by point on
    # one cluster (the pubkey counter reset per point)
    def sweep(argv, lanes, device="cuda"):
        reset_unique_pubkeys()
        args_ = cli.build_parser().parse_args(
            argv + ["--device", device]
            + (["--sweep-lanes", str(lanes)] if lanes else []))
        cfg = cli.config_from_args(args_)
        coll, q = cli.GossipStatsCollection(), DatapointQueue()
        coll.set_number_of_simulations(cfg.num_simulations)
        t0 = time.perf_counter()
        if lanes:
            times = cli.dispatch_sweeps(cfg, "u", args_.origin_rank, coll, q,
                                        "77")
            if not times or times.get("lanes") != min(lanes,
                                                      cfg.num_simulations):
                fail(f"(k) {argv}: --sweep-lanes {lanes} did not run lanes")
        else:
            times = None
            for i in range(cfg.num_simulations):
                reset_unique_pubkeys()
                c, start = cli._stepped_sweep_config(cfg, i,
                                                     args_.origin_rank)
                cli.run_simulation(c, "u", coll, q, i, "77", start)
        wall = time.perf_counter() - t0
        return ([snapshot_strings(x.parity_snapshot())
                 for x in coll.collection],
                q.drain_deterministic_lines(), wall, times)

    def same(a, b, what):
        if a[0] != b[0] or a[1] != b[1]:
            fail(f"(k) {what}: parity snapshots or deterministic lines "
                 f"differ")

    base_cli = ["--num-synthetic-nodes", str(N_FULL)]
    loss_sweep = base_cli + ["--iterations", "100", "--warm-up-rounds",
                             "60", "--origin-rank", "1", "--test-type",
                             "packet-loss", "--num-simulations", str(LANE_K),
                             "--step-size", "0.05"]
    cli_k = {"lanes": [], "serial": []}
    ref_k = None
    for what in ("lanes", "serial"):
        out = sweep(loss_sweep, LANE_K if what == "lanes" else 0)
        ref_k = ref_k or out
        same(out, ref_k, f"packet-loss sweep ({what})")
        cli_k[what].append(dict(wall=out[2], times=out[3]))
        say(f"(k) packet-loss sweep, {LANE_K} points x 100 iterations (60 "
            f"warm-up), {what}: {out[2]:.3f} s"
            + ("" if out[3] is None else
               f" (cluster build {out[3]['cluster_s']:.3f} s, engine "
               f"{out[3]['engine_s']:.3f} s, harvest "
               f"{out[3]['harvest_s']:.3f} s)"))
    short = base_cli + ["--iterations", "60", "--warm-up-rounds", "20"]
    for argv, lanes, what in (
            (["--test-type", "fail-nodes", "--when-to-fail", "30",
              "--num-simulations", "5", "--step-size", "0.1"], 4,
             "fail-nodes, 5 points at 4 lanes (the tail padded)"),
            (["--gossip-mode", "push-pull", "--test-type", "pull-fanout",
              "--num-simulations", "3", "--step-size", "3"], 3,
             "pull-fanout (push-pull)"),
            (["--gossip-mode", "adaptive", "--test-type",
              "adaptive-threshold", "--adaptive-switch-threshold", "0.5",
              "--num-simulations", "3", "--step-size", "0.2"], 3,
             "adaptive-threshold")):
        got_l = sweep(short + argv, lanes)
        same(got_l, sweep(short + argv, 0), what)
        say(f"(k) {what}: the lane sweep equals the serial sweep "
            f"({got_l[2]:.3f} s)")
    pst = short + ["--test-type", "prune-stake-threshold",
                   "--num-simulations", "4", "--step-size", "0.1"]
    same(sweep(pst + ["--engine-representation", "sparse"], 4),
         sweep(pst, 4), "sparse prune-stake-threshold lanes against dense")
    say("(k) prune-stake-threshold lane sweep: sparse equals dense")

    # dyn: lanes at their own origins and start iterations against each
    # lane's solo run; a spliced lane leaves the others' bits unchanged
    dyn_orgs = [top_k[[0, 5]], top_k[[7, 1]], top_k[[3, 3]], top_k[[90, 2]]]
    dyn_starts = [0, 30, 11, 57]
    dyn_p = [plist[j] for j in (0, 3, 4, 7)]
    d_static = eng.merge_lane_statics([p.static_part() for p in dyn_p])
    d_knobs = eng.stack_knobs([p.knob_values() for p in dyn_p])
    solo = []
    for p, o_, s0 in zip(dyn_p, dyn_orgs, dyn_starts):
        o_t = torch.as_tensor(o_, device=dev)
        st = init_state(rng.prng_key(42, dev), tables_k, o_t, p)
        st, _ = run_rounds(d_static, tables_k, o_t, st, s0,
                           knobs=p.knob_values())
        solo.append((o_t, st))
    d_states = eng.SimState(*(torch.stack(x) for x in zip(
        *(st for _, st in solo))))
    d_out, d_rows = eng.run_rounds_lanes_dyn(
        d_static, tables_k, eng.stack_origins(dyn_orgs), d_states, d_knobs,
        20, dyn_starts, detail=True)
    for j, ((o_t, st), p, s0) in enumerate(zip(solo, dyn_p, dyn_starts)):
        s_j, r_j = run_rounds(d_static, tables_k, o_t, st, 20, start_it=s0,
                              detail=True, knobs=p.knob_values())
        bad = (all_equal({k: v[:, j] for k, v in d_rows.items()}, r_j)
               + all_equal(eng.lane_state(d_out, j), s_j))
        if bad:
            fail(f"(k) dyn lane {j} differs from its solo run in {bad}")
    spliced = eng.splice_lane_state(d_out, 2, eng.lane_state(d_states, 2))
    for j in (0, 1, 3):
        if all_equal(eng.lane_state(spliced, j), eng.lane_state(d_out, j)):
            fail(f"(k) splicing lane 2 changed lane {j}")
    say("(k) run_rounds_lanes_dyn: 4 lanes at their own origins and start "
        "iterations (0, 30, 11, 57), 20 rounds, each equal to its solo run; "
        "splicing lane 2 leaves the others' bits unchanged")
    del d_out, d_rows, d_states, spliced, solo

    # cuda == cpu: a churn lane sweep at N=2,000
    churn = ["--num-synthetic-nodes", "2000", "--iterations", "60",
             "--warm-up-rounds", "20", "--test-type", "churn",
             "--churn-fail-rate", "0.01", "--churn-recover-rate", "0.2",
             "--num-simulations", "3", "--step-size", "0.02"]
    same(sweep(churn, 3), sweep(churn, 3, "cpu"),
         "churn lane sweep cuda against cpu")
    say("(k) churn lane sweep at N=2,000: cuda equals cpu")

    # a traffic sweep with --sweep-lanes runs as lanes, equal to its serial
    # sweep (phase (l) measures traffic lanes at full width)
    tr_small = ["--num-synthetic-nodes", str(N_PARITY), "--iterations",
                "30", "--warm-up-rounds", "10", "--traffic-values", "8",
                "--test-type", "traffic-rate", "--num-simulations", "3",
                "--step-size", "2", "--node-ingress-cap", "12"]
    tr_runs = []
    for lanes in (2, 0):
        reset_unique_pubkeys()
        cfg_ = cli.config_from_args(cli.build_parser().parse_args(
            tr_small + ["--device", "cuda"]
            + (["--sweep-lanes", str(lanes)] if lanes else [])))
        coll_, q_ = TrafficStatsCollection(), DatapointQueue()
        rep_ = cli.run_traffic(cfg_, "u", q_, "77", collection=coll_)
        if rep_["sweep_lanes"] != lanes:
            fail(f"(k) the traffic sweep at --sweep-lanes {lanes} reports "
                 f"sweep_lanes {rep_['sweep_lanes']}")
        tr_runs.append(([x.parity_snapshot() for x in coll_.collection],
                        q_.drain_deterministic_lines()))
    if tr_runs[0] != tr_runs[1]:
        fail("(k) the traffic lane sweep differs from its serial sweep")
    say("(k) a 3-point traffic-rate sweep at --sweep-lanes 2 (batches of 2 "
        "and 1) equals its serial sweep (snapshots and Influx lines)")

    # more than 64 lanes: a 66-point packet-loss sweep at N=500 in one
    # batch of 66 lanes (run as groups of at most 64 records), its points
    # at both ends of the groups against their serial runs
    wide_argv = ["--num-synthetic-nodes", str(N_SMALL), "--iterations", "30",
                 "--warm-up-rounds", "10", "--test-type", "packet-loss",
                 "--num-simulations", "66", "--step-size", "0.005"]
    reset_unique_pubkeys()
    args_w = cli.build_parser().parse_args(
        wide_argv + ["--device", "cuda", "--sweep-lanes", "66"])
    cfg_w = cli.config_from_args(args_w)
    coll_w = cli.GossipStatsCollection()
    coll_w.set_number_of_simulations(cfg_w.num_simulations)
    t0 = time.perf_counter()
    times_w = cli.dispatch_sweeps(cfg_w, "u", args_w.origin_rank, coll_w,
                                  None, "77")
    wall_w = time.perf_counter() - t0
    if (times_w or {}).get("lanes") != 66 or times_w.get("batches") != 1:
        fail(f"(k) the 66-point sweep ran {times_w}, not one batch of 66 "
             f"lanes")
    for i in (0, 63, 64, 65):
        reset_unique_pubkeys()
        c_i, start_i = cli._stepped_sweep_config(cfg_w, i,
                                                 args_w.origin_rank)
        coll_i = cli.GossipStatsCollection()
        cli.run_simulation(c_i, "u", coll_i, None, i, "77", start_i)
        if (snapshot_strings(coll_i.collection[0].parity_snapshot())
                != snapshot_strings(coll_w.collection[i].parity_snapshot())):
            fail(f"(k) point {i} of the 66-lane sweep differs from its "
                 f"serial run")
    say(f"(k) a 66-point packet-loss sweep at N={N_SMALL} with --sweep-lanes "
        f"66: 1 batch of 66 lanes ({wall_w:.3f} s: cluster build "
        f"{times_w['cluster_s']:.3f} s, engine {times_w['engine_s']:.3f} s, "
        f"harvest {times_w['harvest_s']:.3f} s); points 0, 63, 64 and 65 "
        f"equal their serial runs")
    say(f"(k) lanes phase: {time.perf_counter() - t_k:.1f} s")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "lanes_k.json").write_text(json.dumps(
        as_builtins({"kernels": lane_k, "device": ln_dev,
                     "engine": eng_runs, "cli": cli_k}), indent=1))

    # ---- (l) traffic lanes at N=10,000 on cuda -----------------------------
    phase("l")
    t_l = time.perf_counter()
    from gossip_sim_tpu_torch.engine import traffic as tr_eng
    from gossip_sim_tpu_torch.kernels import _lanes
    tr_mod = importlib.import_module(
        "gossip_sim_tpu_torch.kernels.traffic_rescue")
    ttables_l = tr_eng.device_traffic_tables(stakes_k, dev)
    # the six kernels' lane calls on round 19 of TL_K lanes at M=256 (the
    # rescue on the adaptive lanes' first round from 39 with values in
    # their pull phase): each lane's part against the kernel's one-lane
    # call and the plain version's, lane by lane; timed in turns beside
    # the sum of the one-lane calls; the bound the sum of the lanes'
    base_l = fresh()
    _, rows_l19, calls_l = traffic_lanes_at(
        kernels, traffic_lane_params(EngineParams, TL_K), tables_k,
        ttables_l, stakes_k, dev, TRAFFIC_KERNELS)
    peak_l19 = peak_above(base_l)
    r_it, rows_lr, rcalls_l = traffic_lanes_at(
        kernels, traffic_lane_params(EngineParams, TL_K, adaptive=True),
        tables_k, ttables_l, stakes_k, dev, ["traffic_rescue"], 39, 139)
    calls_l.update(rcalls_l)
    per_lane = lambda rows, k: rows[k].reshape(-1).tolist()
    say(f"(l) round 19 of {TL_K} traffic lanes (M={M_TRAFFIC}, rate "
        f"{TRAFFIC_RATE}): delivered {per_lane(rows_l19, 'delivered')}, "
        f"deferred {per_lane(rows_l19, 'deferred')}, queue_dropped "
        f"{per_lane(rows_l19, 'queue_dropped')}, dropped "
        f"{per_lane(rows_l19, 'dropped')}, suppressed "
        f"{per_lane(rows_l19, 'suppressed')}; peak {peak_l19:.1f} MiB above "
        f"what was held over its 20 rounds; adaptive lanes' round {r_it}: "
        f"pull_active_values {per_lane(rows_lr, 'pull_active_values')}, "
        f"pull_rescued {per_lane(rows_lr, 'pull_rescued')}")
    if not (per_lane(rows_l19, "dropped")[0] == 0
            < per_lane(rows_l19, "dropped")[1]
            and per_lane(rows_l19, "deferred")[1] > 0
            and per_lane(rows_l19, "suppressed")[3] > 0):
        fail("(l) the lanes' round 19 does not show each lane's own knobs")
    lanes_l = {}
    for name in ADAPTIVE_KERNELS:
        if len(calls_l[name]) != 1:
            fail(f"(l) {name}: {len(calls_l[name])} calls in a lane round")
        a, kw = calls_l[name][0]
        got = real[name](*a, **kw)
        ones = [_lanes.one_lane_call(name, a, kw, j, M_TRAFFIC)
                for j in range(TL_K)]
        err, moved, hashes = 0, 0, [0, 0]
        for j, (a1, k1) in enumerate(ones):
            one = real[name](*a1, **k1)
            part = _lanes.lane_part(name, got, j, M_TRAFFIC)
            e1, e2 = (max_abs_err(part, one),
                      max_abs_err(part, plain[name](*a1, **k1)))
            if min(e1, e2) < 0:
                fail(f"(l) {name}: lane {j}'s part of the lane call has "
                     f"another shape or dtype than its one-lane call")
            err = max(err, e1, e2)
            if name == "traffic_rescue":
                b, eh, nh = rescue_work(a1, k1, one, tr_mod)
                moved, hashes = moved + b, [hashes[0] + eh, hashes[1] + nh]
            else:
                moved += traffic_bytes(name, a1, k1, one)
            del one, part
        worst[f"{name} lanes"] = err
        if err != 0:
            fail(f"(l) {name}: a lane of the lane call differs from its "
                 f"one-lane call or plain version (max_abs_err {err})")
        if name == "traffic_rescue":
            b_ms, b_by = rescue_bound(moved, *hashes)
        else:
            b_ms, b_by = moved / HBM_BYTES_PER_S * 1e3, "bytes"
        ms = {"lanes": [], "one_lane_sum": []}
        for what in ("lanes", "one_lane_sum", "one_lane_sum", "lanes"):
            ms[what].append(cuda_ms(
                (lambda: real[name](*a, **kw)) if what == "lanes" else
                (lambda: [real[name](*a1, **k1) for a1, k1 in ones]),
                reps=10))
        lanes_l[name] = dict(k=TL_K, m=M_TRAFFIC, max_abs_err=err,
                             ms=ms["lanes"],
                             one_lane_sum_ms=ms["one_lane_sum"],
                             bound_ms=b_ms, bound_by=b_by, bytes=moved)
        say(f"(l) {name}: the lane call of {TL_K} lanes x {M_TRAFFIC} values "
            f"exact against each lane's one-lane call and plain version; "
            f"CUDA-event ms in turns: lane call "
            + " / ".join(f"{v:.4f}" for v in ms["lanes"])
            + f", the {TL_K} one-lane calls "
            + " / ".join(f"{v:.4f}" for v in ms["one_lane_sum"])
            + f"; bound {b_ms:.4f} ms by {b_by} ({moved} bytes)")
        del got, ones, a, kw
    del calls_l, rcalls_l, rows_l19, rows_lr
    torch.cuda.empty_cache()
    tl_run = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), TRAFFIC_LANES_FLAG],
        capture_output=True, text=True, timeout=400, cwd=ROOT)
    for line in tl_run.stdout.splitlines()[:-1]:
        print(line, flush=True)
    if tl_run.returncode != 0:
        fail(f"(l) the --profile-traffic-lanes process failed (exit "
             f"{tl_run.returncode}): {tl_run.stderr[-2000:]}")
    tl_dev = json.loads(tl_run.stdout.splitlines()[-1])
    for name, v in tl_dev["kernels"].items():
        lanes_l[name].update(v)
        say(f"(l) {name}: device ms lane call {fmt(v['device_ms'])}, the "
            f"{TL_K} one-lane calls {fmt(v['one_lane_sum_device_ms'])}, "
            f"bound {lanes_l[name]['bound_ms']:.4f} ms")
    for tag, v in tl_dev["rounds"].items():
        say(f"(l) a round of {tag} (5 from round 20): busy {v['busy_ms']} "
            f"ms, wall {v['wall_ms']} ms, device launches {v['launches']}")

    # the engine: a lane batch's rounds, then its lanes' serial rounds
    # (wall, peak memory, kernel launches); each lane equal to its serial
    # run
    L_ROUNDS = 30
    eng_l = {}

    def timed_l(tag, fn):
        base = fresh()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        eng_l.setdefault(tag, []).append(dict(
            wall_ms=(time.perf_counter() - t0) / L_ROUNDS * 1e3,
            peak_mib=peak_above(base),
            launches={n: v / L_ROUNDS for n, v in kernels.LAUNCHES.items()
                      if v}))
        return out

    for k_l, m_l in ((TL_K, M_TRAFFIC), (TL_K_NARROW, M_NARROW)):
        plist = traffic_lane_params(EngineParams, k_l, m_l)
        static = eng.merge_lane_statics([p.static_part() for p in plist])
        kst = eng.stack_knobs([p.knob_values() for p in plist])
        st0 = tr_eng.init_traffic_state(stakes_k, plist[0], 42, dev)
        lane_tag, serial_tag = f"lanes K={k_l} M={m_l}", f"serial x{k_l} " \
            f"M={m_l}"
        timed_l(lane_tag, lambda: tr_eng.run_traffic_lanes(
            static, tables_k, ttables_l,
            tr_eng.broadcast_traffic_state(st0, k_l), kst, L_ROUNDS))
        timed_l(serial_tag, lambda: [tr_eng.run_traffic_rounds(
            p, tables_k, ttables_l, st0, L_ROUNDS) for p in plist])
        want = {n: k_l * 1.0 for n in TRAFFIC_KERNELS}
        got_l = eng_l[lane_tag][0]["launches"]
        got_s = eng_l[serial_tag][0]["launches"]
        if got_l != {n: 1.0 for n in TRAFFIC_KERNELS} or got_s != want:
            fail(f"(l) kernel launches per round: {k_l} lanes {got_l}, "
                 f"{k_l} serial rounds {got_s}")
        states_b, rows_b = tr_eng.run_traffic_lanes(
            static, tables_k, ttables_l,
            tr_eng.broadcast_traffic_state(st0, k_l), kst, L_ROUNDS)
        for j in sorted({0, k_l - 1}):
            s_j, r_j = tr_eng.run_traffic_rounds(plist[j], tables_k,
                                                 ttables_l, st0, L_ROUNDS)
            bad = (rows_differ({k: v[:, j] for k, v in rows_b.items()}, r_j)
                   + all_equal(tr_eng.traffic_lane_state(states_b, j), s_j))
            if bad:
                fail(f"(l) {lane_tag}: lane {j} differs from its serial run "
                     f"in {bad}")
        del states_b, rows_b, st0
        for tag in (lane_tag, serial_tag):
            runs_ = eng_l[tag]
            say(f"(l) engine {tag}, {L_ROUNDS} rounds: per round "
                + " / ".join(f"{r['wall_ms']:.3f}" for r in runs_)
                + " ms wall, peak "
                + " / ".join(f"{r['peak_mib']:.1f}" for r in runs_)
                + " MiB above what was held; kernel launches per round "
                + f"{sum(runs_[0]['launches'].values()):.0f}")
        torch.cuda.empty_cache()

    # the CLI: traffic lane sweeps against the serial sweeps, in turns
    real_lane_sweep = cli._run_traffic_lane_sweep

    def traffic_sweep(argv, lanes, device="cuda"):
        reset_unique_pubkeys()
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            argv + ["--device", device]
            + (["--sweep-lanes", str(lanes)] if lanes else [])))
        coll, q = TrafficStatsCollection(), DatapointQueue()
        times = []
        cli._run_traffic_lane_sweep = lambda *a, **k_: times.append(
            real_lane_sweep(*a, **k_))
        try:
            base = fresh() if device == "cuda" else 0
            t0 = time.perf_counter()
            report = cli.run_traffic(cfg, "u", q, "77", collection=coll)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = peak_above(base) if device == "cuda" else None
        finally:
            cli._run_traffic_lane_sweep = real_lane_sweep
        if bool(lanes) != bool(times) or report["sweep_lanes"] != lanes:
            fail(f"(l) {argv}: --sweep-lanes {lanes} ran "
                 f"{'lanes' if times else 'serially'}")
        return dict(summaries=[x.summary() for x in coll.collection],
                    snapshots=[x.parity_snapshot() for x in coll.collection],
                    lines=q.drain_deterministic_lines(), report=report,
                    wall=wall, peak_mib=peak,
                    times=times[0] if times else None)

    def same_sweep(a, b, what):
        if (a["summaries"] != b["summaries"] or a["snapshots"]
                != b["snapshots"] or a["lines"] != b["lines"]):
            fail(f"(l) {what}: summaries, parity snapshots or deterministic "
                 f"lines differ")

    cli_l = {}
    for what, argv, k_l in (
            (f"traffic-rate M={M_TRAFFIC}", base_cli + [
                "--traffic-values", str(M_TRAFFIC), "--iterations", "100",
                "--warm-up-rounds", "60", "--test-type", "traffic-rate",
                "--traffic-rate", "4", "--num-simulations", str(TL_K),
                "--step-size", "4", "--node-ingress-cap",
                str(TRAFFIC_CAPS[0]), "--node-egress-cap",
                str(TRAFFIC_CAPS[1])], TL_K),
            (f"packet-loss M={M_NARROW}", base_cli + [
                "--traffic-values", str(M_NARROW), "--traffic-rate", "4",
                "--iterations", "60", "--warm-up-rounds", "30",
                "--test-type", "packet-loss", "--num-simulations",
                str(TL_K_NARROW), "--step-size", "0.05",
                "--node-ingress-cap", "48", "--node-egress-cap", "64"],
             TL_K_NARROW)):
        runs_ = {"lanes": [], "serial": []}
        iters = argv[argv.index("--iterations") + 1] + " (warm-up " + \
            argv[argv.index("--warm-up-rounds") + 1] + ")"
        for turn in ("lanes", "serial"):
            out = traffic_sweep(argv, k_l if turn == "lanes" else 0)
            runs_[turn].append(out)
            same_sweep(out, runs_["lanes"][0], f"{what} ({turn})")
            t_ = out["times"]
            say(f"(l) {what} sweep, {k_l} points x {iters} iterations, "
                f"{turn}: {out['wall']:.3f} s, peak "
                f"{out['peak_mib']:.1f} MiB above what was held"
                + ("" if t_ is None else
                   f" (cluster build {t_['cluster_s']:.3f} s, engine "
                   f"{t_['engine_s']:.3f} s, harvest {t_['harvest_s']:.3f} "
                   f"s; {t_['lanes']} lanes, {t_['batches']} batch(es))"))
        s0 = runs_["lanes"][0]["report"]["traffic"]
        say(f"(l) {what}: the lane sweep equals the serial sweep (every "
            f"point's summary, parity snapshot and deterministic Influx "
            f"lines); values injected {s0['values_injected']}, delivered "
            f"{s0['delivered']}, queue dropped {s0['queue_dropped']}")
        cli_l[what] = {t_: [dict(wall=r["wall"], peak_mib=r["peak_mib"],
                                 times=r["times"]) for r in rs]
                       for t_, rs in runs_.items()}
        del runs_
    ad_argv = base_cli + [
        "--traffic-values", str(M_NARROW), "--traffic-rate", "4",
        "--iterations", "60", "--warm-up-rounds", "20", "--gossip-mode",
        "adaptive", "--test-type", "adaptive-threshold",
        "--adaptive-switch-threshold", "0.5", "--num-simulations", "3",
        "--step-size", "0.2", "--node-ingress-cap", "48",
        "--node-egress-cap", "64"]
    ad_l = traffic_sweep(ad_argv, 3)
    same_sweep(ad_l, traffic_sweep(ad_argv, 0), "adaptive-threshold")
    ad_rep = ad_l["report"]["adaptive"]
    if ad_rep["pull_sent"] <= 0:
        fail(f"(l) adaptive-threshold lanes sent no pull request: {ad_rep}")
    say(f"(l) adaptive-threshold lane sweep (0.5, 0.7, 0.9; M={M_NARROW}, "
        f"60 iterations) equals the serial sweep; pull requests "
        f"{ad_rep['pull_sent']}, nodes rescued {ad_rep['pull_rescued']}")
    par_argv = ["--num-synthetic-nodes", str(N_PARITY), "--traffic-values",
                str(M_NARROW), "--traffic-rate", "4", "--iterations", "8",
                "--warm-up-rounds", "3", "--test-type", "packet-loss",
                "--num-simulations", "3", "--step-size", "0.1",
                "--node-ingress-cap", "24", "--node-egress-cap", "40",
                "--churn-fail-rate", "0.01", "--churn-recover-rate", "0.2",
                "--partition-at", "2", "--heal-at", "6"]
    same_sweep(traffic_sweep(par_argv, 3), traffic_sweep(par_argv, 3, "cpu"),
               "packet-loss lanes cuda against cpu")
    say(f"(l) packet-loss lane sweep at N={N_PARITY}, M={M_NARROW} (caps, "
        f"churn, a partition): cuda equals cpu")
    say(f"(l) traffic lanes phase: {time.perf_counter() - t_l:.1f} s")
    (ROOT / "chiprun_out" / "traffic_lanes_l.json").write_text(json.dumps(
        as_builtins({"kernels": lanes_l, "device": tl_dev, "engine": eng_l,
                     "cli": cli_l}), indent=1))

    # ---- (m) checkpoints, the run journal, --resume, the supervisor -------
    phase("m")
    t_m = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           RESUME_FLAG], capture_output=True, text=True,
                          timeout=900, cwd=ROOT)
    (out_dir / "resume_phase.txt").write_text(
        proc.stdout + "\n--- stderr ---\n" + proc.stderr[-200_000:])
    if proc.returncode != 0:
        fail(f"(m) the --resume-phase process failed (exit "
             f"{proc.returncode}): {proc.stderr[-3000:]}")
    resume_res = None
    for ln in proc.stdout.splitlines():
        if ln.startswith("chip_smoke: (m)"):
            print(ln, flush=True)
        elif ln.startswith("RESUME "):
            resume_res = json.loads(ln[len("RESUME "):])
    if resume_res is None:
        fail("(m) the --resume-phase process printed no result")
    (out_dir / "resume.json").write_text(json.dumps(resume_res, indent=1))
    say(f"(m) checkpoint and resume phase: {time.perf_counter() - t_m:.1f} s")

    # ---- (n) the node-health observatory (--health) ----------------------
    phase("n")
    health_res, h_runs, h_digest, h_prof = health_phase(exact, worst,
                                                        out_dir)

    # ---- (o) the flight recorder (--trace-dir) ---------------------------
    phase("o")
    trace_res, t_runs = trace_phase(exact, worst, out_dir)

    # ---- (p) report -------------------------------------------------------
    phase("p")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    say("phase walls: " + ", ".join(f"({k}) {v:.1f} s"
                                    for k, v in phase_walls.items()))
    say(f"total {time.perf_counter() - t_all:.1f} s")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"gossip_sim_tpu_torch/csrc/{name}.cu",
         "replaces": f"{SOURCES[name][0]} ({SOURCES[name][1]})",
         "launches": launches[name],
         "max_abs_err": worst[name],
         "ms": res[name]["ms"], "plain_ms": res[name]["plain_ms"],
         "bound_ms": res[name]["bound_ms"],
         "bound_by": res[name]["bound_by"],
         "calls_per_round": res[name]["calls_per_round"],
         "calls_timed": res[name]["calls"],
         "library_ms": res[name]["library_ms"],
         "device_ms": engine_device[name],
         "main_ms": main_t[name][0], "main_device_ms": main_t[name][1],
         "launches_all_origins": ao_launches[name],
         "all_origins_ms": ao_ms[name],
         "all_origins_bound_ms": ao_bound[name],
         "all_origins_device_ms": ao_prof["device"][name],
         "wide_shapes": wide[name]}
        for name in names]}
    for entry in line["kernels"]:
        if entry["name"] in REDESIGNED:
            entry["whole_call"] = {shape: per[entry["name"]]
                                   for shape, per in calls_prof.items()
                                   if entry["name"] in per}
    lanes_of = lambda key: {
        f: lane_k[key].get(f) for f in ("k", "o", "max_abs_err", "ms",
                                        "one_lane_ms", "same_knobs_ms",
                                        "device_ms", "one_lane_device_ms",
                                        "same_knobs_device_ms", "bound_ms")}
    for entry in line["kernels"]:
        if entry["name"] in LANE_KERNELS:
            entry["lanes"] = lanes_of(entry["name"])
    main_pp = pull_res["push-pull impaired cap 0"]
    line["kernels"].append(
        {"name": PX, "route": "cuda",
         "source": f"gossip_sim_tpu_torch/csrc/{PX}.cu",
         "replaces": f"{SOURCES[PX][0]} ({SOURCES[PX][1]})",
         "launches": cli_runs["push-pull"]["launches"][PX],
         "max_abs_err": worst[PX],
         "ms": main_pp["ms"], "plain_ms": main_pp["plain_ms"],
         "bound_ms": main_pp["bound_ms"], "bound_by": "bytes",
         "library_ms": pull_library_ms,
         "device_ms": pull_dev["push-pull impaired cap 0"],
         "cases": {c: {"o": r["o"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                       "bound_ms": r["bound_ms"],
                       "device_ms": pull_dev[c], "geometry": r["geometry"]}
                   for c, r in pull_res.items()},
         "launches_all_origins": pp_launches[PX],
         "all_origins_origin_rounds_s": AO_ORIGINS * 300 / pp_rounds_s,
         "one_batch_origin_rounds_s": pp_wide_rounds_s,
         "one_batch_peak_mib": pp_wide_peak / 2**20,
         "launches_per_round_push_pull": pp_prof.get("launches"),
         "lanes": lanes_of(PX)})
    tr_u, tr_c = traffic_res["uncapped"], traffic_res["capped"]
    for entry in line["kernels"]:
        if entry["name"] in TRAFFIC_KERNELS:
            entry.update(
                launches_traffic=traffic_cli["uncapped"]["launches"][
                    entry["name"]],
                traffic_ms=tr_u[entry["name"]]["ms"],
                traffic_device_ms=tr_dev["uncapped M=256"][entry["name"]],
                traffic_bound_ms=tr_u[entry["name"]]["bound_ms"])
    for name in TRAFFIC_KERNELS[:2]:
        line["kernels"].append(
            {"name": name, "route": "cuda",
             "source": f"gossip_sim_tpu_torch/csrc/{name}.cu",
             "replaces": f"{SOURCES[name][0]} ({SOURCES[name][1]})",
             "launches": traffic_cli["uncapped"]["launches"][name],
             "max_abs_err": worst[name],
             "ms": tr_u[name]["ms"], "plain_ms": tr_u[name]["plain_ms"],
             "bound_ms": tr_u[name]["bound_ms"], "bound_by": "bytes",
             "library_ms": tr_u[name]["library_ms"],
             "device_ms": tr_dev["uncapped M=256"][name],
             "capped": {k: tr_c[name][k] for k in ("ms", "plain_ms",
                                                    "bound_ms",
                                                    "library_ms")},
             "capped_device_ms": tr_dev["capped M=256"][name],
             "device_ms_m32": tr_dev[f"uncapped M={M_NARROW}"][name],
             "bound_ms_m32": narrow_bound[name],
             "launches_capped": traffic_cli["capped"]["launches"][name],
             "slot_sort_ms": tr_u[name].get("slot_sort_ms")})
        if name in REDESIGNED:
            line["kernels"][-1]["whole_call"] = {
                shape: per[name] for shape, per in calls_prof.items()
                if name in per}
    rs_u, rs_c = rescue_res["uncapped"], rescue_res["capped"]
    line["kernels"].append(
        {"name": "traffic_rescue", "route": "cuda",
         "source": "gossip_sim_tpu_torch/csrc/traffic_rescue.cu",
         "replaces": (f"{SOURCES['traffic_rescue'][0]} "
                      f"({SOURCES['traffic_rescue'][1]})"),
         "launches": adaptive_cli["uncapped"]["launches"]["traffic_rescue"],
         "max_abs_err": worst["traffic_rescue"],
         "ms": rs_u["ms"], "plain_ms": rs_u["plain_ms"],
         "bound_ms": rs_u["bound_ms"], "bound_by": rs_u["bound_by"],
         "library_ms": rs_u["library_ms"],
         "device_ms": tr_dev[f"adaptive uncapped M={M_TRAFFIC}"][
             "traffic_rescue"],
         "round": rs_u["round"],
         "capped": {k: rs_c[k] for k in ("round", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")},
         "capped_device_ms": tr_dev[f"adaptive capped M={M_TRAFFIC}"][
             "traffic_rescue"],
         "launches_capped": adaptive_cli["capped"]["launches"][
             "traffic_rescue"],
         "adaptive_round_busy_ms": prof_ad.get("busy_ms"),
         "adaptive_round_launches": prof_ad.get("launches"),
         "push_round_busy_ms": prof_push.get("busy_ms"),
         "push_round_launches": prof_push.get("launches"),
         "adaptive_cli_rounds_s": {c: r["rounds_s"]
                                   for c, r in adaptive_cli.items()},
         "adaptive_cli_value_rounds_s": {c: r["value_rounds_s"]
                                         for c, r in adaptive_cli.items()}})
    dev_of = lambda n, o, which: sp_dev[f"N={n} O={o} {which}"]
    line["kernels"].append(
        {"name": "rc_merge_prune", "variant": "sparse", "route": "cuda",
         "source": "gossip_sim_tpu_torch/csrc/rc_merge_prune.cu",
         "replaces": (f"{SOURCES['rc_merge_prune'][0]} "
                      f"({SOURCES['rc_merge_prune'][1]}; the sparse arms at "
                      f"core.py:783-816, 835-842)"),
         "launches": cli_h["sparse"]["launches"][SPARSE],
         "max_abs_err": worst[SPARSE],
         "ms": sp_res["ms"], "plain_ms": sp_res["plain_ms"],
         "bound_ms": sp_res["bound_ms"], "bound_by": "bytes",
         "library_ms": sp_res["library_ms"],
         "device_ms": dev_of(N_FULL, O_KERNEL, "sparse")["device_ms"],
         "dense_ms": sp_res["dense_ms"],
         "dense_device_ms": dev_of(N_FULL, O_KERNEL, "dense")["device_ms"],
         "device_ms_o64": dev_of(N_FULL, O_PULL, "sparse")["device_ms"],
         "dense_device_ms_o64": dev_of(N_FULL, O_PULL, "dense")["device_ms"],
         "n100k_o41": {"ms": h_ms, "bound_ms": h_bound,
                       "device_ms": dev_of(N_HUGE, O_HUGE,
                                           "sparse")["device_ms"],
                       "dense_device_ms": dev_of(N_HUGE, O_HUGE,
                                                 "dense")["device_ms"]},
         "rounds": {k: {f: v.get(f) for f in ("busy_ms", "wall_ms",
                                               "launches")}
                    for k, v in sp_dev.items()},
         "engine_o32": {w: [{k: r[k] for k in ("wall_ms", "peak_mib")}
                            for r in runs_] for w, runs_ in eng_sp.items()},
         "all_origins": {f"{'auto' if w == 0 else 'one batch'} {which}": [
             {k: r[k] for k in ("origin_rounds_s", "peak_mib", "wall")}
             for r in runs_] for (w, which), runs_ in ao_sp.items()},
         "engine_n100k_o41": {w: {k: v[k] for k in ("wall_ms", "peak_mib")}
                              for w, v in huge.items()},
         "cli_n100k": {w: {k: v[k] for k in ("wall", "peak_mib")}
                       for w, v in cli_h.items()},
         "lanes": lanes_of(SPARSE)})
    for entry in line["kernels"]:
        if entry["name"] in ("bfs_relax", "rc_merge_prune"):
            sparse_entry = entry.get("variant") == "sparse"
            entry["rounds_19_20"] = {
                k: {f: v.get(f) for f in (
                    "max_abs_err", "device_ms", "ms", "bytes", "bound_ms",
                    "bound_by", "floor_ms", "hops", "fired_rows", "rows")
                    if f in v}
                for k, v in rd.items() if k.startswith(entry["name"])
                and ("rc_merge_prune sparse" in k) == sparse_entry}
    for entry in line["kernels"]:
        if entry["name"] in ADAPTIVE_KERNELS and "variant" not in entry:
            entry["traffic_lanes"] = {
                f: lanes_l[entry["name"]].get(f)
                for f in ("k", "m", "max_abs_err", "ms", "one_lane_sum_ms",
                          "device_ms", "one_lane_sum_device_ms", "bound_ms",
                          "bound_by")}
    hr, ht, hd = (health_res[k] for k in ("round", "traffic", "digest"))
    h_main_r = hr[f"O={O_KERNEL} dense round 19"]
    h_main_t = ht[f"M={M_TRAFFIC} round 19"]
    single, traffic_on = (h_runs["single 10k"]["on"],
                          h_runs[f"traffic M={M_TRAFFIC}"]["on"])
    src = "gossip_sim_tpu_torch/csrc/{}.cu".format
    for name, variant, main, runs_, cases in (
            ("health_round", None, h_main_r, single, hr),
            ("health_round_traffic", "traffic", h_main_t, traffic_on, ht)):
        entry = {"name": "health_round", "route": "cuda",
                 "source": src("health_round"),
                 "replaces": (f"{HEALTH_SOURCES[name][0]} "
                              f"({HEALTH_SOURCES[name][1]})"),
                 "launches": runs_["launches"][name],
                 "max_abs_err": worst[name],
                 "ms": main["ms"], "plain_ms": main["plain_ms"],
                 "bound_ms": main["bound_ms"], "bound_by": "bytes",
                 "library_ms": main["library_ms"],
                 "library_call": "index_add_ of the round's pairs",
                 "device_ms": main["device_ms"], "cases": cases}
        if variant:
            entry["variant"] = variant
        else:
            entry["round_profile"] = h_prof
        line["kernels"].append(entry)
    d_main = h_digest["single 10k"]
    line["kernels"].append(
        {"name": "health_digest", "route": "cuda",
         "source": src("health_digest"),
         "replaces": (f"{HEALTH_SOURCES['health_digest'][0]} "
                      f"({HEALTH_SOURCES['health_digest'][1]})"),
         "launches": single["launches"]["health_digest"],
         "max_abs_err": worst["health_digest"],
         "ms": d_main["ms"], "plain_ms": d_main["plain_ms"],
         "bound_ms": d_main["bound_ms"], "bound_by": "bytes",
         "library_ms": d_main["library_ms"],
         "library_call": "stable torch.sort of the [P, N] stack",
         "device_ms": hd[f"sim O={O_KERNEL}"]["device_ms"],
         "main_path": h_digest, "cases": hd})
    # the flight recorder: the traced calls of the three kernels that
    # gained a trace output, and trace_prune_pairs
    t_calls = trace_res["calls"]
    t_single = t_runs["single 10k push"]["on"]
    t_pp = t_runs["single 10k push-pull"]["on"]
    for entry in line["kernels"]:
        name = entry["name"]
        if name in TRACED_SOURCES and "variant" not in entry:
            key = next(k for k in t_calls if k.startswith(name + " "))
            entry["trace"] = dict(
                t_calls[key], call=key.split(" ", 1)[1],
                replaces=f"gossip_sim_tpu/engine/{TRACED_SOURCES[name]}",
                launches=(t_pp if name == "pull_exchange"
                          else t_single)["launches"][name])
    # the first case: round 19 at the auto cap
    main_pairs = next(iter(trace_res["pairs"].values()))
    line["kernels"].append(
        {"name": "trace_prune_pairs", "route": "cuda",
         "source": src("trace_prune_pairs"),
         "replaces": (f"{TRACE_SOURCES['trace_prune_pairs'][0]} "
                      f"({TRACE_SOURCES['trace_prune_pairs'][1]})"),
         "launches": t_single["launches"]["trace_prune_pairs"],
         "max_abs_err": worst["trace_prune_pairs"],
         "ms": main_pairs["ms"], "plain_ms": main_pairs["plain_ms"],
         "bound_ms": main_pairs["bound_ms"], "bound_by": "bytes",
         "library_ms": main_pairs["library_ms"],
         "library_call": "torch.nonzero of the pruned slots and a gather "
                         "of their prunees",
         "device_ms": main_pairs["device_ms"], "cases": trace_res["pairs"],
         "round_profile": trace_res["round_profile"],
         "cli": {case: {"wall": r["on"]["wall"], "off_wall": r["off"]["wall"],
                        "replay_wall": (r["on"]["replay"] or [None])[0],
                        "write_s": sum(w for w, _ in r["on"]["writes"]),
                        "bytes": r["on"]["bytes"],
                        "segments": r["on"]["segments"],
                        "rounds": r["on"]["rounds"]}
                 for case, r in t_runs.items()}})
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [CALLS_FLAG] and len(sys.argv) <= 3:
        sys.exit(calls_child(Path(sys.argv[2]) if len(sys.argv) == 3
                             else ROOT))
    if sys.argv[1:] == [RESUME_FLAG]:
        sys.exit(resume_child())
    if sys.argv[1:] == [HEALTH_FLAG]:
        sys.exit(health_child())
    if sys.argv[1:] == [TRACE_FLAG]:
        sys.exit(trace_child())
    if sys.argv[1:3] == [RESUME_FLAG, TRAFFIC_PART] and len(sys.argv) <= 4:
        sys.exit(resume_child(*(sys.argv[3:] or ["cuda"]),
                              part=TRAFFIC_PART))
    if sys.argv[1:2] == [SPARSE_FLAG] and len(sys.argv) <= 3:
        sys.exit(sparse_child(Path(sys.argv[2]) if len(sys.argv) == 3
                              else ROOT))
    sys.exit(profile_child(sys.argv[1])
             if sys.argv[1:] in ([PROFILE_FLAG], [WIDE_FLAG], [PULL_FLAG],
                                 [TRAFFIC_FLAG], [LANES_FLAG],
                                 [TRAFFIC_LANES_FLAG])
             else main())
