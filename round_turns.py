#!/usr/bin/env python3
"""Time the port's engine round on one GPU for several checkouts, in turns.

    python3 round_turns.py [--push-pull | --traffic | --calls | --lanes |
                            --merge-bfs | --health] TREE ...

Each TREE is the root of a checkout of the repository (``.`` for this
one); give two trees in turns, e.g. ``build/parent . . build/parent``, to
compare a change with its parent on one card.  Each tree runs in a process
of its own, which imports ``gossip_sim_tpu_torch`` from that tree (its
kernels build into the tree's ``build/kernels``) and measures, on the
synthetic cluster of N=10,000 nodes (chip_smoke.py's shape), for each
shape: ``init_state``, 10 rounds of warm-up, 50 rounds timed on the host
clock (wall per round, ending in a synchronize), the peak device memory of
those rounds above the state, and a 5-round profile (device busy per
round, launches per round, device time per kernel), read by
chip_smoke.py's ``profile_rounds`` (its text goes to
``chiprun_out/profile_roundturns_<tree>.txt``).  The shape is push mode
at O=32 origins; with ``--push-pull`` it is each push-pull case of
chip_smoke.py's phase (h) (``pull_cases``: loss 0.1 + partition + churn at
O=64 with the request cap off and at 2, at O=32, and O=1), whose
``pull_exchange`` device time per round is its time per call, and then
all-origins push-pull on origins 0-199 in one batch of 200 (300
iterations, 200 warm-up; origin-rounds/s over the batch's rounds span,
and peak device memory).  The push mode also runs all-origins push on
origins 0-199 at the auto batch of 64 (origin-rounds/s over the batches'
rounds spans).  With ``--traffic`` it is chip_smoke.py's phase (i): the
traffic round at M=256 value slots uncapped and capped (caps 192/256
under loss + churn + a partition) and at M=32 uncapped, after 20 rounds
(the same wall, memory and profile per round), then the full-width
traffic CLI run (300 iterations, 200 warm-up) uncapped and capped:
traffic rounds/s and value-rounds/s over the engine calls' span.  With
``--calls`` each tree runs chip_smoke.py ``--profile-calls TREE``: the
kernel-only and whole-call device ms of ``prune_apply``,
``traffic_admit`` and ``traffic_send`` on round 19's inputs of each shape
chip_smoke times them at.  With ``--merge-bfs`` each tree runs
chip_smoke.py ``--profile-sparse TREE``: ``rc_merge_prune`` (dense,
sparse, the traffic form) and ``bfs_relax`` on the inputs of rounds 19
(rows fire) and 20 at O=1, 32 and 64 of N=10,000, O=41 of N=100,000, (i)'s
M=256 and (k)'s 8 lanes x 4 origins: device ms, CUDA-event ms, exact
against the tree's plain version, and (for this checkout) ``bfs_relax``'s
latency floor; and the 5-round profiles of both layouts at O=32 and 64 of
N=10,000 and O=41 of N=100,000.  With ``--lanes`` it is the serial push round
at O=32 (as without a flag) and, where the tree has sweep lanes
(``engine.run_rounds_lanes``; a parent without them runs the serial half
only), a round of K=8 lanes of one origin each (packet loss 0 to 0.35,
chip_smoke.py's phase (k)) beside the serial round at O=1 under the same
gates.  With ``--health`` it is chip_smoke.py's phase (n) full-width
``--health`` CLI runs, the single origin and the M=256 traffic run (300
iterations, 200 warm-up), each once to warm up and once under
torch.profiler: the node-health kernels' device ms summed over the whole
run and their launches.  One JSON line per tree, then the card's name
and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
O, N, WARM, TIMED, PROFILED = 32, 10_000, 10, 50, 5
LANES = 8              # --lanes: lanes of one origin each
AO = 200               # all-origins on origins 0-199
WARM_TRAFFIC = 20      # --traffic: rounds before the timed ones


def one(tree: str, mode: str) -> dict:
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch

    from gossip_sim_tpu_torch import cli, kernels, rng
    from gossip_sim_tpu_torch.engine import (EngineParams, init_state,
                                             make_cluster_tables, run_rounds)
    from gossip_sim_tpu_torch.identity import NodeIndex, reset_unique_pubkeys
    # the profile is read as chip_smoke.py reads it: this script's own
    # chip_smoke.py, whichever tree the package comes from
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT
                                                  / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if not torch.cuda.is_available():
        raise SystemExit("round_turns: needs a CUDA device")
    dev = torch.device("cuda")
    kernels.build_all()
    reset_unique_pubkeys()
    accounts, _ = cli.load_cluster_accounts(
        cli.Config(num_synthetic_nodes=N))
    stakes = NodeIndex.from_stakes(accounts).stakes.astype(np.int64)
    tables = make_cluster_tables(stakes, device=dev)
    top = np.argsort(-stakes, kind="stable").astype(np.int32)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)

    def measure(o: int, params, tag: str, lanes=None) -> dict:
        """One shape's rounds: ``params`` at ``o`` origins, or with
        ``lanes`` (parameter sets) those lanes of ``o`` origins each."""
        origins = torch.as_tensor(top[:o], device=dev)
        state = init_state(rng.prng_key(7, dev), tables, origins, params)
        if lanes is None:
            run = lambda st, n, s0: run_rounds(params, tables, origins, st,
                                               n, start_it=s0)
        else:
            from gossip_sim_tpu_torch import engine
            static = engine.merge_lane_statics(
                [p.static_part() for p in lanes])
            kstack = engine.stack_knobs([p.knob_values() for p in lanes])
            state = engine.broadcast_state(state, len(lanes))
            run = lambda st, n, s0: engine.run_rounds_lanes(
                static, tables, origins, st, kstack, n, start_it=s0)
        state, _ = run(state, WARM, 0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state, _ = run(state, TIMED, WARM)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / TIMED
        peak = torch.cuda.max_memory_allocated() - base
        wrapper_launches = {k: v / TIMED for k, v in kernels.LAUNCHES.items()}
        prof = smoke.profile_rounds(
            lambda p, t, o_, st, r: run(st, r, WARM + TIMED),
            params, tables, origins, state, out_dir, rounds=PROFILED,
            tag=" turns " + re.sub(r"\W", "_", tree) + tag)
        return {"o": o, "wall_ms_per_round": wall * 1e3,
                "busy_ms_per_round": prof.get("busy_ms"),
                "launches_per_round": prof.get("launches"),
                "peak_bytes_over_state": peak,
                "kernel_launches_per_round": wrapper_launches,
                "kernel_device_ms_per_round": prof["device"]}

    res = {"tree": tree, "device": torch.cuda.get_device_name(0)}
    if mode == "traffic":
        res.update(traffic(tree, smoke, stakes, tables, out_dir))
        return res
    if mode == "health":
        res.update(health(smoke))
        return res
    if mode == "lanes":
        res.update(measure(O, EngineParams(num_nodes=N, warm_up_rounds=0),
                           ""))
        import gossip_sim_tpu_torch.engine as engine
        if hasattr(engine, "run_rounds_lanes"):
            lanes = [EngineParams(num_nodes=N, warm_up_rounds=0,
                                  packet_loss_rate=0.05 * j)
                     for j in range(LANES)]
            res["lanes"] = measure(1, lanes[1], f" lanes K={LANES} O=1",
                                   lanes)
            res["serial_o1"] = measure(1, lanes[1], " serial O=1")
        return res
    if mode == "push":
        res.update(measure(O, EngineParams(num_nodes=N, warm_up_rounds=0),
                           ""))
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            ["--num-synthetic-nodes", str(N), "--iterations", "300",
             "--warm-up-rounds", "200", "--all-origins", "--device",
             "cuda"]))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reset_unique_pubkeys()
        summary = cli.run_all_origins(cfg, accounts=accounts,
                                      origin_indices=np.arange(
                                          AO, dtype=np.int32))
        torch.cuda.synchronize()
        span = sum(b["rounds_s"] for b in summary["batches"])
        res["all_origins_auto_batch"] = {
            "origins": AO, "batches": len(summary["batches"]),
            "rounds_s": span, "origin_rounds_per_s": AO * 300 / span}
        return res
    res["shapes"] = {
        case: measure(o, prm, " " + re.sub(r"\W", "_", case))
        for case, (o, prm) in smoke.pull_cases(EngineParams).items()
        if case.startswith("push-pull")}
    # all-origins push-pull: origins 0-199 in one batch of 200
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["--num-synthetic-nodes", str(N), "--iterations", "300",
         "--warm-up-rounds", "200", "--all-origins", "--device", "cuda",
         "--gossip-mode", "push-pull", "--origin-batch", str(AO)]))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_unique_pubkeys()
    summary = cli.run_all_origins(cfg, accounts=accounts,
                                  origin_indices=np.arange(AO,
                                                           dtype=np.int32))
    torch.cuda.synchronize()
    (batch,) = summary["batches"]
    res["all_origins_one_batch"] = {
        "origins": AO, "rounds_s": batch["rounds_s"],
        "origin_rounds_per_s": AO * 300 / batch["rounds_s"],
        "peak_bytes": torch.cuda.max_memory_allocated()}
    return res


def traffic(tree: str, smoke, stakes, tables, out_dir) -> dict:
    """``--traffic``: the traffic round per case, then the full-width
    traffic CLI run uncapped and capped."""
    import torch

    from gossip_sim_tpu_torch import cli, kernels
    from gossip_sim_tpu_torch.engine import EngineParams
    from gossip_sim_tpu_torch.engine.traffic import (device_traffic_tables,
                                                     init_traffic_state,
                                                     run_traffic_rounds)
    from gossip_sim_tpu_torch.identity import reset_unique_pubkeys
    ttables = device_traffic_tables(stakes, torch.device("cuda"))
    res = {"rounds": {}, "cli": {}}
    for case, m in (("uncapped", smoke.M_TRAFFIC),
                    ("capped", smoke.M_TRAFFIC),
                    ("uncapped", smoke.M_NARROW)):
        prm = smoke.traffic_params(EngineParams, case, m)
        st = init_traffic_state(stakes, prm, 42, torch.device("cuda"))
        st, _ = run_traffic_rounds(prm, tables, ttables, st, WARM_TRAFFIC)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        st, _ = run_traffic_rounds(prm, tables, ttables, st, TIMED,
                                   start_it=WARM_TRAFFIC)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / TIMED
        peak = torch.cuda.max_memory_allocated() - base
        tag = " turns " + re.sub(r"\W", "_", tree) + f" traffic {case} M={m}"
        prof = smoke.profile_rounds(
            lambda p, t, _o, s_, r: run_traffic_rounds(
                p, t, ttables, s_, r, start_it=WARM_TRAFFIC + TIMED),
            prm, tables, torch.zeros(m), st, out_dir, rounds=PROFILED,
            tag=tag, phase="(i)")
        res["rounds"][f"{case} M={m}"] = {
            "wall_ms_per_round": wall * 1e3,
            "busy_ms_per_round": prof.get("busy_ms"),
            "launches_per_round": prof.get("launches"),
            "peak_bytes_over_state": peak,
            "kernel_launches_per_round": {
                k: v / TIMED for k, v in kernels.LAUNCHES.items() if v},
            "kernel_device_ms_per_round": {
                k: v for k, v in prof["device"].items() if v}}
        del st
        torch.cuda.empty_cache()
    real_rounds = cli.run_traffic_rounds
    for case, extra in (("uncapped", []),
                        ("capped", ["--node-ingress-cap",
                                    str(smoke.TRAFFIC_CAPS[0]),
                                    "--node-egress-cap",
                                    str(smoke.TRAFFIC_CAPS[1])])):
        spans = []

        def timed_rounds(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_rounds(*a, **kw)
            torch.cuda.synchronize()
            spans.append((time.perf_counter() - t0,
                          int(out[1]["live"].sum())))
            return out

        cli.run_traffic_rounds = timed_rounds
        try:
            reset_unique_pubkeys()
            rc = cli.main(["--num-synthetic-nodes", str(N),
                           "--traffic-values", str(smoke.M_TRAFFIC),
                           "--traffic-rate", str(smoke.TRAFFIC_RATE),
                           "--iterations", "300", "--warm-up-rounds", "200",
                           "--device", "cuda"] + extra)
        finally:
            cli.run_traffic_rounds = real_rounds
        if rc != 0:
            raise SystemExit(f"round_turns: traffic CLI {case} exit {rc}")
        span = sum(w for w, _ in spans)
        res["cli"][case] = {"rounds_s": span,
                            "traffic_rounds_per_s": 300 / span,
                            "value_rounds_per_s":
                                sum(v for _, v in spans) / span}
    return res


def health(smoke) -> dict:
    """``--health``: each full-width ``--health`` CLI run once to warm up,
    then once under torch.profiler: the wall, and per node-health kernel
    its device ms summed over the run and its launches (the profiler's and
    the wrapper's count)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gossip_sim_tpu_torch import cli, kernels
    from gossip_sim_tpu_torch.identity import reset_unique_pubkeys
    symbols = {"health_round": "health_round_kernel",
               "health_round_traffic": "health_round_traffic_kernel",
               "health_digest": "health_digest_kernel"}
    base = ["--num-synthetic-nodes", str(N), "--iterations", "300",
            "--warm-up-rounds", "200", "--device", "cuda", "--health"]
    res = {}
    for case, extra in (("single 10k", []),
                        (f"traffic M={smoke.M_TRAFFIC}",
                         ["--traffic-values", str(smoke.M_TRAFFIC),
                          "--traffic-rate", str(smoke.TRAFFIC_RATE)])):
        for profiled in (False, True):
            reset_unique_pubkeys()
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            with (profile(activities=[ProfilerActivity.CUDA]) if profiled
                  else contextlib.nullcontext()) as prof:
                t0 = time.perf_counter()
                rc = cli.main(base + extra)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            if rc != 0:
                raise SystemExit(f"round_turns: {case} --health exit {rc}")
        ms = dict.fromkeys(symbols, 0.0)
        count = dict.fromkeys(symbols, 0)
        for ev in prof.key_averages():
            for name, sym in symbols.items():
                if sym in ev.key:
                    ms[name] += float(getattr(
                        ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0))) / 1e3
                    count[name] += ev.count
        res[case] = {"wall_s": wall, "device_ms": ms,
                     "profiled_launches": count,
                     "wrapper_launches": {k: kernels.LAUNCHES[k]
                                          for k in symbols}}
    return res


def main(argv: list) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        print(json.dumps(one(argv[2], argv[1])), flush=True)
        return 0
    mode = "push"
    if argv[:1] in (["--push-pull"], ["--traffic"], ["--calls"],
                    ["--lanes"], ["--merge-bfs"], ["--health"]):
        mode, argv = argv[0][2:], argv[1:]
    if not argv:
        raise SystemExit(__doc__)
    for tree in argv:
        child = {"calls": "--profile-calls",
                 "merge-bfs": "--profile-sparse"}.get(mode)
        cmd = ([sys.executable, str(ROOT / "chip_smoke.py"), child, tree]
               if child else [sys.executable, __file__, "--one", mode, tree])
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=900)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
