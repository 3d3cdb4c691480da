#!/usr/bin/env python3
"""Time the port's engine round on one GPU for several checkouts, in turns.

    python3 round_turns.py TREE [TREE ...]

Each TREE is the root of a checkout of the repository (``.`` for this
one); give two trees in turns, e.g. ``build/parent . . build/parent``, to
compare a change with its parent on one card.  Each tree runs in a process
of its own, which imports ``gossip_sim_tpu_torch`` from that tree (its
kernels build into the tree's ``build/kernels``) and measures, at O=32
origins and N=10,000 nodes of the synthetic cluster (chip_smoke.py's
shape): ``init_state``, 10 rounds of warm-up, 50 rounds timed on the host
clock (wall per round, ending in a synchronize), the peak device memory of
those rounds above the state, and a 5-round profile (device busy per
round, launches per round, device time per kernel), read by
chip_smoke.py's ``profile_rounds`` (its text goes to
``chiprun_out/profile_roundturns_<tree>.txt``).  One JSON line per tree,
then the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
O, N, WARM, TIMED, PROFILED = 32, 10_000, 10, 50, 5


def one(tree: str) -> dict:
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
    origins = torch.as_tensor(
        np.argsort(-stakes, kind="stable")[:O].astype(np.int32), device=dev)
    params = EngineParams(num_nodes=N, warm_up_rounds=0)
    state = init_state(rng.prng_key(7, dev), tables, origins, params)
    state, _ = run_rounds(params, tables, origins, state, WARM)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state, _ = run_rounds(params, tables, origins, state, TIMED,
                          start_it=WARM)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TIMED
    peak = torch.cuda.max_memory_allocated() - base
    wrapper_launches = {k: v / TIMED for k, v in kernels.LAUNCHES.items()}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    prof = smoke.profile_rounds(run_rounds, params, tables, origins, state,
                                out_dir, rounds=PROFILED,
                                tag=" turns " + re.sub(r"\W", "_", tree))
    return {"tree": tree, "device": torch.cuda.get_device_name(0),
            "wall_ms_per_round": wall * 1e3,
            "busy_ms_per_round": prof.get("busy_ms"),
            "launches_per_round": prof.get("launches"),
            "peak_bytes_over_state": peak,
            "kernel_launches_per_round": wrapper_launches,
            "kernel_device_ms_per_round": prof["device"]}


def main(argv: list) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    if not argv:
        raise SystemExit(__doc__)
    for tree in argv:
        out = subprocess.run([sys.executable, __file__, "--one", tree],
                             capture_output=True, text=True, timeout=900)
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
