#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``gossip_sim_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

  (a) build the four CUDA kernels from ``gossip_sim_tpu_torch/csrc`` with
      nvcc for sm_90a (one nvcc per source, in parallel); print each
      kernel's registers, shared memory and spills (``-Xptxas -v``) and the
      launch geometry of the two redesigned kernels (cluster size, rows per
      block, shared memory);
  (b) capture each kernel's inputs from a real round (round 19, when the
      upsert counters fire) at O=32 origins, N=10,000 nodes, and hold the
      kernel against its plain PyTorch version on the card: exact equality
      (tolerance 0: the data are integers); time kernel, plain version and
      a PyTorch yardstick with CUDA events; then run the engine at
      rc_slots=128 (a row of C + K = 144) and hold ``rc_merge_prune``
      against its plain version on its round-19 inputs;
  (c) run the engine for 50 rounds at O=32, N=10,000: rounds/s, peak
      device memory, every kernel launched;
  (d) run the CLI main path in process: 10,000 synthetic nodes,
      --iterations 300 --warm-up-rounds 200 on cuda; wall time, coverage
      and RMR means; this run's kernel launch counts go into the
      ``kernels`` line, and each kernel is held against its plain version
      on this run's own inputs of rounds 19 and 299 (O=1) and timed on
      those of round 19 (CUDA events, and device time under the
      profiler);
  (e) run the CLI on cuda and on cpu at 2,000 nodes for 60 rounds and
      require equal ``parity_snapshot()``s;
  (f) print the card's name and power limit, the ``kernels`` JSON line and
      the final ``{"ok": true, ...}`` line.

Imports nothing of JAX and nothing of the reference package.
"""

from __future__ import annotations

import importlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate (data sheet)
O_KERNEL, N_FULL = 32, 10_000
SOURCES = {"bfs_relax": ("gossip_sim_tpu/engine/core.py:620",
                         "round/bfs_propagate"),
           "rank_inbound": ("gossip_sim_tpu/engine/core.py:663",
                            "round/verb2_consume"),
           "rc_merge_prune": ("gossip_sim_tpu/engine/core.py:743",
                              "round/rc_merge + round/verb3_prune_decide"),
           "prune_apply": ("gossip_sim_tpu/engine/core.py:894",
                           "round/verb4_prune_apply")}


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
    return sum(t.numel() * t.element_size() for t in ts)


def max_abs_err(got, want) -> int:
    """Largest absolute difference over every output tensor (-1 if a shape
    or dtype differs)."""
    got = tuple(got) if isinstance(got, tuple) else (got,)
    want = tuple(want) if isinstance(want, tuple) else (want,)
    err = 0
    for x, y in zip(got, want):
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
                  "rank_inbound": ("count_kernel", "place_kernel",
                                   "select_kernel"),
                  "rc_merge_prune": ("rc_merge_prune_kernel",),
                  "prune_apply": ("prune_apply_kernel",)}


def device_ms(fn, symbols, reps: int = 10):
    """Mean device milliseconds per call of ``fn`` spent in the kernels whose
    names contain one of ``symbols``, under torch.profiler (None if the
    profiler recorded no device time)."""
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
                   rounds: int = 5) -> dict:
    """Where a round's time goes: device time per kernel group and for the
    plain PyTorch ops, over ``rounds`` rounds under torch.profiler, against
    the host wall clock (device idle share = 1 - busy / wall)."""
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
                break
        else:
            other[ev.key] = other.get(ev.key, 0.0) + us
            n_other += ev.count
    busy_ms = (sum(groups.values()) + sum(other.values())) / 1e3
    if busy_ms <= 0:
        say("(c) profiler: no device time recorded; breakdown not measured")
        return {name: None for name in groups}
    top = sorted(other.items(), key=lambda kv: -kv[1])[:12]
    lines = [f"{rounds} rounds at O={origins.numel()}: wall {wall_ms:.3f} ms,"
             f" device busy {busy_ms:.3f} ms"]
    lines += [f"  {k:>16}: {v / 1e3 / rounds:.4f} ms/round"
              for k, v in groups.items()]
    lines += [f"  other PyTorch kernels: "
              f"{sum(other.values()) / 1e3 / rounds:.4f} ms/round "
              f"({n_other / rounds:.0f} launches/round)"]
    lines += [f"    {v / 1e3 / rounds:.4f} ms/round  {k[:100]}"
              for k, v in top]
    (out_dir / "profile_round.txt").write_text("\n".join(lines) + "\n")
    say(f"(c) profile over {rounds} rounds: per round wall "
        f"{wall_ms / rounds:.3f} ms, device busy {busy_ms / rounds:.3f} ms "
        f"(idle share {1 - busy_ms / wall_ms:.3f}); kernels "
        + ", ".join(f"{k} {v / 1e3 / rounds:.4f} ms"
                    for k, v in groups.items())
        + f"; other PyTorch kernels {sum(other.values()) / 1e3 / rounds:.4f}"
        f" ms in {n_other / rounds:.0f} launches")
    for line in lines[6:]:
        say(f"(c)   {line.strip()}")
    return {k: v / 1e3 / rounds for k, v in groups.items()}


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
    from gossip_sim_tpu_torch.kernels import _build
    bfs_mod = importlib.import_module("gossip_sim_tpu_torch.kernels.bfs_relax")
    merge_mod = importlib.import_module(
        "gossip_sim_tpu_torch.kernels.rc_merge_prune")

    for mod in list(sys.modules):
        if mod == "jax" or mod == "gossip_sim_tpu" or mod.startswith(
                ("jax.", "gossip_sim_tpu.")):
            fail(f"{mod} was imported")
    names = _build.KERNEL_NAMES
    dev = torch.device("cuda")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t_all = time.perf_counter()

    # ---- (a) build -------------------------------------------------------
    build_s = kernels.build_all(force=True)
    say(f"(a) built {len(names)} kernels with nvcc (sm_90a) in "
        f"{build_s:.2f} s")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ptxas.txt").write_text(
        "\n".join(f"--- {k}\n{v}" for k, v in _build.BUILD_LOG.items()))
    for name in names:
        for line in ptxas_summary(_build.BUILD_LOG[name]):
            say(f"(a) ptxas {line}")
    sms, smem_limit = _build.sm_count(dev), _build.smem_optin(dev)
    for o in (1, O_KERNEL):
        g = bfs_mod.launch_geometry(o, N_FULL, sms, smem_limit)
        say(f"(a) bfs_relax at O={o} N={N_FULL} on {sms} SMs: cluster size "
            f"{g.cs}, slice {g.slice_len} nodes, {g.smem} B shared memory "
            f"per CTA (of {smem_limit} B)")
    for c, k in ((64, 16), (128, 16)):
        g = merge_mod.launch_geometry(c, k, smem_limit)
        say(f"(a) rc_merge_prune at C={c} K={k}: {g.rows_per_block} rows "
            f"(warps) per block, {g.smem} B shared memory per block")

    # ---- (b) kernels vs plain on a real round's inputs -------------------
    reset_unique_pubkeys()
    accounts, _ = cli.load_cluster_accounts(
        cli.Config(num_synthetic_nodes=N_FULL))
    index = NodeIndex.from_stakes(accounts)
    stakes_np = index.stakes.astype(np.int64)
    tables = make_cluster_tables(stakes_np, device=dev)
    top = np.argsort(-stakes_np, kind="stable")[:O_KERNEL].astype(np.int32)
    origins = torch.as_tensor(top, device=dev)
    params = EngineParams(num_nodes=N_FULL, warm_up_rounds=0)
    state = init_state(rng.prng_key(42, dev), tables, origins, params)
    for it in range(19):
        state, _ = round_step(params, tables, origins, state, it)
    captured = {}
    real = {name: getattr(kernels, name) for name in names}

    def recorder(name):
        def rec(*args, **kw):
            captured[name] = (args, kw)
            return real[name](*args, **kw)
        return rec

    for name in names:
        setattr(kernels, name, recorder(name))
    try:
        state, rows19 = round_step(params, tables, origins, state, 19)
    finally:
        for name in names:
            setattr(kernels, name, real[name])
    torch.cuda.synchronize()
    say(f"(b) round 19 at O={O_KERNEL} N={N_FULL}: prunes "
        f"{int(rows19['prunes_sent'].sum())}, rc_overflow "
        f"{int(rows19['rc_overflow'].sum())}, inb_dropped "
        f"{int(rows19['inb_dropped'].sum())}")

    plain = {"bfs_relax": kernels.bfs_relax_plain,
             "rank_inbound": kernels.rank_inbound_plain,
             "rc_merge_prune": kernels.rc_merge_prune_plain,
             "prune_apply": kernels.prune_apply_plain}
    res = {}
    for name in names:
        args, kw = captured[name]
        got = real[name](*args, **kw)
        want = plain[name](*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0:
            fail(f"{name}: kernel differs from its plain version "
                 f"(max_abs_err {err})")
        res[name] = dict(
            out=got, max_abs_err=err,
            ms=cuda_ms(lambda: real[name](*args, **kw)),
            plain_ms=cuda_ms(lambda: plain[name](*args, **kw), reps=3,
                             warm=1))

    # PyTorch yardsticks (timed here, used nowhere in the port) and bounds
    tgt, org = captured["bfs_relax"][0]
    reached, dist = res["bfs_relax"]["out"]
    O, N, F = tgt.shape
    hops = int(dist[reached].max())
    hop_idx = torch.where(tgt < N, tgt, N).reshape(O, N * F).long()
    hop_val = torch.ones((O, N * F), dtype=torch.int32, device=dev)
    hop_out = torch.zeros((O, N + 1), dtype=torch.int32, device=dev)

    def bfs_library():
        for _ in range(hops):
            hop_out.scatter_reduce_(1, hop_idx, hop_val, "amax")

    r_args = captured["rank_inbound"][0]
    r_tgt, r_del, r_hop1 = r_args[:3]
    packed = ((torch.where(r_del, r_tgt, N).reshape(O, -1).long() << 32)
              | r_hop1.long().repeat_interleave(F, dim=1))
    mp_args = captured["rc_merge_prune"][0]
    row_keys = torch.cat([mp_args[0], mp_args[5]], -1)
    library = {
        "bfs_relax": (cuda_ms(bfs_library),
                      f"{hops} x scatter_reduce_ amax (one per hop)"),
        "rank_inbound": (cuda_ms(lambda: torch.sort(packed, dim=1)),
                         "torch.sort of the packed (target, key) edges"),
        "rc_merge_prune": (cuda_ms(lambda: torch.sort(row_keys, dim=-1)),
                           "torch.sort of the [O, N, C+K] row keys"),
        "prune_apply": (None, "none"),
    }
    pa_args = captured["prune_apply"][0]
    moved = {
        "bfs_relax": nbytes(tgt, org, reached, dist),
        "rank_inbound": nbytes(r_tgt, r_del, r_hop1,
                               *res["rank_inbound"]["out"]),
        "rc_merge_prune": nbytes(*mp_args, *res["rc_merge_prune"]["out"]),
        "prune_apply": nbytes(*pa_args, res["prune_apply"]["out"]),
    }
    for name in names:
        r = res[name]
        r["bound_ms"] = moved[name] / HBM_BYTES_PER_S * 1e3
        r["library_ms"], what = library[name]
        lib_txt = ("null" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f} ms")
        say(f"(b) {name}: exact vs plain; kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib_txt} ({what}), bound "
            f"{r['bound_ms']:.4f} ms ({moved[name]} bytes)")
    del captured, state, packed, row_keys, hop_idx, hop_val, hop_out
    for r in res.values():
        del r["out"]
    torch.cuda.empty_cache()

    # rc_slots = 128 with the default k_inbound: a row of C + K = 144
    wide = EngineParams(num_nodes=N_FULL, warm_up_rounds=0, rc_slots=128)
    wide_o = origins[:8]
    state = init_state(rng.prng_key(42, dev), tables, wide_o, wide)
    for it in range(19):
        state, _ = round_step(wide, tables, wide_o, state, it)
    wide_in = {}

    def wide_rec(*args, **kw):
        wide_in["mp"] = (args, kw)
        return real["rc_merge_prune"](*args, **kw)

    kernels.rc_merge_prune = wide_rec
    try:
        state, rows_w = round_step(wide, tables, wide_o, state, 19)
    finally:
        kernels.rc_merge_prune = real["rc_merge_prune"]
    args, kw = wide_in["mp"]
    err = max_abs_err(real["rc_merge_prune"](*args, **kw),
                      plain["rc_merge_prune"](*args, **kw))
    torch.cuda.synchronize()
    if err != 0 or args[0].shape[-1] + args[5].shape[-1] != 144:
        fail(f"(b) rc_slots=128: rc_merge_prune differs from its plain "
             f"version (max_abs_err {err}) or the row is not 144 wide")
    say(f"(b) rc_slots=128 K=16 (row 144) at O={wide_o.numel()} N={N_FULL}, "
        f"round 19: rc_merge_prune exact vs plain; kernel "
        f"{cuda_ms(lambda: real['rc_merge_prune'](*args, **kw)):.4f} ms; "
        f"prunes {int(rows_w['prunes_sent'].sum())}")
    del state, wide_in, args, rows_w
    torch.cuda.empty_cache()

    # ---- (c) engine, 50 rounds at O=32, N=10,000 -------------------------
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    state = init_state(rng.prng_key(7, dev), tables, origins, params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, rows = run_rounds(params, tables, origins, state, 50)
    torch.cuda.synchronize()
    eng_s = time.perf_counter() - t0
    engine_launches = dict(kernels.LAUNCHES)
    cov = rows["coverage"]
    if cov.shape != (50, O_KERNEL) or not bool(torch.isfinite(cov).all()):
        fail(f"(c) coverage rows malformed: {tuple(cov.shape)}")
    if not bool(((cov > 0) & (cov <= 1)).all()):
        fail("(c) coverage outside (0, 1]")
    missing = [n for n in names if engine_launches[n] <= 0]
    if missing:
        fail(f"(c) kernels never launched by the engine: {missing}")
    say(f"(c) engine O={O_KERNEL} N={N_FULL}: 50 rounds in {eng_s:.3f} s = "
        f"{50 / eng_s:.2f} rounds/s ({50 * O_KERNEL / eng_s:.1f} "
        f"origin-rounds/s), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, mean coverage "
        f"{float(cov.double().mean()):.6f}, launches {engine_launches}")
    engine_device = profile_rounds(run_rounds, params, tables, origins,
                                   state, out_dir)
    del state, rows
    torch.cuda.empty_cache()

    # ---- (d) CLI main path at N=10,000 on cuda ---------------------------
    argv = ["--num-synthetic-nodes", str(N_FULL), "--iterations", "300",
            "--warm-up-rounds", "200", "--device", "cuda"]
    # keep the main path's own kernel inputs of two rounds (one call per
    # kernel per round): the first round the upsert counters fire, and the
    # last one
    check_at = (19, 299)
    calls = {name: 0 for name in names}
    main_args = {}

    def main_recorder(name):
        def rec(*args, **kw):
            if calls[name] in check_at:
                main_args[(name, calls[name])] = (args, kw)
            calls[name] += 1
            return real[name](*args, **kw)
        return rec

    reset_unique_pubkeys()
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
        for name in names:
            setattr(kernels, name, real[name])
    missing = [n for n in names if launches[n] <= 0]
    if missing:
        fail(f"(d) kernels never launched on the main path: {missing}")
    if len(main_args) != len(names) * len(check_at):
        fail(f"(d) expected each kernel's inputs at rounds {check_at}, got "
             f"{sorted(main_args)}")
    for (name, k), (args, kw) in sorted(main_args.items()):
        err = max_abs_err(real[name](*args, **kw), plain[name](*args, **kw))
        if err != 0:
            fail(f"(d) {name} differs from its plain version on the main "
                 f"path's round {k} inputs (max_abs_err {err})")
    torch.cuda.synchronize()
    say(f"(d) each kernel exact vs plain on the main path's own inputs of "
        f"rounds {check_at} (O=1, N={N_FULL}, shapes "
        f"{tuple(main_args[('rc_merge_prune', 19)][0][0].shape)})")
    main_t = {}
    for name in names:
        args, kw = main_args[(name, 19)]
        main_t[name] = (cuda_ms(lambda: real[name](*args, **kw), reps=50),
                        device_ms(lambda: real[name](*args, **kw),
                                  KERNEL_SYMBOLS[name], reps=50))
        dev_txt = ("not measured" if main_t[name][1] is None
                   else f"{main_t[name][1]:.4f} ms")
        say(f"(d) {name} on the main path's round-19 inputs (O=1): wrapper "
            f"{main_t[name][0]:.4f} ms, device {dev_txt}")
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
    say(f"(d) parts: cluster build (ChaCha stakes + index) "
        f"{build_cluster_s:.3f} s; engine init + 300 rounds at O=1 "
        f"{engine_300_s:.3f} s")

    # ---- (e) cuda vs cpu parity at N=2,000, 60 rounds --------------------
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

    # ---- (f) report -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    say(f"total {time.perf_counter() - t_all:.1f} s")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"gossip_sim_tpu_torch/csrc/{name}.cu",
         "replaces": f"{SOURCES[name][0]} ({SOURCES[name][1]})",
         "launches": launches[name],
         "max_abs_err": res[name]["max_abs_err"],
         "ms": res[name]["ms"], "plain_ms": res[name]["plain_ms"],
         "bound_ms": res[name]["bound_ms"], "bound_by": "bytes",
         "library_ms": res[name]["library_ms"],
         "device_ms": engine_device[name],
         "main_ms": main_t[name][0], "main_device_ms": main_t[name][1]}
        for name in names]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
