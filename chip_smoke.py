#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``gossip_sim_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

  (a) build the seven CUDA kernels from ``gossip_sim_tpu_torch/csrc`` with
      nvcc for sm_90a (one nvcc per source, in parallel); print each
      kernel's registers, shared memory and spills (``-Xptxas -v``), check
      ``rotate``'s static shared memory (the class tables) against ptxas
      and its keys and rows beside them against the block's limit,
      print the launch geometry of the cluster and row kernels (cluster
      size, rows or warps per block, shared memory, ``push_targets``' tiles
      and one-wave grid), and the instructions of one threefry block in the
      SASS (``cuobjdump -sass``) of ``threefry`` and of ``rotate``, by pipe;
  (b) capture each kernel's inputs from a real round (round 19, when the
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
      masks), ``rotate`` and the fail round's three ``threefry`` draws
      against their plain versions on their round-19 inputs;
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
      and RMR means, ``threefry``'s launches (``init_state``'s only), and
      the same run in turns with verbs 1 and 5 in their plain versions
      (plain, kernels, plain, for the wall time and equal means); the first
      run's kernel launch counts go into the ``kernels`` line, and each
      kernel is held against its plain version on this run's own inputs of
      rounds 19 and 299 (O=1; ``threefry`` on ``init_state``'s) and timed
      on those of round 19 (CUDA events, and device time under the
      profiler); ``init_state`` at O=1 is timed alone, with the kernel and
      with the plain draws;
  (e) run the CLI on cuda and on cpu at 2,000 nodes for 60 rounds and
      require equal ``parity_snapshot()``s;
  (f) print the card's name and power limit, the ``kernels`` JSON line and
      the final ``{"ok": true, ...}`` line.

Imports nothing of JAX and nothing of the reference package.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import math
import os
import re
import subprocess
import sys
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
                      "round/verb5_rotate + _sample_fast at core.py:274")}


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
                  "rotate": ("rotate_kernel",)}


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
                   rounds: int = 5, tag: str = "") -> dict:
    """Where a round's time goes: device time and launches per kernel group
    and for the plain PyTorch ops, over ``rounds`` rounds under
    torch.profiler, against the host wall clock (device idle share = 1 -
    busy / wall)."""
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
        say(f"(c){tag} profiler: no device time recorded; breakdown not "
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
    say(f"(c){tag} profile over {rounds} rounds: per round wall "
        f"{wall_ms / rounds:.3f} ms, device busy {busy_ms / rounds:.4f} ms "
        f"(idle share {1 - busy_ms / wall_ms:.3f}), {launches:.1f} device "
        f"launches; kernels "
        + ", ".join(f"{k} {v / 1e3 / rounds:.4f} ms in "
                    f"{counts[k] / rounds:.0f}" for k, v in groups.items())
        + f"; other PyTorch kernels {sum(other.values()) / 1e3 / rounds:.4f}"
        f" ms in {n_other / rounds:.0f} launches")
    for line in lines[len(groups) + 2:]:
        say(f"(c){tag}   {line.strip()}")
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
#: counted: threefry's uniform mode, and rotate (csrc/threefry.cuh in both)
SASS_BLOCKS = {"threefry": ("threefry", "threefry_kernelILi3E"),
               "rotate": ("rotate", "rotate_kernel")}


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
    and the sides while the partition window is on."""
    active, pruned, tfail, origins, side, _, partition = args[:7]
    return (nbytes(active, pruned, tfail, origins, *outs)
            + (nbytes(side) if partition else 0))


def rotate_work(args, outs, rot_mod) -> tuple[int, int, int]:
    """What ``rotate`` must do on these inputs: (bytes moved, threefry
    blocks hashed, rows that rotate).

    Bytes: the three slot planes in and out, the keys, the class tables,
    ``rot_failed``; and for each row that rotates, its origin's and its
    own bucket, the ``perm`` entry of each try it takes (up to its first
    new peer) and the new peer's ``failed`` byte.  Blocks: each origin's
    round key and its T + 1 sub keys (one block a key in the partitionable
    layout, two in the original one), each row's rotation uniform, and two
    words for each try a rotating row takes."""
    import torch
    (active, pruned, tfail, failed, key, it, origins, buckets, perm,
     start, count, cdf, prob, tries, part) = args
    O, N, _ = active.shape
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
    # rotate's shared memory: ptxas's static bytes are the class tables, and
    # the keys and the rows (dynamic) fit beside them at every shape
    table = re.search(r"rotate_kernel: \d+ registers, static shared memory "
                      r"(\d+) B", "\n".join(ptxas_summary(
                          _build.BUILD_LOG["rotate"])))
    if not table or int(table.group(1)) != rot_mod.TABLE_BYTES:
        fail(f"rotate_kernel's static shared memory per ptxas "
             f"({table and table.group(1)} B) is not kernels/rotate.py "
             f"TABLE_BYTES ({rot_mod.TABLE_BYTES} B)")
    for s_, t_, n_, o_ in ((12, 8, N_FULL, O_KERNEL), (12, 8, N_FULL, 1),
                           (25, 32, 40, 5), (12, 8, 1, 200)):
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
    for o in (1, O_KERNEL):
        g = bfs_mod.launch_geometry(o, N_FULL, sms, smem_limit)
        say(f"(a) bfs_relax at O={o} N={N_FULL} on {sms} SMs: cluster size "
            f"{g.cs}, slice {g.slice_len} nodes, {g.smem} B shared memory "
            f"per CTA (of {smem_limit} B)")
    for c, k in ((64, 16), (128, 16)):
        g = merge_mod.launch_geometry(c, k, smem_limit)
        say(f"(a) rc_merge_prune at C={c} K={k}: {g.rows_per_block} rows "
            f"(warps) per block, {g.smem} B shared memory per block")
    for o, k in ((1, 16), (O_KERNEL, 16), (8, 128)):
        g = rank_mod.launch_geometry(o, N_FULL, k, sms, smem_limit,
                                     rank_mod.max_clusters)
        say(f"(a) rank_inbound at O={o} N={N_FULL} K={k}: cluster size "
            f"{g.cs} ({rank_mod.max_clusters(g)} such clusters fit the "
            f"card at once), slice {g.slice_len} nodes, {g.threads} "
            f"threads, {g.smem} B shared memory per CTA ({g.csr_cap} CSR "
            f"keys), counts in "
            f"{'device memory' if g.scratch_words else 'shared memory'}")
    for s_, f_ in ((12, 6), (25, 6)):
        pt_rows, pt_smem = pt_mod.launch_geometry(s_, f_, smem_limit)
        per_sm = pt_mod.blocks_per_sm(dev, pt_rows, pt_smem)
        for o in (1, O_KERNEL):
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
    reset_unique_pubkeys()
    accounts, _ = cli.load_cluster_accounts(
        cli.Config(num_synthetic_nodes=N_FULL))
    index = NodeIndex.from_stakes(accounts)
    stakes_np = index.stakes.astype(np.int64)
    tables = make_cluster_tables(stakes_np, device=dev)
    top = np.argsort(-stakes_np, kind="stable")[:O_KERNEL].astype(np.int32)
    origins = torch.as_tensor(top, device=dev)
    params = EngineParams(num_nodes=N_FULL, warm_up_rounds=0)
    real = {name: getattr(kernels, name) for name in names}
    plain = {name: getattr(kernels, f"{name}_plain") for name in names}

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

    def exact(name, args, kw, where):
        """The kernel's output on ``args``, after holding it against the
        plain version's (exit on any difference)."""
        got = real[name](*args, **kw)
        err = max_abs_err(got, plain[name](*args, **kw))
        torch.cuda.synchronize()
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
            calls_per_round=round_calls[name], max_abs_err=0,
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
    pa_args = captured["prune_apply"][0][0]
    tf_keys = sum(int(math.prod(a[0].shape[:-1]))
                  for a, _ in captured["threefry"])
    tf_blocks = sum(int(math.prod(a[0].shape[:-1]))
                    * tf_mod.pairs(a[1], int(a[2]) if a[1] != "fold_in"
                                   else 1, a[3] if len(a) > 3 else True)
                    for a, _ in captured["threefry"])
    moved = {
        "bfs_relax": nbytes(tgt, org, reached, dist),
        "rank_inbound": nbytes(r_tgt, r_del, r_hop1,
                               *res["rank_inbound"]["out"]),
        "rc_merge_prune": nbytes(*mp_args, *res["rc_merge_prune"]["out"]),
        "prune_apply": nbytes(*pa_args, res["prune_apply"]["out"]),
        # the keys read once (two words each) and every output written
        "threefry": 16 * tf_keys + nbytes(*res["threefry"]["outs"]),
        "push_targets": push_targets_bytes(pt_args,
                                           res["push_targets"]["out"]),
    }
    moved["rotate"], rot_blocks, n_rot = rotate_work(
        captured["rotate"][0][0], res["rotate"]["out"], rot_mod)
    blocks = {name: 0 for name in names}
    blocks.update(threefry=tf_blocks, rotate=rot_blocks)
    int_ops = {name: blocks[name] * tf_ops[name]["total"] if blocks[name]
               else 0 for name in names}
    for name in names:
        r = res[name]
        bytes_ms = moved[name] / HBM_BYTES_PER_S * 1e3
        ops_ms = (issue_s(tf_ops[name], blocks[name]) * 1e3 if blocks[name]
                  else 0.0)
        r["bound_ms"] = max(bytes_ms, ops_ms)
        r["bound_by"] = "operations" if ops_ms > bytes_ms else "bytes"
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
    rows_w, calls = round19_calls(wide, wide_o, ["rc_merge_prune"])
    args, kw = calls["rc_merge_prune"][0]
    exact("rc_merge_prune", args, kw, "(b) rc_slots=128")
    if args[0].shape[-1] + args[5].shape[-1] != 144:
        fail("(b) rc_slots=128: the row is not 144 wide")
    say(f"(b) rc_slots=128 K=16 (row 144) at O={wide_o.numel()} N={N_FULL}, "
        f"round 19: rc_merge_prune exact vs plain; kernel "
        f"{cuda_ms(lambda: real['rc_merge_prune'](*args, **kw)):.4f} ms; "
        f"prunes {int(rows_w['prunes_sent'].sum())}")
    del calls, args, rows_w

    # inbound_cap = 128: past the former 64-entry limit of rank_inbound
    wide = EngineParams(num_nodes=N_FULL, warm_up_rounds=0, inbound_cap=128)
    _, calls = round19_calls(wide, wide_o, ["rank_inbound"])
    args, kw = calls["rank_inbound"][0]
    got = exact("rank_inbound", args, kw, "(b) inbound_cap=128")
    if args[4] != 128:
        fail("(b) inbound_cap=128: K is not 128")
    g = rank_mod.launch_geometry(wide_o.numel(), N_FULL, 128, sms,
                                 smem_limit, rank_mod.max_clusters)
    say(f"(b) inbound_cap=128 at O={wide_o.numel()} N={N_FULL}, round 19: "
        f"rank_inbound exact vs plain; kernel "
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
                                     ["push_targets", "rotate"], part)
            exact("push_targets", *calls["push_targets"][0],
                  f"(b) {lay} layout")
            exact("rotate", *calls["rotate"][0], f"(b) {lay} layout")
        rows_i, calls = round19_calls(impaired, origins,
                                      ["push_targets", "rotate", "threefry"],
                                      part)
        args, kw = calls["push_targets"][0]
        _, sup, drop = exact("push_targets", args, kw,
                             f"(b) impaired, {lay} layout")
        exact("rotate", *calls["rotate"][0], f"(b) impaired, {lay} layout")
        if calls["threefry"]:
            fail("(b) the impaired round launched the threefry kernel")
        if not (bool(sup.any()) and bool(drop.any())):
            fail("(b) impaired round: no edge was suppressed or dropped")
        say(f"(b) loss 0.1 + partition + churn at O={O_KERNEL} "
            f"N={N_FULL}, round 19, {lay} layout: push_targets (masks on) "
            f"and rotate exact vs plain, no threefry launch; push_targets "
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
    real_round_step = core_mod.round_step

    def tagged_round_step(params_, tables_, origins_, state_, it, *a, **kw):
        in_round[0] = int(it)
        try:
            return real_round_step(params_, tables_, origins_, state_, it,
                                   *a, **kw)
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
    core_mod.round_step = tagged_round_step
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
        core_mod.round_step = real_round_step
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
            err = max_abs_err(real[name](*args, **kw),
                              plain[name](*args, **kw))
            if err != 0:
                fail(f"(d) {name} differs from its plain version on the "
                     f"main path's round {k} inputs (max_abs_err {err})")
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
    # the same CLI run in turns with verbs 1 and 5 in their plain versions
    # (as the port made them before their kernels, verb 5 with its plain
    # draws; a comparison only): plain, kernels, plain, after the run above
    walls = {"kernels": [cli_s], "plain verbs 1 and 5": []}
    for what in ("plain verbs 1 and 5", "kernels", "plain verbs 1 and 5"):
        swap = ("push_targets", "rotate") if what != "kernels" else ()
        for name in swap:
            setattr(kernels, name, plain[name])
        try:
            reset_unique_pubkeys()
            t0 = time.perf_counter()
            c = cli.simulate(cli.config_from_args(
                cli.build_parser().parse_args(argv)))
            torch.cuda.synchronize()
            walls[what].append(time.perf_counter() - t0)
        finally:
            for name in swap:
                setattr(kernels, name, real[name])
        st = c.collection[0]
        if (st.coverage_stats.mean, st.rmr_stats.mean) != (cov_mean,
                                                           rmr_mean):
            fail(f"(d) the CLI run with {what} gave other means")
    say("(d) CLI wall in turns: " + "; ".join(
        f"{k} " + ", ".join(f"{w:.3f}" for w in v) + " s"
        for k, v in walls.items()))
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
         "bound_ms": res[name]["bound_ms"],
         "bound_by": res[name]["bound_by"],
         "calls_per_round": res[name]["calls_per_round"],
         "calls_timed": res[name]["calls"],
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
