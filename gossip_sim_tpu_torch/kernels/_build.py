"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface and loaded with ``ctypes``.  The
libraries go to ``build/kernels/<hash>/`` at the repository root (listed in
``.gitignore``), keyed by a hash of every file in ``csrc/`` (sources and
the headers they include) and the compiler flags, so a fresh checkout
builds them at first use and a changed file rebuilds.
All sources compile in parallel: one ``nvcc`` process each, started
together.

Nothing here runs at import time, and nothing falls back: a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_NAMES = ("bfs_relax", "rank_inbound", "rc_merge_prune", "prune_apply",
                "threefry", "push_targets", "rotate", "pull_exchange",
                "traffic_send", "traffic_admit", "traffic_rescue")
#: Kernels built from another's source, counted apart: the sparse layout's
#: variant of rc_merge_prune (csrc/rc_merge_prune.cu).
VARIANT_NAMES = ("rc_merge_prune_sparse",)
#: Libraries that :func:`build_all` leaves out and :func:`library` builds
#: when first asked for: measurement aids that no engine path loads
#: (``bfs_relax_floor``: csrc/bfs_relax.cu with BFS_RELAX_FLOOR defined).
AID_NAMES = ("bfs_relax_floor",)
#: Rows (threads) per block of the kernels that give a thread to each row.
ROWS_PER_BLOCK = 128

#: Kernel launches per wrapper (and variant) since the last reset.  A
#: wrapper adds one where it launches its kernel on the card, and nowhere
#: else.
LAUNCHES = {name: 0 for name in KERNEL_NAMES + VARIANT_NAMES}

_LIBS: dict = {}
BUILD_LOG: dict = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (put it on PATH or set CUDA_HOME)")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all(force: bool = False, names=KERNEL_NAMES) -> float:
    """Compile every library of ``names`` (default: every kernel's) that is
    not built yet (every one with ``force``), all in parallel.  Returns the
    wall seconds spent; raises with the compiler output if any build
    fails."""
    out_dir = _build_dir()
    todo = [n for n in names
            if force or not (out_dir / f"lib{n}.so").exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out_dir / f"lib{name}.so")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded ctypes library of kernel ``name`` (built on first use; an
    aid of ``AID_NAMES`` alone)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all(names=(name,) if name in AID_NAMES else KERNEL_NAMES)
        lib = ctypes.CDLL(str(_build_dir() / f"lib{name}.so"))
        _LIBS[name] = lib
    return lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def smem_optin(device: torch.device) -> int:
    """Bytes of shared memory one block of a CUDA device may opt in to."""
    props = torch.cuda.get_device_properties(device)
    return props.shared_memory_per_block_optin


def row_blocks(name: str, row_bytes: int, smem_limit: int) -> tuple[int, int]:
    """Rows per block and the block's shared memory for a kernel that stages
    ``row_bytes`` of shared memory per row: ``ROWS_PER_BLOCK`` rows, fewer
    where they would pass ``smem_limit`` bytes; raises where one row does
    not fit."""
    if row_bytes > smem_limit:
        raise ValueError(f"{name}: a row needs {row_bytes} bytes of shared "
                         f"memory, more than the {smem_limit} bytes of one "
                         f"block")
    rows = min(ROWS_PER_BLOCK, smem_limit // max(row_bytes, 1))
    return rows, rows * row_bytes


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def launched(name: str, rc: int) -> None:
    """Count one launch of kernel ``name``; raise if the C entry point
    reported a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    LAUNCHES[name] += 1
