"""Build-at-first-use loader for the CUDA sources in ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` (all started
together) into ``csrc/build/<source-hash>/lib<name>.so`` with a plain C
interface, and loaded with ``ctypes``. The hash covers the sources and the
flags, so an edited source builds anew and an unchanged one is reused.
Nothing here runs at import time, and nothing falls back: a missing
``nvcc``, a failed build or a failed launch raises ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("pull_expand", "fused_level", "batch_minor", "blocked_expand",
           "msbfs", "query_device", "semiring")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_F = ctypes.c_float
_ROUND = [_P, _I64, _I, _I64, _I64, _I64, _P, _P, _I64, _P, _P, _P, _P, _P,
          _P, _P]
# extern "C" launchers per source; every pointer and the stream are
# c_void_p, sizes c_int64, small ints c_int; each returns a cudaError_t
SIGNATURES = {
    "pull_expand": {
        "bibfs_pull": [_P, _I64, _I, _I64, _I64, _P, _P, _P, _P, _P, _P,
                       _I64, _P],
        "bibfs_pull_dual": [_P, _I64, _I, _I64, _I64, _P, _P, _P, _P, _P,
                            _P, _P, _P, _P, _I64, _P],
        "bibfs_pull_batch": [_P, _I64, _I, _I64, _P, _P, _P, _I64, _P, _I64,
                             _P, _P, _P, _P, _P],
        "bibfs_pull_dual_batch": [_P, _I64, _I, _I64, _P, _P, _P, _I64, _P,
                                  _I64, _P, _P, _P, _P, _P, _P, _P],
    },
    "fused_level": {
        "bibfs_fused_dual": _ROUND + [_P],
        "bibfs_fused_single": _ROUND + [_I, _P],
        "bibfs_fold_round": [_P, _P, _P, _I, _P],
    },
    "batch_minor": {
        "bibfs_minor_level": [_I, _P, _I64, _I, _I64, _P, _I64, _I64, _P, _P,
                              _P, _P, _P, _P, _P, _I, _P, _P, _P, _P],
    },
    "blocked_expand": {
        "bibfs_blocked_level": [_P, _P, _I64, _I, _P, _P, _P, _P, _P, _P,
                                _I64, _I64, _P, _I, _P, _P, _P, _P],
        "bibfs_blocked_fold": [_I64, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _P, _P],
    },
    "msbfs": {
        "bibfs_msbfs_sweep": [_P, _P, _I64, _I, _I, _I64, _I, _P, _P, _P, _P,
                              _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    },
    "query_device": {
        "bibfs_delta_stepping": [_P, _P, _I64, _I, _I, _I, _I, _F, _I64,
                                 _I64, _P, _P, _P, _I64, _P, _P, _P],
        "bibfs_restricted_sweep": [_P, _P, _I64, _I, _I, _I, _I64, _I64, _I,
                                   _P, _P, _I64, _I64, _P, _P, _P, _P, _P,
                                   _P, _I64, _P, _P, _P],
    },
    "semiring": {
        "bibfs_minplus_fixpoint": [_P, _P, _P, _I64, _I, _I, _I64, _P, _P, _P,
                                   _P],
        "bibfs_pack_tile_rows": [_P, _I64, _I, _P, _P],
        "bibfs_pagerank": [_P, _P, _P, _I64, _I, _I64, _F, _F, _F, _I64, _P,
                           _P, _P, _P, _P, _P],
        "bibfs_tricount": [_P, _P, _I64, _I, _I64, _I, _P, _P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return CSRC / "build" / h.hexdigest()[:16]


def build() -> float:
    """Compile every source not built yet, one ``nvcc`` per source, all
    started together. Returns the seconds spent (0 when all were built).
    The compiler's output, including ``-Xptxas -v``'s register and
    spill report, lands in ``<build_dir>/<name>.log``."""
    with _lock:
        out = build_dir()
        todo = [s for s in SOURCES if not (out / f"lib{s}.so").exists()]
        if not todo:
            return 0.0
        nvcc = _nvcc()
        out.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        jobs = []
        for name in todo:
            tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
            with open(out / f"{name}.log", "w") as log:
                proc = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                    stdout=log, stderr=subprocess.STDOUT,
                )
            jobs.append((name, proc, tmp))
        failed = []
        for name, proc, tmp in jobs:
            if proc.wait() != 0:
                failed.append(name)
            else:
                os.replace(tmp, out / f"lib{name}.so")
        if failed:
            logs = "\n".join(
                (out / f"{n}.log").read_text(errors="replace") for n in failed
            )
            raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
        return time.perf_counter() - t0


def build_logs() -> dict[str, str]:
    """The compiler output of each built source (empty when not built)."""
    out = build_dir()
    return {
        s: (out / f"{s}.log").read_text(errors="replace")
        for s in SOURCES if (out / f"{s}.log").exists()
    }


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name in _libs:
        return _libs[name]
    build()
    with _lock:
        if name not in _libs:
            handle = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(handle, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            handle.bibfs_error_string.argtypes = [ctypes.c_int]
            handle.bibfs_error_string.restype = ctypes.c_char_p
            _libs[name] = handle
        return _libs[name]


def launch(name: str, fn: str, *args) -> None:
    """Call launcher ``fn`` of library ``name`` on the current CUDA stream
    and raise if the launch was refused."""
    handle = lib(name)
    rc = getattr(handle, fn)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = handle.bibfs_error_string(rc).decode()
        raise RuntimeError(f"{fn}: CUDA launch failed ({rc}: {msg})")


_count_lock = threading.Lock()


def count_launch(wrapper, key: str | None = None) -> None:
    """Add one to a wrapper's launch count (``wrapper.launches``, or its
    ``key`` entry), under a lock: launches from two threads (the
    pipelined engine's flusher beside a caller's own) all count."""
    with _count_lock:
        if key is None:
            wrapper.launches += 1
        else:
            wrapper.launches[key] += 1


def check_cuda(device: torch.device, **tensors) -> None:
    """Raise unless every tensor lies on ``device`` and is contiguous."""
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{key} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{key} must be contiguous")


def check_dtype(dtype: torch.dtype, **tensors) -> None:
    for key, t in tensors.items():
        if t.dtype != dtype:
            raise ValueError(f"{key} must be {dtype}, got {t.dtype}")
