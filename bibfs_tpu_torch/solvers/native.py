"""ctypes bindings for the native C++ host runtime: the counterpart of
``bibfs_tpu/solvers/native.py``.

The library is the port's own copy of ``bibfs_native.cpp``, built by
``g++`` at first use (:mod:`bibfs_tpu_torch.native.build`). It gives the
``native`` backend (one search per call, over a CSR it builds itself),
the scratch-reusing :class:`NativeGraph` the serving engine's host route
solves on, the threaded batch, and the native graph loader. Per-level
telemetry (``bibfs_solve_levels``) waits for the adaptive-policy slice.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import threading
import weakref

import numpy as np

from bibfs_tpu_torch.native.build import ensure_built
from bibfs_tpu_torch.solvers.api import BFSResult, register

_ERR = {
    -1: "cannot open file",
    -2: "truncated or malformed file",
    -3: "edge endpoint out of range",
    -4: "bad argument",
    -5: "buffer too small",
    -6: "allocation failure",
}

_LIB: ctypes.CDLL | None = None
_LIB_LOCK = threading.Lock()


def _lib() -> ctypes.CDLL:
    """The loaded library (built first if needed); a missing compiler or
    a failed build raises ``OSError``."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(ensure_built())
        i32, i64, u32, f64 = (ctypes.c_int32, ctypes.c_int64,
                              ctypes.c_uint32, ctypes.c_double)
        p = ctypes.POINTER
        lib.bibfs_read_header.argtypes = [ctypes.c_char_p, p(u32), p(u32)]
        lib.bibfs_read_edges.argtypes = [ctypes.c_char_p, u32, u32, p(u32)]
        lib.bibfs_build_csr.argtypes = [u32, ctypes.c_uint64, p(u32), p(i64),
                                        p(i32), p(i64)]
        lib.bibfs_solve_s.argtypes = [
            u32, p(i64), p(i32), ctypes.c_void_p, u32, u32,
            p(i32), p(i32), i32, p(i32), p(f64), p(i64), p(i32),
        ]
        lib.bibfs_solve_batch.argtypes = [
            u32, p(i64), p(i32), i32, p(u32), p(u32), i32,
            p(i32), p(i32), i32, p(i32), p(f64), p(i64), p(i32),
        ]
        lib.bibfs_scratch_create.argtypes = [u32]
        lib.bibfs_scratch_create.restype = ctypes.c_void_p
        lib.bibfs_scratch_free.argtypes = [ctypes.c_void_p]
        lib.bibfs_scratch_free.restype = None
        for fn in (lib.bibfs_read_header, lib.bibfs_read_edges,
                   lib.bibfs_build_csr, lib.bibfs_solve_s,
                   lib.bibfs_solve_batch):
            fn.restype = i32
        _LIB = lib
        return lib


def _check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: {_ERR.get(rc, f'error {rc}')}")


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def read_graph_native(path: str) -> tuple[int, np.ndarray]:
    """Native binary loader, same contract as
    :func:`bibfs_tpu_torch.graph.io.read_graph_bin`."""
    lib = _lib()
    n = ctypes.c_uint32()
    m = ctypes.c_uint32()
    _check(lib.bibfs_read_header(path.encode(), ctypes.byref(n),
                                 ctypes.byref(m)), path)
    # check the untrusted header against the file size before allocating
    # m * 8 bytes (a corrupt m = 0xFFFFFFFF would ask for ~32 GB)
    need = 8 + 8 * int(m.value)
    have = os.path.getsize(path)
    if have < need:
        raise RuntimeError(
            f"{path}: {_ERR[-2]} (m={m.value} needs {need} B, file is {have} B)"
        )
    edges = np.empty((m.value, 2), dtype=np.uint32)
    _check(lib.bibfs_read_edges(path.encode(), n.value, m.value,
                                _ptr(edges, ctypes.c_uint32)), path)
    return int(n.value), edges.astype(np.int64)


@dataclasses.dataclass
class NativeGraph:
    """A CSR the C runtime searches, with its epoch-stamped solve scratch:
    repeated solves pay O(vertices touched) setup instead of refilling
    four n-sized arrays. NOT thread-safe: one solve at a time per graph
    (the threaded batch makes its own scratches)."""

    n: int
    row_ptr: np.ndarray  # int64[n+1]
    col_ind: np.ndarray  # int32[nnz]

    def __post_init__(self):
        lib = _lib()
        self._scratch = lib.bibfs_scratch_create(self.n)
        if not self._scratch:
            raise MemoryError(f"scratch allocation failed for n={self.n}")
        self._path_buf = np.empty(self.n + 1, dtype=np.int32)
        weakref.finalize(self, lib.bibfs_scratch_free, self._scratch)

    @classmethod
    def build(cls, n: int, edges: np.ndarray) -> "NativeGraph":
        lib = _lib()
        edges_u = np.ascontiguousarray(
            np.asarray(edges).reshape(-1, 2), dtype=np.uint32
        )
        m = edges_u.shape[0]
        row_ptr = np.zeros(n + 1, dtype=np.int64)
        col_ind = np.empty(max(2 * m, 1), dtype=np.int32)
        nnz = ctypes.c_int64()
        _check(
            lib.bibfs_build_csr(
                n, m, _ptr(edges_u, ctypes.c_uint32),
                _ptr(row_ptr, ctypes.c_int64), _ptr(col_ind, ctypes.c_int32),
                ctypes.byref(nnz),
            ),
            "build_csr",
        )
        return cls(n=n, row_ptr=row_ptr, col_ind=col_ind[: nnz.value].copy())


def solve_native_graph(g: NativeGraph, src: int, dst: int) -> BFSResult:
    """One search on a prebuilt :class:`NativeGraph`, reusing its scratch.
    The C runtime does not report the meet vertex (``meet`` is None); the
    path carries it."""
    if not (0 <= src < g.n and 0 <= dst < g.n):
        raise ValueError(f"src/dst out of range for n={g.n}")
    lib = _lib()
    hops = ctypes.c_int32()
    path_buf = g._path_buf
    path_len = ctypes.c_int32()
    secs = ctypes.c_double()
    scanned = ctypes.c_int64()
    levels = ctypes.c_int32()
    _check(lib.bibfs_solve_s(
        g.n, _ptr(g.row_ptr, ctypes.c_int64), _ptr(g.col_ind, ctypes.c_int32),
        g._scratch, src, dst, ctypes.byref(hops), _ptr(path_buf, ctypes.c_int32),
        path_buf.size, ctypes.byref(path_len), ctypes.byref(secs),
        ctypes.byref(scanned), ctypes.byref(levels),
    ), "solve")
    if hops.value < 0:
        return BFSResult(False, None, None, None, secs.value, levels.value,
                         int(scanned.value))
    path = path_buf[: path_len.value].tolist() if path_len.value else None
    return BFSResult(True, hops.value, path, None, secs.value, levels.value,
                     int(scanned.value))


def solve_native(n: int, edges: np.ndarray, src: int, dst: int) -> BFSResult:
    return solve_native_graph(NativeGraph.build(n, edges), src, dst)


# default per-query path capacity of the threaded batch, bounded by the
# graph size (a path never exceeds n + 1 vertices, so small graphs get
# full paths); deeper paths report hops only unless the caller raises
# ``path_cap``
_BATCH_PATH_CAP = 512


def _batch_path_cap(g: NativeGraph, path_cap: int | None) -> int:
    if path_cap is None:
        return min(g.n + 1, _BATCH_PATH_CAP)
    if path_cap < 1:
        raise ValueError(f"path_cap must be >= 1, got {path_cap}")
    return min(g.n + 1, path_cap)


def solve_batch_native_graph(
    g: NativeGraph, pairs, *, threads: int | None = None,
    path_cap: int | None = None,
) -> list[BFSResult]:
    """Many (src, dst) queries through the threaded C batch: queries
    stripe over worker threads, each with its own scratch, sharing the
    read-only CSR. Every result's ``time_s`` is the whole batch's wall
    clock. ``path_cap`` raises the per-query path buffer (default
    ``min(n + 1, 512)``); a found query deeper than it has ``path`` None."""
    return time_batch_native(
        g, pairs, repeats=1, threads=threads, path_cap=path_cap
    )[1]


def _run_batch_native(g: NativeGraph, pairs: np.ndarray, threads: int,
                      path_cap: int):
    lib = _lib()
    b = pairs.shape[0]
    srcs = np.ascontiguousarray(pairs[:, 0], dtype=np.uint32)
    dsts = np.ascontiguousarray(pairs[:, 1], dtype=np.uint32)
    hops = np.full(b, -1, dtype=np.int32)
    path_buf = np.empty((b, path_cap), dtype=np.int32)
    path_len = np.zeros(b, dtype=np.int32)
    secs = ctypes.c_double()
    edges = np.zeros(b, dtype=np.int64)
    levels = np.zeros(b, dtype=np.int32)
    _check(
        lib.bibfs_solve_batch(
            g.n, _ptr(g.row_ptr, ctypes.c_int64),
            _ptr(g.col_ind, ctypes.c_int32), b,
            _ptr(srcs, ctypes.c_uint32), _ptr(dsts, ctypes.c_uint32),
            threads, _ptr(hops, ctypes.c_int32),
            _ptr(path_buf, ctypes.c_int32), path_cap,
            _ptr(path_len, ctypes.c_int32), ctypes.byref(secs),
            _ptr(edges, ctypes.c_int64), _ptr(levels, ctypes.c_int32),
        ),
        "solve_batch",
    )
    results = []
    for i in range(b):
        if hops[i] < 0:
            results.append(BFSResult(False, None, None, None, secs.value,
                                     int(levels[i]), int(edges[i])))
        else:
            path = path_buf[i, : path_len[i]].tolist() if path_len[i] else None
            results.append(BFSResult(True, int(hops[i]), path, None,
                                     secs.value, int(levels[i]),
                                     int(edges[i])))
    return float(secs.value), results


def time_batch_native(
    g: NativeGraph, pairs, *, repeats: int = 5, threads: int | None = None,
    path_cap: int | None = None,
) -> tuple[list[float], list[BFSResult]]:
    """``repeats`` whole-batch passes through the threaded C batch, the
    median stamped into every result's ``time_s``. ``threads`` defaults to
    the host's core count (at most 16)."""
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    if threads is None:
        threads = min(os.cpu_count() or 1, 16)
    if threads < 1:
        raise ValueError(f"threads must be >= 1, got {threads}")
    cap = _batch_path_cap(g, path_cap)
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    if pairs.size and not ((0 <= pairs).all() and (pairs < g.n).all()):
        raise ValueError(f"src/dst out of range for n={g.n}")
    times = []
    results: list[BFSResult] = []
    for _ in range(repeats):
        wall, results = _run_batch_native(g, pairs, threads, cap)
        times.append(wall)
    med = float(np.median(times))
    return times, [dataclasses.replace(r, time_s=med) for r in results]


@register("native")
def _native_backend(n, edges, src, dst, **_):
    return solve_native(n, edges, src, dst)
