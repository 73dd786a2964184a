"""Binary graph format IO, byte-compatible with ``bibfs_tpu.graph.io``.

Format (little-endian): ``uint32 N``, ``uint32 M``, then ``M`` pairs of
``uint32 (u, v)`` undirected edges. Beside each ``<name>.bin`` sits a
ground-truth JSON ``{source, target, hop_count, nodes}``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

_HEADER_DTYPE = np.dtype("<u4")


def _atomic_replace(path, write_payload, *, mode: str = "wb") -> None:
    """Commit a file atomically: ``write_payload(f)`` writes a
    same-directory tmp file that is flushed, fsynced and ``os.replace``d
    onto ``path`` only once complete, so readers see the old file or the
    new one, never a torn middle. On failure the tmp is removed and the
    error re-raised."""
    path = os.fspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, mode) as f:
            write_payload(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_graph_bin(path: str | os.PathLike, n: int, edges: np.ndarray) -> None:
    """Write an undirected edge list (each edge once) in the binary
    format. Endpoints must lie in ``[0, n)``: the on-disk dtype is uint32,
    so a negative endpoint would otherwise wrap. The write is atomic."""
    edges = np.asarray(edges).reshape(-1, 2)
    if edges.size and (int(edges.min()) < 0 or int(edges.max()) >= n):
        raise ValueError(
            f"edge endpoints must be in [0, {n}); got "
            f"[{int(edges.min())}, {int(edges.max())}]"
        )
    edges = np.ascontiguousarray(edges, dtype=_HEADER_DTYPE).reshape(-1, 2)
    m = edges.shape[0]

    def _payload(f):
        np.array([n, m], dtype=_HEADER_DTYPE).tofile(f)
        edges.tofile(f)

    _atomic_replace(path, _payload)


def read_graph_bin(path: str | os.PathLike) -> tuple[int, np.ndarray]:
    """Read the binary format. Returns ``(n, edges[M, 2])`` as int64.

    A file shorter or longer than its header claims raises, and so does
    an endpoint word ``>= 2**31`` (a negative id to the format's C
    readers) or ``>= n``."""
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=_HEADER_DTYPE, count=2)
        if header.size != 2:
            raise ValueError(f"{path}: truncated header")
        n, m = int(header[0]), int(header[1])
        data = np.fromfile(f, dtype=_HEADER_DTYPE)
    if data.size != 2 * m:
        raise ValueError(
            f"{path}: header claims {m} edges ({2 * m} words) but file has "
            f"{data.size} payload words"
        )
    edges = data.reshape(m, 2).astype(np.int64)
    if m:
        top = int(edges.max())
        if top >= np.int64(2) ** 31:
            raise ValueError(
                f"{path}: edge endpoint {top} is negative "
                f"({top - 2 ** 32} as the int32 the format's readers "
                f"use) — not a valid vertex id"
            )
        if top >= n:
            raise ValueError(
                f"{path}: edge endpoint {top} out of range for n={n}"
            )
    return n, edges


def write_ground_truth(
    path: str | os.PathLike,
    source: int,
    target: int,
    hop_count: Optional[int],
    nodes: Optional[list[int]],
) -> None:
    """Write the ground-truth JSON sidecar (atomic)."""
    payload = {
        "source": int(source),
        "target": int(target),
        "hop_count": None if hop_count is None else int(hop_count),
        "nodes": None if nodes is None else [int(v) for v in nodes],
    }
    _atomic_replace(path, lambda f: json.dump(payload, f), mode="w")


def read_ground_truth(path: str | os.PathLike) -> dict:
    with open(path) as f:
        return json.load(f)


def ground_truth_path(bin_path: str | os.PathLike) -> str:
    """The JSON sidecar path convention: ``foo.bin`` -> ``foo.json``."""
    root, _ = os.path.splitext(os.fspath(bin_path))
    return root + ".json"
