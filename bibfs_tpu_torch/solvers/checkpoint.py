"""Checkpoint and resume for long searches: the counterpart of
``bibfs_tpu/solvers/checkpoint.py``.

A search runs in chunks of at most ``chunk`` rounds of the substrate's own
round (the same code as its one-shot search, so the two cannot diverge);
between chunks the host reads the termination scalars and writes the
portable carry to an ``.npz`` atomically (a temporary file, fsync, then
``os.replace``), and :func:`resume` continues from the last completed
chunk.

The carry holds the per-vertex frontiers, parents and distances over the
graph's ``n_pad`` rows and the replicated scalars (``_STATE_KEYS``); the
transients of a substrate (the push path's frontier list, the pull
kernels' packed frontier rows) are rebuilt from it when a drive starts. So
a snapshot moves between the three substrates: one card
(:class:`~bibfs_tpu_torch.solvers.dense.DeviceGraph`), a 1D mesh
(:class:`~bibfs_tpu_torch.solvers.sharded.ShardedGraph`) and a 2D grid
(:class:`~bibfs_tpu_torch.solvers.sharded2d.Sharded2DGraph`), re-padded to
the resuming graph's ``n_pad`` (:func:`_refit`). On a mesh every rank
drives the chunks (SPMD) and rank 0 writes the file.

The file format is the reference's (the same ``.npz`` keys, the ``_meta``
JSON, :data:`CKPT_VERSION`), so either package resumes the other's file.
Modes map as the reference maps them: ``fused`` / ``fused_alt`` run
chunks as ``pallas`` / ``pallas_alt`` (the pull kernels on the card; the
fused state row has no snapshot form), and the pull-only 2D leg runs the
base schedule of any mode.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from bibfs_tpu_torch.solvers.api import BFSResult
from bibfs_tpu_torch.solvers.dense import DENSE_MODES, INF32, _materialize

CKPT_VERSION = 1
# the portable carry: everything the search needs across a chunk boundary
_VERTEX_KEYS = ("fr_s", "fr_t", "par_s", "par_t", "dist_s", "dist_t")
_SCALAR_KEYS = (
    "cnt_s", "cnt_t", "md_s", "md_t", "lvl_s", "lvl_t",
    "best", "meet", "levels", "edges",
)
_STATE_KEYS = _VERTEX_KEYS + _SCALAR_KEYS
_KERNEL_ROUTE = {"fused": "pallas", "fused_alt": "pallas_alt"}


# ------------------------------------------------------- state lifecycle

def _init_state_np(n_pad: int, src: int, dst: int, deg_src: int,
                   deg_dst: int) -> dict:
    """A fresh carry as host arrays (level 0, both seeds placed)."""
    st = {}
    for side, v, d in (("s", src, deg_src), ("t", dst, deg_dst)):
        fr = np.zeros(n_pad, dtype=bool)
        fr[v] = True
        dist = np.full(n_pad, INF32, dtype=np.int32)
        dist[v] = 0
        st[f"fr_{side}"] = fr
        st[f"par_{side}"] = np.full(n_pad, -1, dtype=np.int32)
        st[f"dist_{side}"] = dist
        st[f"cnt_{side}"] = np.int32(1)
        st[f"md_{side}"] = np.int32(d)
        st[f"lvl_{side}"] = np.int32(0)
    st["best"] = np.int32(0 if src == dst else INF32)
    st["meet"] = np.int32(src if src == dst else -1)
    st["levels"] = np.int32(0)
    st["edges"] = np.int32(0)
    return st


def _refit(state: dict, n_pad: int) -> dict:
    """Re-pad the per-vertex arrays to ``n_pad`` rows. Pad rows are inert
    (degree 0, unreachable), so growing adds inert rows and shrinking
    requires the dropped tail to be inert."""
    old = state["fr_s"].shape[0]
    if old == n_pad:
        return state
    out = dict(state)
    fills = {"fr": False, "par": -1, "dist": INF32}
    for key in _VERTEX_KEYS:
        arr = state[key]
        fill = fills[key.split("_")[0]]
        if n_pad > old:
            out[key] = np.concatenate(
                [arr, np.full(n_pad - old, fill, dtype=arr.dtype)])
        else:
            tail = arr[n_pad:]
            inert = (not tail.any() if key.startswith("fr")
                     else (tail >= INF32).all() if key.startswith("dist")
                     else True)
            if not inert:
                raise ValueError(
                    f"cannot shrink checkpoint state from n_pad={old} to "
                    f"{n_pad}: {key} has live entries in the dropped tail")
            out[key] = np.ascontiguousarray(arr[:n_pad])
    return out


# ----------------------------------------------------------- persistence

@dataclasses.dataclass
class CheckpointMeta:
    """Identity and progress of a snapshot: ``n`` / ``num_edges`` /
    ``src`` / ``dst`` fingerprint the search (a resume against another
    graph or query is refused), ``mode`` is the schedule it ran under (a
    resume may override it), ``elapsed_s`` the search seconds so far."""

    n: int
    num_edges: int
    src: int
    dst: int
    mode: str
    levels: int
    elapsed_s: float = 0.0
    version: int = CKPT_VERSION

    def check(self, g, src: int, dst: int) -> None:
        if self.version != CKPT_VERSION:
            raise ValueError(
                f"checkpoint version {self.version} != {CKPT_VERSION}")
        mine = (g.n, g.num_edges, src, dst)
        theirs = (self.n, self.num_edges, self.src, self.dst)
        if mine != theirs:
            raise ValueError(
                f"checkpoint fingerprint mismatch: file has (n, edges, src, "
                f"dst)={theirs}, caller has {mine}")


def save_checkpoint(path: str, state: dict, meta: CheckpointMeta) -> None:
    """Atomic snapshot: write ``<path>.tmp``, fsync it, then ``os.replace``
    (a crash mid-write leaves the previous checkpoint whole)."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, _meta=np.bytes_(json.dumps(dataclasses.asdict(meta))),
                 **state)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_checkpoint(path: str) -> tuple[CheckpointMeta, dict]:
    """Load a snapshot. A file that is not a valid checkpoint (a corrupt
    archive, missing arrays, malformed metadata) raises ``ValueError``
    with the reason; a missing or unreadable file raises ``OSError``."""
    try:
        with np.load(path) as z:
            meta = CheckpointMeta(
                **json.loads(bytes(z["_meta"].item()).decode()))
            state = {key: z[key] for key in _STATE_KEYS}
    except OSError:
        raise
    except Exception as e:
        raise ValueError(
            f"{path} is not a valid checkpoint: {type(e).__name__}: {e}"
        ) from e
    return meta, state


# ------------------------------------------------------------ substrates

def _scalars_to(state: dict, dev) -> dict:
    return {k: torch.tensor(int(state[k]), dtype=torch.int32, device=dev)
            for k in _SCALAR_KEYS}


def _with_fronts(st: dict, kind: str | None, n_rows: int) -> None:
    """Add the pull kernels' frontier rows, rebuilt from the ``bool``
    frontiers: ``"pair"`` (kernel 3) or ``"bits"`` (kernel 4)."""
    if kind == "pair":
        from bibfs_tpu_torch.ops.pull_expand import pack_front

        st["front"] = pack_front(st["fr_s"], st["fr_t"], n_rows)
    elif kind == "bits":
        from bibfs_tpu_torch.ops.bitmap import frontier_words, pack_bits

        for side in "st":
            st[f"bits_{side}"] = pack_bits(st[f"fr_{side}"],
                                           frontier_words(n_rows))


def _with_lists(st: dict, k: int, dev) -> None:
    """The push path's frontier lists, marked stale: a push level rebuilds
    them from the ``bool`` frontier."""
    for side in "st":
        st[f"fi_{side}"] = torch.full((k,), -1, dtype=torch.int32, device=dev)
        st[f"ok_{side}"] = torch.tensor(False, device=dev)


def _kernel_kind(mode: str) -> str | None:
    if not DENSE_MODES[mode][2]:
        return None
    return "pair" if DENSE_MODES[mode][0] == "sync" else "bits"


class _Dense:
    """One card: chunks of ``solvers/dense.py``'s own round."""

    writer = True

    def __init__(self, g, mode: str):
        from bibfs_tpu_torch.solvers import dense

        self.g = g
        mode = dense.resolve_mode(_KERNEL_ROUTE.get(mode, mode), g.tier_meta)
        self.mode = mode
        cap = dense.kernel_cap(mode, g.n_pad, g.device.type)
        self.k = max(cap, 1)
        aux = g.aux
        self.kind = _kernel_kind(mode)
        if self.kind:
            from bibfs_tpu_torch.ops.pull_expand import check_pull

            table = dense._kernel_table(g.tables, g.nbr, g.deg)
            if g.device.type == "cuda":  # once; the rounds launch checked
                check_pull(table, g.deg, g.n_pad)
            aux = ((table,), aux)
        self.body = dense._make_body(mode, cap, g.tier_meta, g.nbr, g.deg, aux)

    def deg_at(self, v: int) -> int:
        return int(self.g.deg[v])

    def put(self, state: dict) -> dict:
        dev = self.g.device
        st = {k: torch.from_numpy(np.array(state[k])).to(dev)
              for k in _VERTEX_KEYS}
        st.update(_scalars_to(state, dev))
        _with_lists(st, self.k, dev)
        _with_fronts(st, self.kind, self.g.n_pad)
        return st

    def read(self, st, stats) -> dict:
        from bibfs_tpu_torch.solvers.dense import _read_scalars

        return _read_scalars(st, stats)

    def round(self, st, sc):
        return self.body(st, sc)

    def rows(self, st, keys) -> list:
        return [st[k] for k in keys]

    def max_degrees(self, st) -> dict:
        return {}


def _mesh_deg_at(g, v: int) -> int:
    """The degree of global vertex ``v`` on a mesh graph (its owner's row,
    summed across the ranks)."""
    from bibfs_tpu_torch.parallel.collectives import sum_allreduce

    local = torch.where(g.ids == v, g.deg, 0).sum(dtype=torch.int32)
    return int(sum_allreduce(local, g.mesh))


class _Sharded:
    """A 1D mesh: chunks of ``solvers/sharded.py``'s round on every
    rank."""

    def __init__(self, g, mode: str):
        from bibfs_tpu_torch.solvers import dense, sharded

        self.g = g
        mode = sharded.resolve_sharded_mode(_KERNEL_ROUTE.get(mode, mode),
                                            g.tier_meta)
        self.mode = mode
        cap = dense.kernel_cap(mode, g.n_pad, g.device.type)
        self.k = max(cap, 1)
        self.kind = _kernel_kind(mode)
        if self.kind and g.device.type == "cuda":
            from bibfs_tpu_torch.ops.pull_expand import check_pull

            check_pull(g.table(), g.deg, g.n_loc)
        self.body = sharded._make_body(g, mode, cap)
        self.writer = g.mesh.rank == 0

    def deg_at(self, v: int) -> int:
        return _mesh_deg_at(self.g, v)

    def put(self, state: dict) -> dict:
        g = self.g
        dev = g.device
        rows = slice(g.offset, g.offset + g.n_loc)
        st = {k: torch.from_numpy(np.array(state[k][rows])).to(dev)
              for k in _VERTEX_KEYS}
        st.update(_scalars_to(state, dev))
        _with_lists(st, self.k, dev)
        _with_fronts(st, self.kind, g.n_loc)
        return st

    def read(self, st, stats) -> dict:
        from bibfs_tpu_torch.solvers.dense import _read_scalars

        return _read_scalars(st, stats)

    def round(self, st, sc):
        return self.body(st, sc)

    def rows(self, st, keys) -> list:
        from bibfs_tpu_torch.solvers.sharded import _gather_rows

        return list(_gather_rows(self.g, *(st[k].to(torch.int32)
                                           for k in keys)))

    def max_degrees(self, st) -> dict:
        return {}


class _Sharded2D:
    """A 2D grid: chunks of ``solvers/sharded2d.py``'s round (the base
    schedule of the mode) on every rank; the carry's ``md_*`` (the Beamer
    switch's input, which the pull-only round does not read) is computed
    from the frontier when the state is fetched."""

    def __init__(self, g, mode: str):
        from bibfs_tpu_torch.solvers import sharded2d

        self.g = g
        self.mode = DENSE_MODES[_KERNEL_ROUTE.get(mode, mode)][0]
        self.body = sharded2d.make_round(g, self.mode)
        self.writer = g.mesh.rank == 0

    def deg_at(self, v: int) -> int:
        return _mesh_deg_at(self.g, v)

    def put(self, state: dict) -> dict:
        g = self.g
        dev = g.device
        rows = slice(g.offset, g.offset + g.n_loc)
        st = {k: torch.from_numpy(np.array(state[k][rows])).to(dev)
              for k in _VERTEX_KEYS}
        st.update(_scalars_to(state, dev))
        return st

    def read(self, st, stats) -> dict:
        from bibfs_tpu_torch.solvers.sharded2d import _read

        return _read(st, stats)

    def round(self, st, sc):
        return self.body(st, sc)

    def rows(self, st, keys) -> list:
        from bibfs_tpu_torch.solvers.sharded2d import gather_rows

        return list(gather_rows(self.g, *(st[k].to(torch.int32)
                                          for k in keys)))

    def max_degrees(self, st) -> dict:
        from bibfs_tpu_torch.parallel.collectives import max_allreduce

        md = torch.stack([torch.where(st[f"fr_{s}"], self.g.deg, 0).max()
                          for s in "st"]).to(torch.int32)
        md = max_allreduce(md, self.g.mesh).tolist()
        return {"md_s": md[0], "md_t": md[1]}


def _substrate(g, mode: str):
    """The chunk loop's view of ``g``: one card, a 1D mesh or a 2D
    grid."""
    if mode not in DENSE_MODES:
        raise ValueError(f"unknown mode {mode!r}; have {sorted(DENSE_MODES)}")
    if hasattr(g, "bnbr"):
        return _Sharded2D(g, mode)
    if hasattr(g, "mesh"):
        return _Sharded(g, mode)
    return _Dense(g, mode)


def _active(sc: dict) -> bool:
    return (sc["lvl_s"] + sc["lvl_t"] < sc["best"]
            and sc["cnt_s"] > 0 and sc["cnt_t"] > 0)


def _fetch(sub, st) -> dict:
    """The device carry as host arrays over the graph's ``n_pad`` rows (a
    gather on a mesh: every rank calls it)."""
    rows = [r.cpu().numpy() for r in sub.rows(st, _VERTEX_KEYS)]
    out = {}
    for key, row in zip(_VERTEX_KEYS, rows):
        out[key] = row.astype(bool) if key.startswith("fr") else \
            row.astype(np.int32)
    scal = {k: v for k, v in zip(
        [k for k in _SCALAR_KEYS if k in st],
        torch.stack([st[k].to(torch.int32) for k in _SCALAR_KEYS
                     if k in st]).tolist())}
    scal.update(sub.max_degrees(st))
    for k in _SCALAR_KEYS:
        out[k] = np.int32(scal[k])
    return out


# ------------------------------------------------------------ chunk loop

def _drive(g, state_np, meta, *, mode, chunk, path, max_chunks):
    """The chunk loop: at most ``chunk`` rounds, the host's read of the
    termination scalars, the snapshot, again. Returns a :class:`BFSResult`,
    or None when ``max_chunks`` chunks ran out first (the state is in
    ``path`` when one was given)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    sub = _substrate(g, mode)
    st = sub.put(_refit(state_np, g.n_pad))
    base_s = meta.elapsed_s
    t0 = time.perf_counter()
    chunks = 0
    while True:
        for _ in range(chunk):
            sc = sub.read(st, None)
            if not _active(sc):
                break
            st = sub.round(st, sc)
        sc = sub.read(st, None)
        running = _active(sc)
        chunks += 1
        if path is not None:
            snap = _fetch(sub, st)  # a gather on a mesh: every rank
            meta = dataclasses.replace(
                meta, levels=int(snap["levels"]),
                elapsed_s=base_s + (time.perf_counter() - t0))
            if sub.writer:
                save_checkpoint(path, snap, meta)
        if not running:
            break
        if max_chunks is not None and chunks >= max_chunks:
            return None
    elapsed = base_s + (time.perf_counter() - t0)
    par_s, par_t = sub.rows(st, ("par_s", "par_t"))
    scal = torch.stack([st[k].to(torch.int32) for k in
                        ("best", "meet", "levels", "edges")]).tolist()
    out = (scal[0], scal[1], par_s, par_t, scal[2], scal[3])
    return _materialize(out, elapsed, mode=sub.mode)


def solve_checkpointed(g, src: int, dst: int, *, mode: str = "sync",
                       chunk: int = 8, path: str | None = None,
                       max_chunks: int | None = None) -> BFSResult | None:
    """A chunked search on a :class:`~bibfs_tpu_torch.solvers.dense.
    DeviceGraph`, a :class:`~bibfs_tpu_torch.solvers.sharded.ShardedGraph`
    or a :class:`~bibfs_tpu_torch.solvers.sharded2d.Sharded2DGraph` (on a
    mesh every rank calls it): at most ``chunk`` rounds between host
    reads, a snapshot to ``path`` after every chunk. Returns the result,
    or None if ``max_chunks`` chunks ran out first (resume later with
    :func:`resume`). ``path=None`` runs chunks with no file."""
    if not (0 <= src < g.n and 0 <= dst < g.n):
        raise ValueError(f"src/dst out of range for n={g.n}")
    sub = _substrate(g, mode)
    state = _init_state_np(g.n_pad, src, dst, sub.deg_at(src),
                           sub.deg_at(dst))
    meta = CheckpointMeta(n=g.n, num_edges=g.num_edges, src=src, dst=dst,
                          mode=mode, levels=0)
    return _drive(g, state, meta, mode=mode, chunk=chunk, path=path,
                  max_chunks=max_chunks)


def resume(path: str, g, *, src: int, dst: int, mode: str | None = None,
           chunk: int = 8, max_chunks: int | None = None) -> BFSResult | None:
    """Continue a checkpointed search from its last completed chunk. ``g``
    may be another substrate or mesh size than the one that wrote the
    file (the state is re-padded and re-sharded); ``src``/``dst`` must
    match its fingerprint. ``mode=None`` keeps the snapshot's schedule.
    The result's ``time_s``, ``levels`` and ``edges_scanned`` cover the
    whole search across the resumes."""
    meta, state = load_checkpoint(path)
    meta.check(g, src, dst)
    return _drive(g, state, meta, mode=mode or meta.mode, chunk=chunk,
                  path=path, max_chunks=max_chunks)


def checkpoint_on_mesh(n: int, edges, src: int, dst: int, *,
                       substrate: str = "1d", num_devices: int | None = None,
                       rows: int | None = None, cols: int | None = None,
                       mode: str = "sync", layout: str = "ell", chunk: int = 8,
                       path: str | None = None, resume_from: bool = False,
                       max_chunks: int | None = None, device=None):
    """A checkpointed search (or, with ``resume_from``, a resume of
    ``path``) on ranks spawned on this host: a 1D mesh of ``num_devices``
    ranks, or a ``rows x cols`` grid (``substrate="2d"``); rank 0 writes
    the file and its result is returned."""
    from bibfs_tpu_torch.parallel.mesh import launch
    from bibfs_tpu_torch.solvers import sharded, sharded2d
    from bibfs_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    if substrate == "2d":
        if num_devices is None and rows is not None and cols is not None:
            num_devices = rows * cols
        ndev = num_devices or (torch.cuda.device_count()
                               if dev.type == "cuda" else 1)
        rows, cols = sharded2d.grid_shape(ndev, rows, cols)
        host = sharded2d.Sharded2DHost.build(n, edges, rows, cols)
    else:
        ndev = num_devices or (torch.cuda.device_count()
                               if dev.type == "cuda" else 1)
        host = sharded.build_host_graph(n, edges, ndev, layout=layout)
    job = dict(kind="resume" if resume_from else "checkpoint", graph="g",
               substrate=substrate, src=src, dst=dst,
               mode=mode, chunk=chunk, path=path, max_chunks=max_chunks)
    out = launch(sharded.sharded_jobs, ndev, {"g": host}, [job],
                 device=dev.type)
    return out["results"][0]
