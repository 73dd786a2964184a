"""Device-tier bitmask-packed multi-source BFS: the counterpart of
``bibfs_tpu/ops/msbfs_device.py`` (its ELL sweep).

K searches advance in one level-synchronous sweep. Every vertex carries
:func:`state_words` uint32 reach words (held in int32 tensors; bit
``k & 31`` of word ``k >> 5`` is search ``k``; ``ceil(K / 32)`` padded to
1, 2 or a multiple of 4), and a level ORs each vertex's neighbours'
*pending* words (the bits they gained the level before), keeps the bits
that are new, and stamps the level into the ``int16 [n, K]`` distance
plane for exactly those bits. The result is the host sweep's contract
(:func:`bibfs_tpu_torch.oracle.trees.multi_source_bfs`): ``int16 [n, K]``,
``-1`` unreachable.

- :func:`msbfs_levels` runs levels ``[first, last]`` from a state. A CUDA
  tensor launches the hand-written ``msbfs_sweep_kernel``
  (``csrc/msbfs.cu``: one cooperative launch loops over the levels on the
  card, pushing from a frontier worklist or, on dense levels, pulling over
  the CSR) and reads its status once, or raises; a CPU tensor runs
  :func:`msbfs_levels_plain`, the level loop over
  :func:`msbfs_level_plain`. Launches count in ``msbfs_levels.launches``.
- :func:`msbfs_level` is one level: on the card the same kernel with
  ``first == last`` (no host read), on the CPU :func:`msbfs_level_plain`.
- :func:`sweep` runs a whole sweep: one launch and one host read on the
  card; on the CPU the plain level loop reads the flags of
  :data:`CHECK_EVERY` levels at once. :func:`msbfs_plane_csr` is the sweep
  from a CSR (uploaded once by :func:`upload_csr`), the oracle index
  builder's input; :func:`msbfs_plane_ell` takes a host ELL table and
  :func:`msbfs_plane_graph` an uploaded
  :class:`~bibfs_tpu_torch.solvers.dense.DeviceGraph` (plain ELL only:
  hub tiers carry edges its rows do not).
- :func:`frontier_bytes` counts, from a finished plane, the bytes each
  level's frontier needs: the sweep's least traffic.

The reference pads every row to the graph's maximum degree
(``_ell_from_csr``); the port sweeps the CSR, so a hub graph's sweep fits
on the card. OR is order-free and each (vertex, search) is stamped once,
so the plane is bit-identical whatever order the card's worklists take.
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

from bibfs_tpu_torch.ops import _cuda
from bibfs_tpu_torch.utils.platform import resolve_device

#: bits per mask word
WORD_BITS = 32

#: the largest distance the int16 plane holds
INT16_MAX = int(np.iinfo(np.int16).max)

#: levels between two host reads of the CPU sweep's flags
CHECK_EVERY = 8

#: a level pulls (dense) when its frontier's degree sum reaches this share
#: of the CSR's entries, and pushes from the worklist below it
DENSE_SHARE = 1 / 4

# the kernel's int64 working block (one per device and stream, zero
# between launches: the kernel resets it as it exits) and its status words
# (last level with a new bit, dense, sparse, error, run, grid)
_CTL_LEN = 16
_STATUS_LEN = 6
_ERR_DEPTH, _ERR_BARRIER = 1, 2

_ctl_lock = threading.Lock()
_ctl_blocks: dict = {}

_sweeps_lock = threading.Lock()
_sweeps_run = 0


def sweeps_run() -> int:
    """How many sweeps this process has run through this module (the
    routing witness: the oracle builder really swept here)."""
    return _sweeps_run


def plane_words(k: int) -> int:
    """Mask words that hold K searches."""
    return max(1, -(-int(k) // WORD_BITS))


def state_words(k: int) -> int:
    """Mask words per vertex of the sweep's state: :func:`plane_words`
    padded to 1, 2 or a multiple of 4, so a vertex's words are one vector
    load on the card (the padding words stay zero)."""
    w = plane_words(k)
    return w if w <= 2 else -(-w // 4) * 4


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2^32)`` as the int32 words of the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """``int32 [n, W]`` mask words -> ``bool [n, 32 W]`` (bit ``b`` of word
    ``w`` is column ``32 w + b``)."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1).bool()


def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`unpack_words`: ``bool [n, 32 W]`` -> ``int32
    [n, W]``."""
    n = bits.shape[0]
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=bits.device)
    vals = bits.view(n, -1, WORD_BITS).to(torch.int64) << shifts
    return _to_i32(vals.sum(-1))


def msbfs_level_plain(row_ptr, col_ind, pending, reach, dist, level: int, flag,
                      live=None):
    """Plain torch twin of :func:`msbfs_level`: the neighbours' pending
    bits exploded per word, summed onto their rows by ``index_add_`` and
    packed back (OR as ``> 0``). Returns ``pending_next``; updates
    ``reach``, ``dist`` and ``flag`` in place."""
    n, words = reach.shape
    k = dist.shape[1]
    if live is not None and int(live.reshape(-1)[0]) == 0:
        return torch.zeros_like(pending)
    deg = row_ptr[1:] - row_ptr[:-1]
    rows = torch.repeat_interleave(
        torch.arange(n, device=reach.device), deg.to(torch.int64)
    )
    src = col_ind.to(torch.int64)
    acc = torch.empty_like(pending)
    for w in range(words):
        bits = unpack_words(pending[:, w:w + 1]).to(torch.int32)
        hits = torch.zeros(n, WORD_BITS, dtype=torch.int32, device=reach.device)
        hits.index_add_(0, rows, bits[src])
        acc[:, w:w + 1] = pack_words(hits > 0)
    fresh = acc & ~reach
    reach |= fresh
    new_bits = unpack_words(fresh)[:, :k]
    if level <= INT16_MAX:
        dist[new_bits] = level
    if bool(new_bits.any()):
        flag.fill_(1)
    return fresh


def _depth_error() -> ValueError:
    return ValueError("graph diameter exceeds int16 distance range")


def msbfs_levels_plain(row_ptr, col_ind, pending, reach, dist, first: int,
                       last: int):
    """Plain torch twin of :func:`msbfs_levels`: :func:`msbfs_level_plain`
    level after level from ``first``, until ``last`` or the first level
    that finds nothing (a state with no pending bit runs no level).
    Returns ``(pending, status)`` as the kernel's wrapper does, ``status``
    with ``levels`` (the last level that found a new bit, ``first - 1`` if
    none) and ``run`` (levels run)."""
    flag = torch.zeros(1, dtype=torch.int32, device=reach.device)
    run, last_new = 0, first - 1
    for level in range(first, last + 1):
        if not bool(pending.any()):
            break
        flag.zero_()
        pending = msbfs_level_plain(row_ptr, col_ind, pending, reach, dist,
                                    level, flag)
        run += 1
        if int(flag) == 0:
            break
        last_new = level
        if level > INT16_MAX:
            raise _depth_error()
    return pending, {"levels": last_new, "run": run}


def check_level(row_ptr, col_ind, pending, reach, dist, flag=None) -> None:
    """Validate a launch's inputs on the card: types, shapes, one device,
    contiguous."""
    n, words = reach.shape
    k = dist.shape[1]
    if row_ptr.shape != (n + 1,) or col_ind.dim() != 1:
        raise ValueError("row_ptr must be [n + 1] and col_ind 1-D")
    if pending.shape != reach.shape or dist.shape[0] != n:
        raise ValueError("pending must be reach's shape and dist [n, K]")
    if words != state_words(k):
        raise ValueError(f"K = {k} needs {state_words(k)} words, got {words}")
    one = {} if flag is None else {"flag": flag}
    if flag is not None and flag.numel() != 1:
        raise ValueError("flag is one int32 word")
    _cuda.check_dtype(torch.int64, row_ptr=row_ptr)
    _cuda.check_dtype(torch.int32, col_ind=col_ind, pending=pending,
                      reach=reach, **one)
    _cuda.check_dtype(torch.int16, dist=dist)
    _cuda.check_cuda(reach.device, row_ptr=row_ptr, col_ind=col_ind,
                     pending=pending, dist=dist, **one)


def lanes_per_vertex(n: int, nnz: int) -> int:
    """Threads that share one vertex's CSR row on the card: the graph's
    mean degree rounded up to a power of two, at most a warp."""
    mean = nnz / max(n, 1)
    return min(32, 1 << max(0, math.ceil(math.log2(mean)) if mean > 1 else 0))


def _ctl_block(dev: torch.device, length: int = _CTL_LEN) -> torch.Tensor:
    """A persistent kernel's working block of ``length`` int64 words for
    ``dev`` and its current stream: zeroed once here, and left zero by
    every launch that ends."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream, length)
    with _ctl_lock:
        ctl = _ctl_blocks.get(key)
        if ctl is None:
            ctl = torch.zeros(length, dtype=torch.int64, device=dev)
            _ctl_blocks[key] = ctl
    return ctl


def _launch(row_ptr, col_ind, pending, reach, dist, first: int, last: int,
            flag=None):
    """One launch of ``msbfs_sweep_kernel`` over levels ``[first, last]``
    (``pending`` is only read); returns its scratch pending buffers
    ``[1 or 3, n, W]`` (level ``first + i`` writes ``scratch[i % 3]``), its
    working block and its status words, not read. Allocates, and fills
    nothing: the kernel zeroes its scratch."""
    if first < 1:
        raise ValueError(f"levels start at 1, got {first}")
    n, wp = reach.shape
    dev = reach.device
    scratch = torch.empty((1 if first == last else 3, n, wp),
                          dtype=torch.int32, device=dev)
    bufs = [scratch[j % scratch.shape[0]] for j in range(3)]
    lists = torch.empty(3 * n, dtype=torch.int32, device=dev)
    mark = torch.empty(n, dtype=torch.int32, device=dev)
    status = torch.empty(_STATUS_LEN, dtype=torch.int64, device=dev)
    ctl = _ctl_block(dev)
    nnz = col_ind.numel()
    _cuda.launch(
        "msbfs", "bibfs_msbfs_sweep", row_ptr.data_ptr(), col_ind.data_ptr(),
        n, wp, dist.shape[1], math.ceil(nnz * DENSE_SHARE),
        lanes_per_vertex(n, nnz), pending.data_ptr(),
        *(b.data_ptr() for b in bufs), reach.data_ptr(), dist.data_ptr(),
        lists.data_ptr(), mark.data_ptr(), ctl.data_ptr(), status.data_ptr(),
        int(first), int(last), INT16_MAX,
        None if flag is None else flag.data_ptr(),
    )
    _cuda.count_launch(msbfs_levels)
    return scratch, ctl, status


def msbfs_levels(row_ptr, col_ind, pending, reach, dist, first: int,
                 last: int, *, checked: bool = False):
    """Levels ``first..last`` of the K-source sweep (module docstring) over
    the CSR ``row_ptr int64 [n + 1]`` / ``col_ind int32 [E]``, from the
    state ``pending`` and ``reach`` (``int32 [n, W]`` mask words,
    ``W = state_words(K)``) and ``dist`` (the ``int16 [n, K]`` plane),
    stopping after the first level that finds nothing. Updates ``reach``
    and ``dist`` in place (levels above the int16 range stamp nothing) and
    leaves ``pending`` as it was. Returns ``(pending_next, status)``:
    the last level's new bits and ``levels`` (the last level that found a
    new bit), ``run`` (levels run) and, on the card, ``dense_levels``,
    ``sparse_levels`` and ``grid`` (blocks). A level above the int16 range
    that finds a new bit raises the reference's ``ValueError``. On the
    card this is one launch and one host read; ``checked`` skips the
    validation (:func:`check_level`)."""
    if not reach.is_cuda:
        return msbfs_levels_plain(row_ptr, col_ind, pending, reach, dist,
                                  first, last)
    if not checked:
        check_level(row_ptr, col_ind, pending, reach, dist)
    scratch, ctl, status = _launch(row_ptr, col_ind, pending, reach, dist,
                                   first, last)
    last_new, dense, sparse, err, run, grid = status.tolist()
    if err == _ERR_BARRIER:
        ctl.zero_()  # blocks that gave up left it mid-count
        raise RuntimeError("msbfs_sweep_kernel: a grid barrier timed out")
    if err == _ERR_DEPTH:
        raise _depth_error()
    out = pending if run == 0 else scratch[(run - 1) % 3]
    return out, {"levels": last_new, "run": run, "dense_levels": dense,
                 "sparse_levels": sparse, "grid": grid}


msbfs_levels.launches = 0


def msbfs_level(row_ptr, col_ind, pending, reach, dist, level: int, flag,
                live=None, *, checked: bool = False):
    """One level of the sweep (:func:`msbfs_levels` with ``first == last``,
    no host read). Returns ``pending_next`` (the bits new at this level);
    updates ``reach`` and ``dist`` and sets the one-word ``flag`` to 1
    when any bit is new. ``live`` (the previous level's flag; 0 makes the
    level empty) belongs to the CPU sweep's loop: on the card a sweep is
    one launch and ``live`` is refused. ``checked`` skips the validation
    (:func:`check_level`)."""
    if not reach.is_cuda:
        return msbfs_level_plain(row_ptr, col_ind, pending, reach, dist, level,
                                 flag, live)
    if live is not None:
        raise ValueError("live is the CPU loop's; on the card a sweep is "
                         "one launch (msbfs_levels)")
    if not checked:
        check_level(row_ptr, col_ind, pending, reach, dist, flag)
    scratch, _ctl, _status = _launch(row_ptr, col_ind, pending, reach, dist,
                                     level, level, flag)
    return scratch[0]


def seed_state(n: int, sources: torch.Tensor):
    """The sweep's level-0 state on the sources' device: ``reach`` (the
    sources' bits, :func:`state_words` words), ``pending`` (a copy) and
    ``dist`` (0 at each source's column, -1 elsewhere)."""
    k = int(sources.numel())
    words = state_words(k)
    dev = sources.device
    col = torch.arange(k, device=dev)
    # one distinct (word, bit) per column, so the sum is the OR
    seed = torch.zeros(n * words, dtype=torch.int64, device=dev)
    seed.index_add_(0, sources * words + col // WORD_BITS,
                    torch.ones(k, dtype=torch.int64, device=dev)
                    << (col % WORD_BITS))
    reach = _to_i32(seed).view(n, words)
    dist = torch.full((n, k), -1, dtype=torch.int16, device=dev)
    dist[sources, col] = 0
    return reach, reach.clone(), dist


def sweep(n: int, row_ptr: torch.Tensor, col_ind: torch.Tensor,
          sources: np.ndarray, *, stats: dict | None = None) -> torch.Tensor:
    """The K-source sweep over a CSR already on its device; returns the
    ``int16 [n, K]`` plane there. ``stats`` (optional) receives the
    levels with new bits, the launches and the host reads, and on the card
    the dense and sparse levels."""
    global _sweeps_run
    dev = row_ptr.device
    src = torch.from_numpy(np.asarray(sources, dtype=np.int64)).to(dev)
    reach, pending, dist = seed_state(n, src)
    if dev.type == "cuda":
        # one launch runs every level; the card stops past the int16 range
        _pending, st = msbfs_levels(row_ptr, col_ind, pending, reach, dist, 1,
                                    INT16_MAX + 1)
        got = dict(levels=st["levels"], launches=1, host_reads=1,
                   dense_levels=st["dense_levels"],
                   sparse_levels=st["sparse_levels"])
    else:
        got = _sweep_plain(row_ptr, col_ind, pending, reach, dist)
    with _sweeps_lock:
        _sweeps_run += 1
    if stats is not None:
        stats.update(got)
    return dist


def _sweep_plain(row_ptr, col_ind, pending, reach, dist) -> dict:
    """The CPU sweep: the plain level, reading the flags of
    :data:`CHECK_EVERY` levels at once (a level after an empty one is
    empty, so the overshoot is exact)."""
    check_every = CHECK_EVERY
    flags = torch.zeros(check_every, dtype=torch.int32, device=reach.device)
    level = reads = 0
    while True:
        flags.zero_()
        live = None  # the last read saw new bits
        for j in range(check_every):
            level += 1
            pending = msbfs_level_plain(row_ptr, col_ind, pending, reach,
                                        dist, level, flags[j:j + 1], live)
            live = flags[j:j + 1]
        got = flags.cpu().numpy()
        reads += 1
        hit = np.flatnonzero(got)
        last = level - check_every + (int(hit[-1]) + 1 if hit.size else 0)
        if last > INT16_MAX:
            raise _depth_error()
        if got[-1] == 0:
            return dict(levels=last, launches=level, host_reads=reads)


def _check_sources(n: int, sources) -> np.ndarray:
    sources = np.asarray(sources, dtype=np.int64).ravel()
    if sources.size and (int(sources.min()) < 0 or int(sources.max()) >= n):
        raise ValueError(f"source out of range for n={n}")
    return sources


def _on(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype).contiguous()
    np_dtype = np.int64 if dtype == torch.int64 else np.int32
    a = np.ascontiguousarray(x, dtype=np_dtype)
    if not a.flags.writeable:
        a = a.copy()  # a read-only mapping: torch takes writable memory only
    return torch.from_numpy(a).to(dev)


def upload_csr(row_ptr, col_ind, device=None):
    """The CSR on ``device`` (default ``cuda``) as ``(row_ptr int64,
    col_ind int32)`` tensors; tensors already there are returned as they
    are, so an index build uploads its CSR once for all its sweeps."""
    dev = resolve_device(device)
    return _on(row_ptr, torch.int64, dev), _on(col_ind, torch.int32, dev)


def msbfs_plane_csr(n: int, row_ptr, col_ind, sources, *, device=None,
                    stats: dict | None = None) -> np.ndarray:
    """The sweep from a CSR (host arrays, or :func:`upload_csr`'s tensors)
    on ``device`` (default ``cuda``; ``"cpu"`` runs the plain level).
    Returns ``int16 [n, K]``."""
    sources = _check_sources(n, sources)
    if sources.size == 0:
        return np.zeros((n, 0), dtype=np.int16)
    rp, ci = upload_csr(row_ptr, col_ind, device)
    return sweep(n, rp, ci, sources, stats=stats).cpu().numpy()


def msbfs_plane_ell(n: int, nbr, deg, sources, *, device=None,
                    stats: dict | None = None) -> np.ndarray:
    """The sweep over one host ELL table (``nbr`` int32 ``[n_pad, width]``
    with a row's live slots first, ``deg`` int32 ``[n_pad]``): its CSR is
    the live slots in row order. Returns ``int16 [n, K]``."""
    nbr = np.asarray(nbr)
    deg = np.asarray(deg, dtype=np.int64)[:n]
    if deg.size and int(deg.max()) > nbr.shape[1]:
        raise ValueError("an ELL row holds fewer slots than its degree")
    live = np.arange(nbr.shape[1])[None, :] < deg[:, None]
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    return msbfs_plane_csr(n, row_ptr, nbr[:n][live], sources, device=device,
                           stats=stats)


def msbfs_plane_graph(g, sources, *, stats: dict | None = None) -> np.ndarray:
    """The sweep over an uploaded serving table
    (:class:`~bibfs_tpu_torch.solvers.dense.DeviceGraph`, plain ELL: hub
    tiers carry edges its rows miss, so tiered layouts are refused), on
    the table's device. Returns ``int16 [n, K]``."""
    if getattr(g, "tier_meta", ()):
        raise ValueError("device msBFS is plain-ELL only (tiered "
                         "layouts keep the host sweep)")
    sources = _check_sources(g.n, sources)
    if sources.size == 0:
        return np.zeros((g.n, 0), dtype=np.int16)
    row_ptr, col_ind = graph_csr(g)
    return sweep(g.n, row_ptr, col_ind, sources, stats=stats).cpu().numpy()


def graph_csr(g):
    """The CSR of an uploaded plain-ELL table
    (:class:`~bibfs_tpu_torch.solvers.dense.DeviceGraph`) on its device,
    ``(row_ptr int64, col_ind int32)``: the live slots in row order, built
    at the first call and kept in the graph's table cache."""
    csr = g.tables.get("csr")
    if csr is None:
        deg = g.deg[: g.n].to(torch.int64)
        live = torch.arange(g.width, device=g.device)[None, :] < deg[:, None]
        col_ind = g.nbr[: g.n][live].contiguous()
        row_ptr = torch.zeros(g.n + 1, dtype=torch.int64, device=g.device)
        torch.cumsum(deg, 0, out=row_ptr[1:])
        csr = (row_ptr, col_ind)
        g.tables["csr"] = csr
    return csr


# ---- the sweep's least traffic, from a finished plane ----------------------

_COUNT_ROWS = 16384  # rows unpacked at a time by _bit_counts


def _level_bits(cols: np.ndarray, lw: int) -> np.ndarray:
    """``uint64 [n, lw]``: bit ``l`` of row ``v`` says some column of
    ``cols`` (``int16 [n, c]``) holds the level ``l`` at ``v``."""
    n = cols.shape[0]
    out = np.zeros((n, lw), dtype=np.uint64)
    rows = np.arange(n)
    for c in range(cols.shape[1]):
        d = cols[:, c].astype(np.int64)
        hit = d >= 0
        d = d[hit]  # one entry per row and column: no index repeats
        out[rows[hit], d >> 6] |= np.uint64(1) << (d & 63).astype(np.uint64)
    return out


def _or_neighbours(bits: np.ndarray, row_ptr: np.ndarray,
                   col_ind: np.ndarray) -> np.ndarray:
    """Each row's OR of its CSR neighbours' rows of ``bits``."""
    out = np.zeros_like(bits)
    has = np.diff(row_ptr) > 0
    if col_ind.size:
        # the segment of a non-empty row ends where the next one starts
        out[has] = np.bitwise_or.reduceat(bits[col_ind], row_ptr[:-1][has],
                                          axis=0)
    return out


def _bit_counts(bits: np.ndarray, weights=None) -> np.ndarray:
    """Per bit position ``l`` of ``uint64 [n, lw]`` rows: how many rows
    have it (or the sum of their ``weights``)."""
    total = np.zeros(bits.shape[1] * 64, dtype=np.int64)
    for i in range(0, bits.shape[0], _COUNT_ROWS):
        chunk = np.ascontiguousarray(bits[i:i + _COUNT_ROWS])
        b = np.unpackbits(chunk.view(np.uint8), axis=1, bitorder="little")
        total += (b.sum(axis=0, dtype=np.int64) if weights is None
                  else weights[i:i + _COUNT_ROWS] @ b)
    return total


def frontier_bytes(row_ptr, col_ind, plane) -> np.ndarray:
    """The bytes each level of the sweep that made ``plane`` (``int16 [n,
    K]``) must move, from the plane alone: ``out[L]`` for levels ``L = 1
    .. D + 1`` (``D`` the deepest stamp; level ``D + 1`` finds nothing).
    Level ``L``'s frontier is the vertices with a stamp ``L - 1``; it
    reads their CSR rows (16 B of ``row_ptr``, 4 B an entry) and their
    pending words (4 B a 32-search word holding such a stamp), the reach
    words of their neighbours (4 B a (neighbour, word) pair with a
    frontier neighbour pending in that word), writes the changed reach and
    next pending words (8 B a (vertex, word) pair with a stamp ``L``) and
    2 B a new stamp. ``out[0]`` is 0."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    col_ind = np.asarray(col_ind, dtype=np.int64)
    plane = np.asarray(plane)
    n, k = plane.shape
    if n == 0 or k == 0 or int(plane.max()) < 0:
        return np.zeros(1, dtype=np.int64)
    depth = int(plane.max())
    levels = depth + 2
    lw = (depth + 1) // 64 + 1  # bit positions 0 .. >= depth + 1
    out = np.zeros(levels, dtype=np.int64)
    stamps = np.bincount(plane[plane > 0].astype(np.int64), minlength=levels)
    out[1:] += 2 * stamps[1:levels]
    frontier = np.zeros((n, lw), dtype=np.uint64)
    for w in range(plane_words(k)):
        own = _level_bits(plane[:, WORD_BITS * w:WORD_BITS * (w + 1)], lw)
        frontier |= own
        held = _bit_counts(own)
        near = _bit_counts(_or_neighbours(own, row_ptr, col_ind))
        out[1:] += 4 * held[:levels - 1] + 4 * near[:levels - 1]
        out[1:] += 8 * held[1:levels]
    rows = _bit_counts(frontier)
    entries = _bit_counts(frontier, weights=np.diff(row_ptr))
    out[1:] += 16 * rows[:levels - 1] + 4 * entries[:levels - 1]
    return out
