"""Device-tier bitmask-packed multi-source BFS: the counterpart of
``bibfs_tpu/ops/msbfs_device.py`` (its ELL sweep).

K searches advance in one level-synchronous sweep. Every vertex carries
``ceil(K / 32)`` uint32 reach words (held in int32 tensors; bit
``k & 31`` of word ``k >> 5`` is search ``k``), and a level ORs each
vertex's neighbours' *pending* words (the bits they gained the level
before), keeps the bits that are new, and stamps the level into the
``int16 [n, K]`` distance plane for exactly those bits. The result is the
host sweep's contract (:func:`bibfs_tpu_torch.oracle.trees.
multi_source_bfs`): ``int16 [n, K]``, ``-1`` unreachable.

- :func:`msbfs_level` is one level. A CUDA tensor launches the
  hand-written ``msbfs_level_kernel`` (``csrc/msbfs.cu``: a pull over the
  CSR, one thread per (vertex, word)) or raises; a CPU tensor runs
  :func:`msbfs_level_plain`, the same function in plain torch. Launches
  count in ``msbfs_level.launches``.
- :func:`msbfs_plane_csr` is the sweep from a host CSR, the oracle index
  builder's input; :func:`msbfs_plane_ell` takes a host ELL table and
  :func:`msbfs_plane_graph` an uploaded
  :class:`~bibfs_tpu_torch.solvers.dense.DeviceGraph` (plain ELL only:
  hub tiers carry edges its rows do not). The host loop reads the flags
  of :data:`CHECK_EVERY` levels at once; a level whose predecessor found
  nothing costs a launch (the kernel reads that flag first).

The reference pads every row to the graph's maximum degree
(``_ell_from_csr``); the port sweeps the CSR, so a hub graph's sweep fits
on the card. OR is order-free, so the plane is bit-identical.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from bibfs_tpu_torch.ops import _cuda
from bibfs_tpu_torch.utils.platform import resolve_device

#: bits per mask word
WORD_BITS = 32

#: the largest distance the int16 plane holds
INT16_MAX = int(np.iinfo(np.int16).max)

#: levels between two host reads of the sweep's flags
CHECK_EVERY = 8

_sweeps_lock = threading.Lock()
_sweeps_run = 0


def sweeps_run() -> int:
    """How many sweeps this process has run through this module (the
    routing witness: the oracle builder really swept here)."""
    return _sweeps_run


def plane_words(k: int) -> int:
    """Mask words per vertex for a K-source sweep."""
    return max(1, -(-int(k) // WORD_BITS))


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


def check_level(row_ptr, col_ind, pending, reach, dist, flag, live) -> None:
    """Validate one launch's inputs on the card: types, shapes, one
    device, contiguous."""
    n, words = reach.shape
    k = dist.shape[1]
    if row_ptr.shape != (n + 1,) or col_ind.dim() != 1:
        raise ValueError("row_ptr must be [n + 1] and col_ind 1-D")
    if pending.shape != reach.shape or dist.shape[0] != n:
        raise ValueError("pending must be reach's shape and dist [n, K]")
    if words != plane_words(k):
        raise ValueError(f"K = {k} needs {plane_words(k)} words, got {words}")
    if flag.numel() != 1 or (live is not None and live.numel() != 1):
        raise ValueError("flag and live are one int32 word each")
    _cuda.check_dtype(torch.int64, row_ptr=row_ptr)
    _cuda.check_dtype(torch.int32, col_ind=col_ind, pending=pending,
                      reach=reach, flag=flag)
    _cuda.check_dtype(torch.int16, dist=dist)
    more = {} if live is None else {"live": live}
    _cuda.check_cuda(reach.device, row_ptr=row_ptr, col_ind=col_ind,
                     pending=pending, dist=dist, flag=flag, **more)


def msbfs_level(row_ptr, col_ind, pending, reach, dist, level: int, flag,
                live=None, *, checked: bool = False):
    """One level of the K-source sweep (module docstring) over the CSR
    ``row_ptr int64 [n + 1]`` / ``col_ind int32 [E]``. ``pending`` and
    ``reach`` are ``int32 [n, W]`` mask words, ``dist`` the ``int16 [n,
    K]`` plane. Returns ``pending_next`` (the bits new at this level);
    updates ``reach`` and ``dist`` (stamped ``level`` where new, unless
    ``level`` exceeds the int16 range) and sets the one-word ``flag`` to 1
    when any bit is new. With ``live`` (the previous level's flag) equal to
    0 the level is empty: ``pending_next`` is zero and nothing else is
    touched. ``checked`` skips the validation (:func:`check_level`)."""
    if not reach.is_cuda:
        return msbfs_level_plain(row_ptr, col_ind, pending, reach, dist, level,
                                 flag, live)
    if not checked:
        check_level(row_ptr, col_ind, pending, reach, dist, flag, live)
    n, words = reach.shape
    pending_next = torch.empty_like(pending)
    _cuda.launch(
        "msbfs", "bibfs_msbfs_level", row_ptr.data_ptr(), col_ind.data_ptr(),
        n, words, dist.shape[1], pending.data_ptr(), reach.data_ptr(),
        pending_next.data_ptr(), dist.data_ptr(), int(level), flag.data_ptr(),
        None if live is None else live.data_ptr(),
    )
    _cuda.count_launch(msbfs_level)
    return pending_next


msbfs_level.launches = 0


def seed_state(n: int, sources: torch.Tensor):
    """The sweep's level-0 state on the sources' device: ``reach`` (the
    sources' bits), ``pending`` (a copy) and ``dist`` (0 at each source's
    column, -1 elsewhere)."""
    k = int(sources.numel())
    words = plane_words(k)
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
    levels with new bits, the launches and the host reads."""
    global _sweeps_run
    dev = row_ptr.device
    check_every = CHECK_EVERY
    src = torch.from_numpy(np.asarray(sources, dtype=np.int64)).to(dev)
    reach, pending, dist = seed_state(n, src)
    flags = torch.zeros(check_every, dtype=torch.int32, device=dev)
    level = reads = 0
    if dev.type == "cuda":
        check_level(row_ptr, col_ind, pending, reach, dist, flags[:1], None)
    while True:
        flags.zero_()
        live = None  # the last read saw new bits
        for j in range(check_every):
            level += 1
            pending = msbfs_level(row_ptr, col_ind, pending, reach, dist,
                                  level, flags[j:j + 1], live, checked=True)
            live = flags[j:j + 1]
        got = flags.cpu().numpy()
        reads += 1
        hit = np.flatnonzero(got)
        last = level - check_every + (int(hit[-1]) + 1 if hit.size else 0)
        if last > INT16_MAX:
            raise ValueError("graph diameter exceeds int16 distance range")
        if got[-1] == 0:
            break
    with _sweeps_lock:
        _sweeps_run += 1
    if stats is not None:
        stats.update(levels=last, launches=level, host_reads=reads)
    return dist


def _check_sources(n: int, sources) -> np.ndarray:
    sources = np.asarray(sources, dtype=np.int64).ravel()
    if sources.size and (int(sources.min()) < 0 or int(sources.max()) >= n):
        raise ValueError(f"source out of range for n={n}")
    return sources


def msbfs_plane_csr(n: int, row_ptr, col_ind, sources, *, device=None,
                    stats: dict | None = None) -> np.ndarray:
    """The sweep from a host CSR (what the oracle index builder holds) on
    ``device`` (default ``cuda``; ``"cpu"`` runs the plain level).
    Returns ``int16 [n, K]``."""
    sources = _check_sources(n, sources)
    if sources.size == 0:
        return np.zeros((n, 0), dtype=np.int16)
    dev = resolve_device(device)
    rp = torch.from_numpy(np.ascontiguousarray(row_ptr, dtype=np.int64)).to(dev)
    ci = torch.from_numpy(np.ascontiguousarray(col_ind, dtype=np.int32)).to(dev)
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
    deg = g.deg[: g.n].to(torch.int64)
    live = torch.arange(g.width, device=g.device)[None, :] < deg[:, None]
    col_ind = g.nbr[: g.n][live].contiguous()
    row_ptr = torch.zeros(g.n + 1, dtype=torch.int64, device=g.device)
    torch.cumsum(deg, 0, out=row_ptr[1:])
    return sweep(g.n, row_ptr, col_ind, sources, stats=stats).cpu().numpy()
