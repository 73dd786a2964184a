"""Semiring products and fixpoints over the blocked tile tables: the
counterpart of ``bibfs_tpu/ops/semiring_plane.py``.

:func:`~bibfs_tpu_torch.ops.blocked_expand.expand_blocked_plane` is the
(OR, AND) instance of ``out = A (x) plane``. This module owns the two
other products the analytics kinds need, over the same ``[nblocks,
bwidth, tile, tile]`` tables, sentinel ``bcol`` gather and chunking:

- :func:`plustimes_plane`: the (+, x) product, the batched product without
  the ``> 0`` readout (PageRank contributions, triangle counts);
- :func:`minplus_plane`: the (min, +) product, per chunk of ``rc`` block
  rows the ``[rc, bwidth, tile, tile, C]`` combine ``w + gathered`` reduced
  by ``min`` over (slot, in-tile column). ``from_tab=True`` derives 0/inf
  weights from the int8 adjacency (min-label propagation, no weight table);
  otherwise the table is a float32 weight table
  (:func:`bibfs_tpu_torch.graph.blocked.build_blocked_weights`).

The JAX package runs each whole-graph recurrence as one ``lax.while_loop``
in one jitted program. Here each is one launch of a hand-written kernel of
``csrc/semiring.cu`` on a CUDA tensor, or raises; a CPU tensor runs its
plain twin, a host-driven torch loop with the reference's iteration
semantics (what the tests hold against the JAX package):

- :func:`sssp_blocked` / :func:`components_blocked` -> :func:`minplus_fixpoint`
  (``minplus_fixpoint_kernel``; twin :func:`minplus_fixpoint_plain`):
  Jacobi sweeps ``nd = min(d, A (x) d)`` until a sweep changes nothing
  (that sweep counted), at most ``nblocks * tile`` sweeps. The kernel
  sweeps only a worklist of block rows (those a changed block row feeds,
  and the changed ones); :func:`minplus_fixpoint_worklist` is those sweeps
  in torch, what :func:`minplus_needed_bytes` and
  :func:`minplus_sweep_modes` count from;
- :func:`pagerank_blocked` (``pagerank_kernel``; twin
  :func:`pagerank_blocked_plain`): damped power iteration to the L1
  tolerance ``max(tol, 5e-7)``, the dangling mass spread over the ``n``
  live rows, pad rows masked;
- :func:`triangles_chunk_blocked` (``tricount_kernel``; twin
  :func:`triangles_chunk_blocked_plain`): one 256-column chunk's
  ``sum((A @ P) * P)``, entry-wise integers. ``P``'s columns are the
  adjacency's own columns ``c0 .. c0 + 255``, so the chunk is named by
  ``c0`` and read from the table (:func:`triangle_plane` builds the
  reference's plane from it).

On the card the (min, +), PageRank and triangle kernels read the table's
packed tile rows, one bit an entry (:func:`pack_tile_rows` over
``pack_tile_rows_kernel``; twin :func:`pack_tile_rows_plain`, inverse
:func:`unpack_tile_rows`): int32 ``[nblocks, bwidth, tile, 4]``, an eighth
of the int8 table, stored slot-minor (a view of ``[nblocks, tile, bwidth,
4]`` memory: a tile row of every slot of a block row side by side, what
the kernels' lanes read together), built once per uploaded graph by the
serving runtime (``BlockedDeviceGraph.bits``) and passed as ``bits=``; the
PageRank and triangle wrappers given none pack the table themselves, the
(min, +) wrapper raises (its weight table is not the adjacency). The CPU
twins read the int8 or float32 table.

Exactness: distances (integer weight sums), labels (vertex ids) and
triangle counts are integers, exact in float32 below 2^24 (the serving
gates enforce the bound), so the kernels and twins equal the JAX package's
answers bit for bit whatever their summation order; PageRank's ranks are
float sums held to a tolerance. Launches count in
``minplus_fixpoint.launches``, ``pagerank_blocked.launches``,
``triangles_chunk_blocked.launches`` and ``pack_tile_rows.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from bibfs_tpu_torch.graph.blocked import TILE
from bibfs_tpu_torch.ops import _cuda
from bibfs_tpu_torch.ops.blocked_expand import (
    BLOCKED_CHUNK_BUDGET_BYTES,
    chunk_block_rows,
)

#: the triangle count's column chunk (the reference's static width)
TRI_CHUNK = 256

#: the widest block row ``tricount_kernel`` takes (its grid: the chunk's
#: block rows x bwidth x ceil(bwidth / 32) blocks)
TRI_MAX_WIDTH = 4096

#: 32-bit words of a packed tile row
PACK_WORDS = TILE // 32

#: the smallest PageRank tolerance float32 L1 deltas resolve
PAGERANK_TOL_FLOOR = 5e-7

# the kernels' status words: [rounds or iterations (negative: an error
# code), the final L1 delta's float32 bits]; a barrier that timed out
_STATUS_LEN = 2
_ERR_BARRIER = 2
# a launch's zeroed working block: barrier arrivals and flags
_CTL_LEN = 8
# the fewest rows of a PageRank work item (a warp each)
_PR_ITEM_ROWS = 8
# minplus_fixpoint_kernel's status words: rounds (or minus an error code),
# sweeps run in one block, sweeps run on the grid, active block rows summed
_MP_STATUS_LEN = 4

#: ``minplus_fixpoint_kernel``'s block, the slots a lane loads at once, and
#: the passes of one block's lane groups a sweep may fill and still run in
#: block 0 alone (``csrc/semiring.cu``)
MINPLUS_THREADS = 512
MINPLUS_SLOTS = 4
MINPLUS_SOLO_ROUNDS = 1
#: the most block rows ``minplus_fixpoint_kernel`` takes (its worklist
#: bitmaps live in shared memory)
MINPLUS_MAX_BLOCK_ROWS = 16384


def minplus_chunk_rows(bwidth: int, c: int, tile: int = TILE) -> int:
    """Block rows per (min, +) chunk: the combine holds a ``[rc, bwidth,
    tile, tile, C]`` float32 working set, a factor ``tile`` heavier a row
    than the dot-product path, under the same budget."""
    per_row = bwidth * tile * tile * max(1, c) * 4
    return max(1, BLOCKED_CHUNK_BUDGET_BYTES // max(per_row, 1))


def plustimes_plane(fr, tab, bcol, *, rc: int):
    """``A @ fr`` over (+, x): the blocked gather and batched product with
    the raw accumulator returned (no ``> 0`` readout), in ``fr``'s type.
    ``fr`` is ``[n_pad, C]``; sentinel slots gather an appended zero
    tile."""
    nblocks, bwidth = bcol.shape
    tile = tab.shape[2]
    c = fr.shape[1]
    f2 = fr.reshape(nblocks, tile, c)
    f2p = torch.cat([f2, f2.new_zeros(1, tile, c)], dim=0)
    outs = []
    for i0 in range(0, nblocks, rc):
        tab_c = tab[i0:i0 + rc].to(fr.dtype)
        fr_c = f2p[bcol[i0:i0 + rc].long()]  # [r, bwidth, tile, C]
        r = tab_c.shape[0]
        a = tab_c.permute(0, 2, 1, 3).reshape(r, tile, bwidth * tile)
        outs.append(torch.bmm(a, fr_c.reshape(r, bwidth * tile, c)))
    return torch.cat(outs, dim=0).reshape(nblocks * tile, c)


def minplus_plane(fr, table, bcol, *, rc: int, from_tab: bool):
    """``out[u] = min over edges (u, v) of (w_uv + fr[v])`` per plane
    column. ``table`` is the float32 weight table (+inf at absent slots),
    or with ``from_tab=True`` the int8 adjacency read as 0/inf weights.
    Sentinel slots gather an all-+inf tile and never win the min. ``table``
    and ``bcol`` may be some block rows of the graph's (``fr`` the whole
    plane): the rows of those block rows come out."""
    nblocks, bwidth = bcol.shape
    tile = table.shape[2]
    c = fr.shape[1]
    inf = torch.tensor(float("inf"), dtype=fr.dtype, device=fr.device)
    f2 = fr.reshape(-1, tile, c)
    f2p = torch.cat([f2, inf.expand(1, tile, c)], dim=0)
    outs = []
    for i0 in range(0, nblocks, rc):
        w_c = table[i0:i0 + rc]
        if from_tab:
            w_c = torch.where(w_c > 0, inf.new_zeros(()), inf)
        else:
            w_c = w_c.to(fr.dtype)
        fr_c = f2p[bcol[i0:i0 + rc].long()]  # [r, bwidth, tile col, C]
        # [r, bwidth, tile row, tile col, C], min over (slot, column)
        comb = w_c[:, :, :, :, None] + fr_c[:, :, None, :, :]
        outs.append(comb.amin(dim=(1, 3)))
    return torch.cat(outs, dim=0).reshape(nblocks * tile, c)


# ---- the plain twins: host-driven loops with the reference's semantics ----

def minplus_fixpoint_plain(table, bcol, init, *, from_tab: bool,
                           max_rounds: int | None = None):
    """Twin of :func:`minplus_fixpoint`: Jacobi sweeps of
    :func:`minplus_plane` until one lowers nothing (counted), at most
    ``max_rounds`` (default ``nblocks * tile``). Returns ``(plane,
    rounds)``."""
    nblocks, bwidth = bcol.shape
    tile = table.shape[2]
    if max_rounds is None:
        max_rounds = nblocks * tile
    rc = minplus_chunk_rows(bwidth, init.shape[1], tile)
    d = init.to(torch.float32)
    rounds, changed = 0, True
    while changed and rounds < max_rounds:
        nd = torch.minimum(d, minplus_plane(d, table, bcol, rc=rc,
                                            from_tab=from_tab))
        changed = bool((nd < d).any())
        d = nd
        rounds += 1
    return d, rounds


def minplus_fixpoint_worklist(table, bcol, init, *, from_tab: bool,
                              max_rounds: int | None = None):
    """The sweeps of ``minplus_fixpoint_kernel`` in torch: the same planes
    and rounds as :func:`minplus_fixpoint_plain`, each sweep computed only
    on its worklist, over two ping-pong buffers as the kernel holds them
    (the second starts as NaN, so a row no sweep wrote shows). Sweep 0
    takes every block row; sweep ``r`` the block rows that lowered an entry
    at sweep ``r - 1`` and every block row whose ``bcol`` row holds one of
    them. Returns ``(plane, rounds, sweeps)``, ``sweeps`` the active block
    rows of each sweep (int64 numpy arrays)."""
    nblocks, bwidth = bcol.shape
    tile = table.shape[2]
    if max_rounds is None:
        max_rounds = nblocks * tile
    c = init.shape[1]
    rc = minplus_chunk_rows(bwidth, c, tile)
    dev = table.device
    first = init.to(device=dev, dtype=torch.float32)
    bufs = [first.clone(), torch.full_like(first, float("nan"))]
    bc = bcol.cpu().numpy()
    in_tile = torch.arange(tile, device=dev)
    sweeps: list = []
    act = np.arange(nblocks)
    rounds = 0
    while rounds < max_rounds and act.size:
        d, nd = bufs[rounds & 1], bufs[(rounds + 1) & 1]
        rows = torch.as_tensor(act, device=dev)
        prod = minplus_plane(d, table[rows], bcol[rows], rc=rc,
                             from_tab=from_tab)
        idx = (rows[:, None] * tile + in_tile).reshape(-1)
        old = d[idx]
        new = torch.minimum(old, prod)
        nd[idx] = new
        lowered = (new < old).reshape(act.size, -1).any(dim=1).cpu().numpy()
        sweeps.append(act)
        rounds += 1
        changed = act[lowered]
        act = np.flatnonzero(np.isin(np.arange(nblocks), changed)
                             | np.isin(bc, changed).any(axis=1))
    return bufs[rounds & 1], rounds, sweeps


def minplus_group(bwidth: int) -> int:
    """The lanes ``minplus_fixpoint_kernel`` gives a row: the power of two
    (at most 32) that leaves a lane at most :data:`MINPLUS_SLOTS` of its
    slots."""
    g = 1
    while g < 32 and g * MINPLUS_SLOTS < bwidth:
        g *= 2
    return g


def minplus_sweep_modes(bwidth: int, sweeps) -> tuple:
    """``(one-block sweeps, grid sweeps)`` of ``minplus_fixpoint_kernel``
    over these worklists: a sweep runs in block 0 alone while its rows'
    lane groups fill at most :data:`MINPLUS_SOLO_ROUNDS` passes of one
    block."""
    cap = MINPLUS_SOLO_ROUNDS * MINPLUS_THREADS
    g = minplus_group(bwidth)
    solo = sum(1 for act in sweeps if len(act) * TILE * g <= cap)
    return solo, len(sweeps) - solo


def minplus_needed_bytes(table, bcol, sweeps, c: int, *, from_tab: bool):
    """The bytes the worklist's sweeps must move: for each sweep the packed
    rows of its active block rows' stored slots (16 bytes a tile row), one
    32-byte sector for each of their stored edges' weights (SSSP; labels
    read no weight), and the plane rows read (the active block rows and the
    block rows they read, once) and written (the active ones), ``4 c``
    bytes a row."""
    nblocks, bwidth = bcol.shape
    tile = table.shape[2]
    bc = bcol.cpu().numpy()
    live = (bc < nblocks).sum(axis=1)
    edges = (table != 0 if from_tab else torch.isfinite(table)).sum(
        dim=(1, 2, 3)).cpu().numpy()
    row_bytes = tile * 4 * int(c)
    total = 0
    for act in sweeps:
        held = bc[act]
        read = np.union1d(act, held[held < nblocks])
        total += int(live[act].sum()) * tile * 16
        if not from_tab:
            total += int(edges[act].sum()) * 32
        total += (read.size + len(act)) * row_bytes
    return total


def pagerank_blocked_plain(tab, bcol, deg, *, n: int, damping: float,
                           tol: float, max_iters: int):
    """Twin of :func:`pagerank_blocked`: the reference's power iteration,
    one :func:`plustimes_plane` a step. Returns ``(ranks float32 [n_pad],
    iters, delta)``."""
    nblocks, bwidth = bcol.shape
    tile = tab.shape[2]
    n_pad = nblocks * tile
    rc = chunk_block_rows(bwidth, 1, 4, tile)
    tol32 = float(np.float32(max(float(tol), PAGERANK_TOL_FLOOR)))
    dev = tab.device
    mask = (torch.arange(n_pad, device=dev) < n).to(torch.float32)
    degf = deg.to(torch.float32)
    live = degf > 0
    r = mask / torch.tensor(float(n), dtype=torch.float32)
    delta = torch.tensor(float("inf"), dtype=torch.float32)
    it = 0
    while float(delta) > tol32 and it < int(max_iters):
        contrib = torch.where(live, r / degf.clamp_min(1.0), 0.0)
        y = plustimes_plane(contrib[:, None], tab, bcol, rc=rc)[:, 0]
        mass = torch.where(live, 0.0, r * mask).sum()
        rn = mask * ((1.0 - damping) / n + damping * (y + mass / n))
        delta = (rn - r).abs().sum()
        r = rn
        it += 1
    return r, it, float(delta)


def triangle_plane(tab, bcol, c0: int, width: int = TRI_CHUNK):
    """The reference's chunk plane ``P`` (float32 ``[n_pad, width]``,
    ``P[u, j] = A[u, c0 + j]``) read from the table: by symmetry the
    transpose of rows ``c0 .. c0 + width - 1``, which are block rows ``c0 /
    tile ..`` of ``tab``. ``c0`` is a multiple of the tile edge."""
    nblocks, bwidth = bcol.shape
    tile = tab.shape[2]
    rows = tab.new_zeros((width, (nblocks + 1) * tile), dtype=torch.float32)
    for i, x in enumerate(range(c0 // tile, (c0 + width) // tile)):
        if x >= nblocks:
            break
        blk = rows[i * tile:(i + 1) * tile].view(tile, nblocks + 1, tile)
        # sentinel slots write zero tiles into the spare column block
        blk[:, bcol[x].long(), :] = tab[x].permute(1, 0, 2).to(torch.float32)
    return rows[:, : nblocks * tile].T.contiguous()


def triangles_chunk_blocked_plain(tab, bcol, c0: int, out=None):
    """Twin of :func:`triangles_chunk_blocked`: the reference's
    ``sum((A @ P) * P)`` with ``P = triangle_plane(tab, bcol, c0)``, each
    entry an integer before the sum, added into ``out`` (int64 ``[1]``)."""
    nblocks, bwidth = bcol.shape
    tile = tab.shape[2]
    if out is None:
        out = torch.zeros(1, dtype=torch.int64, device=tab.device)
    plane = triangle_plane(tab, bcol, c0)
    rc = chunk_block_rows(bwidth, plane.shape[1], 4, tile)
    y = plustimes_plane(plane, tab, bcol, rc=rc)
    out += (y * plane).to(torch.int64).sum()
    return out


def _slot_minor(words):
    """``[nblocks, bwidth, tile, 4]`` words as the kernels store them: a
    view of contiguous ``[nblocks, tile, bwidth, 4]`` memory."""
    return words.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)


def pack_tile_rows_plain(tab):
    """Twin of :func:`pack_tile_rows`: ``np.packbits(tab != 0, axis=-1,
    bitorder="little")`` read as little-endian 32-bit words, int32
    ``[nblocks, bwidth, tile, tile / 32]``: bit ``j`` of word ``w`` of a
    tile row is its column ``32 w + j``; stored slot-minor as the kernel
    stores it."""
    packed = np.packbits(tab.cpu().numpy() != 0, axis=-1, bitorder="little")
    words = np.ascontiguousarray(packed).view("<i4").astype(np.int32)
    return _slot_minor(torch.from_numpy(words)).to(tab.device)


def unpack_tile_rows(bits):
    """The int8 0/1 table whose packed rows are ``bits`` (the inverse of
    :func:`pack_tile_rows`)."""
    words = np.ascontiguousarray(bits.cpu().numpy()).astype("<i4")
    rows = np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little")
    return torch.from_numpy(rows.astype(np.int8)).to(bits.device)


# ---- the kernels --------------------------------------------------------

def _check_table(table, bcol, dtype) -> None:
    if table.dim() != 4 or table.shape[2:] != (TILE, TILE) or bcol.dim() != 2:
        raise ValueError("the table must be [nblocks, bwidth, 128, 128] with "
                         "bcol [nblocks, bwidth]")
    if table.shape[:2] != bcol.shape:
        raise ValueError("the table and bcol disagree on (nblocks, bwidth)")
    _cuda.check_dtype(dtype, table=table)
    _cuda.check_dtype(torch.int32, bcol=bcol)
    _cuda.check_cuda(table.device, table=table, bcol=bcol)


def _check_bits(bits, tab) -> None:
    """Raise unless ``bits`` is ``tab``'s packed rows in shape, type,
    layout and device (int32 ``[nblocks, bwidth, tile, 4]``, slot-minor)."""
    want = (*tab.shape[:3], PACK_WORDS)
    if not isinstance(bits, torch.Tensor) or tuple(bits.shape) != want:
        got = tuple(bits.shape) if isinstance(bits, torch.Tensor) else bits
        raise ValueError(f"bits must be the packed rows {list(want)}, got "
                         f"{got}")
    _cuda.check_dtype(torch.int32, bits=bits)
    if bits.device != tab.device:
        raise ValueError(f"bits is on {bits.device}, expected {tab.device}")
    if not bits.permute(0, 2, 1, 3).is_contiguous():
        raise ValueError("bits must be stored slot-minor, as "
                         "pack_tile_rows stores it")


def pack_tile_rows(tab):
    """The int8 tile table packed one bit an entry: int32 ``[nblocks,
    bwidth, tile, 4]``, bit ``j`` of word ``w`` of a tile row its column
    ``32 w + j`` (``np.packbits(..., bitorder="little")`` read as
    little-endian words); sentinel slots, all-zero tiles, pack to zero.
    Stored slot-minor: the result is a view of contiguous ``[nblocks, tile,
    bwidth, 4]`` memory. On the card one launch of
    ``pack_tile_rows_kernel`` (a warp a tile row of 8 slots: eight
    128-byte rows read, 128 bytes written); on the CPU
    :func:`pack_tile_rows_plain`."""
    if tab.dim() != 4 or tab.shape[2:] != (TILE, TILE):
        raise ValueError("the table must be [nblocks, bwidth, 128, 128]")
    if not tab.is_cuda:
        return pack_tile_rows_plain(tab)
    _cuda.check_dtype(torch.int8, table=tab)
    _cuda.check_cuda(tab.device, table=tab)
    nblocks, bwidth = tab.shape[:2]
    words = torch.empty((nblocks, TILE, bwidth, PACK_WORDS),
                        dtype=torch.int32, device=tab.device)
    _cuda.launch("semiring", "bibfs_pack_tile_rows", tab.data_ptr(), nblocks,
                 bwidth, words.data_ptr())
    _cuda.count_launch(pack_tile_rows)
    return words.permute(0, 2, 1, 3)


pack_tile_rows.launches = 0


def _status(name: str, status: torch.Tensor) -> list:
    """Read a launch's status words once; raise on its error code."""
    got = status.tolist()
    if got[0] < 0:
        why = ("a grid barrier timed out" if -got[0] == _ERR_BARRIER
               else f"error word {-got[0]}")
        raise RuntimeError(f"{name}: {why}")
    return got


def _minplus_launch(bits, weights, bcol, init, *, max_rounds: int):
    """One launch of ``minplus_fixpoint_kernel`` over the packed rows
    ``bits`` (``weights`` the float32 weight table, or None for labels),
    counted in ``minplus_fixpoint.launches``; the inputs are the caller's
    to check. Returns ``(planes [2, n_pad, C], status int64 [4])`` unread:
    the plane lies in buffer ``rounds & 1``, the status holds the rounds
    (or minus the error code), the sweeps run in one block and on the
    grid, and the active block rows summed over the sweeps."""
    nblocks, bwidth = bcol.shape
    n_pad = nblocks * TILE
    dev = bits.device
    c = init.shape[1]
    planes = torch.empty((2, n_pad, c), dtype=torch.float32, device=dev)
    planes[0].copy_(init)
    # one int64 block: the zeroed working words (control words and three
    # changed-block-row bitmaps of ceil(nblocks / 64) words) and the status
    ctl_len = _CTL_LEN + 3 * (-(-nblocks // 64))
    words = torch.empty(ctl_len + _MP_STATUS_LEN, dtype=torch.int64,
                        device=dev)
    ctl, status = words[:ctl_len], words[ctl_len:]
    ctl.zero_()
    _cuda.launch(
        "semiring", "bibfs_minplus_fixpoint", bits.data_ptr(),
        0 if weights is None else weights.data_ptr(), bcol.data_ptr(),
        nblocks, bwidth, c, int(max_rounds), planes.data_ptr(),
        ctl.data_ptr(), status.data_ptr(),
    )
    _cuda.count_launch(minplus_fixpoint)
    return planes, status


def minplus_fixpoint(table, bcol, init, *, from_tab: bool,
                     max_rounds: int | None = None, bits=None):
    """The (min, +) fixpoint over ``[n_pad, C]`` planes: Jacobi sweeps
    ``nd = min(d, A (x) d)`` until one lowers nothing (that sweep counted)
    or ``max_rounds`` (default ``nblocks * tile``) ran. ``table`` is the
    float32 weight table, or with ``from_tab`` the int8 adjacency (0/inf
    weights). On the card one cooperative launch of
    ``minplus_fixpoint_kernel`` over the adjacency's packed rows ``bits``
    (:func:`pack_tile_rows`; required there: the kernel lists each row's
    edges from them, reads one weight an edge from ``table`` and no int8
    tile) and one 8-byte read; a sweep works only on the block rows a
    changed block row feeds and the changed ones, narrow sweeps in one
    block. On the CPU :func:`minplus_fixpoint_plain` over ``table``.
    Returns ``(plane float32 [n_pad, C], rounds)``."""
    if bits is not None:
        _check_bits(bits, table)
    if not table.is_cuda:
        return minplus_fixpoint_plain(table, bcol, init, from_tab=from_tab,
                                      max_rounds=max_rounds)
    _check_table(table, bcol, torch.int8 if from_tab else torch.float32)
    if bits is None:
        raise ValueError("minplus_fixpoint_kernel lists the edges from the "
                         "packed tile rows: pass bits= (pack_tile_rows of "
                         "the int8 adjacency)")
    nblocks, bwidth = bcol.shape
    if nblocks > MINPLUS_MAX_BLOCK_ROWS:
        raise ValueError(f"{nblocks} block rows exceed minplus_fixpoint_"
                         f"kernel's {MINPLUS_MAX_BLOCK_ROWS}")
    n_pad = nblocks * TILE
    if init.dim() != 2 or init.shape[0] != n_pad or init.shape[1] < 1:
        raise ValueError(f"init must be [{n_pad}, C]")
    if max_rounds is None:
        max_rounds = n_pad
    planes, status = _minplus_launch(
        bits, None if from_tab else table, bcol, init,
        max_rounds=max_rounds)
    rounds = _status("minplus_fixpoint_kernel", status[:1])[0]
    return planes[rounds & 1], rounds


minplus_fixpoint.launches = 0


def sssp_blocked(wtab, bcol, sources_init, bits=None):
    """Multi-source Bellman fixpoint over a float32 weight table;
    ``sources_init`` is the ``[n_pad, C]`` plane (0 at each source's
    column, +inf elsewhere); ``bits`` the adjacency's packed rows (needed
    on the card). Returns ``(dist [n_pad, C], rounds)``."""
    return minplus_fixpoint(wtab, bcol, sources_init, from_tab=False,
                            bits=bits)


def components_blocked(tab, bcol, labels_init, bits=None):
    """Min-label propagation fixpoint over the int8 adjacency (``bits`` its
    packed rows, needed on the card). Returns ``(labels [n_pad, 1],
    rounds)``."""
    return minplus_fixpoint(tab, bcol, labels_init, from_tab=True,
                            bits=bits)


def _pagerank_launch(bits, bcol, deg, *, n: int, damping: float,
                     tol: float, max_iters: int):
    """One launch of ``pagerank_kernel`` over the packed rows ``bits`` at
    the float32 tolerance ``tol`` as given (a negative one ends no step
    early: ``max_iters`` steps), counted in ``pagerank_blocked.launches``;
    the inputs are the caller's to check. Returns ``(ranks [2, n_pad],
    status int64 [2])`` unread: the ranks lie in buffer ``iters & 1``, the
    status holds the iterations (or minus the error code) and the last
    delta's float32 bits."""
    nblocks, bwidth = bcol.shape
    n_pad = nblocks * TILE
    dev = bits.device
    # one float block: ranks and contributions, each ping-ponging between
    # two [n_pad] buffers, and the [parity, (delta, mass), item] partial
    # sums (an item is at least 8 rows); one int64 block: the zeroed
    # working words and the status
    items = n_pad // _PR_ITEM_ROWS
    work = torch.empty(4 * n_pad + 4 * items, dtype=torch.float32,
                       device=dev)
    ranks = work[: 2 * n_pad].view(2, n_pad)
    contrib = work[2 * n_pad: 4 * n_pad]
    part = work[4 * n_pad:]
    words = torch.empty(_CTL_LEN + _STATUS_LEN, dtype=torch.int64,
                        device=dev)
    ctl, status = words[:_CTL_LEN], words[_CTL_LEN:]
    ctl.zero_()
    _cuda.launch(
        "semiring", "bibfs_pagerank", bits.data_ptr(), bcol.data_ptr(),
        deg.data_ptr(), nblocks, bwidth, int(n),
        float(np.float32((1.0 - float(damping)) / int(n))),
        float(np.float32(damping)), float(np.float32(tol)), int(max_iters),
        ranks.data_ptr(), contrib.data_ptr(), part.data_ptr(),
        ctl.data_ptr(), status.data_ptr(),
    )
    _cuda.count_launch(pagerank_blocked)
    return ranks, status


def pagerank_blocked(tab, bcol, deg, *, n: int, damping: float, tol: float,
                     max_iters: int, bits=None):
    """Damped power iteration over the tiles to the L1 tolerance
    ``max(tol, 5e-7)`` (what float32 deltas resolve), at most
    ``max_iters`` steps. On the card one cooperative launch of
    ``pagerank_kernel`` over the packed rows ``bits``
    (:func:`pack_tile_rows` of ``tab``, packed here when not given; a warp
    a row, a lane a slot; fixed-order reductions: the same ranks every
    run) and one read; on the CPU :func:`pagerank_blocked_plain` over the
    int8 ``tab``. Returns ``(ranks float32 [n_pad], iters, delta)``."""
    if bits is not None:
        _check_bits(bits, tab)
    if not tab.is_cuda:
        return pagerank_blocked_plain(tab, bcol, deg, n=n, damping=damping,
                                      tol=tol, max_iters=max_iters)
    _check_table(tab, bcol, torch.int8)
    n_pad = bcol.shape[0] * TILE
    if deg.shape != (n_pad,):
        raise ValueError(f"deg must be [{n_pad}]")
    if not 0 < int(n) <= n_pad:
        raise ValueError(f"n={n} outside (0, {n_pad}]")
    _cuda.check_dtype(torch.int32, deg=deg)
    _cuda.check_cuda(tab.device, deg=deg)
    if bits is None:
        bits = pack_tile_rows(tab)
    ranks, status = _pagerank_launch(
        bits, bcol, deg, n=n, damping=damping,
        tol=max(float(tol), PAGERANK_TOL_FLOOR), max_iters=max_iters)
    iters, sbits = _status("pagerank_kernel", status)
    delta = float(np.array([sbits & 0xFFFFFFFF], dtype=np.uint32)
                  .view(np.float32)[0])
    return ranks[iters & 1], iters, delta


pagerank_blocked.launches = 0


def triangles_chunk_blocked(tab, bcol, c0: int, out=None, bits=None):
    """One column chunk's ordered-pair triangle total, ``sum((A @ P) * P)``
    over the chunk ``c0 .. c0 + 255`` (:func:`triangle_plane`), added into
    ``out`` (int64 ``[1]``, zeroed here when None) and returned; the caller
    sums the chunks and divides by 6. On the card one launch of
    ``tricount_kernel`` over the packed rows ``bits`` (:func:`pack_tile_rows`
    of ``tab``, packed here when not given; exact integer arithmetic: for
    each edge ``(x, u)`` with ``x`` in the chunk, the common neighbours of
    ``x`` and ``u`` by popcounts of their packed rows ANDed over the block
    columns both rows hold; ``bcol`` rows ascending with sentinels last, as
    :func:`~bibfs_tpu_torch.graph.blocked.build_blocked` lays them, and
    ``bwidth`` at most :data:`TRI_MAX_WIDTH`); on the CPU
    :func:`triangles_chunk_blocked_plain` over the int8 ``tab``."""
    if int(c0) % TILE:
        raise ValueError(f"c0={c0} is not a multiple of {TILE}")
    if bits is not None:
        _check_bits(bits, tab)
    if not tab.is_cuda:
        return triangles_chunk_blocked_plain(tab, bcol, c0, out)
    _check_table(tab, bcol, torch.int8)
    nblocks, bwidth = bcol.shape
    if bwidth > TRI_MAX_WIDTH:
        raise ValueError(f"bwidth {bwidth} exceeds tricount_kernel's "
                         f"{TRI_MAX_WIDTH}")
    if out is None:
        out = torch.zeros(1, dtype=torch.int64, device=tab.device)
    _cuda.check_dtype(torch.int64, out=out)
    _cuda.check_cuda(tab.device, out=out)
    rows = min(TRI_CHUNK, nblocks * TILE - int(c0))
    if rows > 0:
        if bits is None:
            bits = pack_tile_rows(tab)
        _cuda.launch("semiring", "bibfs_tricount", bits.data_ptr(),
                     bcol.data_ptr(), nblocks, bwidth, int(c0), rows,
                     out.data_ptr())
        _cuda.count_launch(triangles_chunk_blocked)
    return out


triangles_chunk_blocked.launches = 0
