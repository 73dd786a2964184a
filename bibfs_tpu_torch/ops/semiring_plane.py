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
  (that sweep counted), at most ``nblocks * tile`` sweeps;
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

Exactness: distances (integer weight sums), labels (vertex ids) and
triangle counts are integers, exact in float32 below 2^24 (the serving
gates enforce the bound), so the kernels and twins equal the JAX package's
answers bit for bit whatever their summation order; PageRank's ranks are
float sums held to a tolerance. Launches count in
``minplus_fixpoint.launches``, ``pagerank_blocked.launches`` and
``triangles_chunk_blocked.launches``.
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

#: the widest block row ``tricount_kernel`` takes (its shared memory: a
#: row's tile rows and each warp's list of matched block columns)
TRI_MAX_WIDTH = 300

#: the smallest PageRank tolerance float32 L1 deltas resolve
PAGERANK_TOL_FLOOR = 5e-7

# the kernels' status words: [rounds or iterations (negative: an error
# code), the final L1 delta's float32 bits]; a barrier that timed out
_STATUS_LEN = 2
_ERR_BARRIER = 2
# a launch's zeroed working block: barrier arrivals and flags
_CTL_LEN = 8
# work items a block row of the fixpoint kernels (32 rows each)
_ITEM_PARTS = TILE // 32


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
    Sentinel slots gather an all-+inf tile and never win the min."""
    nblocks, bwidth = bcol.shape
    tile = table.shape[2]
    c = fr.shape[1]
    inf = torch.tensor(float("inf"), dtype=fr.dtype, device=fr.device)
    f2 = fr.reshape(nblocks, tile, c)
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


def _status(name: str, status: torch.Tensor) -> list:
    """Read a launch's status words once; raise on its error code."""
    got = status.tolist()
    if got[0] < 0:
        why = ("a grid barrier timed out" if -got[0] == _ERR_BARRIER
               else f"error word {-got[0]}")
        raise RuntimeError(f"{name}: {why}")
    return got


def minplus_fixpoint(table, bcol, init, *, from_tab: bool,
                     max_rounds: int | None = None):
    """The (min, +) fixpoint over ``[n_pad, C]`` planes: Jacobi sweeps
    ``nd = min(d, A (x) d)`` until one lowers nothing (that sweep counted)
    or ``max_rounds`` (default ``nblocks * tile``) ran. ``table`` is the
    float32 weight table, or with ``from_tab`` the int8 adjacency (0/inf
    derived on the fly). On the card one cooperative launch of
    ``minplus_fixpoint_kernel`` (ping-pong planes, a grid barrier between
    sweeps) and one 8-byte read; on the CPU :func:`minplus_fixpoint_plain`.
    Returns ``(plane float32 [n_pad, C], rounds)``."""
    if not table.is_cuda:
        return minplus_fixpoint_plain(table, bcol, init, from_tab=from_tab,
                                      max_rounds=max_rounds)
    _check_table(table, bcol, torch.int8 if from_tab else torch.float32)
    nblocks, bwidth = bcol.shape
    n_pad = nblocks * TILE
    if init.dim() != 2 or init.shape[0] != n_pad or init.shape[1] < 1:
        raise ValueError(f"init must be [{n_pad}, C]")
    if max_rounds is None:
        max_rounds = n_pad
    dev = table.device
    c = init.shape[1]
    planes = torch.empty((2, n_pad, c), dtype=torch.float32, device=dev)
    planes[0].copy_(init)
    ctl = torch.zeros(_CTL_LEN, dtype=torch.int64, device=dev)
    status = torch.empty(_STATUS_LEN, dtype=torch.int64, device=dev)
    _cuda.launch(
        "semiring", "bibfs_minplus_fixpoint", table.data_ptr(),
        int(bool(from_tab)), bcol.data_ptr(), nblocks, bwidth, c,
        int(max_rounds), planes.data_ptr(), ctl.data_ptr(), status.data_ptr(),
    )
    _cuda.count_launch(minplus_fixpoint)
    rounds = _status("minplus_fixpoint_kernel", status[:1])[0]
    return planes[rounds & 1], rounds


minplus_fixpoint.launches = 0


def sssp_blocked(wtab, bcol, sources_init):
    """Multi-source Bellman fixpoint over a float32 weight table;
    ``sources_init`` is the ``[n_pad, C]`` plane (0 at each source's
    column, +inf elsewhere). Returns ``(dist [n_pad, C], rounds)``."""
    return minplus_fixpoint(wtab, bcol, sources_init, from_tab=False)


def components_blocked(tab, bcol, labels_init):
    """Min-label propagation fixpoint over the int8 adjacency. Returns
    ``(labels [n_pad, 1], rounds)``."""
    return minplus_fixpoint(tab, bcol, labels_init, from_tab=True)


def pagerank_blocked(tab, bcol, deg, *, n: int, damping: float, tol: float,
                     max_iters: int):
    """Damped power iteration over the int8 tiles to the L1 tolerance
    ``max(tol, 5e-7)`` (what float32 deltas resolve), at most
    ``max_iters`` steps. On the card one cooperative launch of
    ``pagerank_kernel`` (fixed-order reductions: the same ranks every run)
    and one read; on the CPU :func:`pagerank_blocked_plain`. Returns
    ``(ranks float32 [n_pad], iters, delta)``."""
    if not tab.is_cuda:
        return pagerank_blocked_plain(tab, bcol, deg, n=n, damping=damping,
                                      tol=tol, max_iters=max_iters)
    _check_table(tab, bcol, torch.int8)
    nblocks, bwidth = bcol.shape
    n_pad = nblocks * TILE
    if deg.shape != (n_pad,):
        raise ValueError(f"deg must be [{n_pad}]")
    if not 0 < int(n) <= n_pad:
        raise ValueError(f"n={n} outside (0, {n_pad}]")
    _cuda.check_dtype(torch.int32, deg=deg)
    _cuda.check_cuda(tab.device, deg=deg)
    dev = tab.device
    ranks = torch.empty((2, n_pad), dtype=torch.float32, device=dev)
    # [parity, (delta, mass), item] partial sums, one per work item
    part = torch.empty((2, 2, nblocks * _ITEM_PARTS), dtype=torch.float32,
                       device=dev)
    ctl = torch.zeros(_CTL_LEN, dtype=torch.int64, device=dev)
    status = torch.empty(_STATUS_LEN, dtype=torch.int64, device=dev)
    tol32 = np.float32(max(float(tol), PAGERANK_TOL_FLOOR))
    _cuda.launch(
        "semiring", "bibfs_pagerank", tab.data_ptr(), bcol.data_ptr(),
        deg.data_ptr(), nblocks, bwidth, int(n),
        float(np.float32((1.0 - float(damping)) / int(n))),
        float(np.float32(damping)), float(tol32), int(max_iters),
        ranks.data_ptr(), part.data_ptr(), ctl.data_ptr(), status.data_ptr(),
    )
    _cuda.count_launch(pagerank_blocked)
    iters, bits = _status("pagerank_kernel", status)
    delta = float(np.array([bits & 0xFFFFFFFF], dtype=np.uint32)
                  .view(np.float32)[0])
    return ranks[iters & 1], iters, delta


pagerank_blocked.launches = 0


def triangles_chunk_blocked(tab, bcol, c0: int, out=None):
    """One column chunk's ordered-pair triangle total, ``sum((A @ P) * P)``
    over the chunk ``c0 .. c0 + 255`` (:func:`triangle_plane`), added into
    ``out`` (int64 ``[1]``, zeroed here when None) and returned; the caller
    sums the chunks and divides by 6. On the card one launch of
    ``tricount_kernel`` (exact integer arithmetic: for each edge ``(x, u)``
    with ``x`` in the chunk, the common neighbours of ``x`` and ``u`` by
    byte-AND popcounts of their tile rows over the block columns both rows
    hold; ``bcol`` rows ascending with sentinels last, as
    :func:`~bibfs_tpu_torch.graph.blocked.build_blocked` lays them, and
    ``bwidth`` at most :data:`TRI_MAX_WIDTH`); on the CPU
    :func:`triangles_chunk_blocked_plain`."""
    if int(c0) % TILE:
        raise ValueError(f"c0={c0} is not a multiple of {TILE}")
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
        _cuda.launch("semiring", "bibfs_tricount", tab.data_ptr(),
                     bcol.data_ptr(), nblocks, bwidth, int(c0), rows,
                     out.data_ptr())
        _cuda.count_launch(triangles_chunk_blocked)
    return out


triangles_chunk_blocked.launches = 0
