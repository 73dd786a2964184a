"""Pull expansion of one level over the slot-major table: kernels 3 and 4
of the dense search (modes ``pallas`` and ``pallas_alt``).

- :func:`pull_dual` (CUDA ``pull_dual_kernel``, csrc/pull_expand.cu)
  replaces ``bibfs_tpu/ops/pallas_expand.py::_pull_kernel_dual``: both
  sides' next frontier and parent in one pass over the table.
- :func:`pull_single` (CUDA ``pull_kernel``) replaces ``_pull_kernel``:
  the single-side form.

The table is the TPU kernels' slot-major table without their padding:
``nbr_t int32[width, n_rows]``, dead slots holding the sentinel id
``n_rows`` (:func:`sentinel_transposed_table`). The kernels bound row
``v`` by ``min(deg[v], width)``, so they never read a dead slot; on a
tiered base table a hub row's degree exceeds the width and the whole row
is live. The frontier comes in as bitmaps (:mod:`.bitmap`) and the
kernels write the next one in the same form beside ``nf`` and the
parent, so a search hands it from round to round without repacking
(:func:`pull_round`, :func:`pull_round_dual`). The dist update, the hub
tiers and the max degree stay outside the kernels, as plain torch.

Each row is claimed as in kernels 1 and 2 (``level_common.cuh``): the
row's slots in chunks of :data:`CHUNK` independent loads, the lowest hit
slot per wanted side giving the parent, a warp per tile of 32 rows. The
single-side kernel reads one bitmap, the dual kernel the pair row of
both sides (:func:`pack_front`), so one load per slot answers both.

:func:`pull_dual_batch` and :func:`pull_single_batch` (CUDA
``pull_dual_batch_kernel`` and ``pull_batch_kernel``) are the two kernels
with a query axis, as ``pallas_call``'s batching rule gives them one under
the reference's vmapped search: B queries over the one table, each with
its own frontier row, visited rows and outputs, and a per-query
``active`` mask (kernel 4 also a per-query ``side``). An active query's
rows are the single-query kernel's; an inactive query's are not written
and keep the wrapper's fill, no discovery (``nf`` 0, parent -1, next
frontier empty).

The functional forms :func:`run_pull`, :func:`run_pull_dual`,
:func:`pallas_pull_level` and :func:`pallas_pull_level_dual` keep the
JAX contract (``bool`` frontier rows) and pack around the kernels.

A wrapper launches its CUDA kernel for CUDA tensors (or raises) and runs
its plain torch twin (``*_plain``) for CPU tensors. The parent output is
the first-hit-slot neighbour where the new-frontier output is set and -1
everywhere else. Each wrapper counts its kernel launches in
``.launches``.
"""

from __future__ import annotations

import torch

from bibfs_tpu_torch.ops import _cuda
from bibfs_tpu_torch.ops.bitmap import (
    frontier_words,
    pack_bits,
    pack_pair_rows,
    pack_pairs,
    pack_rows,
    set_bits,
    unpack_bits,
    unpack_pairs,
)
from bibfs_tpu_torch.ops.expand import (
    apply_tiers,
    apply_tiers_dual,
    max_new_degree,
    pack_dual,
)

CHUNK = 8  # table slots per chunk of independent loads (kChunk in the kernels)


def sentinel_transposed_table(nbr, deg):
    """The table of all four kernels: the ``[n_rows, width]`` ELL table
    with its dead slots masked to the sentinel id ``n_rows`` (whose
    frontier value reads 0), transposed to slot-major ``int32[width,
    n_rows]``. The CUDA kernels take any row count and width, so nothing is
    padded."""
    n_rows, width = nbr.shape
    mask = torch.arange(width, device=nbr.device)[None, :] < deg[:, None]
    return torch.where(mask, nbr.to(torch.int32), n_rows).T.contiguous()


def prepare_pallas_tables(nbr, deg) -> tuple:
    """The pull kernels' table as a one-element tuple ``(nbr_t,)``
    (:func:`sentinel_transposed_table`)."""
    return (sentinel_transposed_table(nbr, deg),)


def live_slots(nbr_t) -> torch.Tensor:
    """Each row's live slots, ``int32[n_rows]``: the slots below the
    sentinel, which is ``min(deg, width)`` for the row's degree."""
    return (nbr_t < nbr_t.shape[1]).sum(dim=0, dtype=torch.int32)


def gather_bits(front, nbr_t, n_rows: int):
    """Plain lookup ``front[nbr_t[:, :n_rows]]`` as uint8 ``[width, n_rows]``;
    a sentinel id (``>= len(front)``) reads 0."""
    ext = torch.cat([front.to(torch.uint8), front.new_zeros(1, dtype=torch.uint8)])
    idx = nbr_t[:, :n_rows].long().clamp(0, front.shape[0])
    return ext[idx]


def claim_plain(hit, rows, unvisited):
    """Plain first-hit-slot claim: ``hit bool[width, n]`` over the table rows
    ``rows int32[width, n]``. Returns ``(nf bool[n], parent int32[n])`` with
    parent -1 where ``nf`` is unset."""
    wp = hit.shape[0]
    slots = torch.arange(wp, device=hit.device)[:, None]
    j = torch.where(hit, slots, wp).min(dim=0).values
    nf = (j < wp) & unvisited
    parent = rows.gather(0, j.clamp(max=wp - 1)[None, :])[0]
    return nf, torch.where(nf, parent, -1)


def _check_table(nbr_t):
    if nbr_t.dtype != torch.int32 or nbr_t.dim() != 2:
        raise ValueError("nbr_t must be a 2-D int32 table")


def _live_vals(front, nbr_t, deg, n_rows: int):
    """Plain lookup of a uint8 frontier row over each row's first
    ``min(deg, width)`` slots (0 past them), as the kernels bound a row."""
    width = nbr_t.shape[0]
    live = torch.arange(width, device=nbr_t.device)[:, None] < deg[None, :n_rows]
    return torch.where(live, gather_bits(front, nbr_t, n_rows), 0)


def pull_single_plain(nbr_t, deg, bits, visited):
    """Plain twin of :func:`pull_single`."""
    n_rows = visited.shape[0]
    front = unpack_bits(bits, bits.shape[0] * 32)
    hit = _live_vals(front, nbr_t, deg, n_rows) > 0
    nf, pc = claim_plain(hit, nbr_t[:, :n_rows], ~visited)
    return nf, pc, pack_bits(nf, frontier_words(n_rows))


def check_pull(nbr_t, deg, n_rows: int) -> None:
    """Validate the table and degree row of a pull launch over ``n_rows``
    rows on the card (shapes, dtypes, one device, contiguous). A search
    checks them once and then launches with ``checked=True``: its visited
    rows and frontiers are its own, made on the device in the right form."""
    _check_table(nbr_t)
    if n_rows > nbr_t.shape[1] or deg.shape[0] < n_rows:
        raise ValueError("visited rows must fit the table and deg")
    _cuda.check_dtype(torch.int32, deg=deg)
    _cuda.check_cuda(nbr_t.device, nbr_t=nbr_t, deg=deg)


def _check_launch(nbr_t, deg, front, words: int, **rows) -> None:
    """Validate one launch's inputs (a caller that did not check them)."""
    n_rows = next(iter(rows.values())).shape[0]
    check_pull(nbr_t, deg, n_rows)
    if any(r.shape[0] != n_rows for r in rows.values()):
        raise ValueError("visited rows must match")
    if front.dim() != 1 or front.shape[0] < words:
        raise ValueError("the frontier must cover the table's ids")
    _cuda.check_dtype(torch.int32, front=front)
    _cuda.check_cuda(nbr_t.device, front=front, **rows)


def _launch_single(nbr_t, deg, bits, visited, checked: bool):
    n_rows = visited.shape[0]
    if not checked:
        visited = visited.to(torch.bool).contiguous()
        _check_launch(nbr_t, deg, bits, frontier_words(nbr_t.shape[1]),
                      visited=visited)
    dev = nbr_t.device
    nf = torch.empty(n_rows, dtype=torch.bool, device=dev)
    pc = torch.empty(n_rows, dtype=torch.int32, device=dev)
    out = torch.empty(frontier_words(n_rows), dtype=torch.int32, device=dev)
    _cuda.launch(
        "pull_expand", "bibfs_pull", nbr_t.data_ptr(), nbr_t.stride(0),
        nbr_t.shape[0], n_rows, deg.data_ptr(), bits.data_ptr(),
        bits.shape[0], visited.data_ptr(), nf.data_ptr(), pc.data_ptr(),
        out.data_ptr(), out.shape[0],
    )
    return nf, pc, out


def pull_single(nbr_t, deg, bits, visited, *, checked: bool = False):
    """One side's ``(next_frontier bool[n_rows], parent int32[n_rows],
    next_bits int32[frontier_words(n_rows)])`` for ``n_rows =
    len(visited)`` table rows, from the frontier bitmap ``bits`` over the
    table's ids. ``checked`` skips the validation (:func:`check_pull`)."""
    if not nbr_t.is_cuda:
        return pull_single_plain(nbr_t, deg, bits, visited)
    out = _launch_single(nbr_t, deg, bits, visited, checked)
    _cuda.count_launch(pull_single)
    return out


pull_single.launches = 0


def pack_front(fr_s, fr_t, n_ids: int):
    """Both sides' ``bool`` frontiers as the dual kernel's pair row over
    ``n_ids`` vertices."""
    return pack_pairs(fr_s, fr_t, 2 * frontier_words(n_ids))


def pull_dual_plain(nbr_t, deg, pair, vis_s, vis_t):
    """Plain twin of :func:`pull_dual`."""
    n_rows = vis_s.shape[0]
    fr_s, fr_t = unpack_pairs(pair, pair.shape[0] * 16)
    vals = _live_vals(fr_s.to(torch.uint8) | (fr_t.to(torch.uint8) << 1),
                      nbr_t, deg, n_rows)
    rows = nbr_t[:, :n_rows]
    nf_s, pc_s = claim_plain((vals & 1) > 0, rows, ~vis_s)
    nf_t, pc_t = claim_plain((vals & 2) > 0, rows, ~vis_t)
    return nf_s, pc_s, nf_t, pc_t, pack_front(nf_s, nf_t, n_rows)


def _launch_dual(nbr_t, deg, pair, vis_s, vis_t, checked: bool):
    n_rows = vis_s.shape[0]
    if not checked:
        vis_s = vis_s.to(torch.bool).contiguous()
        vis_t = vis_t.to(torch.bool).contiguous()
        _check_launch(nbr_t, deg, pair, 2 * frontier_words(nbr_t.shape[1]),
                      vis_s=vis_s, vis_t=vis_t)
    dev = nbr_t.device
    nf_s = torch.empty(n_rows, dtype=torch.bool, device=dev)
    nf_t = torch.empty(n_rows, dtype=torch.bool, device=dev)
    pc_s = torch.empty(n_rows, dtype=torch.int32, device=dev)
    pc_t = torch.empty(n_rows, dtype=torch.int32, device=dev)
    tiles = frontier_words(n_rows)
    out = torch.empty(2 * tiles, dtype=torch.int32, device=dev)
    _cuda.launch(
        "pull_expand", "bibfs_pull_dual", nbr_t.data_ptr(), nbr_t.stride(0),
        nbr_t.shape[0], n_rows, deg.data_ptr(), pair.data_ptr(),
        pair.shape[0], vis_s.data_ptr(), vis_t.data_ptr(), nf_s.data_ptr(),
        pc_s.data_ptr(), nf_t.data_ptr(), pc_t.data_ptr(), out.data_ptr(),
        tiles,
    )
    return nf_s, pc_s, nf_t, pc_t, out


def pull_dual(nbr_t, deg, pair, vis_s, vis_t, *, checked: bool = False):
    """Both sides' ``(nf_s, pc_s, nf_t, pc_t, next_pair)`` from the pair
    row of both frontiers (:func:`pack_front`, over the table's ids); the
    next frontier comes back as the pair row over the ``len(vis_s)``
    rows. ``checked`` skips the validation (:func:`check_pull`)."""
    if not nbr_t.is_cuda:
        return pull_dual_plain(nbr_t, deg, pair, vis_s, vis_t)
    out = _launch_dual(nbr_t, deg, pair, vis_s, vis_t, checked)
    _cuda.count_launch(pull_dual)
    return out


pull_dual.launches = 0


def _no_discovery(b: int, n_rows: int, words: int, device):
    """Batched outputs before a launch: ``nf`` 0, parent -1, next
    frontier empty, which an inactive query's rows keep."""
    return (torch.zeros(b, n_rows, dtype=torch.bool, device=device),
            torch.full((b, n_rows), -1, dtype=torch.int32, device=device),
            torch.zeros(b, words, dtype=torch.int32, device=device))


def _active_queries(active) -> list[int]:
    return torch.nonzero(active).flatten().tolist()


def pull_single_batch_plain(nbr_t, deg, bits_s, bits_t, vis_s, vis_t, active,
                            side):
    """Plain twin of :func:`pull_single_batch`: :func:`pull_single_plain`
    of each active query's chosen side."""
    b, n_rows = vis_s.shape
    nf, pc, out = _no_discovery(b, n_rows, frontier_words(n_rows),
                                nbr_t.device)
    for q in _active_queries(active):
        t = bool(side[q])
        nf[q], pc[q], out[q] = pull_single_plain(
            nbr_t, deg, (bits_t if t else bits_s)[q], (vis_t if t else vis_s)[q])
    return nf, pc, out


def pull_dual_batch_plain(nbr_t, deg, pair, vis_s, vis_t, active):
    """Plain twin of :func:`pull_dual_batch`: :func:`pull_dual_plain` of
    each active query."""
    b, n_rows = vis_s.shape
    nf_s, pc_s, out = _no_discovery(b, n_rows, 2 * frontier_words(n_rows),
                                    nbr_t.device)
    nf_t, pc_t, _ = _no_discovery(b, n_rows, 0, nbr_t.device)
    for q in _active_queries(active):
        nf_s[q], pc_s[q], nf_t[q], pc_t[q], out[q] = pull_dual_plain(
            nbr_t, deg, pair[q], vis_s[q], vis_t[q])
    return nf_s, pc_s, nf_t, pc_t, out


def _check_batch(nbr_t, deg, words: int, active, fronts, rows) -> None:
    """Validate one batched launch's inputs: ``fronts`` the frontier rows
    (``[B, >= words]`` int32, one stride), ``rows`` the ``[B, n_rows]``
    visited rows."""
    b, n_rows = next(iter(rows.values())).shape
    check_pull(nbr_t, deg, n_rows)
    if any(r.shape != (b, n_rows) for r in rows.values()):
        raise ValueError("visited rows must match")
    if active.shape != (b,):
        raise ValueError("active must hold one flag per query")
    f0 = next(iter(fronts.values()))
    if any(f.dim() != 2 or f.shape != f0.shape or f.shape[0] != b
           or f.shape[1] < words for f in fronts.values()):
        raise ValueError("the frontier rows must cover the table's ids")
    _cuda.check_dtype(torch.int32, **fronts)
    _cuda.check_cuda(nbr_t.device, active=active, **fronts, **rows)


def _want(active, side=None):
    """One byte per query: 0 inactive, else the sides it expands (1
    source, 2 target; kernel 3 reads any non-zero byte as both)."""
    want = active.to(torch.uint8)
    if side is not None:
        want = want * (1 + side.to(torch.uint8))
    return want.contiguous()


def pull_single_batch(nbr_t, deg, bits_s, bits_t, vis_s, vis_t, active, side,
                      *, checked: bool = False):
    """Kernel 4 with a query axis: ``(nf bool[B, n_rows], parent int32[B,
    n_rows], next_bits int32[B, frontier_words(n_rows)])``, row ``q`` the
    expansion of query ``q``'s side ``side[q]`` (False: source, from
    ``bits_s[q]`` and ``vis_s[q]``; True: target) where ``active[q]``.
    ``bits_*`` are ``[B, words]`` bitmap rows over the table's ids,
    ``vis_*`` ``[B, n_rows]``. ``checked`` skips the validation."""
    if not nbr_t.is_cuda:
        return pull_single_batch_plain(nbr_t, deg, bits_s, bits_t, vis_s,
                                       vis_t, active, side)
    b, n_rows = vis_s.shape
    if not checked:
        vis_s = vis_s.to(torch.bool).contiguous()
        vis_t = vis_t.to(torch.bool).contiguous()
        _check_batch(nbr_t, deg, frontier_words(nbr_t.shape[1]), active,
                     dict(bits_s=bits_s, bits_t=bits_t),
                     dict(vis_s=vis_s, vis_t=vis_t))
        if side.shape != (b,):
            raise ValueError("side must hold one flag per query")
    nf, pc, out = _no_discovery(b, n_rows, frontier_words(n_rows),
                                nbr_t.device)
    want = _want(active, side)
    _cuda.launch(
        "pull_expand", "bibfs_pull_batch", nbr_t.data_ptr(), nbr_t.stride(0),
        nbr_t.shape[0], n_rows, deg.data_ptr(), bits_s.data_ptr(),
        bits_t.data_ptr(), bits_s.shape[1], vis_s.data_ptr(),
        vis_t.data_ptr(), want.data_ptr(), b, nf.data_ptr(),
        pc.data_ptr(), out.data_ptr(), out.shape[1],
    )
    _cuda.count_launch(pull_single_batch)
    return nf, pc, out


pull_single_batch.launches = 0


def pull_dual_batch(nbr_t, deg, pair, vis_s, vis_t, active, *,
                    checked: bool = False):
    """Kernel 3 with a query axis: ``(nf_s, pc_s, nf_t, pc_t, next_pair)``,
    ``[B, n_rows]`` each and ``next_pair`` ``[B, 2 frontier_words(n_rows)]``,
    row ``q`` both sides of query ``q`` where ``active[q]``, from its pair
    row ``pair[q]`` (over the table's ids) and visited rows.
    ``checked`` skips the validation."""
    if not nbr_t.is_cuda:
        return pull_dual_batch_plain(nbr_t, deg, pair, vis_s, vis_t, active)
    b, n_rows = vis_s.shape
    if not checked:
        vis_s = vis_s.to(torch.bool).contiguous()
        vis_t = vis_t.to(torch.bool).contiguous()
        _check_batch(nbr_t, deg, 2 * frontier_words(nbr_t.shape[1]), active,
                     dict(pair=pair), dict(vis_s=vis_s, vis_t=vis_t))
    tiles = frontier_words(n_rows)
    nf_s, pc_s, out = _no_discovery(b, n_rows, 2 * tiles, nbr_t.device)
    nf_t, pc_t, _ = _no_discovery(b, n_rows, 0, nbr_t.device)
    want = _want(active)
    _cuda.launch(
        "pull_expand", "bibfs_pull_dual_batch", nbr_t.data_ptr(),
        nbr_t.stride(0), nbr_t.shape[0], n_rows, deg.data_ptr(),
        pair.data_ptr(), pair.shape[1], vis_s.data_ptr(), vis_t.data_ptr(),
        want.data_ptr(), b, nf_s.data_ptr(), pc_s.data_ptr(),
        nf_t.data_ptr(), pc_t.data_ptr(), out.data_ptr(), tiles,
    )
    _cuda.count_launch(pull_dual_batch)
    return nf_s, pc_s, nf_t, pc_t, out


pull_dual_batch.launches = 0


def run_pull(tables: tuple, frontier, visited):
    """Single-side raw kernel pass: ``(next_frontier, parent_candidate)``
    over the table's rows ``[0, len(visited))`` from a ``bool`` frontier
    row (packed here). Each row is bounded by its live slots
    (:func:`live_slots`), which is ``min(deg, width)``."""
    (nbr_t,) = tables
    bits = pack_bits(frontier, frontier_words(frontier.shape[0]))
    nf, pc, _ = pull_single(nbr_t, live_slots(nbr_t), bits, visited)
    return nf, pc


def run_pull_dual(tables: tuple, fr_s, fr_t, vis_s, vis_t):
    """Both sides' raw kernel pass: ``(nf_s, pc_s, nf_t, pc_t)`` from two
    ``bool`` frontier rows (packed here into the pair row)."""
    (nbr_t,) = tables
    nf_s, pc_s, nf_t, pc_t, _ = pull_dual(
        nbr_t, live_slots(nbr_t), pack_front(fr_s, fr_t, fr_s.shape[0]),
        vis_s, vis_t)
    return nf_s, pc_s, nf_t, pc_t


def pull_round(frontier, bits, par, dist, nbr_t, deg, tiers, lvl_next, *,
               inf: int, checked: bool = False):
    """One side's pull level through the single kernel, with the frontier
    in two forms: ``frontier`` (``bool``, for the hub tiers) and ``bits``
    (the kernel's input). Returns ``(next_frontier, next_bits, par, dist,
    max_deg_of_new_frontier)``: the kernel's next bitmap, or on a tiered
    graph the bitmap rebuilt after the tier pass set hub rows."""
    n_pad = par.shape[0]
    visited = dist < inf
    nf, pcand, nbits = pull_single(nbr_t, deg, bits, visited, checked=checked)
    par = torch.where(nf, pcand, par)
    if tiers:
        nf, par = apply_tiers(nf, par, frontier, visited, deg, tiers, n_pad)
        nbits = pack_bits(nf, nbits.shape[0])
    dist = torch.where(nf & ~visited, lvl_next, dist)
    return nf, nbits, par, dist, max_new_degree(nf, deg)


def pull_round_dual(fr_s, fr_t, front, par_s, dist_s, par_t, dist_t, nbr_t,
                    deg, tiers, lvl_s, lvl_t, *, inf: int,
                    checked: bool = False):
    """Both sides of a lock-step round through the dual kernel, the
    frontier both as ``bool`` rows and in the kernel's layout. Returns
    ``(nf_s, par_s, dist_s, md_s, nf_t, par_t, dist_t, md_t, next_front)``,
    rebuilding ``next_front`` after the tier pass on a tiered graph."""
    n_pad = par_s.shape[0]
    vis_s = dist_s < inf
    vis_t = dist_t < inf
    nf_s, pc_s, nf_t, pc_t, nfront = pull_dual(nbr_t, deg, front, vis_s,
                                               vis_t, checked=checked)
    par_s = torch.where(nf_s, pc_s, par_s)
    par_t = torch.where(nf_t, pc_t, par_t)
    if tiers:
        nf_s, par_s, nf_t, par_t = apply_tiers_dual(
            nf_s, par_s, nf_t, par_t, pack_dual(fr_s, fr_t),
            vis_s, vis_t, deg, tiers, n_pad,
        )
        nfront = pack_front(nf_s, nf_t, n_pad)
    dist_s = torch.where(nf_s & ~vis_s, lvl_s, dist_s)
    dist_t = torch.where(nf_t & ~vis_t, lvl_t, dist_t)
    return (nf_s, par_s, dist_s, max_new_degree(nf_s, deg),
            nf_t, par_t, dist_t, max_new_degree(nf_t, deg), nfront)


def pallas_pull_level_dual(
    fr_s, fr_t, par_s, dist_s, par_t, dist_t, tables, deg, tiers, lvl_s,
    lvl_t, *, inf: int,
):
    """Both sides of a lock-step round through the dual kernel, with the
    return contract of ``expand_pull_dual_tiered``: ``(nf_s, par_s, dist_s,
    md_s, nf_t, par_t, dist_t, md_t)``. Hub tiers run as torch ops around
    the kernel through the same ``apply_tiers_dual``."""
    return pull_round_dual(
        fr_s, fr_t, pack_front(fr_s, fr_t, fr_s.shape[0]), par_s, dist_s,
        par_t, dist_t, tables[0], deg, tiers, lvl_s, lvl_t, inf=inf)[:8]


def pallas_pull_level(frontier, par, dist, tables, deg, tiers, lvl_next, *, inf: int):
    """One side's pull level through the single kernel, with the return
    contract of ``expand_pull_tiered``: ``(next_frontier, par, dist,
    max_deg_of_new_frontier)``."""
    bits = pack_bits(frontier, frontier_words(frontier.shape[0]))
    nf, _, par, dist, md = pull_round(frontier, bits, par, dist, tables[0],
                                      deg, tiers, lvl_next, inf=inf)
    return nf, par, dist, md


def new_pull_frontiers(src: int, dst: int, n_rows: int, device, *,
                       dual: bool) -> dict:
    """The search's first frontiers in the pull kernels' forms, each side
    holding one vertex: ``front`` (the dual kernel's pair row) when
    ``dual``, else ``bits_s`` and ``bits_t`` (a bitmap per side, for the
    single kernel)."""
    words = frontier_words(n_rows)
    if dual:  # the pair row is the bitmap of (source, target) interleaved
        front = torch.zeros(2 * words, dtype=torch.int32, device=device)
        set_bits(front, [2 * src, 2 * dst + 1])
        return dict(front=front)
    bits = torch.zeros(2, words, dtype=torch.int32, device=device)
    set_bits(bits[0], [src])
    set_bits(bits[1], [dst])
    return dict(bits_s=bits[0], bits_t=bits[1])
