"""Pull expansion of one level over the slot-major table: kernels 3 and 4
of the dense search (modes ``pallas`` and ``pallas_alt``).

- :func:`pull_dual` (CUDA ``pull_dual_kernel``, csrc/pull_expand.cu)
  replaces ``bibfs_tpu/ops/pallas_expand.py::_pull_kernel_dual``: both
  sides' next frontier and parent in one pass over the table.
- :func:`pull_single` (CUDA ``pull_kernel``) replaces ``_pull_kernel``:
  the single-side form.

The table is the TPU kernels' slot-major table without their padding:
``nbr_t int32[width, n_rows]``, dead slots holding the sentinel id, the
id space (:func:`sentinel_transposed_table`). On one device the id space
is ``n_rows``; a shard of the vertex-sharded search
(:mod:`bibfs_tpu_torch.solvers.sharded`) holds its own rows, whose slots
are global ids, and passes ``id_space`` (the global row count, the
frontier's length): the reference's ``id_space``. Parents are table
entries, so they are global ids as they are. The kernels bound row
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
the reference's vmapped search: B queries over the one table, their
frontiers one query-packed plane ``int32[n_rows, plane_words(B)]`` (bits
``2 (q & 15)`` and ``2 (q & 15) + 1`` of word ``q >> 4`` hold query
``q``'s source and target side, the order of
:func:`bibfs_tpu_torch.ops.minor_level.pack_sides`; :func:`pack_plane`,
:func:`seed_plane`). A launch expands the listed queries ``qids``
(kernel 4 one side of each, ``side``), takes their ``[A, n_rows]``
visited rows and returns their ``[A, n_rows]`` outputs, each the
single-query kernel's, and the next plane: the expanded bits replaced by
the new frontier, every other bit copied (:func:`plane_set` rebuilds
listed columns, as a tiered round needs after its tier pass). ``qids``
and ``side`` are host tensors: the grid covers only the plane words that
hold a listed query, and :func:`launch_meta` lists them on the host.

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

import numpy as np
import torch
import torch.nn.functional as F

from bibfs_tpu_torch.ops import _cuda
from bibfs_tpu_torch.ops.bitmap import (
    frontier_words,
    pack_bits,
    pack_pairs,
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
from bibfs_tpu_torch.ops.expand_batch import LOCKSTEP_BUDGET_BYTES
from bibfs_tpu_torch.ops.minor_level import pack_sides

CHUNK = 8  # table slots per chunk of independent loads (kChunk in the kernels)


def sentinel_transposed_table(nbr, deg, id_space: int | None = None):
    """The table of all four kernels: the ``[n_rows, width]`` ELL table
    with its dead slots masked to the sentinel id ``id_space`` (default
    ``n_rows``; whose frontier value reads 0), transposed to slot-major
    ``int32[width, n_rows]``. The CUDA kernels take any row count and
    width, so nothing is padded."""
    n_rows, width = nbr.shape
    mask = torch.arange(width, device=nbr.device)[None, :] < deg[:, None]
    sent = n_rows if id_space is None else id_space
    return torch.where(mask, nbr.to(torch.int32), sent).T.contiguous()


def prepare_pallas_tables(nbr, deg, id_space: int | None = None) -> tuple:
    """The pull kernels' table as a one-element tuple ``(nbr_t,)``
    (:func:`sentinel_transposed_table`)."""
    return (sentinel_transposed_table(nbr, deg, id_space),)


def live_slots(nbr_t, id_space: int | None = None) -> torch.Tensor:
    """Each row's live slots, ``int32[n_rows]``: the slots below the
    sentinel ``id_space`` (default the row count), which is ``min(deg,
    width)`` for the row's degree."""
    sent = nbr_t.shape[1] if id_space is None else id_space
    return (nbr_t < sent).sum(dim=0, dtype=torch.int32)


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


def _id_space(nbr_t, id_space):
    return nbr_t.shape[1] if id_space is None else int(id_space)


def pull_single_plain(nbr_t, deg, bits, visited, *, id_space=None):
    """Plain twin of :func:`pull_single`."""
    n_rows = visited.shape[0]
    front = unpack_bits(bits, _id_space(nbr_t, id_space))
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
    """Validate one launch's inputs (a caller that did not check them):
    the frontier row holds ``words`` words, the id space's."""
    n_rows = next(iter(rows.values())).shape[0]
    check_pull(nbr_t, deg, n_rows)
    if any(r.shape[0] != n_rows for r in rows.values()):
        raise ValueError("visited rows must match")
    if front.dim() != 1 or front.shape[0] < words:
        raise ValueError("the frontier must cover the table's ids")
    _cuda.check_dtype(torch.int32, front=front)
    _cuda.check_cuda(nbr_t.device, front=front, **rows)


def _launch_single(nbr_t, deg, bits, visited, id_space: int, checked: bool):
    n_rows = visited.shape[0]
    if not checked:
        visited = visited.to(torch.bool).contiguous()
        _check_launch(nbr_t, deg, bits, frontier_words(id_space),
                      visited=visited)
    dev = nbr_t.device
    nf = torch.empty(n_rows, dtype=torch.bool, device=dev)
    pc = torch.empty(n_rows, dtype=torch.int32, device=dev)
    out = torch.empty(frontier_words(n_rows), dtype=torch.int32, device=dev)
    _cuda.launch(
        "pull_expand", "bibfs_pull", nbr_t.data_ptr(), nbr_t.stride(0),
        nbr_t.shape[0], n_rows, id_space, deg.data_ptr(), bits.data_ptr(),
        visited.data_ptr(), nf.data_ptr(), pc.data_ptr(), out.data_ptr(),
        out.shape[0],
    )
    return nf, pc, out


def pull_single(nbr_t, deg, bits, visited, *, id_space: int | None = None,
                checked: bool = False):
    """One side's ``(next_frontier bool[n_rows], parent int32[n_rows],
    next_bits int32[frontier_words(n_rows)])`` for ``n_rows =
    len(visited)`` table rows, from the frontier bitmap ``bits`` over the
    id space (``id_space`` vertices, default the table's rows).
    ``checked`` skips the validation (:func:`check_pull`)."""
    if not nbr_t.is_cuda:
        return pull_single_plain(nbr_t, deg, bits, visited, id_space=id_space)
    out = _launch_single(nbr_t, deg, bits, visited,
                         _id_space(nbr_t, id_space), checked)
    _cuda.count_launch(pull_single)
    return out


pull_single.launches = 0


def pack_front(fr_s, fr_t, n_ids: int):
    """Both sides' ``bool`` frontiers as the dual kernel's pair row over
    ``n_ids`` vertices."""
    return pack_pairs(fr_s, fr_t, 2 * frontier_words(n_ids))


def pull_dual_plain(nbr_t, deg, pair, vis_s, vis_t, *, id_space=None):
    """Plain twin of :func:`pull_dual`."""
    n_rows = vis_s.shape[0]
    fr_s, fr_t = unpack_pairs(pair, _id_space(nbr_t, id_space))
    vals = _live_vals(fr_s.to(torch.uint8) | (fr_t.to(torch.uint8) << 1),
                      nbr_t, deg, n_rows)
    rows = nbr_t[:, :n_rows]
    nf_s, pc_s = claim_plain((vals & 1) > 0, rows, ~vis_s)
    nf_t, pc_t = claim_plain((vals & 2) > 0, rows, ~vis_t)
    return nf_s, pc_s, nf_t, pc_t, pack_front(nf_s, nf_t, n_rows)


def _launch_dual(nbr_t, deg, pair, vis_s, vis_t, id_space: int,
                 checked: bool):
    n_rows = vis_s.shape[0]
    if not checked:
        vis_s = vis_s.to(torch.bool).contiguous()
        vis_t = vis_t.to(torch.bool).contiguous()
        _check_launch(nbr_t, deg, pair, 2 * frontier_words(id_space),
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
        nbr_t.shape[0], n_rows, id_space, deg.data_ptr(), pair.data_ptr(),
        vis_s.data_ptr(), vis_t.data_ptr(), nf_s.data_ptr(), pc_s.data_ptr(),
        nf_t.data_ptr(), pc_t.data_ptr(), out.data_ptr(), tiles,
    )
    return nf_s, pc_s, nf_t, pc_t, out


def pull_dual(nbr_t, deg, pair, vis_s, vis_t, *, id_space: int | None = None,
              checked: bool = False):
    """Both sides' ``(nf_s, pc_s, nf_t, pc_t, next_pair)`` from the pair
    row of both frontiers (:func:`pack_front`, over the id space of
    ``id_space`` vertices, default the table's rows); the next frontier
    comes back as the pair row over the ``len(vis_s)`` rows. ``checked``
    skips the validation (:func:`check_pull`)."""
    if not nbr_t.is_cuda:
        return pull_dual_plain(nbr_t, deg, pair, vis_s, vis_t,
                               id_space=id_space)
    out = _launch_dual(nbr_t, deg, pair, vis_s, vis_t,
                       _id_space(nbr_t, id_space), checked)
    _cuda.count_launch(pull_dual)
    return out


pull_dual.launches = 0


def plane_words(b: int) -> int:
    """Words per row of the query-packed plane of ``b`` queries (16 a
    word, both sides)."""
    return -(-b // 16)


def pack_plane(fr_s, fr_t):
    """Both sides' ``bool[B, n]`` frontier rows as the query-packed plane
    ``int32[n, plane_words(B)]``, the spare bits of the last word zero."""
    b, n = fr_s.shape
    pad = 16 * plane_words(b) - b
    return pack_sides(F.pad(fr_s.T, (0, pad)), F.pad(fr_t.T, (0, pad)))


def _bit_values(qids, side: int):
    """Each listed query's word and its side's bit in it as an int32 value
    (bit 31 as ``-2 ** 31``)."""
    q = qids.long()
    bit = 2 * (q & 15) + side
    val = torch.where(bit == 31, -2**31, torch.ones_like(bit) << bit)
    return q >> 4, val.to(torch.int32)


def seed_plane(srcs, dsts, n_rows: int):
    """The starting plane of queries ``(srcs[q], dsts[q])``: each side's
    bit set at its one vertex, without a pass over ``[B, n_rows]``."""
    b = srcs.shape[0]
    words = plane_words(b)
    plane = torch.zeros(n_rows, words, dtype=torch.int32, device=srcs.device)
    q = torch.arange(b, device=srcs.device)
    for side, ids in enumerate((srcs, dsts)):
        word, val = _bit_values(q, side)
        # distinct bits of one word add up to their OR
        plane.view(-1).scatter_add_(0, ids.long() * words + word, val)
    return plane


def plane_set(plane, qids, rows, side: int):
    """Write ``rows`` (``bool[A, n]``) as the side-``side`` bits of the
    listed queries ``qids`` into ``plane``, in place, every other bit kept.
    Row chunks bound the ``[rows, A]`` int32 temporary to
    :data:`LOCKSTEP_BUDGET_BYTES`."""
    word, val = _bit_values(qids.to(plane.device), side)
    mask = torch.zeros(plane.shape[1], dtype=torch.int32, device=plane.device)
    plane &= ~mask.index_add_(0, word, val)
    step = max(1, LOCKSTEP_BUDGET_BYTES // (4 * max(rows.shape[0], 1)))
    for r0 in range(0, rows.shape[1], step):
        part = rows[:, r0:r0 + step].T.to(torch.int32) * val
        plane[r0:r0 + step].index_add_(1, word, part)
    return plane


def _plane_column(plane, q: int):
    """Query ``q``'s ``bool[n]`` source and target frontier of a plane."""
    col = plane[:, q >> 4] >> 2 * (q & 15)
    return (col & 1) > 0, (col & 2) > 0


def pull_single_batch_plain(nbr_t, deg, plane, vis_s, vis_t, qids, side):
    """Plain twin of :func:`pull_single_batch`: :func:`pull_single_plain`
    of each listed query's side, then :func:`plane_set`."""
    a, n_rows = vis_s.shape
    nf = torch.empty(a, n_rows, dtype=torch.bool, device=nbr_t.device)
    pc = torch.empty(a, n_rows, dtype=torch.int32, device=nbr_t.device)
    for i, (q, t) in enumerate(zip(qids.tolist(), side.tolist())):
        front = _plane_column(plane, q)[int(t)]
        nf[i], pc[i], _ = pull_single_plain(
            nbr_t, deg, pack_bits(front, frontier_words(front.shape[0])),
            (vis_t if t else vis_s)[i])
    nxt = plane.clone()
    for t in (False, True):
        pick = side.to(torch.bool) == t
        plane_set(nxt, qids[pick], nf[pick], int(t))
    return nf, pc, nxt


def pull_dual_batch_plain(nbr_t, deg, plane, vis_s, vis_t, qids):
    """Plain twin of :func:`pull_dual_batch`: :func:`pull_dual_plain` of
    each listed query, then :func:`plane_set` of both sides."""
    a, n_rows = vis_s.shape
    dev = nbr_t.device
    nf_s, nf_t = (torch.empty(a, n_rows, dtype=torch.bool, device=dev)
                  for _ in range(2))
    pc_s, pc_t = (torch.empty(a, n_rows, dtype=torch.int32, device=dev)
                  for _ in range(2))
    for i, q in enumerate(qids.tolist()):
        fr_s, fr_t = _plane_column(plane, q)
        nf_s[i], pc_s[i], nf_t[i], pc_t[i], _ = pull_dual_plain(
            nbr_t, deg, pack_front(fr_s, fr_t, fr_s.shape[0]), vis_s[i],
            vis_t[i])
    nxt = plane_set(plane_set(plane.clone(), qids, nf_s, 0), qids, nf_t, 1)
    return nf_s, pc_s, nf_t, pc_t, nxt


def _check_batch(nbr_t, deg, plane, qids, side, **rows) -> None:
    """Validate one batched launch's inputs: the plane over the table's
    rows, ``qids`` distinct queries of the plane on the host, the ``[A,
    n_rows]`` visited rows and (kernel 4) one ``side`` per listed query."""
    a, n_rows = next(iter(rows.values())).shape
    check_pull(nbr_t, deg, n_rows)
    if any(r.shape != (a, n_rows) for r in rows.values()):
        raise ValueError("visited rows must match")
    if plane.dim() != 2 or plane.shape[0] != n_rows or n_rows != nbr_t.shape[1]:
        raise ValueError("the plane and the visited rows must cover the "
                         "table's rows")
    if qids.device.type != "cpu" or (side is not None and side.device.type != "cpu"):
        raise ValueError("qids and side must lie on the host")
    if qids.shape != (a,) or (side is not None and side.shape != (a,)):
        raise ValueError("qids (and side) must hold one entry per visited row")
    if a and (int(qids.min()) < 0 or int(qids.max()) >= 16 * plane.shape[1]
              or qids.unique().numel() != a):
        raise ValueError("qids must be distinct queries of the plane")
    _cuda.check_dtype(torch.int32, plane=plane)
    _cuda.check_cuda(nbr_t.device, plane=plane, **rows)


def launch_meta(qids, words: int, side=None, *, pin: bool = False):
    """What a batched launch reads besides its rows, made on the host from
    the listed queries ``qids`` (and, for kernel 4, their ``side``), as one
    int32 tensor: the slot map (``16 words`` entries, each listed query's
    row, -1 for the others), the listed plane words (ascending), then the
    sides. Returns it (in pinned memory with ``pin``, for an upload that
    does not wait for the stream) and the number of listed words, the
    grid's width. Made in numpy: torch's CPU ops cost ~0.1 ms a launch."""
    q = np.asarray(qids, dtype=np.int64)
    listed = np.unique(q >> 4)
    size = 16 * words + listed.size + (0 if side is None else q.size)
    meta = torch.empty(size, dtype=torch.int32, pin_memory=pin)
    m = meta.numpy()
    m[:16 * words] = -1
    m[q] = np.arange(q.size)
    m[16 * words:16 * words + listed.size] = listed
    if side is not None:
        m[16 * words + listed.size:] = np.asarray(side)
    return meta, listed.size


def _batch_outputs(a: int, n_rows: int, sides: int, device):
    return [t for _ in range(sides) for t in (
        torch.empty(a, n_rows, dtype=torch.bool, device=device),
        torch.empty(a, n_rows, dtype=torch.int32, device=device))]


def pull_single_batch(nbr_t, deg, plane, vis_s, vis_t, qids, side, *,
                      checked: bool = False):
    """Kernel 4 with a query axis: ``(nf bool[A, n_rows], parent int32[A,
    n_rows], next_plane)``, row ``a`` the expansion of query ``qids[a]``'s
    side ``side[a]`` (False: source, from its plane bits and ``vis_s[a]``;
    True: target, ``vis_t[a]``). ``plane`` is ``int32[n_rows, words]``
    over the table's rows; the next plane has the expanded bits replaced
    by ``nf`` and the rest copied. ``qids`` and ``side`` are host tensors
    (the grid's width, the listed words, is made from them on the host).
    ``checked`` skips the validation."""
    if not nbr_t.is_cuda:
        return pull_single_batch_plain(nbr_t, deg, plane, vis_s, vis_t, qids,
                                       side)
    a, n_rows = vis_s.shape
    if not checked:
        vis_s = vis_s.to(torch.bool).contiguous()
        vis_t = vis_t.to(torch.bool).contiguous()
        _check_batch(nbr_t, deg, plane, qids, side, vis_s=vis_s, vis_t=vis_t)
    nf, pc = _batch_outputs(a, n_rows, 1, nbr_t.device)
    nxt = torch.empty_like(plane)
    meta, n_listed = launch_meta(qids, plane.shape[1], side, pin=True)
    meta = meta.to(nbr_t.device, non_blocking=True)
    _cuda.launch(
        "pull_expand", "bibfs_pull_batch", nbr_t.data_ptr(), nbr_t.stride(0),
        nbr_t.shape[0], n_rows, deg.data_ptr(), plane.data_ptr(),
        nxt.data_ptr(), plane.shape[1], meta.data_ptr(), n_listed,
        vis_s.data_ptr(), vis_t.data_ptr(), nf.data_ptr(), pc.data_ptr(),
    )
    _cuda.count_launch(pull_single_batch)
    return nf, pc, nxt


pull_single_batch.launches = 0


def pull_dual_batch(nbr_t, deg, plane, vis_s, vis_t, qids, *,
                    checked: bool = False):
    """Kernel 3 with a query axis: ``(nf_s, pc_s, nf_t, pc_t, next_plane)``,
    ``[A, n_rows]`` each, row ``a`` both sides of query ``qids[a]`` from
    its plane bits and visited rows ``vis_s[a]``, ``vis_t[a]``; the next
    plane and ``qids`` as in :func:`pull_single_batch`. ``checked`` skips
    the validation."""
    if not nbr_t.is_cuda:
        return pull_dual_batch_plain(nbr_t, deg, plane, vis_s, vis_t, qids)
    a, n_rows = vis_s.shape
    if not checked:
        vis_s = vis_s.to(torch.bool).contiguous()
        vis_t = vis_t.to(torch.bool).contiguous()
        _check_batch(nbr_t, deg, plane, qids, None, vis_s=vis_s, vis_t=vis_t)
    nf_s, pc_s, nf_t, pc_t = _batch_outputs(a, n_rows, 2, nbr_t.device)
    nxt = torch.empty_like(plane)
    meta, n_listed = launch_meta(qids, plane.shape[1], pin=True)
    meta = meta.to(nbr_t.device, non_blocking=True)
    _cuda.launch(
        "pull_expand", "bibfs_pull_dual_batch", nbr_t.data_ptr(),
        nbr_t.stride(0), nbr_t.shape[0], n_rows, deg.data_ptr(),
        plane.data_ptr(), nxt.data_ptr(), plane.shape[1], meta.data_ptr(),
        n_listed, vis_s.data_ptr(), vis_t.data_ptr(), nf_s.data_ptr(),
        pc_s.data_ptr(), nf_t.data_ptr(), pc_t.data_ptr(),
    )
    _cuda.count_launch(pull_dual_batch)
    return nf_s, pc_s, nf_t, pc_t, nxt


pull_dual_batch.launches = 0


def run_pull(tables: tuple, frontier, visited):
    """Single-side raw kernel pass: ``(next_frontier, parent_candidate)``
    over the table's rows ``[0, len(visited))`` from a ``bool`` frontier
    row over the id space (packed here; its length is the id space). Each
    row is bounded by its live slots (:func:`live_slots`), which is
    ``min(deg, width)``."""
    (nbr_t,) = tables
    ids = frontier.shape[0]
    bits = pack_bits(frontier, frontier_words(ids))
    nf, pc, _ = pull_single(nbr_t, live_slots(nbr_t, ids), bits, visited,
                            id_space=ids)
    return nf, pc


def run_pull_dual(tables: tuple, fr_s, fr_t, vis_s, vis_t):
    """Both sides' raw kernel pass: ``(nf_s, pc_s, nf_t, pc_t)`` from two
    ``bool`` frontier rows over the id space (packed here into the pair
    row)."""
    (nbr_t,) = tables
    ids = fr_s.shape[0]
    nf_s, pc_s, nf_t, pc_t, _ = pull_dual(
        nbr_t, live_slots(nbr_t, ids), pack_front(fr_s, fr_t, ids),
        vis_s, vis_t, id_space=ids)
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
