"""Blocked frontier expansion, one BFS level as masked block products: the
counterpart of ``bibfs_tpu/ops/blocked_expand.py``.

The op is ``reach = A @ F > 0``, with ``A`` the block-sparse tiled
adjacency of :class:`bibfs_tpu_torch.graph.blocked.BlockedGraph` and ``F``
a frontier plane whose columns are both sides of every query of a batch
(source columns ``0..B-1``, target columns ``B..2B-1``), so one sweep of
the table advances every search. Products of 0/1 values are exact
(a count is at most ``bwidth * tile``), and ``> 0`` reads the OR.

- :func:`expand_blocked_plane` is the plain torch twin of the JAX
  package's function of the same name, on its ``[n_pad, C]`` plane:
  a gather of one ``[tile, C]`` frontier sub-plane per (block row, slot),
  then one batched product per chunk of ``rc`` block rows. It computes in
  float32 whatever the plane type (exact below 2^24; the card has no
  integer batched product).
- :func:`blocked_level` is one round of the blocked search on query-major
  planes (``plane [2B, n_pad]``, ``dist int32 [2B, n_pad]``): the
  expansion with the level body's masked stamp
  (``bibfs_tpu/solvers/dense.py:214-216``: ``dist = lvl`` where ``reach &
  dist >= INF32 & live[c mod B]``), and in the same pass the new
  frontier's count and degree sum per plane row and the meet vote of the
  vertices new this round (the ``[B]`` vectors of :func:`round_vectors`).
  It returns the next plane and its occupancy flags
  (:func:`plane_occupancy`). :func:`blocked_fold` then folds the vectors
  into the batch's ``[B]`` state (best, meet, levels, edges, the next live
  mask, one any-live word). A CUDA tensor launches the hand-written
  kernels ``blocked_level_kernel`` and ``blocked_fold_kernel``
  (``csrc/blocked_expand.cu``: both sides of 32 queries per block, slots
  of unoccupied block columns skipped, tiles fed by TMA to int8 ``wgmma``,
  the counts and the vote in the epilogue) or raises; a CPU tensor runs
  :func:`blocked_level_plain` and :func:`blocked_fold_plain`. Launches
  count in ``blocked_level.launches`` and ``blocked_fold.launches``.

The budgets and the fit rule are the JAX package's, so the serving route
takes the same (graph, batch) shapes in both packages.
"""

from __future__ import annotations

import torch

from bibfs_tpu_torch.graph.blocked import TILE
from bibfs_tpu_torch.ops import _cuda

INF32 = 1 << 30

#: working-set budget of one expansion chunk: the gathered frontier block
#: ``[rc, bwidth, tile, C]`` at the plane type plus the ``[rc, tile, C]``
#: accumulator (the JAX package's figure)
BLOCKED_CHUNK_BUDGET_BYTES = 384 * 2**20

#: ceiling on the resident blocked table: past it the block structure is
#: not compact and the ELL routes carry the graph better
BLOCKED_TAB_BUDGET_BYTES = 256 * 2**20


def resolve_plane_dtype(dt=None, device=None) -> torch.dtype:
    """The frontier-plane type: int8 on a CUDA device (the tensor cores'
    input type), float32 on the CPU (its fast matrix product). ``dt``
    (``"int8"``, ``"float32"`` or a torch dtype) forces a choice."""
    if dt is not None:
        return dt if isinstance(dt, torch.dtype) else getattr(torch, str(dt))
    dev = torch.device("cpu" if device is None else device)
    return torch.int8 if dev.type == "cuda" else torch.float32


def chunk_block_rows(bwidth: int, c: int, itemsize: int,
                     tile: int = TILE) -> int:
    """Block rows per expansion chunk under the working-set budget (at
    least 1)."""
    per_row = tile * c * (bwidth * itemsize + 4)
    return max(1, BLOCKED_CHUNK_BUDGET_BYTES // max(per_row, 1))


def blocked_fits(nblocks: int, bwidth: int, b: int,
                 itemsize: int = 4) -> bool:
    """Whether the blocked path takes this (graph, batch) shape: the int8
    table under its budget and the dual-plane state (frontier and dist at
    ``[n_pad, 2B]``) under the chunk budget."""
    tab_bytes = nblocks * bwidth * TILE * TILE  # int8 storage
    if tab_bytes > BLOCKED_TAB_BUDGET_BYTES:
        return False
    plane_bytes = nblocks * TILE * 2 * b * (itemsize + 4)
    return plane_bytes <= BLOCKED_CHUNK_BUDGET_BYTES


def expand_blocked_plane(fr, tab, bcol, *, rc: int):
    """One frontier-plane expansion ``(A @ fr) > 0``: ``fr`` is a 0/1
    ``[n_pad, C]`` plane, ``tab`` int8 ``[nblocks, bwidth, tile, tile]``,
    ``bcol`` int32 ``[nblocks, bwidth]`` with sentinel ``nblocks`` (it reads
    an appended zero tile). Returns bool ``[n_pad, C]``: every vertex with
    a frontier neighbour, discovered or not."""
    nblocks, bwidth = bcol.shape
    tile = tab.shape[2]
    c = fr.shape[1]
    f2 = fr.reshape(nblocks, tile, c).float()
    f2p = torch.cat([f2, f2.new_zeros(1, tile, c)], dim=0)
    outs = []
    for i0 in range(0, nblocks, rc):
        tab_c = tab[i0:i0 + rc].float()  # [r, bwidth, tile, tile]
        # one [tile, C] frontier sub-plane per (block row, slot), contracted
        # over (slot, in-tile column) against the tiles
        fr_c = f2p[bcol[i0:i0 + rc].long()]  # [r, bwidth, tile, C]
        r = tab_c.shape[0]
        a = tab_c.permute(0, 2, 1, 3).reshape(r, tile, bwidth * tile)
        outs.append(torch.bmm(a, fr_c.reshape(r, bwidth * tile, c)))
    return torch.cat(outs, dim=0).reshape(nblocks * tile, c) > 0


#: queries per column group: the kernel's block takes rows ``32g ..
#: 32g + 31`` (source sides) and ``B + 32g .. B + 32g + 31`` (target sides)
GROUP = 32

#: the empty meet-vote key (above every ``(sum << 32) | vertex``)
KEY_EMPTY = (1 << 63) - 1

#: the ``[B]`` / ``[2B]`` vectors a round reads and the fold updates
ROUND_VECTORS = ("best", "meet", "levels", "edges", "live", "any",
                 "scan_cur", "cnt", "scan", "key")


def group_rows(b: int, device=None) -> torch.Tensor:
    """The column-group map of a ``[2b, n_pad]`` plane: int64 ``[ceil(b /
    32), 64]``, group g's source rows ``32g ..`` then its target rows ``b +
    32g ..``; -1 where ``32g + i >= b`` (a ragged last group)."""
    ng = -(-b // GROUP)
    q = torch.arange(ng * GROUP, device=device).reshape(ng, GROUP)
    rows = torch.cat([q, b + q], dim=1)
    return torch.where(torch.cat([q, q], dim=1) < b, rows, -1)


def plane_occupancy(plane) -> torch.Tensor:
    """int32 ``[ceil(B / 32), nblocks]``: 1 where a query group's rows of a
    block column of ``plane [2B, n_pad]`` hold an entry."""
    c, n_pad = plane.shape
    blk = plane.ne(0).reshape(c, n_pad // TILE, TILE).any(2)
    # row -1 of the map reads the appended empty row
    blk = torch.cat([blk, blk.new_zeros(1, blk.shape[1])])
    return blk[group_rows(c // 2, plane.device)].any(1).to(torch.int32)


def round_vectors(srcs, dsts, deg) -> dict:
    """The round-0 vectors of a batch (:data:`ROUND_VECTORS`): ``src ==
    dst`` queries done (best 0, meet src), the others live; ``scan_cur``
    the degree sums of the round-0 frontiers (``deg[src]``, ``deg[dst]``);
    the accumulators ``cnt``, ``scan`` (int32 ``[2B]``) and ``key`` (int64
    ``[B]``) empty, as the fold leaves them."""
    b = srcs.shape[0]
    dev = srcs.device
    same = srcs == dsts
    live = (~same).to(torch.int32)
    zeros2 = torch.zeros(2 * b, dtype=torch.int32, device=dev)
    return dict(
        best=torch.where(same, 0, INF32).to(torch.int32),
        meet=torch.where(same, srcs, -1).to(torch.int32),
        levels=torch.zeros(b, dtype=torch.int32, device=dev),
        edges=torch.zeros(b, dtype=torch.int32, device=dev),
        live=live,
        any=live.amax(0, keepdim=True),
        scan_cur=torch.cat([deg[srcs.long()], deg[dsts.long()]]),
        cnt=zeros2, scan=zeros2.clone(),
        key=torch.full((b,), KEY_EMPTY, dtype=torch.int64, device=dev),
    )


def blocked_level_plain(tab, bcol, deg, plane, dist, occ, vec, lvl: int, *,
                        rc: int | None = None):
    """Plain twin of :func:`blocked_level`: the expansion of the
    transposed plane, the masked stamp in place on ``dist``, then the
    counts, degree sums and vote added into ``vec`` as the kernel's
    atomics do. ``occ`` only lets the kernel skip work; the twin reads
    every slot."""
    del occ
    nblocks = bcol.shape[0]
    b = plane.shape[0] // 2
    if rc is None:
        rc = chunk_block_rows(bcol.shape[1], plane.shape[0],
                              plane.element_size())
    reach = expand_blocked_plane(plane.T, tab, bcol, rc=min(rc, nblocks)).T
    # live[c mod B] for each of the C = 2B rows
    new = reach & (dist >= INF32) & vec["live"].to(torch.bool).repeat(2)[:, None]
    dist.copy_(torch.where(new, lvl, dist))
    vec["cnt"] += new.sum(1, dtype=torch.int32)
    vec["scan"] += torch.where(new, deg, 0).sum(1, dtype=torch.int32)
    # the vote: a vertex new on either side with both sides now reached
    ds, dt = dist[:b], dist[b:]
    cand = (new[:b] | new[b:]) & (ds < INF32) & (dt < INF32)
    vid = torch.arange(plane.shape[1], dtype=torch.int64, device=plane.device)
    keys = torch.where(cand, ((ds + dt).to(torch.int64) << 32) | vid,
                       KEY_EMPTY)
    torch.minimum(vec["key"], keys.amin(1), out=vec["key"])
    fr = new.to(plane.dtype)
    return fr, plane_occupancy(fr)


def blocked_fold_plain(vec, lvl: int) -> None:
    """Plain twin of :func:`blocked_fold`, in place on ``vec``."""
    b = vec["best"].shape[0]
    key, live = vec["key"], vec["live"]
    kval = (key >> 32).to(torch.int32)
    take = kval < vec["best"]
    vec["meet"].copy_(torch.where(take, (key & 0xFFFFFFFF).to(torch.int32),
                                  vec["meet"]))
    torch.minimum(vec["best"], kval, out=vec["best"])
    sc = vec["scan_cur"]
    vec["edges"] += (sc[:b] + sc[b:]) * live
    vec["levels"] += 2 * live
    sc.copy_(vec["scan"])
    cnt = vec["cnt"]
    nxt = (2 * lvl < vec["best"]) & (cnt[:b] > 0) & (cnt[b:] > 0)
    live.copy_(nxt)
    vec["any"].copy_(nxt.any().reshape(1))
    cnt.zero_()
    vec["scan"].zero_()
    key.fill_(KEY_EMPTY)


def check_vectors(vec) -> None:
    """Validate a round's vectors (:data:`ROUND_VECTORS`) for the card."""
    b = vec["best"].shape[0]
    want = {"any": 1, "scan_cur": 2 * b, "cnt": 2 * b, "scan": 2 * b}
    for k in ROUND_VECTORS:
        if vec[k].shape != (want.get(k, b),):
            raise ValueError(f"{k} has shape {tuple(vec[k].shape)}")
    _cuda.check_dtype(torch.int64, key=vec["key"])
    _cuda.check_dtype(torch.int32,
                      **{k: vec[k] for k in ROUND_VECTORS if k != "key"})
    _cuda.check_cuda(vec["best"].device, **{k: vec[k] for k in ROUND_VECTORS})


def check_blocked(tab, bcol, deg, plane, dist, occ, vec) -> None:
    """Validate one launch's inputs on the card (shapes, types, one
    device, contiguous); a search checks once and then launches with
    ``checked=True``."""
    if tab.dim() != 4 or tab.shape[2:] != (TILE, TILE) or bcol.dim() != 2:
        raise ValueError("tab must be [nblocks, bwidth, 128, 128] with "
                         "bcol [nblocks, bwidth]")
    nblocks, bwidth = bcol.shape
    if tab.shape[:2] != (nblocks, bwidth):
        raise ValueError("tab and bcol disagree on (nblocks, bwidth)")
    if not 0 < nblocks <= 65535:
        raise ValueError(f"{nblocks} block rows exceed the kernel's grid")
    c, n_pad = plane.shape
    b = c // 2
    if n_pad != nblocks * TILE or c % 2 or b != vec["best"].shape[0]:
        raise ValueError("plane must be [2B, nblocks * 128] for B queries")
    if dist.shape != plane.shape or deg.shape != (n_pad,):
        raise ValueError("dist must have the plane's shape and deg [n_pad]")
    if occ.shape != (-(-b // GROUP), nblocks):
        raise ValueError("occ must be [ceil(B / 32), nblocks]")
    check_vectors(vec)
    _cuda.check_dtype(torch.int8, tab=tab, plane=plane)
    _cuda.check_dtype(torch.int32, bcol=bcol, deg=deg, dist=dist, occ=occ)
    _cuda.check_cuda(vec["best"].device, tab=tab, bcol=bcol, deg=deg,
                     plane=plane, dist=dist, occ=occ)


def blocked_level(tab, bcol, deg, plane, dist, occ, vec, lvl: int, *,
                  rc: int | None = None, checked: bool = False):
    """One blocked round on query-major planes (module docstring): stamps
    ``dist`` in place, adds the new frontier's counts, degree sums and meet
    vote into ``vec`` (``cnt``, ``scan``, ``key``; empty on entry, as
    :func:`blocked_fold` leaves them) and returns the next plane and its
    occupancy flags. ``occ`` must flag every occupied block column of the
    plane (:func:`plane_occupancy`). ``rc`` is the twin's chunk (the kernel
    needs none); ``checked`` skips the validation (:func:`check_blocked`)."""
    if not plane.is_cuda:
        return blocked_level_plain(tab, bcol, deg, plane, dist, occ, vec, lvl,
                                   rc=rc)
    if not checked:
        check_blocked(tab, bcol, deg, plane, dist, occ, vec)
    c, n_pad = plane.shape
    nblocks, bwidth = bcol.shape
    plane_n = torch.empty_like(plane)  # the kernel writes every entry
    occ_n = torch.empty_like(occ)
    _cuda.launch(
        "blocked_expand", "bibfs_blocked_level",
        tab.data_ptr(), bcol.data_ptr(), nblocks, bwidth, deg.data_ptr(),
        plane.data_ptr(), plane_n.data_ptr(), dist.data_ptr(), occ.data_ptr(),
        occ_n.data_ptr(), n_pad, c, vec["live"].data_ptr(), int(lvl),
        vec["cnt"].data_ptr(), vec["scan"].data_ptr(), vec["key"].data_ptr(),
    )
    _cuda.count_launch(blocked_level)
    return plane_n, occ_n


blocked_level.launches = 0


def blocked_fold(vec, lvl: int, *, checked: bool = False) -> None:
    """Fold a round's accumulators into the ``[B]`` state, in place on
    ``vec``: ``best``/``meet`` lowered by the vote where strictly lower,
    ``edges += (scan_cur_s + scan_cur_t) * live``, ``levels += 2 * live``,
    ``scan_cur = scan``, the next ``live`` by the minor kernel's rule at
    level ``lvl`` (``2 lvl < best`` and both new frontiers non-empty),
    ``any`` = any live; then ``cnt``, ``scan`` and ``key`` reset. A CUDA
    tensor launches ``blocked_fold_kernel`` (one block) or raises."""
    if not vec["best"].is_cuda:
        blocked_fold_plain(vec, lvl)
        return
    if not checked:
        check_vectors(vec)
    _cuda.launch(
        "blocked_expand", "bibfs_blocked_fold", vec["best"].shape[0], int(lvl),
        *(vec[k].data_ptr() for k in ("best", "meet", "levels", "edges",
                                      "scan_cur", "live", "any", "cnt",
                                      "scan", "key")),
    )
    _cuda.count_launch(blocked_fold)


blocked_fold.launches = 0
