"""Frontier-expansion level code as plain torch: the level code of the
``sync``, ``alt`` and ``beamer`` modes, and the hub-tier code around the
pull kernels.

Pull-style expansion over the regularized ELL table:

    next[v] = (exists j < deg[v] : frontier[nbr[v, j]]) and not visited[v]

The parent of a newly reached vertex is its neighbour in the lowest hit
slot, so parents are deterministic. The Beamer push path claims parents
with a scatter-max instead (the largest discovering source wins), and the
hub tiers fold into the base table's parent with a max as well.

Scatter-max/min are ``scatter_reduce(..., "amax"/"amin",
include_self=True)``; an out-of-range target (``== n``) is dropped by
scattering into one extra slot that is then cut off. All ops are
device-agnostic and take int32 tables and rows.
"""

from __future__ import annotations

import torch


def _first_true(hits: torch.Tensor) -> torch.Tensor:
    """Column of the first True in each row of ``hits [R, W]`` (0 for a
    row with none), by a deterministic min over column indices."""
    w = hits.shape[1]
    cols = torch.arange(w, device=hits.device)
    j = torch.where(hits, cols, w).min(dim=1).values
    return torch.where(j == w, 0, j)


def _scatter_drop(target, idx, src, reduce: str):
    """``target.at[idx].<reduce>(src, mode="drop")`` for indices in
    ``[0, len(target)]``: index ``len(target)`` lands in a cut-off slot."""
    n = target.shape[0]
    ext = torch.cat([target, target.new_zeros(1)])
    ext.scatter_reduce_(
        0, idx.reshape(-1), src.reshape(-1).to(target.dtype), reduce=reduce,
        include_self=True,
    )
    return ext[:n]


def _fill_drop(mask, idx):
    """Set ``mask[idx] = True`` for indices in ``[0, len(mask)]``,
    dropping ``len(mask)``."""
    n = mask.shape[0]
    ext = torch.cat([mask, mask.new_zeros(1)])
    ext.index_fill_(0, idx.reshape(-1), True)
    return ext[:n]


def expand_pull(frontier, visited, nbr, deg):
    """One BFS level. Returns ``(next_frontier bool[n], parent int32[n])``;
    ``parent[v]`` is meaningful only where ``next_frontier[v]`` and is the
    first frontier neighbour in ELL slot order."""
    width = nbr.shape[1]
    valid = torch.arange(width, device=nbr.device)[None, :] < deg[:, None]
    hits = frontier[nbr.long()] & valid
    next_f = hits.any(dim=1) & ~visited
    j = _first_true(hits)
    parent = nbr.gather(1, j[:, None])[:, 0]
    return next_f, parent


def _push_claim(fc, rows, valid, scanned, par, dist, deg, lvl_next, *, inf):
    """Push claim/dedup/compact over candidate edges (the top-down half of
    Beamer direction optimization). Cost scales with ``K * width``.

    Every discovering edge scatters its source id into ``par`` and the
    max source wins; the winning occurrence is found by a read-back
    compare. Returns ``(next_frontier, next_fidx int32[K], cnt, par,
    dist, scanned, max_deg)``; ``next_fidx`` is complete only when
    ``cnt <= K``."""
    k = fc.shape[0]
    n_pad = par.shape[0]
    rows_l = rows.long()
    cand_new = valid & (dist[rows_l] >= inf)
    tgt = torch.where(cand_new, rows_l, n_pad)
    lvl = lvl_next.to(torch.int32).expand(tgt.shape)
    dist = _scatter_drop(dist, tgt, lvl, "amin")
    srcb = fc[:, None].expand(tgt.shape)
    par = _scatter_drop(par, tgt, srcb, "amax")
    win = cand_new & (par[rows_l] == srcb)
    next_f = _fill_drop(torch.zeros(n_pad, dtype=torch.bool, device=par.device),
                        tgt)
    wflat = win.reshape(-1)
    pos = torch.cumsum(wflat, 0) - 1
    outpos = torch.where(wflat & (pos < k), pos, k)  # winners past K drop
    next_fidx = torch.full((k + 1,), -1, dtype=torch.int32, device=par.device)
    next_fidx.scatter_(0, outpos, rows.reshape(-1).to(torch.int32))
    cnt = wflat.sum(dtype=torch.int32)
    max_deg = torch.where(win, deg[rows_l], 0).max()
    return next_f, next_fidx[:k], cnt, par, dist, scanned, max_deg


def pack_dual(frontier_s, frontier_t):
    """Pack both sides' boolean frontiers into one uint8 row (bit 0 =
    source side, bit 1 = target side) so a lock-step round reads the
    neighbour table once for both expansions."""
    return frontier_s.to(torch.uint8) | (frontier_t.to(torch.uint8) << 1)


def _dual_hits(vals, valid, bit: int):
    return ((vals & bit) > 0) & valid


def expand_pull_dual(packed, visited_s, visited_t, nbr, deg):
    """Both sides of one lock-step level from one ``packed[nbr]`` gather.
    Returns ``(next_s, parent_s, next_t, parent_t)``."""
    width = nbr.shape[1]
    valid = torch.arange(width, device=nbr.device)[None, :] < deg[:, None]
    vals = packed[nbr.long()]
    outs = []
    for bit, visited in ((1, visited_s), (2, visited_t)):
        hits = _dual_hits(vals, valid, bit)
        next_f = hits.any(dim=1) & ~visited
        j = _first_true(hits)
        parent = nbr.gather(1, j[:, None])[:, 0]
        outs += [next_f, parent]
    return tuple(outs)


def _tier_valid(slot_count, width: int, rank, tier_count: int):
    """Valid-slot mask for one hub tier: bool[rows, width]."""
    member = (rank >= 0) & (rank < tier_count)
    cols = torch.arange(width, device=rank.device)[None, :]
    return member[:, None] & (cols < slot_count[:, None])


def _tier_rows(start: int, count: int, tier_nbr, hub_ids, deg, n_pad: int):
    """Per-tier geometry shared by both tier folds: clipped hub ids and
    the valid-slot mask."""
    width = tier_nbr.shape[1]
    rank = torch.arange(tier_nbr.shape[0], device=tier_nbr.device)
    ids_c = hub_ids.clamp(0, n_pad - 1).long()
    slot_count = (deg[ids_c] - start).clamp(0, width)
    valid = _tier_valid(slot_count, width, rank, count) & (hub_ids >= 0)[:, None]
    return ids_c, valid


def _tier_claim(hits, tier_nbr, hub_ids, ids_c, visited, nf, par, n_pad: int):
    """Fold one tier's hits into ``(nf, par)``: any-hit, visited test,
    first-hit-slot parent, scatter-max into the dense rows."""
    hub_new = hits.any(dim=1) & ~visited[ids_c]
    j = _first_true(hits)
    hub_par = tier_nbr.gather(1, j[:, None])[:, 0]
    tgt = torch.where(hub_new, hub_ids.long(), n_pad)
    return _fill_drop(nf, tgt), _scatter_drop(par, tgt, hub_par, "amax")


def apply_tiers(nf, par, frontier, visited, deg, tiers, n_pad: int):
    """Fold the hub-tier contributions of one side into ``(nf, par)``. A
    hub's base-table parent and its tier parent combine by max."""
    for start, count, tier_nbr, hub_ids in tiers:
        ids_c, valid = _tier_rows(start, count, tier_nbr, hub_ids, deg, n_pad)
        hits = frontier[tier_nbr.long()] & valid
        nf, par = _tier_claim(hits, tier_nbr, hub_ids, ids_c, visited, nf,
                              par, n_pad)
    return nf, par


def apply_tiers_dual(
    nf_s, par_s, nf_t, par_t, packed, vis_s, vis_t, deg, tiers, n_pad: int
):
    """Dual-side :func:`apply_tiers`: one packed gather per tier serves
    both sides."""
    for start, count, tier_nbr, hub_ids in tiers:
        ids_c, valid = _tier_rows(start, count, tier_nbr, hub_ids, deg, n_pad)
        vals = packed[tier_nbr.long()]
        nf_s, par_s = _tier_claim(_dual_hits(vals, valid, 1), tier_nbr,
                                  hub_ids, ids_c, vis_s, nf_s, par_s, n_pad)
        nf_t, par_t = _tier_claim(_dual_hits(vals, valid, 2), tier_nbr,
                                  hub_ids, ids_c, vis_t, nf_t, par_t, n_pad)
    return nf_s, par_s, nf_t, par_t


def max_new_degree(nf, deg):
    """Largest degree in the new frontier (0 when it is empty)."""
    return torch.where(nf, deg, 0).max()


def expand_pull_tiered(frontier, par, dist, nbr, deg, tiers, lvl_next, *, inf: int):
    """Pull expansion over a tiered ELL: the base-table pull plus the hub
    tiers. ``tiers`` holds ``(start, count, tier_nbr, hub_ids)``. Returns
    ``(next_frontier, par, dist, max_deg_of_new_frontier)``."""
    n_pad = nbr.shape[0]
    visited = dist < inf
    nf, pcand = expand_pull(frontier, visited, nbr, deg)
    par = torch.where(nf, pcand, par)
    nf, par = apply_tiers(nf, par, frontier, visited, deg, tiers, n_pad)
    dist = torch.where(nf & (dist >= inf), lvl_next, dist)
    return nf, par, dist, max_new_degree(nf, deg)


def expand_pull_dual_tiered(
    fr_s, fr_t, par_s, dist_s, par_t, dist_t, nbr, deg, tiers, lvl_s, lvl_t, *, inf
):
    """Lock-step :func:`expand_pull_tiered`: one packed gather per table
    serves both sides. Returns ``(nf_s, par_s, dist_s, md_s, nf_t, par_t,
    dist_t, md_t)``."""
    n_pad = nbr.shape[0]
    packed = pack_dual(fr_s, fr_t)
    vis_s = dist_s < inf
    vis_t = dist_t < inf
    nf_s, pc_s, nf_t, pc_t = expand_pull_dual(packed, vis_s, vis_t, nbr, deg)
    par_s = torch.where(nf_s, pc_s, par_s)
    par_t = torch.where(nf_t, pc_t, par_t)
    nf_s, par_s, nf_t, par_t = apply_tiers_dual(
        nf_s, par_s, nf_t, par_t, packed, vis_s, vis_t, deg, tiers, n_pad
    )
    dist_s = torch.where(nf_s & ~vis_s, lvl_s, dist_s)
    dist_t = torch.where(nf_t & ~vis_t, lvl_t, dist_t)
    return (nf_s, par_s, dist_s, max_new_degree(nf_s, deg),
            nf_t, par_t, dist_t, max_new_degree(nf_t, deg))


def expand_push_tiered(
    fidx, par, dist, nbr, deg, hub_rank, push_tiers, lvl_next, *, inf: int
):
    """Push expansion over a tiered ELL. Callable only when every frontier
    vertex's degree fits the base width plus ``push_tiers``; the candidate
    width is static (base + allowed tier widths)."""
    live = fidx >= 0
    fc = torch.where(live, fidx, 0)
    fcl = fc.long()
    vd = torch.where(live, deg[fcl], 0)
    base_w = nbr.shape[1]
    cols = torch.arange(base_w, device=nbr.device)[None, :]
    parts_rows = [nbr[fcl]]
    parts_valid = [cols < vd.clamp(max=base_w)[:, None]]
    if push_tiers:
        frank = hub_rank[fcl]
        for start, count, tier_nbr, _hub_ids in push_tiers:
            width = tier_nbr.shape[1]
            rk = torch.where((frank >= 0) & (frank < count), frank, 0)
            slot_count = (vd - start).clamp(0, width)
            parts_rows.append(tier_nbr[rk.long()])
            parts_valid.append(_tier_valid(slot_count, width, frank, count))
    rows = torch.cat(parts_rows, dim=1)
    valid = torch.cat(parts_valid, dim=1)
    return _push_claim(fc, rows, valid, vd.sum(dtype=torch.int32), par, dist,
                       deg, lvl_next, inf=inf)


def frontier_count(frontier):
    """Popcount of a boolean frontier, int32."""
    return frontier.sum(dtype=torch.int32)


def frontier_degree_sum(frontier, deg):
    """Directed edges a push-expansion of ``frontier`` would scan (the
    TEPS numerator increment), int32."""
    return torch.where(frontier, deg, 0).sum(dtype=torch.int32)
