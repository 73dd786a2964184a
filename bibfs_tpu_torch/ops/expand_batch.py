"""The level code of :mod:`bibfs_tpu_torch.ops.expand` over B searches at
once: the torch level code of the lock-step batch of the per-query modes
(:mod:`bibfs_tpu_torch.solvers.dense_batch`), where the reference runs
``ops/expand.py`` under ``jax.vmap``.

Every function takes the ``[B, n_pad]`` rows of the queries it expands
(the caller picks them) and gives each row exactly what the single-query
function gives that query: the same next frontier, parents (lowest hit
slot on the pull path, the largest discovering source on the push path,
tier parents folded in by max), distances and counters.

- Pull: the frontier rows are transposed once per call to ``[n_ids, B]``
  bytes, so one table index gathers the bytes of all B queries; the
  table is walked in row chunks whose ``[rows, width, B]`` gather fits
  :data:`LOCKSTEP_BUDGET_BYTES`, and the hub tiers the same way.
- Push: each query's compact frontier list is a row of ``fi [B, k]``; the
  claims scatter over flattened ids ``q * n_pad + v``, so no two queries
  meet in a scatter.
- Scatters update the rows they are given in place, dropping an entry by
  scattering a neutral value (0 into a frontier, -1 into a parent,
  ``inf`` into a distance) where the single-query code scatters into a
  cut-off slot.
"""

from __future__ import annotations

import torch

from bibfs_tpu_torch.ops.expand import _tier_rows

# working-set budget of one gather: the ``[rows, width, B]`` frontier bytes
# gathered through a table chunk and their hit and slot intermediates (the
# batch-minor search's ``CHUNK_BUDGET_BYTES``, a budget of its own)
LOCKSTEP_BUDGET_BYTES = 384 * 2**20
# bytes charged per gathered (row, slot, query) element: the frontier
# byte, the hit flags and the int32 slot index of the first-hit reduction
_BYTES_PER_ELEMENT = 10


def chunk_rows(width: int, b: int) -> int:
    """Table rows per gather of ``b`` queries over ``width`` slots."""
    return max(1, LOCKSTEP_BUDGET_BYTES // (max(width, 1) * max(b, 1)
                                            * _BYTES_PER_ELEMENT))


def frontier_count(fr):
    """Popcount of each row, int32 ``[B]``."""
    return fr.sum(dim=1, dtype=torch.int32)


def frontier_degree_sum(fr, deg):
    """Directed edges a push of each row would scan, int32 ``[B]``."""
    return torch.where(fr, deg, 0).sum(dim=1, dtype=torch.int32)


def max_new_degree(nf, deg):
    """Largest degree in each row's new frontier (0 when it is empty)."""
    return torch.where(nf, deg, 0).amax(dim=1)


def flatnonzero(fr, k: int):
    """The first ``k`` set positions of each row as int32 ``[B, k]``,
    padded with -1."""
    b, n = fr.shape
    pos = fr.cumsum(dim=1, dtype=torch.int32) - 1
    out = torch.full((b, k + 1), -1, dtype=torch.int32, device=fr.device)
    slot = torch.where(fr & (pos < k), pos, k).long()
    ids = torch.arange(n, dtype=torch.int32, device=fr.device).expand(b, n)
    out.scatter_(1, slot, ids)  # positions past k land in the cut-off column
    return out[:, :k]


def _first_true(hits):
    """Slot of the first hit of each (row, query) of ``hits [R, W, B]``
    (0 where none), by a deterministic min over slot indices."""
    w = hits.shape[1]
    cols = torch.arange(w, dtype=torch.int32, device=hits.device)[None, :, None]
    j = torch.where(hits, cols, w).amin(dim=1)
    return torch.where(j == w, 0, j)


def _claim(front_t, tab, valid, bits):
    """For each bit of ``bits``: ``(any [R, B], parent [R, B])`` of the
    table rows ``tab [R, W]`` (live slots ``valid [R, W]``) over the
    transposed frontier bytes ``front_t [n_ids, B]``; the parent is the
    neighbour in the lowest hit slot (slot 0's where there is none)."""
    vals = front_t[tab.long()]  # [R, W, B]
    out = []
    for bit in bits:
        hits = ((vals & bit) > 0) & valid[:, :, None]
        out.append((hits.any(dim=1), tab.gather(1, _first_true(hits).long())))
    return out


def _pull_rows(front, sides, nbr, deg):
    """The base-table pull of ``front`` (uint8 ``[B, n_pad]``, one bit per
    side) for ``sides``, ``[(bit, visited [B, n_pad])]``: per side
    ``(next_frontier bool [B, n_pad], parent_candidate int32 [B, n_pad])``
    and the transposed frontier, which the tier passes read too."""
    b, n_pad = front.shape
    front_t = front.T.contiguous()
    width = nbr.shape[1]
    cols = torch.arange(width, device=nbr.device)[None, :]
    outs = [(torch.empty(b, n_pad, dtype=torch.bool, device=nbr.device),
             torch.empty(b, n_pad, dtype=torch.int32, device=nbr.device))
            for _ in sides]
    step = chunk_rows(width, b)
    for r0 in range(0, n_pad, step):
        r1 = min(n_pad, r0 + step)
        valid = cols < deg[r0:r1, None]
        claims = _claim(front_t, nbr[r0:r1], valid, [bit for bit, _ in sides])
        for (anyh, par), (nf, pc), (_bit, vis) in zip(claims, outs, sides):
            nf[:, r0:r1] = anyh.T & ~vis[:, r0:r1]
            pc[:, r0:r1] = par.T
    return outs, front_t


def _apply_tiers(planes, front_t, sides, deg, tiers, n_pad: int):
    """Fold the hub tiers into each side's ``(nf, par)`` in place (a hub's
    base parent and tier parent combine by max); ``sides`` as in
    :func:`_pull_rows`, the visited rows being the round's old ones."""
    b = front_t.shape[1]
    for start, count, tier_nbr, hub_ids in tiers:
        ids_c, valid = _tier_rows(start, count, tier_nbr, hub_ids, deg, n_pad)
        step = chunk_rows(tier_nbr.shape[1], b)
        for r0 in range(0, tier_nbr.shape[0], step):
            r1 = r0 + step
            ids = ids_c[r0:r1]
            claims = _claim(front_t, tier_nbr[r0:r1], valid[r0:r1],
                            [bit for bit, _ in sides])
            for (anyh, hub_par), (nf, par), (_bit, vis) in zip(
                    claims, planes, sides):
                hub_new = (anyh & ~vis[:, ids].T).T  # [B, R]
                tgt = torch.where(hub_new, hub_ids[r0:r1].long()[None, :], 0)
                nf.view(torch.uint8).scatter_reduce_(
                    1, tgt, hub_new.to(torch.uint8), "amax")
                par.scatter_reduce_(1, tgt, torch.where(hub_new, hub_par.T, -1),
                                    "amax")
    return planes


def stamp(nf, dist, vis, lvl_next):
    """Each row's new frontier at its next level; ``lvl_next [B]``."""
    return torch.where(nf & ~vis, lvl_next[:, None], dist)


def expand_pull_tiered(fr, par, dist, nbr, deg, tiers, lvl_next, *, inf: int):
    """Batched :func:`bibfs_tpu_torch.ops.expand.expand_pull_tiered`:
    ``(next_frontier, par, dist, max_deg_of_new_frontier)``;
    ``lvl_next [B]``."""
    vis = dist < inf
    ((nf, pc),), front_t = _pull_rows(fr.to(torch.uint8), [(1, vis)], nbr, deg)
    par = torch.where(nf, pc, par)
    (nf, par), = _apply_tiers([(nf, par)], front_t, [(1, vis)], deg, tiers,
                              nbr.shape[0])
    return nf, par, stamp(nf, dist, vis, lvl_next), max_new_degree(nf, deg)


def expand_pull_dual_tiered(fr_s, fr_t, par_s, dist_s, par_t, dist_t, nbr, deg,
                            tiers, lvl_s, lvl_t, *, inf: int):
    """Batched :func:`bibfs_tpu_torch.ops.expand.expand_pull_dual_tiered`:
    one gather per table chunk serves both sides of every query. Returns
    ``(nf_s, par_s, dist_s, md_s, nf_t, par_t, dist_t, md_t)``."""
    vis_s, vis_t = dist_s < inf, dist_t < inf
    sides = [(1, vis_s), (2, vis_t)]
    packed = fr_s.to(torch.uint8) | (fr_t.to(torch.uint8) << 1)
    ((nf_s, pc_s), (nf_t, pc_t)), front_t = _pull_rows(packed, sides, nbr, deg)
    planes = _apply_tiers([(nf_s, torch.where(nf_s, pc_s, par_s)),
                           (nf_t, torch.where(nf_t, pc_t, par_t))],
                          front_t, sides, deg, tiers, nbr.shape[0])
    (nf_s, par_s), (nf_t, par_t) = planes
    return (nf_s, par_s, stamp(nf_s, dist_s, vis_s, lvl_s),
            max_new_degree(nf_s, deg),
            nf_t, par_t, stamp(nf_t, dist_t, vis_t, lvl_t),
            max_new_degree(nf_t, deg))


def apply_tiers(nf, par, fr, vis, deg, tiers, n_pad: int):
    """Batched :func:`bibfs_tpu_torch.ops.expand.apply_tiers` around a
    pull kernel: ``(nf, par)`` with the tiers folded in (in place)."""
    if not tiers:
        return nf, par
    front_t = fr.to(torch.uint8).T.contiguous()
    (nf, par), = _apply_tiers([(nf, par)], front_t, [(1, vis)], deg, tiers,
                              n_pad)
    return nf, par


def apply_tiers_dual(nf_s, par_s, nf_t, par_t, fr_s, fr_t, vis_s, vis_t, deg,
                     tiers, n_pad: int):
    """Batched :func:`bibfs_tpu_torch.ops.expand.apply_tiers_dual` around
    the dual pull kernel: one gather per tier chunk serves both sides."""
    if not tiers:
        return nf_s, par_s, nf_t, par_t
    packed = fr_s.to(torch.uint8) | (fr_t.to(torch.uint8) << 1)
    (nf_s, par_s), (nf_t, par_t) = _apply_tiers(
        [(nf_s, par_s), (nf_t, par_t)], packed.T.contiguous(),
        [(1, vis_s), (2, vis_t)], deg, tiers, n_pad)
    return nf_s, par_s, nf_t, par_t


def _tier_valid(slot_count, width: int, rank, tier_count: int):
    """Valid-slot mask of one hub tier for ``[B, k]`` frontier entries:
    bool ``[B, k, width]``."""
    member = (rank >= 0) & (rank < tier_count)
    cols = torch.arange(width, device=rank.device)
    return member[..., None] & (cols < slot_count[..., None])


def expand_push_tiered(fidx, par, dist, nbr, deg, hub_rank, push_tiers,
                       lvl_next, *, inf: int):
    """Batched :func:`bibfs_tpu_torch.ops.expand.expand_push_tiered` over
    the compact lists ``fidx [B, k]``: ``(next_frontier, next_fidx [B, k],
    cnt, par, dist, scanned, max_deg)``, each a row or entry per query;
    ``par`` and ``dist`` are updated in place."""
    b, k = fidx.shape
    n_pad = par.shape[1]
    live = fidx >= 0
    fc = torch.where(live, fidx, 0)
    fcl = fc.long()
    vd = torch.where(live, deg[fcl], 0)
    base_w = nbr.shape[1]
    cols = torch.arange(base_w, device=nbr.device)
    parts_rows = [nbr[fcl]]
    parts_valid = [cols < vd.clamp(max=base_w)[..., None]]
    if push_tiers:
        frank = hub_rank[fcl]
        for start, count, tier_nbr, _hub_ids in push_tiers:
            width = tier_nbr.shape[1]
            rk = torch.where((frank >= 0) & (frank < count), frank, 0)
            slot_count = (vd - start).clamp(0, width)
            parts_rows.append(tier_nbr[rk.long()])
            parts_valid.append(_tier_valid(slot_count, width, frank, count))
    rows = torch.cat(parts_rows, dim=2)  # [B, k, Wc]
    valid = torch.cat(parts_valid, dim=2)
    rows_l = rows.long()
    flat = torch.arange(b, device=nbr.device)[:, None, None] * n_pad + rows_l
    dist_f, par_f = dist.view(-1), par.view(-1)
    cand_new = valid & (dist_f[flat] >= inf)
    tgt = torch.where(cand_new, flat, 0)
    dist_f.scatter_reduce_(0, tgt.view(-1), torch.where(
        cand_new, lvl_next[:, None, None], inf).view(-1), "amin")
    srcb = fc[:, :, None].expand(rows.shape)
    par_f.scatter_reduce_(0, tgt.view(-1),
                          torch.where(cand_new, srcb, -1).reshape(-1), "amax")
    win = (cand_new & (par_f[flat] == srcb)).view(b, -1)
    nf = torch.zeros(b, n_pad, dtype=torch.bool, device=nbr.device)
    nf.view(-1).view(torch.uint8).scatter_reduce_(
        0, tgt.view(-1), cand_new.view(-1).to(torch.uint8), "amax")
    pos = torch.cumsum(win, dim=1) - 1
    outpos = torch.where(win & (pos < k), pos, k)  # winners past k drop
    nfidx = torch.full((b, k + 1), -1, dtype=torch.int32, device=nbr.device)
    nfidx.scatter_(1, outpos, rows.view(b, -1).to(torch.int32))
    cnt = win.sum(dim=1, dtype=torch.int32)
    max_deg = torch.where(win, deg[rows_l].view(b, -1), 0).amax(dim=1)
    return (nf, nfidx[:, :k], cnt, par, dist, vd.sum(dim=1, dtype=torch.int32),
            max_deg)
