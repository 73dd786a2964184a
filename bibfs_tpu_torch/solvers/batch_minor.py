"""Batch-minor batched bidirectional BFS on one device: the counterpart of
``bibfs_tpu/solvers/batch_minor.py`` (its single-device part).

B queries advance lock-step (both sides every round) over ``[n_pad2, B]``
distance and parent planes, the queries on the minor axis, with the
frontier and visited sets packed to one bit per (row, query, side)
(``front`` and ``vis``, ``[n_pad2, B / 16]`` int32 pair rows), so every
neighbour index of the shared table gathers one contiguous run of B
frontier bits per side. Each round is one level launch
(:func:`bibfs_tpu_torch.ops.minor_level.minor_level`, a hand-written CUDA
kernel on the card, its plain torch twin on the CPU), then on a tiered
graph the hub-tier passes (:func:`_tier_pass`, torch), then the per-query
fold on ``[B]`` vectors. The meet vote is carried from round to round:
the level folds the votes of its claims into the previous round's key
(the seed's vote first: ``src`` where ``src == dst``). The host reads one
bool a round (does any query go on?), counted in
``stats["host_syncs"]``.

Semantics are the reference's: finished queries freeze through
``active``, termination is the per-query vote ``2 * rnd >= best`` or an
empty frontier, and the outputs are per-query ``(best, meet, par_s
[B, n_pad2], par_t, levels, edges)`` as ``dense._materialize_batch``
expects. Mode ``minor8`` keeps int8 planes: parents are ELL slots, decoded
to vertex ids in the untimed finish hook (:func:`_decode_slot_parents`),
and the loop also stops at round :data:`MAX_RND8`, returning a per-query
``capped`` flag; :func:`_refill_capped` re-solves those queries through
the int32 planes (or the lock-step ``sync`` batch where those do not fit),
so the mode is exact on any graph.

The geometry rules (:func:`_minor_geometry`, :func:`minor_fits`,
:func:`chunk_rows`) are the reference's unchanged: they decide which
batches ``auto`` routes here and which ``ValueError`` a caller sees. The
CUDA kernel needs no ``tc`` chunking; the twin scans in ``tc``-row chunks
as the reference does.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from bibfs_tpu_torch.ops.minor_level import (
    INF8,
    INF32,
    LANES,
    NO_MEET,
    check_minor,
    decode_meet,
    meet_vote,
    minor_level,
    pack_sides,
    unpack_front,
)

_BIG = 2147483647  # int32 max: never wins a min

# int8 planes (mode "minor8"): INF8 = 127 is the unvisited sentinel, so the
# deepest stampable level is 126; rounds start only while rnd < MAX_RND8
MAX_RND8 = 126

# working-set budget of one reference chunk: the gathered [Wp, tc, B] block
# plus its int32 key-select and meet intermediates, at (itemsize + 4) bytes
# per element. It shapes the geometry rules (and the twin's chunks). The
# lock-step batch's gathers take their own budget,
# ``ops/expand_batch.py`` ``LOCKSTEP_BUDGET_BYTES``.
CHUNK_BUDGET_BYTES = 384 * 2**20

# below this many queries 'auto' takes the lock-step sync batch: the minor
# planes pad every batch to 128 lanes (the reference's measured default,
# used where calibration.json has no block for the platform)
SMALL_BATCH_SYNC = 32

def _slot_pad(width: int) -> int:
    """ELL width padded up to the reference's 8-slot quantum."""
    return max(8, -(-width // 8) * 8)


def pad_batch(b: int) -> int:
    """Queries padded up to whole 128-lane groups (pad queries are
    ``src == dst == 0``: best 0 at the start, frozen before round one)."""
    return max(LANES, -(-b // LANES) * LANES)


def chunk_rows(wp: int, b_pad: int, n_pad: int, itemsize: int = 4) -> int:
    """Vertex rows per reference chunk: the largest multiple of 8 whose
    working set, charged at ``itemsize + 4`` bytes per ``[Wp, tc, B]``
    element, fits the budget (at least 8)."""
    raw = CHUNK_BUDGET_BYTES // (wp * b_pad * (itemsize + 4))
    return int(max(8, min(n_pad, (raw // 8) * 8)))


def minor_fits(n_pad: int, width: int, b: int, itemsize: int = 4) -> bool:
    """Whether the batch-minor path takes this (graph, batch) shape: the
    parent key ``(Wp-1)*KS + sentinel`` stays in int32 and one 8-row chunk
    fits the budget at the :func:`chunk_rows` charge."""
    wp = _slot_pad(width)
    ks = n_pad + 1
    if wp * ks >= (1 << 31):
        return False
    return wp * 8 * pad_batch(b) * (itemsize + 4) <= CHUNK_BUDGET_BYTES


def tier_slab_rows(tw: int, b_pad: int) -> int:
    """Hub rows per tier-pass slab (a flat 8 bytes per element)."""
    raw = CHUNK_BUDGET_BYTES // (tw * b_pad * 8)
    return int(max(8, (raw // 8) * 8))


def _tier_pass(dual_old, planes, tnbr_m, ids, tw: int, cc: int, *,
               ks: int, lvl: int, active_i):
    """One hub tier's part of the level: slab by slab, gather the OLD dual
    frontier at every tier slot and scatter each side's discoveries into
    the planes. ``tnbr_m`` is the sentinel-masked tier table
    (``[count_pad, tw]``, dead slots ``n_pad2``, which read 0), ``ids`` the
    -1-padded hub ids, ``planes`` ``(nfh_s, nfh_t, dist_s, dist_t, par_s,
    par_t)``, updated in place. Visited tests read the UPDATED dist
    planes, so a vertex the base scan or an earlier tier claimed keeps its
    parent. A pad row (id -1) scatters neutral values into row 0, which
    stands in for the reference's dropped index."""
    n_pad2 = ks - 1
    nfh_s, nfh_t, ds, dt, ps, pt = planes
    b = dual_old.shape[1]
    col = torch.arange(tw, dtype=torch.int32, device=dual_old.device)[None, :]
    act = active_i[None, :]
    for r0 in range(0, tnbr_m.shape[0], cc):
        tn = tnbr_m[r0:r0 + cc]
        ids_c = ids[r0:r0 + cc]
        ok = (ids_c >= 0)[:, None]
        tgt = torch.where(ids_c >= 0, ids_c, 0).long()
        live = tn < n_pad2
        vals = torch.where(live[:, :, None],
                           dual_old[torch.where(live, tn, 0).long()], 0)
        keys = col * ks + tn  # the first-hit slot wins the key-min
        tgt_b = tgt[:, None].expand(-1, b)
        for bit, d, p, nfh in ((0, ds, ps, nfh_s), (1, dt, pt, nfh_t)):
            hit = (vals >> bit) & 1
            anyh = hit.amax(dim=1)  # [cc, B]
            drow = d[tgt]
            hub_new = (torch.where(drow < INF32, 0, anyh) * act > 0) & ok
            kmin = torch.where(hit > 0, keys[:, :, None], _BIG).amin(dim=1)
            d.scatter_reduce_(
                0, tgt_b, torch.where(hub_new, lvl, INF32).to(d.dtype), "amin")
            p.scatter_reduce_(0, tgt_b, torch.where(hub_new, kmin % ks, -1),
                              "amax")
            nfh.scatter_reduce_(0, tgt_b, hub_new.to(torch.int32), "amax")


def _tier_tables(tier_meta, aux, deg, n_pad2: int, b: int) -> list:
    """Each tier's sentinel-masked table, padded to whole slabs once per
    batch: dead slots (past the hub's degree, past the tier's live count,
    or pad rows) hold ``n_pad2`` and read 0."""
    dev = deg.device
    deg2 = torch.zeros(n_pad2, dtype=torch.int32, device=dev)
    deg2[: deg.shape[0]] = deg
    tabs = []
    for (start, count, tw), (tnbr, hub_ids) in zip(tier_meta, aux):
        count_pad = tnbr.shape[0]
        cc = min(tier_slab_rows(tw, b), count_pad)
        rank = torch.arange(count_pad, dtype=torch.int32, device=dev)
        slot_count = (deg2[hub_ids.clamp(0, n_pad2 - 1).long()] - start).clamp(0, tw)
        cols = torch.arange(tw, dtype=torch.int32, device=dev)[None, :]
        valid = ((rank < count)[:, None] & (hub_ids >= 0)[:, None]
                 & (cols < slot_count[:, None]))
        tnbr_m = torch.where(valid, tnbr.to(torch.int32), n_pad2)
        pad_rows = -(-count_pad // cc) * cc - count_pad
        tnbr_m = torch.nn.functional.pad(tnbr_m, (0, 0, 0, pad_rows),
                                         value=n_pad2)
        ids_p = torch.nn.functional.pad(hub_ids.to(torch.int32), (0, pad_rows),
                                        value=-1)
        tabs.append((tnbr_m, ids_p, tw, cc))
    return tabs


@lru_cache(maxsize=None)
def _build_minor_kernel(n_pad2: int, wp: int, tc: int, b: int,
                        dt8: bool = False, tier_meta: tuple = ()):
    """The whole-batch search of one (graph, batch) geometry:
    ``fn(nbr, deg, aux, srcs, dsts, *, cache=None, stats=None) -> (best,
    meet, par_s [B, n_pad2], par_t, levels, edges)``, plus ``capped
    bool[B]`` under ``dt8``, every output a tensor on the graph's device.
    ``aux`` is the tier tuple ``((tier_nbr, hub_ids), ...)``, empty for
    plain ELL; ``cache`` the graph's table cache. It depends on the
    padded geometry alone, so it is cached on it. Under ``dt8`` the
    parent planes hold ELL slots, not vertex ids."""
    pdt = torch.int8 if dt8 else torch.int32
    inf_d = INF8 if dt8 else INF32
    if tier_meta and dt8:
        raise ValueError("tiered batch-minor is int32-plane only")

    def minor_kernel(nbr, deg, aux, srcs, dsts, *, cache=None, stats=None):
        from bibfs_tpu_torch.solvers.dense import _kernel_table

        dev = nbr.device
        nbr_t = _kernel_table(cache, nbr, deg)
        tiers = _tier_tables(tier_meta, aux, deg, n_pad2, b)
        qi = torch.arange(b, device=dev)
        si, di = srcs.long(), dsts.long()
        front = _seed_bits(si, di, n_pad2, b)
        vis = front.clone()
        dist_s = torch.full((n_pad2, b), inf_d, dtype=pdt, device=dev)
        dist_t = dist_s.clone()
        dist_s[si, qi] = 0
        dist_t[di, qi] = 0
        par_s = torch.full((n_pad2, b), -1, dtype=pdt, device=dev)
        par_t = par_s.clone()
        same = srcs == dsts
        best = torch.where(same, 0, INF32).to(torch.int32)
        meet = torch.where(same, srcs, -1).to(torch.int32)
        # the seed's meet vote: (0 << 32) | src where both sides hold src
        key = torch.where(same, srcs.long(), NO_MEET)
        cnt_s = torch.ones(b, dtype=torch.int32, device=dev)
        cnt_t = cnt_s.clone()
        levels = torch.zeros(b, dtype=torch.int32, device=dev)
        edges = torch.zeros(b, dtype=torch.int32, device=dev)
        rnd = 0

        def wants_to_run():
            return (2 * rnd < best) & (cnt_s > 0) & (cnt_t > 0)

        if dev.type == "cuda":  # the planes of every round, checked once
            # (``levels`` has the shape and type of every round's active)
            check_minor(nbr_t, deg, front, vis, dist_s, dist_t, par_s, par_t,
                        levels, key, 1)
        while not (dt8 and rnd >= MAX_RND8):
            act = wants_to_run()
            if stats is not None:
                stats["host_syncs"] += 1
            if not bool(act.any()):
                break
            active_i = act.to(torch.int32)
            lvl = rnd + 1
            front_n, counts, key = minor_level(
                nbr_t, deg, front, vis, dist_s, dist_t, par_s, par_t, lvl,
                active_i, key, tc=tc, checked=True)
            cs, ct, sc = counts
            if tiers:
                dual_old = unpack_front(front, torch.int32)
                zp = torch.zeros(n_pad2, b, dtype=torch.int32, device=dev)
                planes = (zp, zp.clone(), dist_s, dist_t, par_s, par_t)
                for tnbr_m, ids_p, tw, cc in tiers:
                    _tier_pass(dual_old, planes, tnbr_m, ids_p, tw, cc,
                               ks=n_pad2 + 1, lvl=lvl, active_i=active_i)
                hubs = pack_sides(planes[0] > 0, planes[1] > 0)
                front_n |= hubs
                vis |= hubs
                # the kernel's reductions cannot see the hub scatters:
                # recompute the counts and the meet vote plane-wide, and
                # carry that vote to the next level
                dual_n = unpack_front(front_n, torch.int32)
                cs = (dual_n & 1).sum(0, dtype=torch.int32)
                ct = ((dual_n >> 1) & 1).sum(0, dtype=torch.int32)
                key = meet_vote(dist_s, dist_t)
            mval, midx = decode_meet(key)
            take = mval < best
            best = torch.minimum(best, mval)
            meet = torch.where(take, midx, meet)
            cnt_s, cnt_t = cs, ct
            levels = levels + 2 * active_i
            edges = edges + sc
            front = front_n
            rnd = lvl
        res = (best, meet, _transpose(par_s), _transpose(par_t), levels,
               edges)
        if dt8:
            # still live at the cap: these answers are not final
            return res + (wants_to_run(),)
        return res

    return minor_kernel


def _seed_bits(si, di, n_rows: int, b: int):
    """The pair rows (``[n_rows, b / 16]``) with each query's source bit
    on side 0 and its target bit on side 1, made on the device: the bits
    of one word are distinct, so adding them sets them."""
    q = torch.arange(b, device=si.device)
    one = torch.ones(b, dtype=torch.int32, device=si.device)
    words = torch.zeros(n_rows * (b // 16), dtype=torch.int32, device=si.device)
    for side, v in ((0, si), (1, di)):
        bit = one << (2 * (q & 15) + side).to(torch.int32)
        words.index_add_(0, v * (b // 16) + (q >> 4), bit)
    return words.view(n_rows, b // 16)


def _transpose(plane, block: int = 8):
    """``plane.T.contiguous()`` in two passes of ``block``-row slabs: each
    pass reads and writes runs that share sectors, where the one-pass copy
    reads one entry per sector (``[2^20, 256]`` planes on an NVIDIA H100
    80GB HBM3 at 700 W, ``cli/minor_probe.py``: 1.14 against 8.27 ms at
    int8, 2.05 against 9.09 ms at int32)."""
    rows, b = plane.shape
    if rows % block:
        return plane.T.contiguous()
    slabs = plane.view(rows // block, block, b).transpose(1, 2).contiguous()
    return slabs.transpose(0, 1).contiguous().view(b, rows)


def small_batch_threshold(platform: str = "cuda") -> int:
    """The batch size from which ``auto`` takes the minor layout: the
    ``batch_crossover`` of ``calibration.json``'s block for ``platform``
    (``cpu`` or ``cuda``) when it holds a positive int, else
    :data:`SMALL_BATCH_SYNC`."""
    from bibfs_tpu_torch.utils.calibrate import load_calibration

    cal = load_calibration(platform) or {}
    crossover = cal.get("batch_crossover")
    if isinstance(crossover, int) and crossover > 0:
        return crossover
    return SMALL_BATCH_SYNC


def auto_batch_mode(g, num_pairs: int) -> str:
    """The reference's preference order: ``minor8`` where the graph is
    plain ELL and the geometry fits, else ``minor``, else the lock-step
    ``sync`` batch (:mod:`bibfs_tpu_torch.solvers.dense_batch`), which
    batches under :func:`small_batch_threshold` queries (for the platform
    of the graph's tensors) take too."""
    if num_pairs < small_batch_threshold(g.device.type):
        return "sync"
    for mode, dt8 in (("minor8", True), ("minor", False)):
        try:
            _minor_geometry(g, num_pairs, dt8)
            return mode
        except ValueError:
            continue
    return "sync"


def _minor_geometry(g, num_pairs: int, dt8: bool = False
                    ) -> tuple[int, int, int, int]:
    """``(n_pad2, wp, tc, b_pad)`` of a graph and batch size after the
    reference's fit checks; the vertex axis is padded to whole chunks and
    pad rows stay inert."""
    if g.tier_meta and dt8:
        raise ValueError(
            "minor8 is plain-ELL only (slot-coded parents have no tier "
            "decode); tiered graphs batch through mode='minor' or 'sync'"
        )
    b_pad = pad_batch(num_pairs)
    wp = _slot_pad(g.width)
    if not minor_fits(g.n_pad, g.width, num_pairs, itemsize=1 if dt8 else 4):
        raise ValueError(
            f"batch-minor geometry does not fit (n_pad={g.n_pad}, "
            f"width={g.width}, batch={num_pairs}); use the vmapped path"
        )
    if dt8 and wp > 127:
        raise ValueError(
            f"minor8 stores parent slots in int8; width {g.width} "
            f"(padded {wp}) exceeds 127 — use mode='minor'"
        )
    tc = chunk_rows(wp, b_pad, g.n_pad, itemsize=1 if dt8 else 4)
    n_pad2 = -(-g.n_pad // tc) * tc
    if wp * (n_pad2 + 1) >= (1 << 31):
        raise ValueError(
            f"batch-minor parent key overflows int32 after chunk "
            f"rounding (n_pad2={n_pad2}, wp={wp}); use the vmapped path"
        )
    for start, _count, tw in g.tier_meta:
        if tw * (n_pad2 + 1) >= (1 << 31) or (
            tw * 8 * b_pad * 8 > CHUNK_BUDGET_BYTES
        ):
            raise ValueError(
                f"batch-minor tier (start={start}, width={tw}) does not "
                f"fit this batch; use the vmapped path"
            )
    return n_pad2, wp, tc, b_pad


def _refill_capped(g, pairs, out):
    """Re-solve the int8 search's depth-capped queries (``out[-1]``)
    through the int32 planes, or the lock-step ``sync`` batch where those
    do not fit, and splice their rows into the outputs. The sub-dispatch's
    own finish hook always runs."""
    capped = out[-1].cpu().numpy()
    if not capped.any():
        return out[:-1]
    idx = np.flatnonzero(capped[: len(pairs)])
    sub = pairs[idx]
    try:
        _, sub_thunk, sub_finish = batch_dispatch(g, sub, dt8=False)
    except ValueError:
        # int8 planes fit at 5 B/elem where int32 ones do not at 8
        from bibfs_tpu_torch.solvers.dense import _batch_dispatch

        _, sub_thunk, sub_finish = _batch_dispatch(g, sub, "sync")
    sub_out = sub_finish(sub_thunk())
    outs = [o.clone() for o in out[:-1]]
    rows = torch.as_tensor(idx, device=outs[0].device)
    for o, so in zip(outs, sub_out):
        so = torch.as_tensor(so)[: len(sub)].to(o.device, o.dtype)
        if o.dim() == 2:
            # the two searches pad the vertex axis differently; columns
            # past the common width are pad rows (-1) in both
            w = min(o.shape[1], so.shape[1])
            o[rows, :w] = so[:, :w]
        else:
            o[rows] = so
    return tuple(outs)


def _dp_slice(pairs, mesh):
    """This rank's slice of the batch: ``b_loc = pad_batch(ceil(B /
    size))`` queries a rank in rank order, as the reference shards the
    lane-padded batch axis (a rank past the end gets none)."""
    b_loc = pad_batch(-(-len(pairs) // mesh.size))
    return pairs[mesh.rank * b_loc:(mesh.rank + 1) * b_loc]


def dp_batch_dispatch(g, pairs, mesh, dt8: bool = False,
                      stats: dict | None = None):
    """The data-parallel batch on this rank (every rank calls it with the
    same ``pairs``): the graph ``g`` is this rank's replica, the rank runs
    :func:`batch_dispatch` on its lane-padded slice of the queries
    (:func:`_dp_slice`) on its own device, with no collective; under
    ``dt8`` the finish decodes the slot parents and re-solves the
    int8-capped queries through the int32 planes on the same rank.
    Returns ``(local_pairs, thunk, finish)``, the contract of
    :func:`batch_dispatch` over the local slice (``thunk`` None for a rank
    with no query)."""
    local = _dp_slice(pairs, mesh)
    if not len(local):
        return local, None, lambda out: out
    return batch_dispatch(g, local, dt8=dt8, stats=stats)


def _dp_results(g, pairs, mesh, dt8: bool, repeats: int | None):
    """Run this rank's slice (timed ``repeats`` times, or once), then
    gather every rank's results in rank order. ``time_s`` is the batch's
    wall clock over the whole mesh: every rank waits for the slowest."""
    import time as _time

    from bibfs_tpu_torch.solvers.dense import _materialize_batch
    from bibfs_tpu_torch.solvers.timing import force_scalar, timed_batch_repeats

    stats = {"host_syncs": 0}
    local, thunk, finish = dp_batch_dispatch(g, pairs, mesh, dt8, stats)

    def run():
        out = thunk() if thunk is not None else None
        force_scalar(out)
        mesh.barrier()
        return out

    mesh.barrier()
    times = None
    if repeats is None:
        t0 = _time.perf_counter()
        out = run()
        elapsed = _time.perf_counter() - t0
    else:
        times, out = timed_batch_repeats(run, repeats, force=None)
        elapsed = float(np.median(times))
    mine = ([] if thunk is None else
            _materialize_batch(finish(out), len(local), elapsed,
                               mode="minor8" if dt8 else "minor",
                               host_syncs=stats["host_syncs"]))
    results = [r for part in mesh.all_gather_object(mine) for r in part]
    for r in results:
        r.time_s = elapsed
    return times, results


def solve_batch_dp(g, pairs, mesh, *, dt8: bool = False) -> list:
    """The data-parallel batch (:func:`dp_batch_dispatch`), called by every
    rank: one :class:`BFSResult` per pair on every rank, each equal to the
    query's result in a one-device batch; ``time_s`` is the whole batch's
    wall clock."""
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    if pairs.size and not ((0 <= pairs).all() and (pairs < g.n).all()):
        raise ValueError(f"src/dst out of range for n={g.n}")
    return _dp_results(g, pairs, mesh, dt8, None)[1]


def time_batch_dp(g, pairs, mesh, *, repeats: int = 5, dt8: bool = False):
    """The ``dense.time_batch_graph`` protocol over the data-parallel
    batch: a warm-up, then ``repeats`` timed runs of the whole mesh's
    batch; the results carry the median."""
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    if pairs.size and not ((0 <= pairs).all() and (pairs < g.n).all()):
        raise ValueError(f"src/dst out of range for n={g.n}")
    return _dp_results(g, pairs, mesh, dt8, repeats)


def _padded_queries(pairs, b_pad: int, device):
    srcs = np.zeros(b_pad, np.int32)
    dsts = np.zeros(b_pad, np.int32)
    srcs[: len(pairs)] = pairs[:, 0]
    dsts[: len(pairs)] = pairs[:, 1]
    return (torch.from_numpy(srcs).to(device),
            torch.from_numpy(dsts).to(device))


def batch_dispatch(g, pairs, dt8: bool = False, stats: dict | None = None):
    """``dense._batch_dispatch``'s contract for modes ``minor`` /
    ``minor8``: ``(pairs, thunk, finish)``. The thunk runs the whole batch
    on the device and is the timed unit; ``finish(out)`` turns its output
    into the standard 6-tuple outside the timed region (under ``dt8``:
    the slot decode and the capped refill). ``pairs`` come normalized and
    range-checked; ``stats["host_syncs"]`` counts the loop's host reads."""
    n_pad2, wp, tc, b_pad = _minor_geometry(g, len(pairs), dt8)
    kern = _build_minor_kernel(n_pad2, wp, tc, b_pad, dt8, g.tier_meta)
    srcs, dsts = _padded_queries(pairs, b_pad, g.device)

    def thunk():
        return kern(g.nbr, g.deg, g.tiers, srcs, dsts, cache=g.tables,
                    stats=stats)

    if not dt8:
        return pairs, thunk, lambda out: out
    return pairs, thunk, lambda out: _finish_dt8(g, pairs, out)


def blocked_batch_dispatch(g, pairs, dt=None, stats: dict | None = None):
    """Dispatch one flush through the blocked kernel: one ``[2B, n_pad]``
    dual-side frontier plane rides each sweep of the tile table, so the
    whole flush shares the table. ``g`` is a
    :class:`~bibfs_tpu_torch.solvers.dense.BlockedDeviceGraph`; returns
    ``(pairs, thunk)``, the thunk the timed unit; the untimed epilogue
    (``dense._materialize_blocked_batch``) walks the paths from the dist
    planes over the host CSR. ``dt`` forces the plane type
    (:func:`~bibfs_tpu_torch.ops.blocked_expand.resolve_plane_dtype`);
    ``stats["host_syncs"]`` counts the loop's host reads."""
    from bibfs_tpu_torch.ops.blocked_expand import (
        chunk_block_rows,
        resolve_plane_dtype,
    )
    from bibfs_tpu_torch.solvers.dense import _build_blocked_kernel

    dt = resolve_plane_dtype(dt, g.device)
    b_pad = pad_batch(len(pairs))
    rc = min(chunk_block_rows(g.bwidth, 2 * b_pad, dt.itemsize, g.tile),
             g.nblocks)
    kern = _build_blocked_kernel(rc)
    srcs, dsts = _padded_queries(pairs, b_pad, g.device)

    def thunk():
        return kern(g.tab, g.bcol, g.deg, srcs, dsts, dt=dt, stats=stats)

    return pairs, thunk


def _finish_dt8(g, pairs, out):
    """The untimed int8 epilogue: slot-parent decode, then the refill."""
    return _refill_capped(g, pairs, _decode_slot_parents(g, out))


def _decode_slot_parents(g, out):
    """Decode the int8 search's slot-parent planes (``[B, n_pad2]``, slot s
    of row v meaning parent ``nbr[v, s]``) to int32 vertex ids, on the
    graph's device. The kernel stamps only slots of real hits, so a slot
    >= 0 indexes a live ELL entry."""
    best, meet, ps, pt, levels, edges = out[:6]
    nbr = g.nbr  # [n_pad, width]
    n_pad, width = nbr.shape

    def decode(slot_plane):
        s = slot_plane[:, :n_pad].long()
        vals = nbr.T.gather(0, s.clamp(0, width - 1))
        dec = torch.full(slot_plane.shape, -1, dtype=torch.int32,
                         device=slot_plane.device)
        dec[:, :n_pad] = torch.where(s >= 0, vals, -1)
        return dec

    return (best, meet, decode(ps), decode(pt), levels, edges) + tuple(out[6:])
