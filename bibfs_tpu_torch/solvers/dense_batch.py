"""The lock-step batch of the per-query dense modes on one device: B
searches advance together in one host loop over ``[B, n_pad]`` state,
the counterpart of the reference's vmapped search
(``bibfs_tpu/solvers/dense.py:1068-1093``, ``_side_step`` and the bodies
of ``_make_body`` under ``jax.vmap``).

Modes ``sync``, ``sync_unfused``, ``alt``, ``beamer``, ``beamer_alt``,
``pallas`` and ``pallas_alt`` (``fused`` / ``fused_alt`` arrive here as
``pallas`` / ``pallas_alt``, as both packages route a batch). Each round:

- one host read of the stacked ``[K, B]`` scalars (:data:`dense._HOST_KEYS`),
  from which each query's own stop rule (``dense._cond``) gives the
  active set; the loop ends when no query is active;
- the round's body over the active queries only. Where the reference's
  ``lax.cond`` becomes a per-query select under ``vmap`` (push or pull,
  which side under ``alt``), the queries are split into sets on the host
  and each set takes its branch; the torch level code
  (:mod:`bibfs_tpu_torch.ops.expand_batch`) and the pull kernels run on
  the rows of its set (``side`` per query under ``pallas_alt``), which
  are written back. A frozen query's rows are not touched, so a round
  costs the active queries' rows only.

A finished query takes no further step, so its state stays what its
single-query search ended with: each query's ``(best, meet, par_s,
par_t, levels, edges)`` is exactly :func:`dense.solve_dense_graph`'s.
``stats["host_syncs"]`` counts the reads: the rounds plus the final one.
On CUDA tensors the pull kernels launch or raise; CPU tensors run their
plain twins. The kernel modes also carry every query's frontier as one
query-packed plane (``st["plane"]``,
:func:`bibfs_tpu_torch.ops.pull_expand.seed_plane`): each round's kernel
reads it and writes the next one whole, a frozen query's bits copied.
"""

from __future__ import annotations

import numpy as np
import torch

from bibfs_tpu_torch.ops import expand_batch as xb
from bibfs_tpu_torch.solvers.dense import (
    _BIGI,
    _HOST_KEYS,
    DENSE_MODES,
    INF32,
    _full_tiers,
    _kernel_table,
    push_span,
)

# the modes a lock-step batch runs (the fused modes arrive as pallas)
LOCKSTEP_MODES = ("sync", "sync_unfused", "alt", "beamer", "beamer_alt",
                  "pallas", "pallas_alt")


def _read(st, stats) -> dict:
    """One device->host read of every query's round scalars."""
    vals = torch.stack([st[k].to(torch.int32) for k in _HOST_KEYS]).cpu().numpy()
    if stats is not None:
        stats["host_syncs"] += 1
    return dict(zip(_HOST_KEYS, vals))


def _cond(sc) -> np.ndarray:
    """Each query's stop rule (``dense._cond``) as a bool ``[B]``."""
    return ((sc["lvl_s"] + sc["lvl_t"] < sc["best"])
            & (sc["cnt_s"] > 0) & (sc["cnt_t"] > 0))


class _Rows:
    """The rows of a query set: ``idx`` is None when the set is the whole
    batch (the state's tensors are used as they are), else the set's
    indices on the device. :meth:`get` gathers a key's rows, :meth:`put`
    writes them back."""

    def __init__(self, mask: np.ndarray, device):
        self.mask = mask
        self.idx = (None if mask.all()
                    else torch.from_numpy(np.flatnonzero(mask)).to(device))

    def get(self, st, key):
        return st[key] if self.idx is None else st[key][self.idx]

    def put(self, st, **vals) -> None:
        for key, val in vals.items():
            if self.idx is None:
                st[key] = val
            else:
                st[key][self.idx] = val


def _init_state(n_pad: int, k: int, srcs, dsts, deg) -> dict:
    """The batched ``dense._init_state``: every query's single-query
    start, one row or entry per query."""
    dev = deg.device
    b = srcs.shape[0]
    q = torch.arange(b, device=dev)

    def side(v):
        fr = torch.zeros(b, n_pad, dtype=torch.bool, device=dev)
        fr[q, v] = True
        fi = torch.full((b, k), -1, dtype=torch.int32, device=dev)
        fi[:, 0] = v
        dist = torch.full((b, n_pad), INF32, dtype=torch.int32, device=dev)
        dist[q, v] = 0
        return dict(
            fr=fr, fi=fi, ok=torch.ones(b, dtype=torch.bool, device=dev),
            cnt=torch.ones(b, dtype=torch.int32, device=dev), md=deg[v],
            par=torch.full((b, n_pad), -1, dtype=torch.int32, device=dev),
            dist=dist, lvl=torch.zeros(b, dtype=torch.int32, device=dev),
        )

    same = srcs == dsts
    st = {f"{key}_s": val for key, val in side(srcs).items()}
    st.update({f"{key}_t": val for key, val in side(dsts).items()})
    st.update(
        best=torch.where(same, 0, INF32).to(torch.int32),
        meet=torch.where(same, srcs, -1).to(torch.int32),
        levels=torch.zeros(b, dtype=torch.int32, device=dev),
        edges=torch.zeros(b, dtype=torch.int32, device=dev),
    )
    return st


def _meet_vote(st, rows: _Rows, delta: int) -> None:
    """The batched ``dense._meet_vote`` on the rows of ``rows``."""
    ds, dt = rows.get(st, "dist_s"), rows.get(st, "dist_t")
    both = (ds < INF32) & (dt < INF32)
    sums = torch.where(both, ds + dt, INF32)
    cur = sums.amin(dim=1)
    ids = torch.arange(sums.shape[1], dtype=torch.int32, device=sums.device)
    arg = torch.where(sums == cur[:, None], ids, _BIGI).amin(dim=1)
    best, meet = rows.get(st, "best"), rows.get(st, "meet")
    rows.put(st, meet=torch.where(cur < best, arg, meet),
             best=torch.minimum(best, cur),
             levels=rows.get(st, "levels") + delta)


def _add_edges(st, rows: _Rows, scanned) -> None:
    rows.put(st, edges=rows.get(st, "edges") + scanned)


def _no(rows: _Rows, device):
    return torch.zeros(int(rows.mask.sum()), dtype=torch.bool, device=device)


def _pull_step(st, rows: _Rows, side: str, nbr, deg, tiers) -> None:
    """One side's torch pull on the rows of ``rows``."""
    fr = rows.get(st, f"fr_{side}")
    lvl = rows.get(st, f"lvl_{side}") + 1
    scanned = xb.frontier_degree_sum(fr, deg)
    nf, par, dist, md = xb.expand_pull_tiered(
        fr, rows.get(st, f"par_{side}"), rows.get(st, f"dist_{side}"), nbr,
        deg, tiers, lvl, inf=INF32)
    rows.put(st, **{f"fr_{side}": nf, f"par_{side}": par, f"dist_{side}": dist,
                    f"lvl_{side}": lvl, f"cnt_{side}": xb.frontier_count(nf),
                    f"md_{side}": md, f"ok_{side}": _no(rows, deg.device)})
    _add_edges(st, rows, scanned)


def _push_step(st, sc, rows: _Rows, side: str, nbr, deg, hub_rank,
               push_tiers) -> None:
    """One side's push on the rows of ``rows``. A query whose compact
    list is stale (a pull round made it) recomputes it first."""
    dev = deg.device
    k = st[f"fi_{side}"].shape[1]
    stale = rows.mask & (sc[f"ok_{side}"] == 0)
    if stale.any():
        fix = _Rows(stale, dev)
        fix.put(st, **{f"fi_{side}": xb.flatnonzero(fix.get(st, f"fr_{side}"),
                                                    k)})
    lvl = rows.get(st, f"lvl_{side}") + 1
    nf, fi, cnt, par, dist, scanned, md = xb.expand_push_tiered(
        rows.get(st, f"fi_{side}"), rows.get(st, f"par_{side}"),
        rows.get(st, f"dist_{side}"), nbr, deg, hub_rank, push_tiers, lvl,
        inf=INF32)
    rows.put(st, **{f"fr_{side}": nf, f"fi_{side}": fi, f"ok_{side}": cnt <= k,
                    f"par_{side}": par, f"dist_{side}": dist,
                    f"lvl_{side}": lvl, f"cnt_{side}": cnt, f"md_{side}": md})
    _add_edges(st, rows, scanned)


def _side_step(st, sc, mask: np.ndarray, side: str, nbr, deg, aux, tier_meta,
               push_cap: int) -> None:
    """The batched ``dense._side_step`` (torch level code) for the
    queries of ``mask``: those whose frontier is at most ``push_cap`` wide
    and whose max degree fits the push span push, the rest pull."""
    hub_rank = aux[0] if aux else None
    tiers = _full_tiers(aux, tier_meta)
    span, ncov = push_span(nbr.shape[1], tier_meta)
    push = np.zeros_like(mask)
    if push_cap > 0:
        push = (mask & (sc[f"cnt_{side}"] <= push_cap)
                & (sc[f"md_{side}"] <= span))
    if push.any():
        _push_step(st, sc, _Rows(push, deg.device), side, nbr, deg, hub_rank,
                   tiers[:ncov])
    if (mask & ~push).any():
        _pull_step(st, _Rows(mask & ~push, deg.device), side, nbr, deg, tiers)


def _dual_round(st, rows: _Rows, nbr, deg, tiers) -> None:
    """The pull-only lock-step round (``sync``): one gather per table
    chunk serves both sides of every active query."""
    fr_s, fr_t = rows.get(st, "fr_s"), rows.get(st, "fr_t")
    lvl_s = rows.get(st, "lvl_s") + 1
    lvl_t = rows.get(st, "lvl_t") + 1
    scanned = xb.frontier_degree_sum(fr_s, deg) + xb.frontier_degree_sum(fr_t, deg)
    nf_s, par_s, dist_s, md_s, nf_t, par_t, dist_t, md_t = \
        xb.expand_pull_dual_tiered(
            fr_s, fr_t, rows.get(st, "par_s"), rows.get(st, "dist_s"),
            rows.get(st, "par_t"), rows.get(st, "dist_t"), nbr, deg, tiers,
            lvl_s, lvl_t, inf=INF32)
    _put_dual(st, rows, deg, nf_s, par_s, dist_s, md_s, lvl_s, nf_t, par_t,
              dist_t, md_t, lvl_t, scanned)


def _put_dual(st, rows, deg, nf_s, par_s, dist_s, md_s, lvl_s, nf_t, par_t,
              dist_t, md_t, lvl_t, scanned) -> None:
    """Write a lock-step round's outputs back to the rows of ``rows``."""
    rows.put(st, fr_s=nf_s, par_s=par_s, dist_s=dist_s, md_s=md_s,
             cnt_s=xb.frontier_count(nf_s), lvl_s=lvl_s,
             ok_s=_no(rows, deg.device),
             fr_t=nf_t, par_t=par_t, dist_t=dist_t, md_t=md_t,
             cnt_t=xb.frontier_count(nf_t), lvl_t=lvl_t,
             ok_t=_no(rows, deg.device))
    _add_edges(st, rows, scanned)


def _qids(rows: _Rows):
    """The queries of ``rows`` as a plane kernel lists them: ascending, on
    the host."""
    return torch.from_numpy(np.flatnonzero(rows.mask))


def _kernel_dual_round(st, act: np.ndarray, nbr_t, deg, tiers) -> None:
    """A ``pallas`` round: kernel 3 on the active queries (their visited
    rows gathered when a query is frozen, so a round costs the active
    queries' rows only, and the plane's other bits copied), then the hub
    tiers, distances and counters."""
    from bibfs_tpu_torch.ops.pull_expand import plane_set, pull_dual_batch

    dev = deg.device
    n_pad = st["par_s"].shape[1]
    rows = _Rows(act, dev)
    qids = _qids(rows)
    dist_s, dist_t = rows.get(st, "dist_s"), rows.get(st, "dist_t")
    vis_s, vis_t = dist_s < INF32, dist_t < INF32
    nf_s, pc_s, nf_t, pc_t, plane = pull_dual_batch(
        nbr_t, deg, st["plane"], vis_s, vis_t, qids, checked=True)
    fr_s, fr_t = rows.get(st, "fr_s"), rows.get(st, "fr_t")
    scanned = xb.frontier_degree_sum(fr_s, deg) + xb.frontier_degree_sum(fr_t, deg)
    par_s = torch.where(nf_s, pc_s, rows.get(st, "par_s"))
    par_t = torch.where(nf_t, pc_t, rows.get(st, "par_t"))
    if tiers:
        nf_s, par_s, nf_t, par_t = xb.apply_tiers_dual(
            nf_s, par_s, nf_t, par_t, fr_s, fr_t, vis_s, vis_t, deg, tiers,
            n_pad)
        plane_set(plane_set(plane, qids, nf_s, 0), qids, nf_t, 1)
    st["plane"] = plane
    lvl_s = rows.get(st, "lvl_s") + 1
    lvl_t = rows.get(st, "lvl_t") + 1
    _put_dual(st, rows, deg,
              nf_s, par_s, xb.stamp(nf_s, dist_s, vis_s, lvl_s),
              xb.max_new_degree(nf_s, deg), lvl_s,
              nf_t, par_t, xb.stamp(nf_t, dist_t, vis_t, lvl_t),
              xb.max_new_degree(nf_t, deg), lvl_t, scanned)


def _kernel_single_round(st, act: np.ndarray, on_t: np.ndarray, nbr_t, deg,
                         tiers) -> None:
    """A ``pallas_alt`` round: kernel 4 on the active queries (as in
    :func:`_kernel_dual_round`), each expanding its own side (``on_t``:
    the target side), then each side's tiers, distances and counters on
    its rows."""
    from bibfs_tpu_torch.ops.pull_expand import plane_set, pull_single_batch

    dev = deg.device
    n_pad = st["par_s"].shape[1]
    rows = _Rows(act, dev)
    side_t = on_t[act]
    vis = {s: rows.get(st, f"dist_{s}") < INF32 for s in ("s", "t")}
    nf_all, pc_all, plane = pull_single_batch(
        nbr_t, deg, st["plane"], vis["s"], vis["t"],
        _qids(rows), torch.from_numpy(side_t), checked=True)
    out = dict(nf=nf_all, pc=pc_all)
    for side, pick in (("s", ~side_t), ("t", side_t)):
        if not pick.any():
            continue
        sub = _Rows(pick, dev)  # the side's rows among the active ones
        mine = _Rows(act & (on_t if side == "t" else ~on_t), dev)
        nf, pc = sub.get(out, "nf"), sub.get(out, "pc")
        v = sub.get(vis, side)
        fr = mine.get(st, f"fr_{side}")
        scanned = xb.frontier_degree_sum(fr, deg)
        par = torch.where(nf, pc, mine.get(st, f"par_{side}"))
        if tiers:
            nf, par = xb.apply_tiers(nf, par, fr, v, deg, tiers, n_pad)
            plane_set(plane, _qids(mine), nf, int(side == "t"))
        lvl = mine.get(st, f"lvl_{side}") + 1
        mine.put(st, **{
            f"fr_{side}": nf, f"par_{side}": par,
            f"dist_{side}": xb.stamp(nf, mine.get(st, f"dist_{side}"), v, lvl),
            f"lvl_{side}": lvl, f"cnt_{side}": xb.frontier_count(nf),
            f"md_{side}": xb.max_new_degree(nf, deg), f"ok_{side}": _no(mine, dev)})
        _add_edges(st, mine, scanned)
    st["plane"] = plane


def _make_body(mode: str, cap: int, tier_meta, nbr, deg, aux):
    """The round ``(st, sc, act) -> None`` (in place) for (mode, cap,
    tier layout): the batched bodies of ``dense._make_body``. Kernel
    modes get ``aux`` as ``((kernel table,), tier aux)``."""
    schedule, _hybrid, use_pallas = DENSE_MODES[mode]
    dev = deg.device
    if use_pallas:
        (nbr_t,), tier_aux = aux
        ktiers = _full_tiers(tier_aux, tier_meta)
        if schedule == "sync":
            def body(st, sc, act):
                _kernel_dual_round(st, act, nbr_t, deg, ktiers)
                _meet_vote(st, _Rows(act, dev), 2)
        else:
            def body(st, sc, act):
                _kernel_single_round(st, act, act & (sc["cnt_s"] > sc["cnt_t"]),
                                     nbr_t, deg, ktiers)
                _meet_vote(st, _Rows(act, dev), 1)
        return body

    def step(st, sc, mask, side):
        _side_step(st, sc, mask, side, nbr, deg, aux, tier_meta, cap)

    if mode == "sync":
        tiers = _full_tiers(aux, tier_meta)

        def body(st, sc, act):
            rows = _Rows(act, dev)
            _dual_round(st, rows, nbr, deg, tiers)
            _meet_vote(st, rows, 2)

    elif schedule == "sync":  # sync_unfused, beamer

        def body(st, sc, act):
            # the t-step reads only t-side scalars, which the s-step leaves
            step(st, sc, act, "s")
            step(st, sc, act, "t")
            _meet_vote(st, _Rows(act, dev), 2)

    else:  # alt, beamer_alt: the smaller frontier, ties to the source side

        def body(st, sc, act):
            on_s = act & (sc["cnt_s"] <= sc["cnt_t"])
            if on_s.any():
                step(st, sc, on_s, "s")
            if (act & ~on_s).any():
                step(st, sc, act & ~on_s, "t")
            _meet_vote(st, _Rows(act, dev), 1)

    return body


def lockstep_search(g, srcs, dsts, mode: str, push_cap: int, stats=None):
    """Run B searches of ``mode`` lock-step on the device graph ``g``
    (``srcs`` / ``dsts`` int64 tensors on its device): ``(best, meet,
    par_s [B, n_pad], par_t, levels, edges)``, each row the single-query
    search's, as tensors on the device."""
    if mode not in LOCKSTEP_MODES:
        raise ValueError(f"mode {mode!r} has no lock-step batch; have "
                         f"{list(LOCKSTEP_MODES)}")
    nbr, deg, aux = g.nbr, g.deg, g.aux
    n_pad = nbr.shape[0]
    cap = push_cap if DENSE_MODES[mode][1] else 0
    st = _init_state(n_pad, max(cap, 1), srcs, dsts, deg)
    if DENSE_MODES[mode][2]:
        from bibfs_tpu_torch.ops.pull_expand import check_pull, seed_plane

        table = _kernel_table(g.tables, nbr, deg)
        if nbr.device.type == "cuda":  # once; the rounds launch checked
            check_pull(table, deg, n_pad)
        aux = ((table,), aux)
        st["plane"] = seed_plane(srcs, dsts, n_pad)
    body = _make_body(mode, cap, g.tier_meta, nbr, deg, aux)
    while True:
        sc = _read(st, stats)
        act = _cond(sc)
        if not act.any():
            break
        body(st, sc, act)
    return (st["best"], st["meet"], st["par_s"], st["par_t"], st["levels"],
            st["edges"])
