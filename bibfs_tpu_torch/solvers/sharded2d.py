"""2D block-partitioned bidirectional BFS over an ``R x C`` grid of ranks:
the counterpart of ``bibfs_tpu/solvers/sharded2d.py``.

The 1D search ships the whole packed frontier to every rank each pull
level (n/8 bytes a rank). Here the adjacency is blocked over the grid
(Graph500-style 2D partitioning): rank ``(r, c)`` stores, for the
vertices of row range ``r`` (``n_pad / R`` of them), only their
neighbours inside column range ``c`` (``n_pad / C`` ids, stored
localized), and per-vertex state is 1D-sharded over all ``R C`` ranks in
row-major order (rank ``r C + c`` owns slice ``r C + c``). One level is
three exchanges, each over one axis of the grid
(:mod:`bibfs_tpu_torch.parallel.collectives`):

1. **transpose** (:func:`~bibfs_tpu_torch.parallel.collectives.
   transpose_permute`): each rank's packed owned slice goes, point to
   point, to the rank whose column gather needs it;
2. **expand** (:func:`~bibfs_tpu_torch.parallel.collectives.
   all_gather_rows`): the ranks of grid column ``c`` gather column range
   ``c``'s frontier, packed;
3. **fold** (:func:`~bibfs_tpu_torch.parallel.collectives.
   max_allreduce_cols`): each row range's parent candidates are
   max-reduced across its row; the fold's chunk ``c`` is the rank's owned
   slice.

Semantics are the reference's exactly: level-synchronous pull, the
parent the first hit slot within a block and the max across blocks, the
``lvl_s + lvl_t >= best`` stop, and ``sync`` (both sides a round, their
planes in one exchange) or ``alt`` (the smaller frontier). Hub groups
that exceed the base block width spill into geometric per-block overflow
tiers (a gather and a ``scatter_reduce(amax)`` each), as the reference
builds them; the block tables equal its ``Sharded2DGraph`` arrays.

The search is pull-only, as in the reference, and its level is torch
code (gathers and a scatter-max), as the reference's level runs outside
any Pallas kernel: no hand kernel is on this path.

:class:`Sharded2DHost` holds every block on the host (built once, saved
for the ranks to map); :class:`Sharded2DGraph` is one rank's block, and
:func:`solve_sharded2d_graph` the SPMD search every rank calls.
:func:`solve_sharded2d` and the ``"sharded2d"`` backend are
single-controller calls that spawn the ranks.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from bibfs_tpu_torch.graph.csr import canonical_pairs
from bibfs_tpu_torch.ops.bitmap import pack_bits, unpack_bits
from bibfs_tpu_torch.ops.expand import (
    _dual_hits,
    _first_true,
    _scatter_drop,
    pack_dual,
)
from bibfs_tpu_torch.parallel.collectives import (
    all_gather_rows,
    global_min_and_argmin,
    max_allreduce_cols,
    sum_allreduce,
    transpose_permute,
)
from bibfs_tpu_torch.solvers.api import BFSResult, register
from bibfs_tpu_torch.solvers.dense import INF32, _materialize

MODES_2D = ("sync", "alt")


def grid_shape(ndev: int, rows: int | None = None, cols: int | None = None
               ) -> tuple[int, int]:
    """``(rows, cols)`` of a grid of ``ndev`` ranks: the given shape (which
    must multiply to ``ndev``), else the squarest factorization, as the
    reference's ``Sharded2DGraph.build`` picks it."""
    if rows is None or cols is None:
        rows = int(np.sqrt(ndev))
        while ndev % rows:
            rows -= 1
        return rows, ndev // rows
    if rows * cols != ndev:
        raise ValueError(f"--grid {rows}x{cols} disagrees with "
                         f"num_devices={ndev}")
    return int(rows), int(cols)


class Sharded2DHost:
    """Every block of the grid on the host, in the reference's layout:
    ``bnbr [R, C, nr, W]`` localized neighbour ids, ``bcnt [R, C, nr]``
    the true group sizes, ``deg [n_pad]``, and per hub tier ``tiers[i] =
    (tnbr [R, C, K_pad, Wt], tids [R, C, K_pad])`` with ``tier_meta[i] =
    (start, K_pad, Wt)``. ``n_pad`` is a multiple of ``32 R C`` so each
    owned slice packs into whole words."""

    def __init__(self, *, n, n_pad, R, C, num_edges, width, max_group, bnbr,
                 bcnt, deg, tiers=(), tier_meta=()):
        self.n, self.n_pad, self.R, self.C = int(n), int(n_pad), int(R), int(C)
        self.num_edges = int(num_edges)
        self.width, self.max_group = int(width), int(max_group)
        self.n_loc = self.n_pad // (self.R * self.C)
        self.bnbr, self.bcnt, self.deg = bnbr, bcnt, deg
        self.tiers = tuple(tiers)
        self.tier_meta = tuple(tuple(int(x) for x in m) for m in tier_meta)

    @property
    def padded_slots(self) -> int:
        """Stored neighbour slots (base blocks and tier rows)."""
        base = self.R * self.C * (self.n_pad // self.R) * self.width
        return base + sum(self.R * self.C * kp * wt
                          for (_s, kp, wt) in self.tier_meta)

    @classmethod
    def build(cls, n: int, edges, R: int, C: int, *, pairs=None
              ) -> "Sharded2DHost":
        """The reference's block build (``Sharded2DGraph.__init__``), on
        the host: the base width minimizing stored slots, hub groups past
        it spilled into geometric tiers."""
        from bibfs_tpu_torch.graph.csr import (
            _BASE_WIDTHS,
            _pad_hub_count,
            _tier_plan,
        )

        pairs = canonical_pairs(n, edges) if pairs is None else pairs
        pad = 32 * R * C
        n_pad = -(-max(n, 1) // pad) * pad
        nr, nc = n_pad // R, n_pad // C
        u, v = pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)
        cb = v // nc  # column block of each directed edge's target
        gkey = u * C + cb  # consecutive groups: pairs sorted by (u, v)
        cmat = np.bincount(gkey, minlength=n_pad * C).reshape(n_pad, C)
        if pairs.size:
            firsts = np.zeros(gkey.size, dtype=np.int64)
            starts = np.flatnonzero(np.diff(gkey)) + 1
            firsts[starts] = starts
            np.maximum.accumulate(firsts, out=firsts)
            rank_blk = np.arange(gkey.size) - firsts
            w_max = int(rank_blk.max()) + 1
        else:
            rank_blk = np.zeros(0, dtype=np.int64)
            w_max = 1

        def tier_rows_pad(start: int) -> int:
            per_dev = (cmat > start).reshape(R, nr, C).sum(axis=1)
            k = int(per_dev.max())
            return _pad_hub_count(k) if k else 0

        def slots(w0: int) -> int:
            total = n_pad * C * w0
            for start, width in _tier_plan(w0, w_max):
                total += R * C * tier_rows_pad(start) * width
            return total

        w0 = min([w for w in _BASE_WIDTHS if w < w_max] + [w_max], key=slots)
        bnbr = np.zeros((R, C, nr, w0), dtype=np.int32)
        if pairs.size:
            sel = rank_blk < w0
            bnbr[u[sel] // nr, cb[sel], u[sel] % nr, rank_blk[sel]] = (
                v[sel] - cb[sel] * nc)
        bcnt = cmat.reshape(R, nr, C).transpose(0, 2, 1).astype(np.int32)
        bcnt = np.ascontiguousarray(bcnt)
        deg = np.zeros(n_pad, dtype=np.int32)
        deg[:n] = np.bincount(u, minlength=n)[:n]
        tiers, meta = [], []
        for start, wt in _tier_plan(w0, w_max):
            mu, mcb = np.nonzero(cmat > start)  # members, row-major order
            mdev = (mu // nr) * C + mcb
            order = np.argsort(mdev, kind="stable")
            mu, mcb, mdev = mu[order], mcb[order], mdev[order]
            tfirst = np.zeros(mdev.size, dtype=np.int64)
            tstarts = np.flatnonzero(np.diff(mdev)) + 1
            tfirst[tstarts] = tstarts
            np.maximum.accumulate(tfirst, out=tfirst)
            k_local = np.arange(mdev.size) - tfirst  # rank within its block
            k_pad = tier_rows_pad(start)
            tnbr = np.zeros((R, C, k_pad, wt), dtype=np.int32)
            tids = np.full((R, C, k_pad), -1, dtype=np.int32)
            tids[mu // nr, mcb, k_local] = (mu % nr).astype(np.int32)
            gk = np.full((n_pad, C), -1, dtype=np.int64)
            gk[mu, mcb] = k_local
            esel = (rank_blk >= start) & (rank_blk < start + wt)
            if esel.any():
                us, cbs = u[esel], cb[esel]
                tnbr[us // nr, cbs, gk[us, cbs], rank_blk[esel] - start] = (
                    v[esel] - cbs * nc).astype(np.int32)
            tiers.append((tnbr, tids))
            meta.append((start, k_pad, wt))
        return cls(n=n, n_pad=n_pad, R=R, C=C, num_edges=pairs.shape[0] // 2,
                   width=w0, max_group=w_max, bnbr=bnbr, bcnt=bcnt, deg=deg,
                   tiers=tiers, tier_meta=meta)

    def save(self, path: str) -> str:
        """Write the blocks (``.npy``) and sizes (``meta.json``) into
        directory ``path``, for ranks to map with :meth:`load`."""
        os.makedirs(path, exist_ok=True)
        meta = {"kind": "blocks2d", "n": self.n, "n_pad": self.n_pad,
                "R": self.R, "C": self.C, "num_edges": self.num_edges,
                "width": self.width, "max_group": self.max_group,
                "tier_meta": [list(m) for m in self.tier_meta]}
        for name in ("bnbr", "bcnt", "deg"):
            np.save(os.path.join(path, f"{name}.npy"), getattr(self, name))
        for i, (tnbr, tids) in enumerate(self.tiers):
            np.save(os.path.join(path, f"tnbr{i}.npy"), tnbr)
            np.save(os.path.join(path, f"tids{i}.npy"), tids)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
        return path

    @classmethod
    def load(cls, path: str) -> "Sharded2DHost":
        """The blocks :meth:`save` wrote, their arrays mapped read-only."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)

        def arr(name):
            return np.load(os.path.join(path, f"{name}.npy"), mmap_mode="r")

        tm = [tuple(m) for m in meta["tier_meta"]]
        return cls(n=meta["n"], n_pad=meta["n_pad"], R=meta["R"],
                   C=meta["C"], num_edges=meta["num_edges"],
                   width=meta["width"], max_group=meta["max_group"],
                   bnbr=arr("bnbr"), bcnt=arr("bcnt"), deg=arr("deg"),
                   tiers=[(arr(f"tnbr{i}"), arr(f"tids{i}"))
                          for i in range(len(tm))], tier_meta=tm)


class Sharded2DGraph:
    """This rank's block of a :class:`Sharded2DHost` on a 2D grid
    (:func:`~bibfs_tpu_torch.parallel.mesh.make_2d_mesh`): ``bnbr [nr,
    W]`` and ``bcnt [nr]`` of block ``(row, col)``, the degrees of its
    owned slice, and its tier rows ``(start, tnbr [K_pad, Wt], tids
    [K_pad])``; only this rank's arrays are read from a mapped host."""

    def __init__(self, host: Sharded2DHost, grid):
        if not hasattr(grid, "row_axis"):
            raise ValueError("Sharded2DGraph needs a 2D mesh (make_2d_mesh)")
        if (grid.R, grid.C) != (host.R, host.C):
            raise ValueError(f"blocks built for {host.R}x{host.C}, grid is "
                             f"{grid.R}x{grid.C}")
        self.mesh = grid
        self.R, self.C = host.R, host.C
        self.n, self.n_pad, self.n_loc = host.n, host.n_pad, host.n_loc
        self.num_edges, self.width = host.num_edges, host.width
        self.max_group, self.tier_meta = host.max_group, host.tier_meta
        r, c = grid.row, grid.col
        self.offset = grid.rank * self.n_loc
        put = self._put
        self.bnbr = put(host.bnbr[r, c])
        self.bcnt = put(host.bcnt[r, c])
        self.deg = put(host.deg[self.offset:self.offset + self.n_loc])
        self.tiers = tuple((start, put(tnbr[r, c]), put(tids[r, c]))
                           for (start, _kp, _wt), (tnbr, tids)
                           in zip(host.tier_meta, host.tiers))
        self.ids = self.offset + torch.arange(self.n_loc, dtype=torch.int32,
                                              device=grid.device)

    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(
            self.mesh.device)

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @classmethod
    def build(cls, n: int, edges, grid, *, pairs=None) -> "Sharded2DGraph":
        """Build the blocks (every rank the same) and keep this rank's."""
        return cls(Sharded2DHost.build(n, edges, grid.R, grid.C, pairs=pairs),
                   grid)


# ---- the search -------------------------------------------------------------

def _scalar(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def _init_state(g: Sharded2DGraph, src: int, dst: int) -> dict:
    dev = g.device
    st = {}
    for side, v in (("s", src), ("t", dst)):
        fr = g.ids == v
        st.update({
            f"fr_{side}": fr, f"cnt_{side}": _scalar(1, dev),
            f"par_{side}": torch.full((g.n_loc,), -1, dtype=torch.int32,
                                      device=dev),
            f"dist_{side}": torch.where(fr, 0, INF32).to(torch.int32),
            f"lvl_{side}": _scalar(0, dev),
        })
    st.update(best=_scalar(0 if src == dst else INF32, dev),
              meet=_scalar(src if src == dst else -1, dev),
              levels=_scalar(0, dev), edges=_scalar(0, dev))
    return st


def _column_frontier(g: Sharded2DGraph, planes) -> torch.Tensor:
    """The transpose and the row-axis gather of ``planes`` (``[k, n_loc]``
    bool, this rank's owned slice per side): ``bool[k, n_pad / C]``, the
    sides' frontiers over column range ``col``."""
    k = planes.shape[0]
    nw = g.n_loc // 32  # n_loc is a multiple of 32 by construction
    words = torch.stack([pack_bits(p, nw) for p in planes])  # [k, nw]
    allw = all_gather_rows(transpose_permute(words, g.mesh), g.mesh)
    nc = g.n_pad // g.C
    return torch.stack([unpack_bits(allw[:, i, :].reshape(-1), nc)
                        for i in range(k)])


def _block_cands(g: Sharded2DGraph, vals, bits) -> list:
    """Each side's candidate parent per row-range vertex from one gather
    of the column frontier over the block (``vals``: bool ``[nr, W]`` for
    one side, or the dual codes with ``bits`` (1, 2)) and its tiers:
    the first hit slot's neighbour globalized, -1 without a hit, a hub
    tier's verdict max-scattered in."""
    nr, w = g.bnbr.shape
    base = g.mesh.col * (g.n_pad // g.C)
    valid = torch.arange(w, device=g.device)[None, :] < g.bcnt[:, None]
    gathered = vals(g.bnbr.long())
    tier_vals = [(start, tnbr, tids, vals(tnbr.long()))
                 for start, tnbr, tids in g.tiers]
    cands = []
    for bit in bits:
        hits = (_dual_hits(gathered, valid, bit) if bit
                else gathered & valid)
        p = g.bnbr.gather(1, _first_true(hits)[:, None])[:, 0]
        cand = torch.where(hits.any(dim=1), p + base, -1).to(torch.int32)
        for start, tnbr, tids, tv in tier_vals:
            wt = tnbr.shape[1]
            ids_c = torch.clamp(tids, 0, nr - 1).long()
            scnt = torch.clamp(g.bcnt[ids_c] - start, 0, wt)
            tvalid = ((torch.arange(wt, device=g.device)[None, :]
                       < scnt[:, None]) & (tids >= 0)[:, None])
            thits = _dual_hits(tv, tvalid, bit) if bit else tv & tvalid
            tany = thits.any(dim=1)
            tp = tnbr.gather(1, _first_true(thits)[:, None])[:, 0]
            tcand = torch.where(tany, tp + base, -1)
            tgt = torch.where(tany, ids_c, nr)  # nr: dropped
            cand = _scatter_drop(cand, tgt, tcand, "amax")
        cands.append(cand)
    return cands


def _claim(g: Sharded2DGraph, st, side: str, fold) -> None:
    """The fold's chunk ``col`` (this rank's owned slice) claims the
    unvisited vertices with a candidate."""
    chunk = fold[g.mesh.col * g.n_loc:(g.mesh.col + 1) * g.n_loc]
    nf = (chunk >= 0) & (st[f"dist_{side}"] >= INF32)
    st[f"par_{side}"] = torch.where(nf, chunk, st[f"par_{side}"])
    st[f"dist_{side}"] = torch.where(nf, st[f"lvl_{side}"] + 1,
                                     st[f"dist_{side}"])
    st[f"fr_{side}"] = nf
    st[f"lvl_{side}"] = st[f"lvl_{side}"] + 1


def _meet_vote(g: Sharded2DGraph, st, delta: int):
    both = (st["dist_s"] < INF32) & (st["dist_t"] < INF32)
    sums = torch.where(both, st["dist_s"] + st["dist_t"], INF32)
    i = torch.argmin(sums)
    gmin, garg = global_min_and_argmin(sums[i], g.ids[i], g.mesh)
    st["meet"] = torch.where(gmin < st["best"], garg, st["meet"])
    st["best"] = torch.minimum(st["best"], gmin)
    st["levels"] = st["levels"] + delta
    return st


def _frontier_degrees(g: Sharded2DGraph, *frs):
    return torch.stack([torch.where(fr, g.deg, 0).sum(dtype=torch.int32)
                        for fr in frs])


def _sync_round(g: Sharded2DGraph, st):
    """Both sides a round: their planes in one transpose and one row
    gather, one block gather of the dual codes serving both, the two
    folds stacked."""
    st = dict(st)
    scanned = sum_allreduce(_frontier_degrees(g, st["fr_s"], st["fr_t"]),
                            g.mesh)
    f_col = _column_frontier(g, torch.stack([st["fr_s"], st["fr_t"]]))
    packed = pack_dual(f_col[0], f_col[1])
    cands = _block_cands(g, lambda idx: packed[idx], (1, 2))
    fold = max_allreduce_cols(torch.stack(cands), g.mesh)
    for i, side in enumerate("st"):
        _claim(g, st, side, fold[i])
    cnt = sum_allreduce(torch.stack([st["fr_s"].sum(dtype=torch.int32),
                                     st["fr_t"].sum(dtype=torch.int32)]),
                        g.mesh)
    st["cnt_s"], st["cnt_t"] = cnt[0], cnt[1]
    st["edges"] = st["edges"] + scanned[0] + scanned[1]
    return _meet_vote(g, st, 2)


def _alt_round(g: Sharded2DGraph, st, side: str):
    """The smaller frontier's side a level (the host chose ``side``)."""
    st = dict(st)
    scanned = sum_allreduce(_frontier_degrees(g, st[f"fr_{side}"]), g.mesh)
    f_col = _column_frontier(g, st[f"fr_{side}"][None])[0]
    (cand,) = _block_cands(g, lambda idx: f_col[idx], (0,))
    _claim(g, st, side, max_allreduce_cols(cand, g.mesh))
    st[f"cnt_{side}"] = sum_allreduce(
        st[f"fr_{side}"].sum(dtype=torch.int32), g.mesh)
    st["edges"] = st["edges"] + scanned[0]
    return _meet_vote(g, st, 1)


_HOST_KEYS = ("lvl_s", "lvl_t", "best", "cnt_s", "cnt_t")


def _read(st, stats) -> dict:
    """One read of the round's replicated scalars."""
    vals = torch.stack([st[k] for k in _HOST_KEYS]).tolist()
    if stats is not None:
        stats["host_syncs"] += 1
    return dict(zip(_HOST_KEYS, vals))


def _active(sc: dict) -> bool:
    return (sc["lvl_s"] + sc["lvl_t"] < sc["best"]
            and sc["cnt_s"] > 0 and sc["cnt_t"] > 0)


def make_round(g: Sharded2DGraph, mode: str):
    """The round ``(st, sc) -> st`` of ``mode`` (``sync`` or ``alt``);
    ``sc`` is the host's reading of the scalars (:func:`_read`). Shared by
    the one-shot search and the checkpointed chunks."""
    if mode == "sync":
        return lambda st, sc: _sync_round(g, st)
    if mode == "alt":
        return lambda st, sc: _alt_round(
            g, st, "s" if sc["cnt_s"] <= sc["cnt_t"] else "t")
    raise ValueError(f"sharded2d supports modes 'sync' and 'alt', got {mode!r}")


def gather_rows(g: Sharded2DGraph, *rows):
    """Every rank's owned slices concatenated in rank order: global
    ``int32[n_pad]`` rows (the row-major layout puts slice ``s`` at
    ``[s n_loc, (s + 1) n_loc)``)."""
    allr = g.mesh.all_gather(torch.stack(rows))  # [size, k, n_loc]
    return tuple(allr[:, i].reshape(-1) for i in range(len(rows)))


def _search(g: Sharded2DGraph, src: int, dst: int, mode: str, stats):
    body = make_round(g, mode)
    st = _init_state(g, src, dst)
    while True:
        sc = _read(st, stats)
        if not _active(sc):
            break
        st = body(st, sc)
    par_s, par_t = gather_rows(g, st["par_s"], st["par_t"])
    return (sc["best"], int(st["meet"]), par_s, par_t, int(st["levels"]),
            int(st["edges"]))


def _check_pair(g, src: int, dst: int) -> None:
    if not (0 <= src < g.n and 0 <= dst < g.n):
        raise ValueError(f"src/dst out of range for n={g.n}")


def solve_sharded2d_graph(g: Sharded2DGraph, src: int, dst: int, *,
                          mode: str = "sync") -> BFSResult:
    """Search a 2D-blocked graph; every rank calls it (SPMD) and gets the
    same result (``time_s`` this rank's clock, ``host_syncs`` its scalar
    reads)."""
    from bibfs_tpu_torch.solvers.timing import force_scalar

    _check_pair(g, src, dst)
    stats = {"host_syncs": 0}
    t0 = time.perf_counter()
    out = _search(g, src, dst, mode, stats)
    force_scalar(out)
    return _materialize(out, time.perf_counter() - t0, mode=mode,
                        host_syncs=stats["host_syncs"])


def raw_sharded2d(g: Sharded2DGraph, src: int, dst: int, mode: str = "sync"):
    """One search's raw ``(best, meet, par_s, par_t, levels, edges)``, the
    parent rows over ``n_pad`` as numpy (the reference's program
    outputs)."""
    _check_pair(g, src, dst)
    o = _search(g, src, dst, mode, None)
    return (int(o[0]), int(o[1]), o[2].cpu().numpy(), o[3].cpu().numpy(),
            int(o[4]), int(o[5]))


def time_search_2d(g: Sharded2DGraph, src: int, dst: int, *,
                   repeats: int = 30, mode: str = "sync"
                   ) -> tuple[list[float], BFSResult]:
    """The shared timing protocol on every rank (warm-up excluded, CUDA
    events on a card); the result carries the median."""
    from bibfs_tpu_torch.solvers.timing import timed_repeats

    _check_pair(g, src, dst)
    return timed_repeats(lambda: _search(g, src, dst, mode, None),
                         lambda: solve_sharded2d_graph(g, src, dst, mode=mode),
                         repeats, device=g.device)


def _check_pairs(g, pairs) -> np.ndarray:
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    if pairs.size and not ((0 <= pairs).all() and (pairs < g.n).all()):
        raise ValueError(f"src/dst out of range for n={g.n}")
    return pairs


def solve_batch_sharded2d_graph(g: Sharded2DGraph, pairs, *,
                                mode: str = "sync") -> list[BFSResult]:
    """Many queries through the grid program, one after another (each
    result equals its own solve, as the reference's ``vmap`` gives);
    every ``time_s`` is the whole batch's wall clock."""
    pairs = _check_pairs(g, pairs)
    t0 = time.perf_counter()
    results = [solve_sharded2d_graph(g, int(s), int(d), mode=mode)
               for s, d in pairs]
    elapsed = time.perf_counter() - t0
    for r in results:
        r.time_s = elapsed
    return results


def time_batch_sharded2d(g: Sharded2DGraph, pairs, *, repeats: int = 5,
                         mode: str = "sync"
                         ) -> tuple[list[float], list[BFSResult]]:
    """A 2D batch under the shared timing protocol; the results carry the
    median."""
    from bibfs_tpu_torch.solvers.timing import timed_batch_repeats

    pairs = _check_pairs(g, pairs)
    times, _ = timed_batch_repeats(
        lambda: [_search(g, int(s), int(d), mode, None) for s, d in pairs],
        repeats, device=g.device)
    results = solve_batch_sharded2d_graph(g, pairs, mode=mode)
    med = float(np.median(times))
    for r in results:
        r.time_s = med
    return times, results


def frontier_exchange_bytes_2d(n_pad: int, R: int, C: int) -> dict:
    """Bytes a rank sends a pull level, by exchange (the reference's
    accounting): the transpose (its packed slice, point to point), the
    row-axis gather, the column-axis max of int32 candidates, and the 1D
    gather's bytes for comparison."""
    n_loc = n_pad // (R * C)
    return {
        "transpose_ppermute": n_loc // 8,
        "expand_all_gather_r": (R - 1) * (n_loc // 8),
        "fold_pmax_c": 4 * (n_pad // R),
        "oneD_all_gather_equiv": n_pad // 8,
    }


def solve_sharded2d(n: int, edges, src: int, dst: int, *,
                    rows: int | None = None, cols: int | None = None,
                    num_devices: int | None = None, mode: str = "sync",
                    device=None, repeats: int = 1) -> BFSResult:
    """One query on a ``rows x cols`` grid of ranks spawned on this host
    (default: the squarest grid of every card; one rank with ``device
    "cpu"`` unless a shape or ``num_devices`` is given). The blocks are
    built once here; rank 0's result is returned."""
    return _single_controller(n, edges, [(src, dst)], rows, cols, num_devices,
                              mode, device, repeats, batch=False)


def solve_batch_sharded2d(n: int, edges, pairs, *, rows=None, cols=None,
                          num_devices=None, mode: str = "sync", device=None,
                          repeats: int = 1) -> list[BFSResult]:
    """:func:`solve_batch_sharded2d_graph` (with ``repeats > 1``
    :func:`time_batch_sharded2d`) through spawned ranks."""
    return _single_controller(n, edges, pairs, rows, cols, num_devices, mode,
                              device, repeats, batch=True)


def _single_controller(n, edges, pairs, rows, cols, num_devices, mode, device,
                       repeats, *, batch: bool):
    from bibfs_tpu_torch.parallel.mesh import launch
    from bibfs_tpu_torch.solvers.sharded import sharded_jobs
    from bibfs_tpu_torch.utils.platform import resolve_device

    if mode not in MODES_2D:
        raise ValueError(f"sharded2d supports modes 'sync' and 'alt', got "
                         f"{mode!r}")
    dev = resolve_device(device)
    if num_devices is None and rows is not None and cols is not None:
        num_devices = rows * cols
    ndev = num_devices or (torch.cuda.device_count() if dev.type == "cuda"
                           else 1)
    rows, cols = grid_shape(ndev, rows, cols)
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    if pairs.size and not ((0 <= pairs).all() and (pairs < n).all()):
        raise ValueError(f"src/dst out of range for n={n}")
    host = Sharded2DHost.build(n, edges, rows, cols)
    job = dict(kind="batch2d" if batch else "solve2d", graph="g",
               grid=(rows, cols), mode=mode, repeats=repeats)
    if batch:
        job["pairs"] = pairs
    else:
        job.update(src=int(pairs[0, 0]), dst=int(pairs[0, 1]))
    out = launch(sharded_jobs, ndev, {"g": host}, [job], device=dev.type)
    return out["results"][0]


@register("sharded2d")
def _sharded2d_backend(n, edges, src, dst, mode="sync", rows=None, cols=None,
                       num_devices=None, device=None, **_):
    return solve_sharded2d(n, edges, src, dst, rows=rows, cols=cols,
                           num_devices=num_devices, mode=mode, device=device)
