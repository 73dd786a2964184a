"""Multi-device bidirectional BFS, vertex-sharded over a 1D mesh: the
counterpart of ``bibfs_tpu/solvers/sharded.py``.

Every rank of a :class:`~bibfs_tpu_torch.parallel.mesh.Mesh` runs the same
search (SPMD) over its own rows: the ELL table, degrees, distances and
parents are 1D-sharded (rank ``r`` owns global rows ``[r n_loc, (r + 1)
n_loc)``), and hub tiers of the tiered layout are sharded by hub rank
with their rank-to-vertex maps replicated. Scalar state (frontier counts,
max degrees, levels, best, meet, edges) is replicated: every rank applies
the same all-reduced values, and the host reads one replicated scalar row
a round, so every rank takes the same branch. The exchanges are the
reference's:

- a pull gathers the expanding side's frontier, packed 32 vertices a
  word (:func:`~bibfs_tpu_torch.parallel.collectives.all_gather_bits`);
  a lock-step pull round packs both sides into one gather;
- a push (Beamer's switch by ``kernel_cap``) gathers the candidate
  targets of the replicated frontier list and claims by scatter-max of
  the source (``par[t] = max(src)``), the winners' flags all-reduced;
- one gather per hub tier carries each hub's verdict (the first hit
  slot's neighbour, -1 without a hit);
- the meet vote is a global (min, lowest global id).

The kernel modes run the level kernels per rank over the local rows with
the global frontier (the reference's ``id_space``): ``pallas`` runs kernel
3 on the gathered pair row, ``pallas_alt`` (and ``fused_alt``, which has
no sharded program in the reference either) kernel 4 on a gathered
bitmap, and ``fused`` on plain ELL kernel 1 plus the fold, its bitmaps
gathered and its reductions all-reduced each round with the state on the
device (one host read per ``unroll`` rounds). A tiered ``fused`` takes the
layout route to ``pallas``, as the dense search does; the result records
the mode that ran. On CUDA tensors a kernel launches or raises.

:func:`solve_sharded` and the ``"sharded"`` backend are single-controller
calls: they build the host graph, spawn the ranks
(:func:`~bibfs_tpu_torch.parallel.mesh.launch`) and return rank 0's
answer. Inside ranks, :class:`ShardedGraph` and
:func:`solve_sharded_graph` are the SPMD API.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from bibfs_tpu_torch.graph.csr import (
    EllGraph,
    HubTier,
    TieredEllGraph,
    build_ell,
    build_tiered,
)
from bibfs_tpu_torch.ops.bitmap import frontier_words, pack_bits, unpack_pairs
from bibfs_tpu_torch.ops.expand import (
    _dual_hits,
    _fill_drop,
    _first_true,
    _scatter_drop,
    expand_pull,
    expand_pull_dual,
    frontier_count,
    frontier_degree_sum,
    max_new_degree,
    pack_dual,
)
from bibfs_tpu_torch.parallel.collectives import (
    all_gather_bits,
    all_gather_bits_dual,
    gather_bitmap,
    gather_pairs,
    global_min_and_argmin,
    max_allreduce,
    sum_allreduce,
)
from bibfs_tpu_torch.solvers.api import BFSResult, register
from bibfs_tpu_torch.solvers.dense import (
    DENSE_MODES,
    INF32,
    _cond,
    _flatnonzero,
    _materialize,
    _read_scalars,
    kernel_cap,
    push_span,
)

SHARDED_MODES = DENSE_MODES  # the same matrix
_BIG64 = (1 << 63) - 1
# a search's raw outputs; the reference's sharded search shares all six
# with its dense search of the same mode (parent rows over the first n
# rows), on plain and tiered graphs (tests/test_torch_sharded_cases.py
# asserts it), so chip_smoke.py holds the port's sharded answers on the
# card to its dense ones on all six
RAW_FIELDS = ("best", "meet", "par_s", "par_t", "levels", "edges")


def resolve_sharded_mode(mode: str, tier_meta: tuple = ()) -> str:
    """The mode that runs on the mesh: ``fused_alt`` as ``pallas_alt``
    (the reference has no sharded alt-schedule fused program), a tiered
    ``fused`` as ``pallas`` (the layout route)."""
    if mode not in SHARDED_MODES:
        raise ValueError(f"unknown sharded mode {mode!r}; have "
                         f"{sorted(SHARDED_MODES)}")
    if mode == "fused_alt" or (mode == "fused" and tier_meta):
        return "pallas_alt" if mode == "fused_alt" else "pallas"
    return mode


def default_pad_multiple(ndev: int) -> int:
    """The vertex padding a graph sharded over ``ndev`` ranks needs: the
    int32 sublane quantum per rank (the same for every mode)."""
    return 8 * ndev


class ShardedGraph:
    """This rank's shard of a host graph (:class:`EllGraph` or
    :class:`TieredEllGraph`, arrays possibly memory-mapped: only this
    rank's rows are read and uploaded). Tier tables are re-padded to a
    multiple of ``8 * size`` hub ranks and sharded by rank; each tier
    keeps its rank-to-vertex map ``tids`` replicated and its per-rank slot
    counts ``tslots``. ``tier_meta`` holds ``(start, count, width,
    count_pad)`` per tier."""

    def __init__(self, g, mesh):
        ndev = mesh.size
        if g.n_pad % ndev:
            raise ValueError(
                f"n_pad={g.n_pad} not divisible by {ndev} devices; build "
                f"with pad_multiple a multiple of the mesh size"
            )
        if isinstance(g, EllGraph) and g.overflow.shape[0]:
            raise NotImplementedError(
                "EllGraph has width_cap overflow edges; use build_tiered "
                "(tiered ELL) for skewed-degree graphs instead of width_cap"
            )
        self.mesh = mesh
        self.n = int(g.n)
        self.n_pad = int(g.n_pad)
        self.width = int(g.width)
        self.num_edges = int(g.num_edges)
        self.n_loc = self.n_pad // ndev
        self.offset = mesh.rank * self.n_loc
        rows = slice(self.offset, self.offset + self.n_loc)
        put = self._put
        self.nbr = put(g.nbr[rows])
        self.deg = put(g.deg[rows])
        self.ids = self.offset + torch.arange(self.n_loc, dtype=torch.int32,
                                              device=mesh.device)
        self.hub_rank = None
        self.tiers: tuple = ()
        self.tier_meta: tuple = ()
        self.tables: dict = {}
        if isinstance(g, TieredEllGraph) and g.tiers:
            deg = np.asarray(g.deg)
            hub_ids = np.asarray(g.hub_ids)
            tiers, meta = [], []
            for t in g.tiers:
                cpad = -(-t.nbr.shape[0] // (8 * ndev)) * (8 * ndev)
                h_loc = cpad // ndev
                lo = mesh.rank * h_loc
                hi = min(lo + h_loc, t.nbr.shape[0])
                tnbr = np.zeros((h_loc, t.nbr.shape[1]), dtype=np.int32)
                if hi > lo:
                    tnbr[: hi - lo] = t.nbr[lo:hi]
                tids = np.full(cpad, -1, dtype=np.int32)
                tids[: min(t.count, cpad)] = hub_ids[: t.count]
                tslots = np.zeros(cpad, dtype=np.int32)
                tslots[: t.count] = np.clip(
                    deg[hub_ids[: t.count]] - t.start, 0, t.nbr.shape[1])
                tiers.append((put(tnbr), put(tslots[lo:lo + h_loc]),
                              put(tids)))
                meta.append((int(t.start), int(t.count), int(t.nbr.shape[1]),
                             int(cpad)))
            self.hub_rank = put(g.hub_rank[rows])
            self.tiers = tuple(tiers)
            self.tier_meta = tuple(meta)

    def _put(self, a) -> torch.Tensor:
        """A private int32 copy of ``a`` on this rank's device (mapped
        arrays are read-only, so every upload copies)."""
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(self.mesh.device)

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def id_space(self) -> int:
        return self.n_pad

    def table(self) -> torch.Tensor:
        """The level kernels' slot-major table of the local rows, its dead
        slots at the global sentinel ``n_pad``; built once."""
        if "nbr_t" not in self.tables:
            from bibfs_tpu_torch.ops.pull_expand import sentinel_transposed_table

            self.tables["nbr_t"] = sentinel_transposed_table(
                self.nbr, self.deg, self.id_space)
        return self.tables["nbr_t"]

    @classmethod
    def build(cls, n: int, edges: np.ndarray, mesh, *, layout: str = "ell",
              pad_multiple: int | None = None, pairs=None) -> "ShardedGraph":
        """Build the host graph (every rank builds the same one) and keep
        this rank's shard. ``pad_multiple`` defaults to ``8 * size``."""
        return cls(build_host_graph(n, edges, mesh.size, layout=layout,
                                    pad_multiple=pad_multiple, pairs=pairs),
                   mesh)


def build_host_graph(n: int, edges, ndev: int, *, layout: str = "ell",
                     pad_multiple: int | None = None, pairs=None):
    """The host ELL (or tiered) graph a mesh of ``ndev`` ranks shards."""
    pm = pad_multiple if pad_multiple is not None else default_pad_multiple(ndev)
    if pm % ndev:
        raise ValueError(f"pad_multiple={pm} must be a multiple of the "
                         f"{ndev}-device mesh")
    if layout == "tiered":
        return build_tiered(n, edges, pad_multiple=pm, pairs=pairs)
    if layout == "ell":
        return build_ell(n, edges, pad_multiple=pm, pairs=pairs)
    raise ValueError(f"unknown layout {layout!r} (expected 'ell' or 'tiered')")


# ---- host graphs on disk: one build, mapped by every rank ------------------

def save_host_graph(g, path: str) -> str:
    """Write a host graph's arrays (``.npy``) and sizes (``meta.json``)
    into directory ``path``, for ranks to map with
    :func:`load_host_graph` instead of rebuilding it."""
    os.makedirs(path, exist_ok=True)
    meta = {"n": int(g.n), "n_pad": int(g.n_pad), "width": int(g.width),
            "num_edges": int(g.num_edges)}
    np.save(os.path.join(path, "nbr.npy"), np.asarray(g.nbr))
    np.save(os.path.join(path, "deg.npy"), np.asarray(g.deg))
    if isinstance(g, TieredEllGraph):
        meta.update(kind="tiered", max_deg=int(g.max_deg),
                    tiers=[[int(t.start), int(t.count)] for t in g.tiers])
        np.save(os.path.join(path, "hub_rank.npy"), g.hub_rank)
        np.save(os.path.join(path, "hub_ids.npy"), g.hub_ids)
        for i, t in enumerate(g.tiers):
            np.save(os.path.join(path, f"tier{i}.npy"), t.nbr)
    else:
        meta["kind"] = "ell"
        np.save(os.path.join(path, "overflow.npy"), g.overflow)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    return path


def load_host_graph(path: str):
    """The graph :func:`save_host_graph` (or :meth:`~bibfs_tpu_torch.
    solvers.sharded2d.Sharded2DHost.save`) wrote, its arrays mapped
    read-only."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta["kind"] == "blocks2d":
        from bibfs_tpu_torch.solvers.sharded2d import Sharded2DHost

        return Sharded2DHost.load(path)

    def arr(name):
        return np.load(os.path.join(path, f"{name}.npy"), mmap_mode="r")

    sizes = dict(n=meta["n"], n_pad=meta["n_pad"], width=meta["width"],
                 num_edges=meta["num_edges"])
    if meta["kind"] == "ell":
        return EllGraph(nbr=arr("nbr"), deg=arr("deg"),
                        overflow=np.asarray(arr("overflow")), **sizes)
    tiers = tuple(HubTier(start=s, count=c, nbr=arr(f"tier{i}"))
                  for i, (s, c) in enumerate(meta["tiers"]))
    return TieredEllGraph(nbr=arr("nbr"), deg=arr("deg"),
                          hub_rank=arr("hub_rank"), hub_ids=arr("hub_ids"),
                          tiers=tiers, max_deg=meta["max_deg"], **sizes)


# ---- the search -------------------------------------------------------------

def _scalar(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def _init_state(g: ShardedGraph, k: int, src: int, dst: int, kind: str | None):
    """Round 0 on this rank: each side's frontier (its one vertex where
    this rank owns it), the replicated frontier list and the global degree
    of each end (one all-reduce). ``kind`` adds the kernels' frontier rows
    over the local rows: ``"pair"`` (kernel 3) or ``"bits"`` (kernel 4)."""
    dev = g.device
    fr = {s: g.ids == v for s, v in (("s", src), ("t", dst))}
    md = sum_allreduce(torch.stack([torch.where(fr[s], g.deg, 0).sum(
        dtype=torch.int32) for s in "st"]), g.mesh)
    st = {}
    for i, (side, v) in enumerate((("s", src), ("t", dst))):
        fi = torch.full((k,), -1, dtype=torch.int32, device=dev)
        fi[0] = v
        st.update({
            f"fr_{side}": fr[side], f"fi_{side}": fi,
            f"ok_{side}": torch.tensor(True, device=dev),
            f"cnt_{side}": _scalar(1, dev), f"md_{side}": md[i],
            f"par_{side}": torch.full((g.n_loc,), -1, dtype=torch.int32,
                                      device=dev),
            f"dist_{side}": torch.where(fr[side], 0, INF32).to(torch.int32),
            f"lvl_{side}": _scalar(0, dev),
        })
        if kind == "bits":
            st[f"bits_{side}"] = pack_bits(fr[side], frontier_words(g.n_loc))
    if kind == "pair":
        from bibfs_tpu_torch.ops.pull_expand import pack_front

        st["front"] = pack_front(fr["s"], fr["t"], g.n_loc)
    st.update(
        best=_scalar(0 if src == dst else INF32, dev),
        meet=_scalar(src if src == dst else -1, dev),
        levels=_scalar(0, dev),
        edges=_scalar(0, dev),
    )
    return st


def _meet_vote(g: ShardedGraph, st, delta: int):
    """The local minimum of ``dist_s + dist_t`` at its lowest id, then the
    global (min, lowest global id) across the mesh."""
    both = (st["dist_s"] < INF32) & (st["dist_t"] < INF32)
    sums = torch.where(both, st["dist_s"] + st["dist_t"], INF32)
    i = torch.argmin(sums)
    gmin, garg = global_min_and_argmin(sums[i], g.ids[i], g.mesh)
    st["meet"] = torch.where(gmin < st["best"], garg, st["meet"])
    st["best"] = torch.minimum(st["best"], gmin)
    st["levels"] = st["levels"] + delta
    return st


def _owned(g: ShardedGraph, tids):
    """Local rows of the global ids ``tids`` this rank owns: ``(own,
    tloc, tclip)``."""
    tloc = tids - g.offset
    own = (tloc >= 0) & (tloc < g.n_loc) & (tids >= 0)
    return own, tloc, torch.where(own, tloc, 0).long()


def _tier_verdicts(hits, tnbr):
    """Each local hub row's verdict: the neighbour in its first hit slot,
    -1 without a hit."""
    p = tnbr.gather(1, _first_true(hits)[:, None])[:, 0]
    return torch.where(hits.any(dim=1), p, -1)


def _tier_claim(g: ShardedGraph, nf, par, dist, par_all, tids):
    """Scatter the gathered hub verdicts ``par_all`` (rank-ordered, one a
    hub) into this rank's rows: an unvisited owned hub with a verdict
    joins the frontier and its parent is the max of both candidates."""
    own, tloc, tclip = _owned(g, tids)
    new = own & (par_all >= 0) & (dist[tclip] >= INF32)
    t2 = torch.where(new, tloc, g.n_loc).long()
    return _fill_drop(nf, t2), _scatter_drop(par, t2, par_all, "amax")


def _pull(g: ShardedGraph, st, side: str, use_kernel: bool):
    """One side's pull level: one packed frontier gather, the local rows
    claimed (kernel 4 on the card), one gather per hub tier."""
    mesh = g.mesh
    fr, par, dist = st[f"fr_{side}"], st[f"par_{side}"], st[f"dist_{side}"]
    lvl_next = st[f"lvl_{side}"] + 1
    scanned = frontier_degree_sum(fr, g.deg)
    visited = dist < INF32
    extra = {}
    if use_kernel:
        from bibfs_tpu_torch.ops.bitmap import unpack_bits
        from bibfs_tpu_torch.ops.pull_expand import pull_single

        nw = -(-g.n_loc // 32)
        bits = gather_bitmap(st[f"bits_{side}"][:nw], g.n_loc, mesh,
                             g.id_space)
        nf, pcand, nbits = pull_single(g.table(), g.deg, bits, visited,
                                       id_space=g.id_space, checked=True)
        f_glob = unpack_bits(bits, g.id_space) if g.tiers else None
    else:
        f_glob = all_gather_bits(fr, mesh)
        nf, pcand = expand_pull(f_glob, visited, g.nbr, g.deg)
    par = torch.where(nf, pcand, par)
    for (_s, _c, twidth, _cp), (tnbr, tslots, tids) in zip(g.tier_meta,
                                                           g.tiers):
        cols = torch.arange(twidth, device=g.device)[None, :]
        hits = f_glob[tnbr.long()] & (cols < tslots[:, None])
        par_all = mesh.all_gather(_tier_verdicts(hits, tnbr)).reshape(-1)
        nf, par = _tier_claim(g, nf, par, dist, par_all, tids)
    if use_kernel:
        extra[f"bits_{side}"] = (pack_bits(nf, nbits.shape[0]) if g.tiers
                                 else nbits)
    dist = torch.where(nf & (dist >= INF32), lvl_next, dist)
    sums = sum_allreduce(torch.stack([scanned, frontier_count(nf)]), mesh)
    md = max_allreduce(max_new_degree(nf, g.deg), mesh)
    ok = torch.tensor(False, device=g.device)
    return nf, st[f"fi_{side}"], ok, par, dist, lvl_next, sums[1], md, \
        sums[0], extra


def _push(g: ShardedGraph, st, side: str, sc: dict, k: int, push_tiers):
    """One side's push level over the replicated frontier list: owners
    expand their entries, the candidate targets are gathered, each owner
    claims its targets by scatter-max of the source, and the winners'
    flags are all-reduced into the next replicated list."""
    mesh = g.mesh
    dev = g.device
    fr, fi = st[f"fr_{side}"], st[f"fi_{side}"]
    par, dist = st[f"par_{side}"], st[f"dist_{side}"]
    lvl_next = st[f"lvl_{side}"] + 1
    if not sc[f"ok_{side}"]:
        # pull -> push: rebuild the replicated list from the local frontiers
        loc = _flatnonzero(fr, k)
        loc = torch.where(loc >= 0, loc + g.offset, -1)
        allv = mesh.all_gather(loc).reshape(-1)
        live = allv >= 0
        pos = torch.cumsum(live, 0) - 1
        outpos = torch.where(live & (pos < k), pos, k)
        fi = torch.full((k + 1,), -1, dtype=torch.int32, device=dev)
        fi.scatter_(0, outpos, allv)
        fi = fi[:k]
    mine = (fi >= g.offset) & (fi < g.offset + g.n_loc)
    floc = torch.where(mine, fi - g.offset, 0).long()
    if push_tiers:
        packed = sum_allreduce(torch.where(
            mine, torch.stack([g.deg[floc], g.hub_rank[floc] + 1]), 0), mesh)
        vd, franks = packed[0], packed[1] - 1
    else:
        vd = sum_allreduce(torch.where(mine, g.deg[floc], 0), mesh)
    cols = torch.arange(g.width, device=dev)[None, :]
    parts_rows = [g.nbr[floc]]
    parts_valid = [mine[:, None] & (cols < torch.clamp(vd, max=g.width)[:, None])]
    for (_s, _c, twidth, _cp), (tnbr, tslots, _tids) in push_tiers:
        h_loc = tnbr.shape[0]
        r_off = mesh.rank * h_loc
        mine_r = (franks >= r_off) & (franks < r_off + h_loc)
        rloc = torch.where(mine_r, franks - r_off, 0).long()
        tcols = torch.arange(twidth, device=dev)[None, :]
        parts_rows.append(tnbr[rloc])
        parts_valid.append(mine_r[:, None] & (tcols < tslots[rloc][:, None]))
    rows = torch.cat(parts_rows, dim=1)
    valid = torch.cat(parts_valid, dim=1)
    wtot = rows.shape[1]
    tgt_all = mesh.all_gather(torch.where(valid, rows, -1).reshape(-1)
                              ).reshape(-1)
    src_all = fi[:, None].expand(k, wtot).reshape(-1).repeat(mesh.size)
    own, tloc, tclip = _owned(g, tgt_all)
    new = own & (dist[tclip] >= INF32)
    t2 = torch.where(new, tloc, g.n_loc).long()
    dist = _scatter_drop(dist, t2, lvl_next.expand(t2.shape), "amin")
    par = _scatter_drop(par, t2, src_all, "amax")
    win_loc = new & (par[tclip] == src_all)
    win = sum_allreduce(win_loc.to(torch.int32), mesh) > 0
    nf = _fill_drop(torch.zeros(g.n_loc, dtype=torch.bool, device=dev), t2)
    pos = torch.cumsum(win, 0) - 1
    outpos = torch.where(win & (pos < k), pos, k)
    nfi = torch.full((k + 1,), -1, dtype=torch.int32, device=dev)
    nfi.scatter_(0, outpos, tgt_all)
    cnt = win.sum(dtype=torch.int32)
    md = max_allreduce(torch.where(win_loc, g.deg[tclip], 0).max(), mesh)
    scanned = vd.sum(dtype=torch.int32)
    return nf, nfi[:k], cnt <= k, par, dist, lvl_next, cnt, md, scanned, {}


def _side_step(g: ShardedGraph, st, sc, side: str, *, push_cap: int,
               use_kernel: bool):
    """Advance one side one level: push when Beamer's switch says so
    (the frontier at most ``push_cap`` wide and its max degree within the
    push span), else pull."""
    span, ncov = push_span(g.width, g.tier_meta)
    if (push_cap > 0 and sc[f"cnt_{side}"] <= push_cap
            and sc[f"md_{side}"] <= span):
        k = st[f"fi_{side}"].shape[0]
        out = _push(g, st, side, sc, k,
                    tuple(zip(g.tier_meta, g.tiers))[:ncov])
    else:
        out = _pull(g, st, side, use_kernel)
    nf, fi, ok, par, dist, lvl, cnt, md, scanned, extra = out
    return {
        **st, f"fr_{side}": nf, f"fi_{side}": fi, f"ok_{side}": ok,
        f"par_{side}": par, f"dist_{side}": dist, f"lvl_{side}": lvl,
        f"cnt_{side}": cnt, f"md_{side}": md,
        "edges": st["edges"] + scanned, **extra,
    }


def _dual_round(g: ShardedGraph, st, use_kernel: bool):
    """A pull-only lock-step round: one exchange carries both sides (the
    dual code, or kernel 3's pair row), one table pass claims both, one
    stacked gather per hub tier."""
    mesh = g.mesh
    fr_s, fr_t = st["fr_s"], st["fr_t"]
    vis_s, vis_t = st["dist_s"] < INF32, st["dist_t"] < INF32
    scanned = torch.stack([frontier_degree_sum(fr_s, g.deg),
                           frontier_degree_sum(fr_t, g.deg)])
    extra = {}
    if use_kernel:
        from bibfs_tpu_torch.ops.pull_expand import pack_front, pull_dual

        nw = -(-g.n_loc // 16)
        pair = gather_pairs(st["front"][:nw], g.n_loc, mesh, g.id_space)
        nf_s, pc_s, nf_t, pc_t, nfront = pull_dual(
            g.table(), g.deg, pair, vis_s, vis_t, id_space=g.id_space,
            checked=True)
        packed = pack_dual(*unpack_pairs(pair, g.id_space)) if g.tiers else None
    else:
        packed = all_gather_bits_dual(fr_s, fr_t, mesh)
        nf_s, pc_s, nf_t, pc_t = expand_pull_dual(packed, vis_s, vis_t,
                                                  g.nbr, g.deg)
    par_s = torch.where(nf_s, pc_s, st["par_s"])
    par_t = torch.where(nf_t, pc_t, st["par_t"])
    for (_s, _c, twidth, _cp), (tnbr, tslots, tids) in zip(g.tier_meta,
                                                           g.tiers):
        cols = torch.arange(twidth, device=g.device)[None, :]
        valid = cols < tslots[:, None]
        vals = packed[tnbr.long()]
        verdicts = torch.stack([_tier_verdicts(_dual_hits(vals, valid, bit),
                                               tnbr) for bit in (1, 2)])
        allv = mesh.all_gather(verdicts)  # [ndev, 2, h_loc]
        nf_s, par_s = _tier_claim(g, nf_s, par_s, st["dist_s"],
                                  allv[:, 0].reshape(-1), tids)
        nf_t, par_t = _tier_claim(g, nf_t, par_t, st["dist_t"],
                                  allv[:, 1].reshape(-1), tids)
    if use_kernel:
        extra["front"] = pack_front(nf_s, nf_t, g.n_loc) if g.tiers else nfront
    dist_s = torch.where(nf_s & ~vis_s, st["lvl_s"] + 1, st["dist_s"])
    dist_t = torch.where(nf_t & ~vis_t, st["lvl_t"] + 1, st["dist_t"])
    sums = sum_allreduce(torch.cat([scanned, torch.stack(
        [frontier_count(nf_s), frontier_count(nf_t)])]), mesh)
    md = max_allreduce(torch.stack([max_new_degree(nf_s, g.deg),
                                    max_new_degree(nf_t, g.deg)]), mesh)
    no = torch.tensor(False, device=g.device)
    st = {
        **st,
        "fr_s": nf_s, "par_s": par_s, "dist_s": dist_s, "cnt_s": sums[2],
        "md_s": md[0], "lvl_s": st["lvl_s"] + 1, "ok_s": no,
        "fr_t": nf_t, "par_t": par_t, "dist_t": dist_t, "cnt_t": sums[3],
        "md_t": md[1], "lvl_t": st["lvl_t"] + 1, "ok_t": no,
        "edges": st["edges"] + sums[0] + sums[1], **extra,
    }
    return _meet_vote(g, st, 2)


def _make_body(g: ShardedGraph, mode: str, cap: int):
    """The round ``(st, sc) -> st`` of ``mode`` (already resolved)."""
    schedule, _hybrid, use_kernel = SHARDED_MODES[mode]
    use_kernel = bool(use_kernel)

    def step(st, sc, side):
        return _side_step(g, st, sc, side, push_cap=cap, use_kernel=use_kernel)

    if schedule == "sync" and cap == 0 and mode != "sync_unfused":
        return lambda st, sc: _dual_round(g, st, use_kernel)
    if schedule == "sync":
        return lambda st, sc: _meet_vote(g, step(step(st, sc, "s"), sc, "t"), 2)

    def alt_body(st, sc):
        return _meet_vote(g, step(st, sc, "s" if sc["cnt_s"] <= sc["cnt_t"]
                                  else "t"), 1)

    return alt_body


def _gather_rows(g: ShardedGraph, *rows):
    """The local rows of every rank, concatenated: ``int32[n_pad]`` each."""
    allr = g.mesh.all_gather(torch.stack(rows))  # [ndev, k, n_loc]
    return tuple(allr[:, i].reshape(-1) for i in range(len(rows)))


def _search(g: ShardedGraph, src: int, dst: int, mode: str, cap: int, stats):
    """The torch-composed and pull-kernel modes: one replicated scalar
    read a round on the host, the round on every rank."""
    k = max(cap, 1)
    use_kernel = SHARDED_MODES[mode][2]
    kind = None
    if use_kernel:
        from bibfs_tpu_torch.ops.pull_expand import check_pull

        kind = "pair" if SHARDED_MODES[mode][0] == "sync" else "bits"
        if g.device.type == "cuda":  # once; the rounds launch checked
            check_pull(g.table(), g.deg, g.n_loc)
    st = _init_state(g, k, src, dst, kind)
    body = _make_body(g, mode, cap)
    while True:
        sc = _read_scalars(st, stats)
        if not _cond(sc):
            break
        st = body(st, sc)
    par_s, par_t = _gather_rows(g, st["par_s"], st["par_t"])
    return (sc["best"], sc["meet"], par_s, par_t, sc["levels"], sc["edges"])


def _fused_search(g: ShardedGraph, src: int, dst: int, unroll: int, stats):
    """Mode ``fused`` on plain ELL: kernel 1 over the local rows with the
    global bitmaps, then per round one gather of both sides' new local
    words, one all-reduce of the counts and degree sums and one (min) of
    the meet key and the negated max degrees, and the fold; the host reads
    the replicated state once per ``unroll`` rounds. Rounds past the end
    do nothing; their exchanges carry stale words no round reads."""
    from bibfs_tpu_torch.ops.fused_level import (
        NO_MEET,
        S,
        active,
        check_round,
        fold_round,
        fused_dual_round,
        new_frontier,
        new_scratch,
    )

    mesh = g.mesh
    dev = g.device
    nbr_t = g.table()
    n_loc, ids = g.n_loc, g.id_space
    dist_s = torch.where(g.ids == src, 0, INF32).to(torch.int32)
    dist_t = torch.where(g.ids == dst, 0, INF32).to(torch.int32)
    par_s = torch.full((n_loc,), -1, dtype=torch.int32, device=dev)
    par_t = par_s.clone()
    bits = new_frontier(src, dst, ids, dev)  # global, the same on every rank
    ends = sum_allreduce(torch.stack([
        torch.where(g.ids == v, g.deg, 0).sum(dtype=torch.int32)
        for v in (src, dst)]), mesh)
    same = src == dst
    # new_state's row, with each end's degree read across the mesh
    d_s, d_t = ends.tolist()
    state = torch.tensor([0, 0, 0 if same else INF32, src if same else -1,
                          1, 1, d_s, d_t, d_s, d_t, 0, 0], dtype=torch.int32,
                         device=dev)
    acc, key = new_scratch(dev)
    if dev.type == "cuda":  # the buffers of every round, checked once
        check_round(nbr_t, g.deg, bits, dist_s, dist_t, par_s, par_t, state,
                    acc, key, id_space=ids)
    nw = -(-n_loc // 32)
    sums_at = torch.tensor([0, 1, 4, 5], device=dev)  # acc's cnt and ds slots
    rnd = 0
    while True:
        for _ in range(unroll):
            fused_dual_round(nbr_t, g.deg, bits, dist_s, dist_t, par_s, par_t,
                             state, acc, key, id_space=ids,
                             row_offset=g.offset, checked=True)
            p = (rnd + 1) & 1  # both sides advance together: parity of rnd + 1
            bits[:, p] = gather_bitmap(bits[:, p, :nw], n_loc, mesh, ids)
            sums = sum_allreduce(acc[sums_at], mesh)
            mins = mesh.all_reduce(torch.stack([
                torch.where(key[0] == NO_MEET, _BIG64, key[0]),
                -acc[2].long(), -acc[3].long()]), "min")
            acc[sums_at] = sums
            acc[2:4] = (-mins[1:]).to(torch.int32)
            key[0] = torch.where(mins[0] == _BIG64, NO_MEET, mins[0])
            fold_round(state, acc, key, alt=False, checked=True)
            rnd += 1
        sc = state.tolist()
        if stats is not None:
            stats["host_syncs"] += 1
        if not active(sc):
            break
    par_s, par_t = _gather_rows(g, par_s, par_t)
    return (sc[S["best"]], sc[S["meet"]], par_s, par_t, sc[S["levels"]],
            sc[S["edges"]])


def _run(g: ShardedGraph, src: int, dst: int, mode: str, unroll: int,
         stats, push_cap: int | None = None):
    """``(ran_mode, out)`` of one search on every rank; ``push_cap``
    overrides the mode's cap (Beamer modes only)."""
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")
    ran = resolve_sharded_mode(mode, g.tier_meta)
    if ran == "fused":
        return ran, _fused_search(g, src, dst, unroll, stats)
    cap = kernel_cap(ran, g.n_pad, g.device.type)
    if push_cap is not None and SHARDED_MODES[ran][1]:
        cap = push_cap
    return ran, _search(g, src, dst, ran, cap, stats)


def _check_pair(g: ShardedGraph, src: int, dst: int) -> None:
    if not (0 <= src < g.n and 0 <= dst < g.n):
        raise ValueError(f"src/dst out of range for n={g.n}")


def solve_sharded_graph(g: ShardedGraph, src: int, dst: int, *,
                        mode: str = "sync", unroll: int = 1,
                        push_cap: int | None = None) -> BFSResult:
    """Search a sharded graph; every rank calls it (SPMD) and every rank
    gets the same result. ``time_s`` covers the search (this rank's
    clock), ``host_syncs`` its replicated-scalar reads, ``mode`` the mode
    that ran. ``unroll`` is the fused mode's rounds per host read (exact
    for every value)."""
    from bibfs_tpu_torch.solvers.timing import force_scalar

    _check_pair(g, src, dst)
    stats = {"host_syncs": 0}
    t0 = time.perf_counter()
    ran, out = _run(g, src, dst, mode, unroll, stats, push_cap)
    force_scalar(out)
    elapsed = time.perf_counter() - t0
    return _materialize(out, elapsed, mode=ran, host_syncs=stats["host_syncs"])


def time_search(g: ShardedGraph, src: int, dst: int, *, repeats: int = 30,
                mode: str = "sync", unroll: int = 1
                ) -> tuple[list[float], BFSResult]:
    """Warm-up, ``repeats`` timed searches (CUDA events on a card) and one
    materializing solve, on every rank; ``result.time_s`` is the median."""
    from bibfs_tpu_torch.solvers.timing import timed_repeats

    _check_pair(g, src, dst)
    return timed_repeats(
        lambda: _run(g, src, dst, mode, unroll, None)[1],
        lambda: solve_sharded_graph(g, src, dst, mode=mode, unroll=unroll),
        repeats, device=g.device,
    )


def solve_batch_sharded_graph(g: ShardedGraph, pairs, *, mode: str = "sync"
                              ) -> list[BFSResult]:
    """Solve many queries through the collective program, one after
    another: each result equals its own solve (what the reference's
    ``vmap`` of the program gives). Every ``time_s`` is the whole batch's
    wall clock, as in ``dense.solve_batch_graph``."""
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    if pairs.size and not ((0 <= pairs).all() and (pairs < g.n).all()):
        raise ValueError(f"src/dst out of range for n={g.n}")
    t0 = time.perf_counter()
    results = [solve_sharded_graph(g, int(s), int(d), mode=mode)
               for s, d in pairs]
    elapsed = time.perf_counter() - t0
    for r in results:
        r.time_s = elapsed
    return results


def time_batch_sharded(g: ShardedGraph, pairs, *, repeats: int = 5,
                       mode: str = "sync") -> tuple[list[float], list[BFSResult]]:
    """A sharded batch under the shared timing protocol (warm-up excluded,
    CUDA events on a card); the results carry the median."""
    from bibfs_tpu_torch.solvers.timing import timed_batch_repeats

    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    if pairs.size and not ((0 <= pairs).all() and (pairs < g.n).all()):
        raise ValueError(f"src/dst out of range for n={g.n}")

    def dispatch():
        return [_run(g, int(s), int(d), mode, 1, None)[1] for s, d in pairs]

    times, _ = timed_batch_repeats(dispatch, repeats, device=g.device)
    results = solve_batch_sharded_graph(g, pairs, mode=mode)
    med = float(np.median(times))
    for r in results:
        r.time_s = med
    return times, results


# ---- single-controller calls --------------------------------------------------

class RankJobs:
    """One rank's graphs and its job loop: the body of the
    single-controller calls (:func:`sharded_jobs` under
    :func:`~bibfs_tpu_torch.parallel.mesh.launch`) and of every rank of a
    :class:`~bibfs_tpu_torch.parallel.pool.MeshPool`, which keeps one
    across calls. Graphs are registered by key (a host graph, or a
    directory :func:`save_host_graph` or :meth:`~bibfs_tpu_torch.solvers.
    sharded2d.Sharded2DHost.save` wrote); the rank builds what a job needs
    from one on demand (its 1D shard, its data-parallel replica, its 2D
    block) and keeps it until :meth:`release`."""

    def __init__(self, mesh, graphs: dict | None = None):
        self.mesh = mesh
        self.sources: dict = dict(graphs or {})
        self.hosts: dict = {}
        self.built: dict = {}  # (key, what) -> shard / replica / 2D block

    def add(self, key, graph) -> None:
        """Register ``graph`` (a host graph or a directory) under ``key``."""
        self.release(key)
        self.sources[key] = graph

    def release(self, key) -> None:
        """Forget ``key`` and everything built from it."""
        self.sources.pop(key, None)
        self.hosts.pop(key, None)
        for k in [k for k in self.built if k[0] == key]:
            del self.built[k]

    def host(self, key):
        if key not in self.hosts:
            src = self.sources[key]
            self.hosts[key] = load_host_graph(src) if isinstance(src, str) \
                else src
        return self.hosts[key]

    def shard(self, key) -> ShardedGraph:
        if (key, "1d") not in self.built:
            self.built[key, "1d"] = ShardedGraph(self.host(key), self.mesh)
        return self.built[key, "1d"]

    def replica(self, key):
        if (key, "dp") not in self.built:
            from bibfs_tpu_torch.solvers.dense import DeviceGraph

            h = self.host(key)
            self.built[key, "dp"] = (
                DeviceGraph.from_tiered(h, self.mesh.device)
                if isinstance(h, TieredEllGraph)
                else DeviceGraph.from_ell(h, self.mesh.device))
        return self.built[key, "dp"]

    def blocks(self, key):
        """This rank's 2D block of ``key`` (blocks built for a grid that
        covers every rank), on that grid."""
        if (key, "2d") not in self.built:
            from bibfs_tpu_torch.parallel.mesh import make_2d_mesh
            from bibfs_tpu_torch.solvers.sharded2d import Sharded2DGraph

            h = self.host(key)
            self.built[key, "2d"] = Sharded2DGraph(h, make_2d_mesh(h.R, h.C))
        return self.built[key, "2d"]

    def graph_for(self, key, substrate: str):
        """The graph a checkpoint job runs on: ``"1d"`` the shard, ``"2d"``
        the block."""
        return self.blocks(key) if substrate == "2d" else self.shard(key)

    def run(self, jobs: list, info: bool = True) -> dict:
        """Run ``jobs`` in order (:func:`sharded_jobs` lists the kinds).
        Returns ``{"results": [...], "launches": [...], "transport": ...}``
        and, with ``info``, every rank's placement after the jobs
        (:func:`~bibfs_tpu_torch.parallel.mesh.rank_info`) under
        ``"ranks"``."""
        results, launches = [], []
        for job in jobs:
            before = kernel_launches()
            results.append(self._job(job))
            after = kernel_launches()
            mine = {k: after[k] - before[k] for k in after}
            launches.append({k: sum(d[k] for d in
                                    self.mesh.all_gather_object(mine))
                             for k in mine})
        out = {"results": results, "launches": launches,
               "transport": self.mesh.transport}
        if info:
            from bibfs_tpu_torch.parallel.mesh import rank_info

            out["ranks"] = rank_info(self.mesh)
        return out

    def _job(self, job: dict):
        from bibfs_tpu_torch.solvers import sharded2d as s2
        from bibfs_tpu_torch.solvers.batch_minor import (
            solve_batch_dp,
            time_batch_dp,
        )

        key, kind = job.get("graph"), job["kind"]
        reps = job.get("repeats", 1)
        if kind == "call":
            import importlib

            mod, name = job["fn"].split(":")
            return getattr(importlib.import_module(mod), name)(
                self, **job.get("args", {}))
        if kind == "dp":
            if reps > 1:
                return time_batch_dp(self.replica(key), job["pairs"],
                                     self.mesh, repeats=reps,
                                     dt8=job.get("dt8", False))[1]
            return solve_batch_dp(self.replica(key), job["pairs"], self.mesh,
                                  dt8=job.get("dt8", False))
        if kind in ("checkpoint", "resume"):
            from bibfs_tpu_torch.solvers import checkpoint as ck

            g = self.graph_for(key, job.get("substrate", "1d"))
            kw = dict(chunk=job.get("chunk", 8),
                      max_chunks=job.get("max_chunks"))
            if kind == "resume":
                return ck.resume(job["path"], g, src=int(job["src"]),
                                 dst=int(job["dst"]), mode=job.get("mode"),
                                 **kw)
            return ck.solve_checkpointed(g, int(job["src"]), int(job["dst"]),
                                         mode=job.get("mode", "sync"),
                                         path=job.get("path"), **kw)
        if kind in ("solve2d", "batch2d", "exchange2d"):
            g = self.blocks(key)
            mode = job.get("mode", "sync")
            if kind == "exchange2d":
                return exchange2d_ms(g, job.get("reps", 25))
            if kind == "batch2d":
                if reps > 1:
                    return s2.time_batch_sharded2d(g, job["pairs"],
                                                   repeats=reps, mode=mode)[1]
                return s2.solve_batch_sharded2d_graph(g, job["pairs"],
                                                      mode=mode)
            src, dst = int(job["src"]), int(job["dst"])
            if job.get("raw"):
                return s2.raw_sharded2d(g, src, dst, mode)
            if reps > 1:
                return s2.time_search_2d(g, src, dst, repeats=reps,
                                         mode=mode)[1]
            return s2.solve_sharded2d_graph(g, src, dst, mode=mode)
        g = self.shard(key)
        if kind == "solve" and job.get("raw"):
            return _raw_job(g, job)
        if kind == "exchange":
            return exchange_ms(g, job.get("reps", 25))
        if kind == "profile":
            return profile_search(g, int(job["src"]), int(job["dst"]),
                                  mode=job.get("mode", "fused"),
                                  repeats=job.get("repeats", 5))
        if kind == "solve" and reps > 1:
            return time_search(g, int(job["src"]), int(job["dst"]),
                               repeats=reps, mode=job.get("mode", "sync"),
                               unroll=job.get("unroll", 1))[1]
        if kind == "solve":
            return solve_sharded_graph(
                g, int(job["src"]), int(job["dst"]),
                mode=job.get("mode", "sync"), unroll=job.get("unroll", 1),
                push_cap=job.get("push_cap"))
        if kind == "batch" and reps > 1:
            return time_batch_sharded(g, job["pairs"], repeats=reps,
                                      mode=job.get("mode", "sync"))[1]
        if kind == "batch":
            return solve_batch_sharded_graph(g, job["pairs"],
                                             mode=job.get("mode", "sync"))
        raise ValueError(f"unknown job kind {kind!r}")


def sharded_jobs(mesh, graphs: dict, jobs: list) -> dict:
    """The rank body of the single-controller calls (run under
    :func:`~bibfs_tpu_torch.parallel.mesh.launch`): register ``graphs`` (a
    host graph or a directory each) and run ``jobs`` in order
    (:class:`RankJobs`), each a dict with ``kind``:

    - ``"solve"`` (``graph``, ``src``, ``dst``, ``mode``, ``unroll``,
      ``push_cap``, ``repeats``: the median of that many timed searches;
      ``raw``: :func:`_raw_job`'s outputs in place of the result),
      ``"batch"`` (``graph``, ``pairs``, ``mode``, ``repeats``),
      ``"exchange"`` (``graph``, ``reps``: :func:`exchange_ms`) or
      ``"profile"`` (``graph``, ``src``, ``dst``, ``mode``, ``repeats``:
      :func:`profile_search`), on the 1D shard;
    - ``"dp"`` (``graph``, ``pairs``, ``dt8``, ``repeats``): the
      data-parallel batch over a replicated copy;
    - ``"solve2d"`` / ``"batch2d"`` / ``"exchange2d"``: the same on the 2D
      block of a :class:`~bibfs_tpu_torch.solvers.sharded2d.Sharded2DHost`
      graph (``raw``: :func:`~bibfs_tpu_torch.solvers.sharded2d.
      raw_sharded2d`'s outputs);
    - ``"checkpoint"`` (``graph``, ``substrate`` ``"1d"`` or ``"2d"``,
      ``src``, ``dst``, ``mode``, ``chunk``, ``path``, ``max_chunks``) and
      ``"resume"`` (the same, ``mode`` None keeping the file's):
      :mod:`~bibfs_tpu_torch.solvers.checkpoint` on the ranks, rank 0
      writing the file;
    - ``"call"`` (``fn`` ``"module:function"``, ``args``): ``function(rank
      jobs, **args)`` on every rank, a probe's hook (its graphs through
      this rank's :class:`RankJobs`).

    Returns ``{"results": [...], "launches": [...], "transport": ...,
    "ranks": [...]}``: per job its result and the kernel launches it
    made, summed over the ranks; then every rank's placement after the
    jobs."""
    return RankJobs(mesh, graphs).run(jobs)


def _raw_job(g: ShardedGraph, job: dict) -> tuple:
    """One search's mode that ran and raw ``(best, meet, par_s, par_t,
    levels, edges)``, the parent rows as numpy; with ``raw="digest"`` the
    rows' first ``n`` entries as SHA-256 digests instead, and the
    materialized :class:`BFSResult` last (a path to validate)."""
    import hashlib

    src, dst = int(job["src"]), int(job["dst"])
    _check_pair(g, src, dst)
    ran, o = _run(g, src, dst, job.get("mode", "sync"), job.get("unroll", 1),
                  None, job.get("push_cap"))
    rows = [o[2].cpu().numpy(), o[3].cpu().numpy()]
    if job["raw"] != "digest":
        return (ran, int(o[0]), int(o[1]), *rows, int(o[4]), int(o[5]))
    dig = [hashlib.sha256(r[: g.n].tobytes()).hexdigest() for r in rows]
    return (ran, int(o[0]), int(o[1]), *dig, int(o[4]), int(o[5]),
            _materialize(o, 0.0, mode=ran))


def exchange_ms(g: ShardedGraph, reps: int = 25) -> dict:
    """What one lock-step round exchanges on this rank, at this graph's
    shard: the bytes it sends (both sides' packed local words, and as
    bools) and the median wall ms, on the host clock with the device
    synchronized, of the packed all-gather and of the round's two scalar
    all-reduces (kernel 1's counts and sums, and the meet key with the
    negated max degrees), each after a barrier."""
    from bibfs_tpu_torch.parallel.collectives import frontier_exchange_bytes

    mesh = g.mesh
    dev = g.device
    words = torch.zeros(2, -(-g.n_loc // 32), dtype=torch.int32, device=dev)
    sums = torch.zeros(4, dtype=torch.int32, device=dev)
    mins = torch.zeros(3, dtype=torch.int64, device=dev)

    def timed(fn) -> float:
        out = []
        for _ in range(reps + 2):
            mesh.barrier()
            t0 = time.perf_counter()
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out.append(time.perf_counter() - t0)
        return float(np.median(out[2:])) * 1e3

    return dict(
        n_loc=g.n_loc, transport=mesh.transport,
        bytes_packed=2 * frontier_exchange_bytes(g.n_loc),
        bytes_bool=2 * frontier_exchange_bytes(g.n_loc, packed=False),
        gather_ms=timed(lambda: mesh.all_gather(words)),
        reduce_ms=timed(lambda: (mesh.all_reduce(sums, "sum"),
                                 mesh.all_reduce(mins, "min"))),
    )


def exchange2d_ms(g, reps: int = 25) -> dict:
    """What one ``sync`` round of the 2D search exchanges on this rank of
    a grid: the bytes by exchange (both sides' planes:
    :func:`~bibfs_tpu_torch.solvers.sharded2d.frontier_exchange_bytes_2d`
    doubled) and the median wall ms of the transpose, the row-axis gather
    and the column-axis max, each after a barrier, the device
    synchronized."""
    from bibfs_tpu_torch.parallel.collectives import (
        all_gather_rows,
        max_allreduce_cols,
        transpose_permute,
    )
    from bibfs_tpu_torch.solvers.sharded2d import frontier_exchange_bytes_2d

    mesh, dev = g.mesh, g.device
    words = torch.zeros(2, g.n_loc // 32, dtype=torch.int32, device=dev)
    cand = torch.zeros(2, g.n_pad // g.R, dtype=torch.int32, device=dev)

    def timed(fn) -> float:
        out = []
        for _ in range(reps + 2):
            mesh.barrier()
            t0 = time.perf_counter()
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out.append(time.perf_counter() - t0)
        return float(np.median(out[2:])) * 1e3

    by = frontier_exchange_bytes_2d(g.n_pad, g.R, g.C)
    return dict(grid=[g.R, g.C], n_loc=g.n_loc, transport=mesh.transport,
                bytes_per_side=by,
                transpose_ms=timed(lambda: transpose_permute(words, mesh)),
                gather_ms=timed(lambda: all_gather_rows(words, mesh)),
                fold_ms=timed(lambda: max_allreduce_cols(cand, mesh)))


def _busy_us(spans) -> float:
    """Microseconds covered by the union of ``(start, end)`` spans."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_search(g: ShardedGraph, src: int, dst: int, *,
                   mode: str = "fused", repeats: int = 5) -> list:
    """Where a search's time goes on each rank: after a warm-up and with
    every rank's profiler started (a barrier), ``repeats`` searches (one
    host read a round) under ``torch.profiler``, each rank's host clock
    around the mesh's collective calls. Per search and rank: the wall ms
    (the device synchronized), the rounds, the ms the host spent inside
    the collective calls (the enqueue on NCCL, the whole exchange on
    gloo) and the five host ops with the most self time; on a card also
    the ms some kernel or copy ran (``busy_ms``; for the rest of the wall
    the card waited on the host), NCCL's kernels' ms (the transfer and
    the wait for the other ranks) and the other device ops' ms, with the
    five device ops that took the most (user annotations, which mirror
    host ranges on the device, left out). Every rank gets every rank's
    dict."""
    _check_pair(g, src, dst)
    mesh = g.mesh
    cuda = g.device.type == "cuda"
    spent = [0.0]

    def clocked(fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[0] += time.perf_counter() - t0
            return out
        return call

    _run(g, src, dst, mode, 1, None)  # the warm-up
    stats = {"host_syncs": 0}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        mesh.barrier()  # no rank's searches wait on another's profiler start
        # the instance's collectives, timed for these searches only
        mesh.all_gather = clocked(mesh.all_gather)
        mesh.all_reduce = clocked(mesh.all_reduce)
        try:
            with torch.profiler.record_function("sharded_searches"):
                t0 = time.perf_counter()
                for _ in range(repeats):
                    _run(g, src, dst, mode, 1, stats)
                    if cuda:
                        torch.cuda.synchronize(g.device)
                wall = time.perf_counter() - t0
        finally:
            del mesh.all_gather, mesh.all_reduce
    events = prof.events()
    start = min(e.time_range.start for e in events
                if e.name == "sharded_searches")
    host, spans, dev = {}, [], {}
    for e in events:
        if e.time_range.start < start or e.name == "sharded_searches":
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name.startswith(
                    "nccl:"):
                continue
            spans.append((e.time_range.start, e.time_range.end))
            dev[e.name] = dev.get(e.name, 0.0) + e.time_range.elapsed_us()
        else:
            host[e.name] = host.get(e.name, 0.0) + e.self_cpu_time_total
    per = lambda us: us / 1e3 / repeats  # noqa: E731 - ms per search
    top = lambda d: [[k[:60], per(v)] for k, v in  # noqa: E731
                     sorted(d.items(), key=lambda kv: -kv[1])[:5]]
    out = {"rank": mesh.rank, "wall_ms": wall * 1e3 / repeats,
           "rounds": stats["host_syncs"] / repeats,
           "collective_call_ms": spent[0] * 1e3 / repeats,
           "top_host_ms": top(host), "busy_ms": None,
           "collective_kernel_ms": None, "other_ms": None,
           "top_device_ms": None}
    if cuda:
        coll = sum(us for k, us in dev.items() if "nccl" in k.lower())
        out.update(busy_ms=per(_busy_us(spans)), collective_kernel_ms=per(coll),
                   other_ms=per(sum(dev.values()) - coll), top_device_ms=top(dev))
    return mesh.all_gather_object(out)


def kernel_launches() -> dict:
    """This process's launch counts of the kernels a mesh path runs."""
    from bibfs_tpu_torch.ops import fused_level as fl
    from bibfs_tpu_torch.ops import minor_level as ml
    from bibfs_tpu_torch.ops import pull_expand as pe

    out = {"fused_dual_round": fl.fused_dual_round.launches,
           "fold_round": fl.fold_round.launches,
           "pull_dual": pe.pull_dual.launches,
           "pull_single": pe.pull_single.launches}
    for key, n in ml.minor_level.launches.items():
        out[f"minor_level[{key}]"] = n
    return out


def solve_sharded(n: int, edges: np.ndarray, src: int, dst: int, *,
                  num_devices: int | None = None, mode: str = "sync",
                  layout: str = "ell", unroll: int = 1, device=None,
                  repeats: int = 1) -> BFSResult:
    """One query on ``num_devices`` ranks spawned on this host (default:
    every card; one rank on the CPU), ``device`` ``cuda`` (default) or
    ``cpu`` (gloo ranks). The host graph is built once here and pickled to
    the ranks; rank 0's result is returned (with ``repeats > 1`` the
    median of that many timed searches, :func:`time_search`)."""
    from bibfs_tpu_torch.parallel.mesh import launch
    from bibfs_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    ndev = num_devices or (torch.cuda.device_count() if dev.type == "cuda"
                           else 1)
    if not (0 <= src < n and 0 <= dst < n):
        raise ValueError(f"src/dst out of range for n={n}")
    resolve_sharded_mode(mode)
    g = build_host_graph(n, edges, ndev, layout=layout,
                         pad_multiple=default_pad_multiple(ndev))
    out = launch(sharded_jobs, ndev, {"g": g},
                 [{"kind": "solve", "graph": "g", "src": src, "dst": dst,
                   "mode": mode, "unroll": unroll, "repeats": repeats}],
                 device=dev.type)
    return out["results"][0]


def solve_batch_sharded(n: int, edges: np.ndarray, pairs, *,
                        num_devices: int | None = None, mode: str = "sync",
                        layout: str = "ell", device=None, repeats: int = 1
                        ) -> list[BFSResult]:
    """:func:`solve_batch_sharded_graph` (with ``repeats > 1``
    :func:`time_batch_sharded`) through spawned ranks, as
    :func:`solve_sharded`."""
    from bibfs_tpu_torch.parallel.mesh import launch
    from bibfs_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    ndev = num_devices or (torch.cuda.device_count() if dev.type == "cuda"
                           else 1)
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    if pairs.size and not ((0 <= pairs).all() and (pairs < n).all()):
        raise ValueError(f"src/dst out of range for n={n}")
    resolve_sharded_mode(mode)
    g = build_host_graph(n, edges, ndev, layout=layout,
                         pad_multiple=default_pad_multiple(ndev))
    out = launch(sharded_jobs, ndev, {"g": g},
                 [{"kind": "batch", "graph": "g", "pairs": pairs,
                   "mode": mode, "repeats": repeats}], device=dev.type)
    return out["results"][0]


@register("sharded")
def _sharded_backend(n, edges, src, dst, num_devices=None, mode="sync",
                     layout="ell", unroll=1, device=None, **_):
    return solve_sharded(n, edges, src, dst, num_devices=num_devices,
                         mode=mode, layout=layout, unroll=unroll,
                         device=device)
