"""Single-device bidirectional BFS on torch tensors: the counterpart of
``bibfs_tpu/solvers/dense.py``.

Both frontiers, visited sets (``dist < INF32``), parents, the direction
choice, the meet vote and the stop rule ``lvl_s + lvl_t >= best`` run on
the device. Nine modes (:data:`DENSE_MODES`) share one contract: a kernel
``fn(nbr, deg, aux, src, dst) -> (best, meet, par_s, par_t, levels,
edges)``.

- ``fused`` / ``fused_alt`` keep the whole search state on the device
  (:mod:`bibfs_tpu_torch.ops.fused_level`): each round is one level
  kernel plus a one-thread fold, and the host reads the state once per
  ``unroll`` rounds. Rounds past the end do nothing, so every ``unroll``
  gives the same result.
- The torch-composed modes (``sync``, ``alt``, ``beamer``,
  ``beamer_alt``, ``sync_unfused``, and ``pallas`` / ``pallas_alt`` on the
  pull kernels) read a handful of scalars once per round on the host to
  pick the next step (stop, side, push or pull); ``unroll`` does not
  change them.

There is no silent fallback: on CUDA tensors a kernel launches or raises.
The one routing rule kept is the layout one: a tiered graph runs
``fused`` as ``pallas`` and ``fused_alt`` as ``pallas_alt``, and the
result records the mode that ran.
"""

from __future__ import annotations

import dataclasses
import time
from functools import lru_cache

import numpy as np
import torch

from bibfs_tpu_torch.graph.csr import build_ell, build_tiered
from bibfs_tpu_torch.ops.expand import (
    expand_pull_dual_tiered,
    expand_pull_tiered,
    expand_push_tiered,
    frontier_count,
    frontier_degree_sum,
)
from bibfs_tpu_torch.solvers.api import BFSResult, register
from bibfs_tpu_torch.solvers.serial import _reconstruct
from bibfs_tpu_torch.utils.platform import resolve_device

INF32 = 1 << 30
_BIGI = 2147483647  # int32 max: never wins a min


@dataclasses.dataclass
class DeviceGraph:
    """ELL (optionally tiered) adjacency resident on one device, uploaded
    once per graph. ``tiers`` holds one ``(nbr [count_pad, width], hub_ids
    [count_pad])`` pair per hub tier and ``tier_meta`` the matching
    ``(start, count, width)`` triples. ``tables`` caches the one
    slot-major table all four kernels read, built at the first solve that
    needs it."""

    n: int
    n_pad: int
    width: int
    num_edges: int
    nbr: torch.Tensor  # int32[n_pad, width]
    deg: torch.Tensor  # int32[n_pad] (TRUE degree when tiered)
    hub_rank: torch.Tensor | None = None  # int32[n_pad] when tiered
    tiers: tuple = ()
    tier_meta: tuple = ()
    tables: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return self.nbr.device

    @property
    def aux(self):
        """``(hub_rank, tiers)`` for a tiered graph, ``()`` for plain ELL."""
        return (self.hub_rank, self.tiers) if self.tiers else ()

    @classmethod
    def from_arrays(cls, nbr, deg, *, hub_rank=None, tiers=(), tier_meta=(),
                    n: int, num_edges: int, device=None) -> "DeviceGraph":
        """Build from numpy arrays shaped like the ``EllGraph`` /
        ``TieredEllGraph`` fields (``tiers`` as ``(nbr, hub_ids)`` pairs)."""
        dev = resolve_device(device)

        def put(a):  # a private copy: the graph never aliases caller arrays
            return torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)

        nbr = np.asarray(nbr)
        return cls(
            n=int(n),
            n_pad=int(nbr.shape[0]),
            width=int(nbr.shape[1]),
            num_edges=int(num_edges),
            nbr=put(nbr),
            deg=put(deg),
            hub_rank=put(hub_rank) if tiers else None,
            tiers=tuple((put(t), put(h)) for t, h in tiers),
            tier_meta=tuple(tuple(int(x) for x in m) for m in tier_meta),
        )

    @classmethod
    def from_ell(cls, g, device=None) -> "DeviceGraph":
        if g.overflow.shape[0]:
            raise NotImplementedError(
                "EllGraph has width_cap overflow edges; use build_tiered "
                "(tiered ELL) for skewed-degree graphs instead of width_cap"
            )
        return cls.from_arrays(g.nbr, g.deg, n=g.n, num_edges=g.num_edges,
                               device=device)

    @classmethod
    def from_tiered(cls, g, device=None) -> "DeviceGraph":
        """Upload a :class:`bibfs_tpu_torch.graph.csr.TieredEllGraph`."""
        tiers = [(t.nbr, g.hub_ids[: t.nbr.shape[0]]) for t in g.tiers]
        meta = [(t.start, t.count, t.nbr.shape[1]) for t in g.tiers]
        return cls.from_arrays(g.nbr, g.deg, hub_rank=g.hub_rank, tiers=tiers,
                               tier_meta=meta, n=g.n, num_edges=g.num_edges,
                               device=device)

    @classmethod
    def build(cls, n: int, edges: np.ndarray | None = None, *,
              layout: str = "ell", device=None,
              pairs: np.ndarray | None = None) -> "DeviceGraph":
        """Build + upload in one step: ``layout="ell"`` is one table,
        ``layout="tiered"`` a base table plus geometric hub tiers."""
        device = resolve_device(device)
        if layout == "tiered":
            return cls.from_tiered(build_tiered(n, edges, pairs=pairs), device)
        if layout == "ell":
            return cls.from_ell(build_ell(n, edges, pairs=pairs), device)
        raise ValueError(f"unknown layout {layout!r} (expected 'ell' or 'tiered')")


def _auto_push_cap(n_pad: int, platform: str) -> int:
    """Frontier size below which push beats pull, as the reference
    computes it. With a calibration block for ``platform`` (``cpu`` or
    ``cuda``, :func:`bibfs_tpu_torch.utils.calibrate.load_calibration`):
    ``n_pad // push_cap_divisor`` rounded down to a power of two, clamped
    to ``[128, 4096]`` and to ``n_pad``, and 0 (pull only) where the block
    measured that push never wins. Otherwise the uncalibrated rule:
    ``n_pad / 256`` rounded up to a power of two, clamped to
    ``[128, 2048]`` and to ``n_pad``."""
    from bibfs_tpu_torch.utils.calibrate import load_calibration

    cal = load_calibration(platform) or {}
    if "push_cap" in cal:
        if not cal["push_cap"]:
            return 0
        divisor = cal.get("push_cap_divisor")
        if isinstance(divisor, int) and divisor > 0:
            cap = 1 << max(7, (n_pad // divisor).bit_length() - 1)
            return int(min(4096, cap, max(128, n_pad)))
    cap = 1 << max(7, (n_pad // 256).bit_length())
    return int(min(2048, cap, max(128, n_pad)))


# mode -> (schedule, hybrid expansion?, kernel pull?). "sync" expands both
# sides every round, "alt" the smaller frontier only; "beamer" variants add
# push/pull direction optimization; "pallas" variants pull the base table
# through the pull kernels (hub tiers as torch ops); "fused" variants run
# each round as one level kernel plus the fold (plain ELL only).
# "sync_unfused" is the lock-step schedule as two single-side expansions.
DENSE_MODES = {
    "sync": ("sync", False, False),
    "alt": ("alt", False, False),
    "beamer": ("sync", True, False),
    "beamer_alt": ("alt", True, False),
    "pallas": ("sync", False, True),
    "pallas_alt": ("alt", False, True),
    "fused": ("sync", False, "fused"),
    "fused_alt": ("alt", False, "fused"),
    "sync_unfused": ("sync", False, False),
}

_LAYOUT_ROUTE = {"fused": "pallas", "fused_alt": "pallas_alt"}


def kernel_cap(mode: str, n_pad: int, platform: str) -> int:
    """The push cap of (mode, graph, platform of the graph's tensors): the
    auto cap for Beamer modes, 0 for pull-only modes."""
    return _auto_push_cap(n_pad, platform) if DENSE_MODES[mode][1] else 0


def _resolve_pallas_mode(mode: str) -> str:
    """The identity: a kernel mode runs its kernels or raises."""
    return mode


def resolve_mode(mode: str, tier_meta: tuple = ()) -> str:
    """The mode that runs on a layout: tiered graphs run the fused modes
    through the pull kernels."""
    if mode not in DENSE_MODES:
        raise ValueError(f"unknown dense mode {mode!r}; have {sorted(DENSE_MODES)}")
    if tier_meta and mode in _LAYOUT_ROUTE:
        return _LAYOUT_ROUTE[mode]
    return _resolve_pallas_mode(mode)


def _scalar(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def _init_state(n_pad, k, src, dst, deg):
    dev = deg.device

    def side(v):
        fr = torch.zeros(n_pad, dtype=torch.bool, device=dev)
        fr[v] = True
        fi = torch.full((k,), -1, dtype=torch.int32, device=dev)
        fi[0] = v
        dist = torch.full((n_pad,), INF32, dtype=torch.int32, device=dev)
        dist[v] = 0
        return dict(
            fr=fr, fi=fi, ok=torch.tensor(True, device=dev), cnt=_scalar(1, dev),
            md=deg[v].clone(),  # max degree in the frontier (push routing)
            par=torch.full((n_pad,), -1, dtype=torch.int32, device=dev),
            dist=dist, lvl=_scalar(0, dev),
        )

    st = {f"{key}_s": val for key, val in side(src).items()}
    st.update({f"{key}_t": val for key, val in side(dst).items()})
    st.update(
        best=_scalar(0 if src == dst else INF32, dev),
        meet=_scalar(src if src == dst else -1, dev),
        levels=_scalar(0, dev),
        edges=_scalar(0, dev),
    )
    return st


def _meet_vote(st, delta: int):
    """Best candidate distance and its meet vertex over the visited
    intersection (lowest id on ties); visited is ``dist < INF32``."""
    both = (st["dist_s"] < INF32) & (st["dist_t"] < INF32)
    sums = torch.where(both, st["dist_s"] + st["dist_t"], INF32)
    cur = sums.min()
    ids = torch.arange(sums.shape[0], dtype=torch.int32, device=sums.device)
    arg = torch.where(sums == cur, ids, _BIGI).min()
    st["meet"] = torch.where(cur < st["best"], arg, st["meet"])
    st["best"] = torch.minimum(st["best"], cur)
    st["levels"] = st["levels"] + delta
    return st


# the scalars the host reads once per round of a torch-composed mode
_HOST_KEYS = ("lvl_s", "lvl_t", "best", "meet", "cnt_s", "cnt_t", "md_s",
              "md_t", "ok_s", "ok_t", "levels", "edges")


def _read_scalars(st, stats) -> dict:
    """One device->host read of the round's scalars."""
    vals = torch.stack([st[k].to(torch.int32) for k in _HOST_KEYS]).tolist()
    if stats is not None:
        stats["host_syncs"] += 1
    return dict(zip(_HOST_KEYS, vals))


def _cond(sc: dict) -> bool:
    """The provably-correct stop: once ``lvl_s + lvl_t >= best`` no
    undiscovered vertex can improve the meet; an empty frontier ends the
    search too."""
    return (sc["lvl_s"] + sc["lvl_t"] < sc["best"]
            and sc["cnt_s"] > 0 and sc["cnt_t"] > 0)


def _full_tiers(aux, tier_meta) -> tuple:
    """``(start, count, tier_nbr, hub_ids)`` tuples from the static tier
    metadata and the device tier arrays."""
    tiers = aux[1] if aux else ()
    return tuple(
        (start, count, tnbr, tids)
        for (start, count, _w), (tnbr, tids) in zip(tier_meta, tiers)
    )


# a frontier whose max degree exceeds this stays on the pull path
PUSH_SPAN_TARGET = 256


def push_span(width: int, tier_meta) -> tuple[int, int]:
    """Static split of hub tiers into push-covered and pull-only:
    ``(span, ncovered)``; a frontier whose max degree exceeds ``span``
    takes the pull path."""
    span = width
    ncovered = 0
    for start, _count, twidth, *_rest in tier_meta:
        if start >= PUSH_SPAN_TARGET:
            break
        ncovered += 1
        span = start + twidth
    return span, ncovered


def _flatnonzero(fr, k: int):
    """The first ``k`` set positions of ``fr`` as int32, padded with -1."""
    idx = torch.nonzero(fr).flatten()[:k].to(torch.int32)
    out = torch.full((k,), -1, dtype=torch.int32, device=fr.device)
    out[: idx.shape[0]] = idx
    return out


def _side_step(st, sc, side: str, nbr, deg, aux, tier_meta, *, push_cap: int,
               use_pallas: bool = False):
    """Advance one side one level. ``push_cap > 0`` enables Beamer
    direction optimization: a frontier at most ``push_cap`` wide whose
    max degree fits the push span goes through the push path, larger ones
    through the pull path. ``use_pallas`` pulls the base table through the
    single pull kernel (hub tiers as torch ops). ``sc`` holds the host's
    reading of the scalars this round. The single kernel reads the side's
    frontier bitmap ``st["bits_<side>"]`` and writes the next one there."""
    k = st[f"fi_{side}"].shape[0]
    if use_pallas:
        ptables, tier_aux = aux
        hub_rank = None
        full_tiers = _full_tiers(tier_aux, tier_meta)
    else:
        ptables = None
        hub_rank = aux[0] if aux else None
        full_tiers = _full_tiers(aux, tier_meta)
    span, ncov = push_span(nbr.shape[1], tier_meta)
    fr, fi = st[f"fr_{side}"], st[f"fi_{side}"]
    par, dist = st[f"par_{side}"], st[f"dist_{side}"]
    lvl = st[f"lvl_{side}"] + 1
    extra = {}
    if (push_cap > 0 and sc[f"cnt_{side}"] <= push_cap
            and sc[f"md_{side}"] <= span):
        if not sc[f"ok_{side}"]:
            fi = _flatnonzero(fr, k)
        nf, fi, cnt, par, dist, scanned, md = expand_push_tiered(
            fi, par, dist, nbr, deg, hub_rank, full_tiers[:ncov], lvl,
            inf=INF32,
        )
        ok = cnt <= k
    else:
        scanned = frontier_degree_sum(fr, deg)
        if use_pallas:
            from bibfs_tpu_torch.ops.pull_expand import pull_round

            nf, bits, par, dist, md = pull_round(
                fr, st[f"bits_{side}"], par, dist, ptables[0], deg,
                full_tiers, lvl, inf=INF32, checked=True,
            )
            extra[f"bits_{side}"] = bits
        else:
            nf, par, dist, md = expand_pull_tiered(
                fr, par, dist, nbr, deg, full_tiers, lvl, inf=INF32
            )
        # the compact index list is now stale; push recomputes it on entry
        ok = torch.tensor(False, device=fr.device)
        cnt = frontier_count(nf)
    return {
        **st,
        f"fr_{side}": nf,
        f"fi_{side}": fi,
        f"ok_{side}": ok,
        f"par_{side}": par,
        f"dist_{side}": dist,
        f"lvl_{side}": lvl,
        f"cnt_{side}": cnt,
        f"md_{side}": md,
        "edges": st["edges"] + scanned,
        **extra,
    }


def _dual_round(st, outs, deg, **extra):
    """A lock-step round from one dual expansion's outputs ``outs``
    (``expand_pull_dual_tiered``'s contract, computed from ``st``);
    ``extra`` entries (the dual kernel's next frontier) go into the
    state as they are."""
    scanned = (frontier_degree_sum(st["fr_s"], deg)
               + frontier_degree_sum(st["fr_t"], deg))
    nf_s, par_s, dist_s, md_s, nf_t, par_t, dist_t, md_t = outs
    no = torch.tensor(False, device=deg.device)
    st = {
        **st,
        "fr_s": nf_s, "par_s": par_s, "dist_s": dist_s, "md_s": md_s,
        "cnt_s": frontier_count(nf_s), "lvl_s": st["lvl_s"] + 1, "ok_s": no,
        "fr_t": nf_t, "par_t": par_t, "dist_t": dist_t, "md_t": md_t,
        "cnt_t": frontier_count(nf_t), "lvl_t": st["lvl_t"] + 1, "ok_t": no,
        "edges": st["edges"] + scanned,
        **extra,
    }
    return _meet_vote(st, 2)


def _make_body(mode: str, cap: int, tier_meta, nbr, deg, aux):
    """The round ``(st, sc) -> st`` for (mode, cap, tier layout)."""
    schedule, hybrid, use_pallas = DENSE_MODES[mode]

    def step(st, sc, side):
        return _side_step(st, sc, side, nbr, deg, aux, tier_meta,
                          push_cap=cap, use_pallas=use_pallas)

    if schedule == "sync" and use_pallas:
        # lock-step pull kernel: the dual kernel reads the table once per
        # round for both sides, and hands its next frontier to the next
        # round in its own layout
        from bibfs_tpu_torch.ops.pull_expand import pull_round_dual

        ptables, tier_aux = aux
        ktiers = _full_tiers(tier_aux, tier_meta)

        def body(st, sc):
            *outs, front = pull_round_dual(
                st["fr_s"], st["fr_t"], st["front"], st["par_s"],
                st["dist_s"], st["par_t"], st["dist_t"], ptables[0], deg,
                ktiers, st["lvl_s"] + 1, st["lvl_t"] + 1, inf=INF32,
                checked=True,
            )
            return _dual_round(st, outs, deg, front=front)

    elif (schedule == "sync" and not hybrid and not use_pallas
          and mode != "sync_unfused"):
        # pull-only lock-step: one packed gather per table for both sides
        full_tiers = _full_tiers(aux, tier_meta)

        def body(st, sc):
            outs = expand_pull_dual_tiered(
                st["fr_s"], st["fr_t"], st["par_s"], st["dist_s"],
                st["par_t"], st["dist_t"], nbr, deg, full_tiers,
                st["lvl_s"] + 1, st["lvl_t"] + 1, inf=INF32,
            )
            return _dual_round(st, outs, deg)

    elif schedule == "sync":

        def body(st, sc):
            # the t-step reads only t-side scalars, which the s-step leaves
            return _meet_vote(step(step(st, sc, "s"), sc, "t"), 2)

    else:

        def body(st, sc):
            side = "s" if sc["cnt_s"] <= sc["cnt_t"] else "t"
            return _meet_vote(step(st, sc, side), 1)

    return body


def _kernel_table(cache, nbr, deg):
    """The slot-major table of all four kernels, built once per graph
    when ``cache`` (the graph's ``tables`` dict) is given."""
    from bibfs_tpu_torch.ops.pull_expand import sentinel_transposed_table

    if cache is None:
        return sentinel_transposed_table(nbr, deg)
    if "nbr_t" not in cache:
        cache["nbr_t"] = sentinel_transposed_table(nbr, deg)
    return cache["nbr_t"]


def _build_fused_kernel(tier_meta: tuple = (), unroll: int = 1, *,
                        alt: bool = False):
    """The device-state search program of modes ``fused`` / ``fused_alt``:
    each round is one level kernel (dual or single side) plus the fold,
    and the host reads the state once per ``unroll`` rounds. Tiered
    layouts run the matching ``pallas`` program."""
    from bibfs_tpu_torch.ops.fused_level import (
        S,
        active,
        check_round,
        fold_round,
        fused_dual_round,
        fused_single_round,
        new_frontier,
        new_scratch,
        new_state,
    )

    round_fn = fused_single_round if alt else fused_dual_round

    def dense_fused_kernel(nbr, deg, aux, src, dst, *, cache=None, stats=None):
        if tier_meta:
            return _build_kernel(_LAYOUT_ROUTE["fused_alt" if alt else "fused"],
                                 0, tier_meta, unroll)(
                nbr, deg, aux, src, dst, cache=cache, stats=stats)
        nbr_t = _kernel_table(cache, nbr, deg)
        n_pad = nbr.shape[0]
        dev = nbr.device
        dist_s = torch.full((n_pad,), INF32, dtype=torch.int32, device=dev)
        dist_t = dist_s.clone()
        dist_s[src] = 0
        dist_t[dst] = 0
        par_s = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
        par_t = par_s.clone()
        # each side's frontier bitmap sits at its level's parity
        bits = new_frontier(src, dst, n_pad, dev)
        state = new_state(src, dst, deg)
        acc, key = new_scratch(dev)
        if dev.type == "cuda":  # the buffers of every round, checked once
            check_round(nbr_t, deg, bits, dist_s, dist_t, par_s, par_t,
                        state, acc, key)
        while True:
            for _ in range(unroll):
                round_fn(nbr_t, deg, bits, dist_s, dist_t, par_s, par_t,
                         state, acc, key, checked=True)
                fold_round(state, acc, key, alt=alt, checked=True)
            sc = state.tolist()
            if stats is not None:
                stats["host_syncs"] += 1
            if not active(sc):
                break
        return (sc[S["best"]], sc[S["meet"]], par_s, par_t,
                sc[S["levels"]], sc[S["edges"]])

    return dense_fused_kernel


def _build_kernel(mode: str, push_cap: int, tier_meta: tuple = (),
                  unroll: int = 1):
    """Build the search kernel for (mode, push_cap, tier layout):
    ``fn(nbr, deg, aux, src, dst, *, cache=None, stats=None) -> (best,
    meet, par_s, par_t, levels, edges)`` with the scalars as ints and the
    parent rows as int32 tensors; ``best >= INF32`` means no path.
    ``cache`` (a dict kept with the graph) holds the kernels' table
    across solves; ``stats["host_syncs"]`` counts the state reads."""
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")
    if mode in ("fused", "fused_alt"):
        return _build_fused_kernel(tier_meta, unroll, alt=mode == "fused_alt")
    cap = push_cap if DENSE_MODES[mode][1] else 0
    k = max(cap, 1)

    def dense_kernel(nbr, deg, aux, src, dst, *, cache=None, stats=None):
        st = _init_state(nbr.shape[0], k, src, dst, deg)
        if DENSE_MODES[mode][2]:
            # kernel modes: aux becomes ((kernel table,), tier aux), and the
            # state carries the frontier in the pull kernels' form
            from bibfs_tpu_torch.ops.pull_expand import (
                check_pull,
                new_pull_frontiers,
            )

            table = _kernel_table(cache, nbr, deg)
            if nbr.device.type == "cuda":  # once; the rounds launch checked
                check_pull(table, deg, nbr.shape[0])
            aux = ((table,), aux)
            st.update(new_pull_frontiers(src, dst, nbr.shape[0], nbr.device,
                                         dual=DENSE_MODES[mode][0] == "sync"))
        body = _make_body(mode, cap, tier_meta, nbr, deg, aux)
        while True:
            sc = _read_scalars(st, stats)
            if not _cond(sc):
                break
            st = body(st, sc)
        return (sc["best"], sc["meet"], st["par_s"], st["par_t"],
                sc["levels"], sc["edges"])

    return dense_kernel


def _get_kernel(mode: str, push_cap: int, tier_meta: tuple = (),
                unroll: int = 1):
    """The kernel of ``mode`` after the layout route, cached."""
    return _get_kernel_resolved(resolve_mode(mode, tier_meta), push_cap,
                                tuple(tier_meta), unroll)


@lru_cache(maxsize=None)
def _get_kernel_resolved(mode: str, push_cap: int, tier_meta: tuple = (),
                         unroll: int = 1):
    return _build_kernel(mode, push_cap, tier_meta, unroll)


def _check_pair(g: DeviceGraph, src: int, dst: int) -> None:
    if not (0 <= src < g.n and 0 <= dst < g.n):
        raise ValueError(f"src/dst out of range for n={g.n}")


def _run(g: DeviceGraph, src: int, dst: int, mode: str, unroll: int, stats):
    kern = _get_kernel(mode, kernel_cap(mode, g.n_pad, g.device.type),
                       g.tier_meta, unroll)
    return kern(g.nbr, g.deg, g.aux, src, dst, cache=g.tables, stats=stats)


def solve_dense_graph(g: DeviceGraph, src: int, dst: int, *, mode: str = "sync",
                      unroll: int = 1, telemetry=None) -> BFSResult:
    """Search an already device-resident graph; ``time_s`` covers the
    search only. ``unroll`` is the number of fused rounds per host read
    (exact for every mode). ``telemetry`` (opt-in) swaps in the level by
    level drive :func:`_solve_dense_traced`, which records each level's
    frontier, edges and push/pull choice onto ``level_stats``; None runs
    the search untouched."""
    from bibfs_tpu_torch.solvers.timing import force_scalar

    _check_pair(g, src, dst)
    if telemetry:  # any falsy value (None/False/0) is off
        return _solve_dense_traced(g, src, dst, mode, telemetry)
    ran = resolve_mode(mode, g.tier_meta)
    stats = {"host_syncs": 0}
    t0 = time.perf_counter()
    out = _run(g, src, dst, mode, unroll, stats)
    force_scalar(out)
    elapsed = time.perf_counter() - t0
    return _materialize(out, elapsed, mode=ran,
                        host_syncs=stats["host_syncs"])


# the torch-composed schedule a kernel mode's telemetry drive steps
_TRACED_BASE = {"pallas": "sync", "pallas_alt": "alt", "fused": "sync",
                "fused_alt": "alt"}


def _solve_dense_traced(g: DeviceGraph, src: int, dst: int, mode: str,
                        telemetry) -> BFSResult:
    """The per-level telemetry drive of the dense search, as the JAX
    package's: the same state, side steps, meet vote and stop rule as the
    search, stepped one side at a time from the host so each step's
    frontier, edges scanned and push/pull choice can be read and recorded.
    Kernel modes step their torch-composed schedule (the kernels fuse work
    within a level, not across levels, so the per-level numbers are the
    same), and the lock-step schedules step their two sides in turn (the
    ``sync_unfused`` body: the same state as the dual expansion). Every
    step pays host reads, and ``mode`` of the result names the schedule
    that ran; the ``telemetry=None`` default never comes here."""
    from bibfs_tpu_torch.obs.telemetry import coerce

    if mode not in DENSE_MODES:
        raise ValueError(f"unknown dense mode {mode!r}; have {sorted(DENSE_MODES)}")
    tel = coerce(telemetry)
    if tel.n != 0:
        tel.n = g.n  # re-stamp per solve (n=0 opts out)
    schedule, hybrid, _kernel = DENSE_MODES[mode]
    base = _TRACED_BASE.get(mode, mode)
    cap = kernel_cap(base, g.n_pad, g.device.type)
    span, _ncov = push_span(g.nbr.shape[1], g.tier_meta)
    stats = {"host_syncs": 0}
    t0 = time.perf_counter()
    st = _init_state(g.n_pad, max(cap, 1), src, dst, g.deg)

    def advance(st, side):
        """Expand one side; record its routing and its frontier and edges
        after the step."""
        pre = _read_scalars(st, stats)
        st = _side_step(st, pre, side, g.nbr, g.deg, g.aux, g.tier_meta,
                        push_cap=cap)
        post = _read_scalars(st, stats)
        pushed = (hybrid and cap > 0 and pre[f"cnt_{side}"] <= cap
                  and pre[f"md_{side}"] <= span)
        tel.record_level(post["lvl_s"] + post["lvl_t"], side,
                         "push" if pushed else "pull",
                         post[f"cnt_{side}"], post["edges"] - pre["edges"])
        return st

    while True:
        sc = _read_scalars(st, stats)
        if not _cond(sc):
            break
        if schedule == "sync":
            st = advance(advance(st, "s"), "t")
        else:  # alt: the smaller frontier first
            st = advance(st, "s" if sc["cnt_s"] <= sc["cnt_t"] else "t")
        st = _meet_vote(st, 2 if schedule == "sync" else 1)
        best, meet, levels = (int(v) for v in torch.stack(
            [st["best"], st["meet"], st["levels"]]).tolist())
        stats["host_syncs"] += 1
        if best < sc["best"]:
            tel.note_meet(levels, meet)
    elapsed = time.perf_counter() - t0
    out = (sc["best"], sc["meet"], st["par_s"], st["par_t"], sc["levels"],
           sc["edges"])
    res = _materialize(out, elapsed, mode=base,
                       host_syncs=stats["host_syncs"])
    res.level_stats = tel.as_dict()
    return res


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _materialize(out, elapsed: float, *, mode: str | None = None,
                 host_syncs: int | None = None) -> BFSResult:
    best, meet, par_s, par_t, levels, edges = out
    best, meet, levels, edges = int(best), int(meet), int(levels), int(edges)
    extra = dict(mode=mode, host_syncs=host_syncs)
    if best >= INF32:
        return BFSResult(False, None, None, None, elapsed, levels, edges, **extra)
    path = _reconstruct(_host(par_s).astype(np.int64),
                        _host(par_t).astype(np.int64), meet)
    return BFSResult(True, best, path, meet, elapsed, levels, edges, **extra)


def time_search(g: DeviceGraph, src: int, dst: int, *, repeats: int = 30,
                mode: str = "sync", unroll: int = 1
                ) -> tuple[list[float], BFSResult]:
    """Warm-up, ``repeats`` forced-execution timings (CUDA events on a
    card) and one materializing solve; ``result.time_s`` is the median."""
    from bibfs_tpu_torch.solvers.timing import timed_repeats

    _check_pair(g, src, dst)
    return timed_repeats(
        lambda: _run(g, src, dst, mode, unroll, None),
        lambda: solve_dense_graph(g, src, dst, mode=mode, unroll=unroll),
        repeats,
        device=g.device,
    )


def _batch_dispatch(g: DeviceGraph, pairs, mode: str,
                    stats: dict | None = None):
    """``(pairs, thunk, finish)`` of a batch: ``pairs`` normalized to
    ``int64[B, 2]`` and range-checked before anything runs, ``thunk()``
    the timed unit (the whole batch on the device), ``finish(out)`` the
    untimed conversion to the 6-tuple ``(best, meet, par_s [B, *], par_t,
    levels, edges)``. ``auto`` resolves through ``auto_batch_mode``;
    ``minor`` / ``minor8`` run the batch-minor layout
    (:mod:`bibfs_tpu_torch.solvers.batch_minor`). Every other mode runs
    the lock-step batch of its single-query search
    (:mod:`bibfs_tpu_torch.solvers.dense_batch`), with ``fused`` /
    ``fused_alt`` routed to ``pallas`` / ``pallas_alt`` as the reference's
    vmapped batch routes them: each query's result is the single-query
    one. ``stats`` collects ``host_syncs`` (the host reads of every run
    of the thunk: a batch's rounds plus one) and the ``mode`` that runs."""
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    if pairs.size and not ((0 <= pairs).all() and (pairs < g.n).all()):
        raise ValueError(f"src/dst out of range for n={g.n}")
    stats = {"host_syncs": 0} if stats is None else stats
    if mode == "auto":
        from bibfs_tpu_torch.solvers.batch_minor import auto_batch_mode

        mode = auto_batch_mode(g, len(pairs))
    if mode in ("minor", "minor8"):
        from bibfs_tpu_torch.solvers.batch_minor import batch_dispatch

        stats["mode"] = mode
        return batch_dispatch(g, pairs, dt8=(mode == "minor8"), stats=stats)
    from bibfs_tpu_torch.solvers.dense_batch import lockstep_search

    mode = resolve_mode(_LAYOUT_ROUTE.get(mode, mode), g.tier_meta)
    stats["mode"] = mode
    cap = kernel_cap(mode, g.n_pad, g.device.type)
    srcs = torch.from_numpy(pairs[:, 0].copy()).to(g.device)
    dsts = torch.from_numpy(pairs[:, 1].copy()).to(g.device)

    def dispatch():
        return lockstep_search(g, srcs, dsts, mode, cap, stats)

    return pairs, dispatch, lambda out: out


def _materialize_batch(out, num: int, elapsed: float, *,
                       mode: str | None = None,
                       host_syncs: int | None = None) -> list[BFSResult]:
    # one device->host copy per OUTPUT, not one per (output, query)
    outs = [_host(o) for o in out]
    return [_materialize(tuple(o[i] for o in outs), elapsed, mode=mode,
                         host_syncs=host_syncs) for i in range(num)]


def solve_batch_graph(g: DeviceGraph, pairs, *, mode: str = "sync"
                      ) -> list[BFSResult]:
    """Solve many (src, dst) queries as one batch (:func:`_batch_dispatch`).
    One :class:`BFSResult` per pair; every result's ``time_s`` is the
    WHOLE batch's wall clock (divide by ``len(pairs)`` for the time per
    query), ``host_syncs`` the batch's host reads and ``mode`` the batch
    mode that ran."""
    from bibfs_tpu_torch.solvers.timing import force_scalar

    stats = {"host_syncs": 0}
    pairs, dispatch, finish = _batch_dispatch(g, pairs, mode, stats)
    t0 = time.perf_counter()
    out = dispatch()
    force_scalar(out)
    elapsed = time.perf_counter() - t0
    return _materialize_batch(finish(out), pairs.shape[0], elapsed,
                              mode=stats["mode"],
                              host_syncs=stats["host_syncs"])


def time_batch_graph(g: DeviceGraph, pairs, *, repeats: int = 5,
                     mode: str = "sync") -> tuple[list[float], list[BFSResult]]:
    """A batch under the shared timing protocol (warm-up excluded, forced
    execution per repeat, CUDA events on a card); the last timed output is
    materialized with the median stamped into every result's ``time_s``
    and the host reads of one batch in ``host_syncs``."""
    from bibfs_tpu_torch.solvers.timing import timed_batch_repeats

    stats = {"host_syncs": 0}
    pairs, dispatch, finish = _batch_dispatch(g, pairs, mode, stats)
    times, out = timed_batch_repeats(dispatch, repeats, device=g.device)
    return times, _materialize_batch(
        finish(out), pairs.shape[0], float(np.median(times)),
        mode=stats["mode"], host_syncs=stats["host_syncs"] // (repeats + 1))


def time_batch_only(g: DeviceGraph, pairs, *, repeats: int = 10,
                    mode: str = "sync") -> list[float]:
    """Forced-execution batch timing without materializing results: the
    wall time of each of ``repeats`` whole-batch runs."""
    from bibfs_tpu_torch.solvers.timing import timed_repeats

    _pairs, dispatch, _finish = _batch_dispatch(g, pairs, mode)
    return timed_repeats(dispatch, None, repeats, device=g.device)[0]


@dataclasses.dataclass
class BlockedDeviceGraph:
    """The blocked tile adjacency on one device, uploaded once per graph
    (the upload of :class:`bibfs_tpu_torch.graph.blocked.BlockedGraph`).
    ``tab`` stays int8: the CUDA kernel's input type; the CPU twin casts
    at the product. ``bits`` is ``tab``'s packed tile rows
    (:func:`bibfs_tpu_torch.ops.semiring_plane.pack_tile_rows`), packed
    by a serving runtime's upload on the card
    (``_GraphRuntime.blocked_graph``); None otherwise."""

    n: int
    n_pad: int
    tile: int
    nblocks: int
    bwidth: int
    num_edges: int
    tab: torch.Tensor  # int8 [nblocks, bwidth, tile, tile]
    bcol: torch.Tensor  # int32 [nblocks, bwidth], sentinel nblocks
    deg: torch.Tensor  # int32 [n_pad]
    bits: torch.Tensor | None = None  # int32 [nblocks, bwidth, tile, 4]

    @property
    def device(self) -> torch.device:
        return self.tab.device

    @classmethod
    def from_host(cls, bg, device=None) -> "BlockedDeviceGraph":
        dev = resolve_device(device)

        def put(a):  # a private copy: the graph never aliases caller arrays
            return torch.from_numpy(np.array(a)).to(dev)

        return cls(
            n=bg.n, n_pad=bg.n_pad, tile=bg.tile, nblocks=bg.nblocks,
            bwidth=bg.bwidth, num_edges=bg.num_edges,
            tab=put(bg.tab), bcol=put(bg.bcol), deg=put(bg.deg),
        )


def _make_blocked_body(tab, bcol, deg, rc: int):
    """The blocked level body, in place on the state ``st``
    (:func:`_blocked_state`): both sides of all queries advance one level
    through one :func:`~bibfs_tpu_torch.ops.blocked_expand.blocked_level`
    launch over the dual plane, then one :func:`~bibfs_tpu_torch.ops.
    blocked_expand.blocked_fold` launch over the ``[B]`` vectors. The port
    keeps the planes query-major (``fr`` and ``dist`` ``[2b, n_pad]``:
    source rows ``0..b-1``, target rows ``b..2b-1``), the kernel's operand
    layout; the rules are the JAX package's body: discovery masked by
    dist, finished queries frozen by ``live``, the meet vote the lowest
    vertex of the minimum sum, ``levels += 2`` and ``edges +=`` the
    current frontiers' degree sums per live round. The vote and the sums
    are carried (a vertex reached by both sides before this round voted
    then, so only this round's new vertices can lower ``best``; this
    round's new frontier sums are the next round's current ones), so no
    op over a ``[2b, n_pad]`` plane runs outside the kernel. No parents:
    paths come from the dist planes on the host
    (:func:`_materialize_blocked_batch`)."""
    from bibfs_tpu_torch.ops.blocked_expand import blocked_fold, blocked_level

    def body(st):
        lvl = st["rnd"] + 1
        st["fr"], st["occ"] = blocked_level(
            tab, bcol, deg, st["fr"], st["dist"], st["occ"], st, lvl, rc=rc,
            checked=True)
        blocked_fold(st, lvl, checked=True)
        st["rnd"] = lvl

    return body


def _blocked_state(srcs, dsts, deg, dt) -> dict:
    """The blocked search's round-0 state on the queries' device: each
    query's source in its row of the source half of the plane, its target
    in the target half, at distance 0, the plane's occupancy flags, and
    the round vectors (:func:`~bibfs_tpu_torch.ops.blocked_expand.
    round_vectors`: ``src == dst`` queries done, best 0, meet src)."""
    from bibfs_tpu_torch.ops.blocked_expand import (
        plane_occupancy,
        round_vectors,
    )

    b = srcs.shape[0]
    n_pad = deg.shape[0]
    dev = srcs.device
    qi = torch.arange(b, device=dev)
    si, di = srcs.long(), dsts.long()
    fr = torch.zeros((2 * b, n_pad), dtype=dt, device=dev)
    fr[qi, si] = 1
    fr[b + qi, di] = 1
    dist = torch.full((2 * b, n_pad), INF32, dtype=torch.int32, device=dev)
    dist[qi, si] = 0
    dist[b + qi, di] = 0
    return dict(fr=fr, dist=dist, occ=plane_occupancy(fr),
                **round_vectors(srcs, dsts, deg), rnd=0)


def _build_blocked_kernel(rc: int):
    """The whole-batch blocked search: ``fn(tab, bcol, deg, srcs, dsts, *,
    stats=None, dt) -> (best, meet, dist [n_pad, 2b], levels, edges)``,
    every output on the table's device (``dist`` a transposed view of the
    query-major plane). The JAX package's ``while_loop`` is a host loop
    that reads the one any-live word the fold writes once a round
    (``stats["host_syncs"]``): two launches and one 4-byte read a round."""

    def blocked_kernel(tab, bcol, deg, srcs, dsts, *, dt, stats=None):
        from bibfs_tpu_torch.ops.blocked_expand import check_blocked

        st = _blocked_state(srcs, dsts, deg, dt)
        if tab.is_cuda:  # the planes of every round, checked once
            check_blocked(tab, bcol, deg, st["fr"], st["dist"], st["occ"], st)
        body = _make_blocked_body(tab, bcol, deg, rc)
        while True:
            if stats is not None:
                stats["host_syncs"] += 1
            if not bool(st["any"]):
                break
            body(st)
        return st["best"], st["meet"], st["dist"].T, st["levels"], st["edges"]

    return blocked_kernel


def _walk_dist_plane(row_ptr, col_ind, dvec, v: int) -> list[int]:
    """Walk ``v`` back to its side's root along strictly decreasing level
    stamps. Level-synchronous dists make this exact: every vertex stamped
    at level l > 0 has a neighbour stamped l - 1 (the one that discovered
    it)."""
    path = [v]
    lvl = int(dvec[v])
    while lvl > 0:
        for u in col_ind[row_ptr[v]: row_ptr[v + 1]]:
            if dvec[u] == lvl - 1:
                v = int(u)
                lvl -= 1
                path.append(v)
                break
        else:  # impossible for a level-synchronous stamping
            raise RuntimeError(f"blocked dist plane inconsistent at vertex {v}")
    return path


def _materialize_blocked_batch(out, pairs, elapsed: float, row_ptr, col_ind,
                               *, host_syncs: int | None = None
                               ) -> list[BFSResult]:
    """The blocked route's untimed epilogue: one host copy per output,
    then each found query's path from the dist planes (``[n_pad, 2B']``
    with ``B' >= len(pairs)``) over the host CSR."""
    best, meet, dist, levels, edges = (_host(o) for o in out)
    b_pad = dist.shape[1] // 2
    extra = dict(mode="blocked", host_syncs=host_syncs)
    results = []
    for i, (src, dst) in enumerate(pairs):
        if best[i] >= INF32:
            results.append(BFSResult(False, None, None, None, elapsed,
                                     int(levels[i]), int(edges[i]), **extra))
            continue
        m = int(meet[i])
        left = _walk_dist_plane(row_ptr, col_ind, dist[:, i], m)
        right = _walk_dist_plane(row_ptr, col_ind, dist[:, b_pad + i], m)
        results.append(BFSResult(True, int(best[i]), left[::-1] + right[1:],
                                 m, elapsed, int(levels[i]), int(edges[i]),
                                 **extra))
    return results


def solve_blocked_batch(g: BlockedDeviceGraph, pairs, *, csr, dt=None
                        ) -> list[BFSResult]:
    """Solve many (src, dst) queries through the blocked kernel
    (``solve_batch_graph``'s contract: ``time_s`` is the whole batch's
    wall clock). ``csr`` is the host ``(row_ptr, col_ind)`` the path walk
    reads."""
    from bibfs_tpu_torch.solvers.batch_minor import blocked_batch_dispatch
    from bibfs_tpu_torch.solvers.timing import force_scalar

    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    if pairs.size and not ((0 <= pairs).all() and (pairs < g.n).all()):
        raise ValueError(f"src/dst out of range for n={g.n}")
    stats = {"host_syncs": 0}
    pairs, thunk = blocked_batch_dispatch(g, pairs, dt=dt, stats=stats)
    t0 = time.perf_counter()
    out = thunk()
    force_scalar(out)
    elapsed = time.perf_counter() - t0
    return _materialize_blocked_batch(out, pairs, elapsed, *csr,
                                      host_syncs=stats["host_syncs"])


def solve_blocked_graph(g: BlockedDeviceGraph, src: int, dst: int, *, csr,
                        dt=None) -> BFSResult:
    """One query through the blocked kernel (a B = 1 plane, padded to 128
    lanes; the batched form is where the layout pays)."""
    if not (0 <= src < g.n and 0 <= dst < g.n):
        raise ValueError(f"src/dst out of range for n={g.n}")
    return solve_blocked_batch(g, [(src, dst)], csr=csr, dt=dt)[0]


def solve_dense(n: int, edges: np.ndarray, src: int, dst: int, *,
                mode: str = "sync", layout: str = "ell", unroll: int = 1,
                device=None, telemetry=None) -> BFSResult:
    return solve_dense_graph(
        DeviceGraph.build(n, edges, layout=layout, device=device), src, dst,
        mode=mode, unroll=unroll, telemetry=telemetry,
    )


@register("dense")
def _dense_backend(n, edges, src, dst, mode="sync", layout="ell", unroll=1,
                   device=None, telemetry=None, **_):
    return solve_dense(n, edges, src, dst, mode=mode, layout=layout,
                       unroll=unroll, device=device, telemetry=telemetry)
