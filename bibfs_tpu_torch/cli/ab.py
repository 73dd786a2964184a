"""Parent against change: dense search times of two checkouts of this
package in one process, interleaved solve by solve.

``python -m bibfs_tpu_torch.cli.ab PARENT_ROOT`` loads ``bibfs_tpu_torch``
from the checkout at PARENT_ROOT beside the one this module comes from
(each with its own modules, kernels and graph), builds G(2^scale,
8/2^scale) as plain ELL in each, and for 8 seeded pairs and each mode
times one solve in each checkout in turn (median of 3; host clock around
the solve and a synchronize), the first checkout alternating from round
to round. It prints one JSON line: the card, and per checkout and mode
the median and quartiles of those times, and whether the two checkouts
gave the same ``(best, meet, par_s, par_t, levels, edges)`` everywhere.
With ``--batch N`` it times lock-step batches in place of single solves
(``time_batch_only``, median of 3 a turn): N seeded pairs, or with
``--pad`` the deepest of the 8 pairs beside N - 1 pad lanes ``(0, 0)``
that finish at round 0 (a serving rung's pad).

With ``--blocked GEOM`` (``grid-128x1024`` or ``grid-64x64``, the grids
of ``chip_smoke.py`` phase 10) it times blocked batches instead: each
checkout builds the grid and its tile table, and per turn runs
``blocked_batch_dispatch``'s thunk of the same ``--batch`` seeded pairs
(default 256) three times (median; host clock around the batch and a
synchronize); it prints the same JSON line with ``same_results`` over
``(best, meet, dist, levels, edges)`` and each checkout's host reads.

With ``--oracle GEOM`` (``grid-500x500`` or ``gnp-deg8-s20``, the graphs
of ``chip_smoke.py`` phase 11) it times the oracle's index build instead:
each checkout builds the graph's host CSR, and per turn runs
``build_index`` of ``--k`` landmarks (default 64) three times (median),
each split by :func:`build_split` into the device sweeps, the copies
(CSR uploads, sources, planes back), the NumPy landmark scoring and the
index's construction; ``same_results`` compares landmarks and planes.

With ``--kinds GEOM`` (``grid-500x500`` and ``gnp-deg8-s20``, the graphs
of ``chip_smoke.py`` phase 13, or ``grid-RxC`` / ``gnp-deg8-sK`` cut
small) it times the query kinds' two kernels instead, on inputs built once
and uploaded by each checkout's own ``query_device``: per turn, three runs
(median) of ``delta_stepping`` (weight seed 0, the mean weight as delta)
on phase 13's pairs (the grid's 0 -> n - 1; four seeded gnp pairs) and of
``restricted_sweep`` on Yen's first iteration (the grid's 0 -> the first
vertex 100 levels out; the first gnp pair), from its seeded plane (and,
where the checkout takes them, its seeded entries); host clock around the
call and a synchronize. ``same_results`` compares the distances,
``buckets``, ``relaxations`` and ``passes``, and the planes with
``levels`` and ``run``; each checkout's last status words are kept.

With ``--analytics GEOM`` (``gnp-10000-d128``, the graph of
``chip_smoke.py`` phase 16, or any ``gnp-N-dD``: G(N, D / (N - 1)), seed
161) it times the analytics kernels instead: each checkout builds the
graph's tile table and uploads it (a checkout whose kernels take packed
tile rows also packs them once, as a serving runtime does), and per turn
runs a PageRank solve (damping 0.85, tolerance 1e-8, at most 100 steps),
the triangle chunk at column 0 and three (min, +) fixpoints of phase 16
(SSSP from 8 seeded sources on G(5000, 64 / 4999) under weight seed 0,
labels on GEOM, SSSP from one source on the 64x64 grid) three times each
(median; CUDA events around the call on the card, the host clock on the
CPU), and the change's pack alone. ``same_results`` holds the chunks'
counts, the fixpoints' planes bit for bit and their rounds equal and the
ranks within 1e-6 with the same iterations; the line also carries
``nvidia-smi``'s name and power limit of the card.

With ``--store GEOM`` (``gnp-deg8-s20``, the graph of ``chip_smoke.py``
phases 3 and 17, or ``gnp-deg8-sK`` cut small) it times a compaction of
the graph store's delta overlay instead, host code only: each checkout
builds the graph's ``GraphSnapshot``, and per turn a fresh
``DeltaOverlay`` over it applies ``--adds`` seeded non-edges and
``--dels`` seeded base edges (the first ``apply`` builds the overlay's
base-edge index) and folds them into a new snapshot (``snapshot()``),
each step timed once on the host clock. ``same_results`` holds the
folded snapshots' pairs and digests equal.

The host-bound modes' times drift by tens of percent from process to
process and over minutes; run in turns within one process, both
checkouts see the same drift. A card is used unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pkgutil
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

PKG = "bibfs_tpu_torch"


def _ours(name: str) -> bool:
    return name == PKG or name.startswith(PKG + ".")


def _load(root: Path | None) -> dict:
    """Every module of the package (its CLIs aside) from ``root``, or the
    ones already imported when ``root`` is None, as a ``sys.modules``
    snapshot."""
    if root is not None:
        for name in [m for m in sys.modules if _ours(m)]:
            del sys.modules[name]
        sys.path.insert(0, str(root))
    try:
        pkg = importlib.import_module(PKG)
        for info in pkgutil.walk_packages(pkg.__path__, PKG + "."):
            if not info.name.startswith(PKG + ".cli"):
                importlib.import_module(info.name)
    finally:
        if root is not None:
            sys.path.remove(str(root))
    return {m: mod for m, mod in sys.modules.items() if _ours(m)}


def _restore(saved: dict) -> None:
    """Put back the package modules that were imported before ``_load``,
    and unbind from those packages every submodule ``_load`` imported
    first: left bound, a later ``from package import module`` would bind
    a module that ``sys.modules`` no longer holds, where the next import
    now loads and registers it anew."""
    for name in [m for m in sys.modules if _ours(m)]:
        del sys.modules[name]
    sys.modules.update(saved)
    for name, mod in saved.items():
        for attr, val in list(vars(mod).items()):
            if (isinstance(val, types.ModuleType)
                    and val.__name__ == f"{name}.{attr}"
                    and val.__name__ not in saved):
                delattr(mod, attr)


def _same(a, b) -> bool:
    return (a[0] == b[0] and a[1] == b[1] and a[4:] == b[4:]
            and torch.equal(a[2], b[2]) and torch.equal(a[3], b[3]))


def _batch_pairs(dense, g, pairs, rng, b: int, pad: bool) -> np.ndarray:
    """``b`` seeded pairs, or the deepest of ``pairs`` (by its single
    search) followed by ``b - 1`` pad lanes ``(0, 0)``."""
    if not pad:
        return rng.integers(0, g.n, (b, 2))
    def hops(p):
        best = int(dense._run(g, *p, "sync", 1, None)[0])
        return best if best < 1 << 30 else -1

    deep = max(pairs, key=hops)
    return np.array([deep] + [(0, 0)] * (b - 1), np.int64)


def build_split(mods: dict, n: int, row_ptr, col_ind, k: int, device,
                sync) -> tuple:
    """``build_index(n, row_ptr, col_ind, k, device=device)`` of the
    checkout whose modules ``mods`` holds (``sys.modules`` entries of this
    package), timed on the host clock and split into ``sweeps_ms`` (inside
    ``msbfs_device.sweep``: the state's seeding, the kernel launches and
    their host reads), ``copies_ms`` (the rest of each sweep call: the CSR
    and sources uploaded, the plane copied back; and a separate CSR
    upload, where the build has one), ``scoring_ms`` (the rest of
    landmark selection: the NumPy scoring between batches) and
    ``index_ms`` (the rest: the index built from the planes). Returns
    ``(index, split)``."""
    md = mods[f"{PKG}.ops.msbfs_device"]
    lm = mods[f"{PKG}.oracle.landmarks"]
    trees = mods[f"{PKG}.oracle.trees"]
    spent = {"sweep": 0.0, "call": 0.0, "upload": 0.0, "select": 0.0}
    wrap = [(md, "sweep", "sweep"), (lm, "multi_source_dist", "call"),
            (lm, "select_landmarks", "select")]
    if hasattr(lm, "device_csr"):
        wrap.append((lm, "device_csr", "upload"))
    saved = []

    def timed(fn, key):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kw)
                sync()
                return out
            finally:
                spent[key] += (time.perf_counter() - t0) * 1e3
        return run

    for mod, name, key in wrap:
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, timed(getattr(mod, name), key))
    try:
        sync()
        t0 = time.perf_counter()
        idx = trees.build_index(n, row_ptr, col_ind, k, device=device)
        sync()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return idx, {
        "build_ms": total, "sweeps_ms": spent["sweep"],
        "copies_ms": spent["call"] - spent["sweep"] + spent["upload"],
        "scoring_ms": spent["select"] - spent["call"] - spent["upload"],
        "index_ms": total - spent["select"]}


#: the oracle A/B's graphs, as chip_smoke.py phase 11
ORACLE_GRAPHS = ("grid-500x500", "gnp-deg8-s20")


def _oracle_ab(snaps, geom: str, k: int, rounds: int, dev, sync) -> dict:
    """Index builds of both checkouts in turns (module docstring)."""
    csrs = {}
    for who, snap in snaps.items():
        sys.modules.update(snap)
        gen = snap[f"{PKG}.graph.generate"]
        if geom == "grid-500x500":
            n, edges = 500 * 500, gen.grid_graph(500, 500, perforation=0.02,
                                                 seed=1)
        else:
            n = 1 << 20
            edges = gen.gnp_random_graph(n, 8 / n, seed=7)
        csrs[who] = snap[f"{PKG}.graph.csr"].build_csr(n, edges)
    splits = {w: [] for w in snaps}
    same = True
    for rnd in range(rounds):
        order = ("parent", "change") if rnd % 2 == 0 else ("change", "parent")
        outs = {}
        for who in order:
            sys.modules.update(snaps[who])
            outs[who], _ = build_split(snaps[who], n, *csrs[who], k, dev,
                                       sync)  # warm
            runs = [build_split(snaps[who], n, *csrs[who], k, dev, sync)[1]
                    for _ in range(3)]
            runs.sort(key=lambda r: r["build_ms"])
            splits[who].append(runs[1])
        same &= (np.array_equal(outs["parent"].landmarks,
                                outs["change"].landmarks)
                 and np.array_equal(outs["parent"].dist, outs["change"].dist))
        del outs
    line = {"geometry": geom, "n": n, "k": k, "rounds": rounds,
            "same_results": bool(same)}
    for who, v in splits.items():
        build = [r["build_ms"] for r in v]
        line[f"{who}/build_index"] = {
            "median_ms": float(np.median(build)),
            "p25_ms": float(np.percentile(build, 25)),
            "p75_ms": float(np.percentile(build, 75)), "builds": len(v),
            **{key: float(np.median([r[key] for r in v]))
               for key in ("sweeps_ms", "copies_ms", "scoring_ms",
                           "index_ms")}}
    return line


#: the query-kind A/B's graphs, as chip_smoke.py phase 13 (or cut small:
#: grid-RxC, gnp-deg8-sK)
KIND_GRAPHS = ("grid-500x500", "gnp-deg8-s20")
KIND_PAIR_SEED = 151  # phase 13's gnp pairs
KIND_GRID_HOPS = 100  # the restricted sweep's grid pair


def _kind_graph(snap, geom: str):
    """``(n, canonical pairs, row_ptr, col_ind)`` of a --kinds geometry."""
    gen = snap[f"{PKG}.graph.generate"]
    csr = snap[f"{PKG}.graph.csr"]
    kind, _, shape = geom.partition("-")
    if kind == "grid":
        rows, cols = (int(x) for x in shape.split("x"))
        n, edges = rows * cols, gen.grid_graph(rows, cols, perforation=0.02,
                                               seed=1)
    elif kind == "gnp" and shape.startswith("deg8-s"):
        n = 1 << int(shape[len("deg8-s"):])
        edges = gen.gnp_random_graph(n, 8 / n, seed=7)
    else:
        raise ValueError(f"--kinds: no geometry {geom!r}")
    pairs = csr.canonical_pairs(n, edges)
    return (n, pairs, *csr.build_csr(n, pairs=pairs))


def _kind_pairs(geom: str, n: int, rp, ci, lv) -> tuple:
    """Phase 13's delta pairs and the restricted sweep's pair."""
    if geom.startswith("grid"):
        far = np.flatnonzero(lv == min(KIND_GRID_HOPS, int(lv.max())))
        return [(0, n - 1)], (0, int(far[0]))
    rng = np.random.default_rng(KIND_PAIR_SEED)
    linked = np.flatnonzero(np.diff(rp) > 0)
    pairs = [tuple(int(x) for x in rng.choice(linked, 2, replace=False))
             for _ in range(4)]
    return pairs, pairs[0]


def _kinds_ab(snaps, geom: str, rounds: int, dev, sync) -> dict:
    """The query kinds' kernels of both checkouts in turns (module
    docstring)."""
    import inspect

    change = snaps["change"]
    sys.modules.update(change)
    n, pairs, rp, ci = _kind_graph(change, geom)
    kshort = change[f"{PKG}.query.kshortest"]
    weighted = change[f"{PKG}.query.weighted"]
    ell = change[f"{PKG}.graph.csr"].build_ell(n, pairs=pairs)
    w = weighted.synthetic_weights(rp, ci, 0)
    delta = float(w.mean())
    lv = change[f"{PKG}.oracle"].multi_source_bfs(n, rp, ci, np.array([0]))[:, 0]
    dpairs, (s0, d0) = _kind_pairs(geom, n, rp, ci, lv)
    first = kshort.bfs_restricted(n, rp, ci, s0, d0)
    cands = [(first[i], set(first[:i]), {(first[i], first[i + 1])})
             for i in range(len(first) - 1)]
    rpd = torch.from_numpy(rp).to(dev)
    cid = torch.from_numpy(ci.astype(np.int32)).to(dev)
    runs = {}
    for who, snap in snaps.items():
        sys.modules.update(snap)
        qd = snap[f"{PKG}.solvers.query_device"]
        tables = qd.delta_tables(ell, 0, device=dev)
        b = qd._pad_candidates(len(cands))
        seed, blocked = qd.seed_candidates(n, rp, ci, cands, b, dev)
        kw = {}
        if "seeds" in inspect.signature(qd.restricted_sweep).parameters:
            kw["seeds"] = qd.seed_entries(qd.candidate_seeds(n, rp, ci, cands),
                                          dev)
        runs[who] = (qd, tables, seed, blocked, kw)
    times = {(w_, k): [] for w_ in snaps for k in ("delta", "restricted")}
    status = {w_: {} for w_ in snaps}
    same = True

    def timed(fn, reset=None):
        ts = []
        for _ in range(3):
            if reset is not None:
                reset()
            sync()
            t0 = time.perf_counter()
            out = fn()
            sync()
            ts.append(time.perf_counter() - t0)
        return out, float(np.median(ts)) * 1e3

    for rnd in range(rounds):
        order = ("parent", "change") if rnd % 2 == 0 else ("change", "parent")
        outs: dict = {}
        for who in order:
            sys.modules.update(snaps[who])
            qd, (tgt, wts), seed, blocked, kw = runs[who]
            got = []
            for s, d in dpairs:
                (dist, info), ms = timed(
                    lambda: qd.delta_stepping(tgt, wts, s, d, delta))
                times[(who, "delta")].append(ms)
                got.append((dist.cpu(), {k: info[k] for k in
                                         ("buckets", "relaxations", "passes")}))
                status[who]["delta_stepping"] = info
            work = seed.clone()
            st, ms = timed(
                lambda: qd.restricted_sweep(rpd, cid, work, blocked, d0, **kw),
                lambda: work.copy_(seed))
            times[(who, "restricted")].append(ms)
            status[who]["restricted_sweep"] = st
            outs[who] = (got, work.cpu(), (st["levels"], st["run"]))
        pa, ch = outs["parent"], outs["change"]
        same &= (all(torch.equal(x[0], y[0]) and x[1] == y[1]
                     for x, y in zip(pa[0], ch[0]))
                 and torch.equal(pa[1], ch[1]) and pa[2] == ch[2])
    line = {"geometry": geom, "n": n, "rounds": rounds,
            "delta_pairs": [list(p) for p in dpairs],
            "restricted_pair": [s0, d0], "candidates": len(cands),
            "same_results": bool(same)}
    for (who, k), v in times.items():
        name = "delta_stepping" if k == "delta" else "restricted_sweep"
        line[f"{who}/{name}"] = {
            "median_ms": float(np.median(v)),
            "p25_ms": float(np.percentile(v, 25)),
            "p75_ms": float(np.percentile(v, 75)), "solves": len(v),
            "status": status[who][name]}
    return line


#: the analytics A/B's graphs, as chip_smoke.py phase 16 (or gnp-N-dD)
ANALYTICS_GRAPHS = ("gnp-10000-d128",)
ANALYTICS_SEED = 161  # phase 16's gnp-10000-d128
RANK_ERR = 1e-6  # the two checkouts' PageRank ranks
#: the fixpoints' graphs, as chip_smoke.py phase 16: G(5000, 64 / 4999)
#: (n, mean degree, seed) and the 64 x 64 grid (2% of its edges removed);
#: a test may set smaller ones and restore them
FIXPOINT_GNP = (5000, 64, 163)
FIXPOINT_GRID = (64, 64)


def _analytics_graph(snap, geom: str):
    """``(n, BlockedGraph)`` of a --analytics geometry."""
    kind, n, deg = (geom.split("-") + ["", ""])[:3]
    if kind != "gnp" or not n.isdigit() or not deg[1:].isdigit() or \
            deg[:1] != "d" or int(n) < 2:
        raise ValueError(f"--analytics: no geometry {geom!r}")
    n = int(n)
    edges = snap[f"{PKG}.graph.generate"].gnp_random_graph(
        n, int(deg[1:]) / (n - 1), seed=ANALYTICS_SEED)
    pairs = snap[f"{PKG}.graph.csr"].canonical_pairs(n, edges)
    return n, snap[f"{PKG}.graph.blocked"].build_blocked(n, pairs=pairs)


def _card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _fixpoint_inputs(snap, dev, geom: str, geom_bg) -> dict:
    """One checkout's three (min, +) fixpoints of ``chip_smoke.py`` phase
    16, built and uploaded by its own modules: step name -> ``(table,
    bcol, init, from_tab, kw)``, ``kw`` the packed rows where its
    ``minplus_fixpoint`` takes them."""
    import inspect

    gen = snap[f"{PKG}.graph.generate"]
    csr = snap[f"{PKG}.graph.csr"]
    blk = snap[f"{PKG}.graph.blocked"]
    sr = snap[f"{PKG}.ops.semiring_plane"]
    packed = "bits" in inspect.signature(sr.minplus_fixpoint).parameters

    def put(a):
        return torch.from_numpy(np.array(a)).to(dev)

    def blocked(n, edges):
        pairs = csr.canonical_pairs(n, edges)
        return pairs, blk.build_blocked(n, pairs=pairs)

    def sssp(n, pairs, bg, c):
        srcs = np.random.default_rng(0).choice(n, c, replace=False)
        init = np.full((bg.n_pad, c), np.inf, np.float32)
        init[srcs, np.arange(c)] = 0.0
        w = put(blk.build_blocked_weights(bg, pairs, seed=0))
        return w, put(bg.bcol), put(init), False

    out = {}
    n, deg, seed = FIXPOINT_GNP
    pairs, bg = blocked(n, gen.gnp_random_graph(n, deg / (n - 1), seed=seed))
    out[f"gnp-{n}-d{deg} sssp C=8"] = (*sssp(n, pairs, bg, 8), bg)
    r, c = FIXPOINT_GRID
    pairs, gbg = blocked(r * c, gen.grid_graph(r, c, perforation=0.02,
                                               seed=1))
    out[f"grid-{r}x{c} sssp C=1"] = (*sssp(r * c, pairs, gbg, 1), gbg)
    bg = geom_bg
    out[f"{geom} components"] = (
        put(bg.tab), put(bg.bcol),
        put(np.arange(bg.n_pad, dtype=np.float32)[:, None]), True, bg)
    for step, (table, bcol, init, from_tab, b) in list(out.items()):
        kw = {"bits": sr.pack_tile_rows(put(b.tab))} if packed else {}
        out[step] = (table, bcol, init, from_tab, kw)
    return out


def _analytics_ab(snaps, geom: str, rounds: int, dev, sync) -> dict:
    """The PageRank and triangle kernels and the three (min, +) fixpoints
    of both checkouts in turns, and the change's pack (module
    docstring)."""
    import inspect

    runs, fixes = {}, {}
    for who, snap in snaps.items():
        sys.modules.update(snap)
        n, bg = _analytics_graph(snap, geom)
        g = snap[f"{PKG}.solvers.dense"].BlockedDeviceGraph.from_host(
            bg, device=dev)
        sr = snap[f"{PKG}.ops.semiring_plane"]
        kw = {}
        if "bits" in inspect.signature(sr.pagerank_blocked).parameters:
            kw["bits"] = sr.pack_tile_rows(g.tab)
        runs[who] = (sr, g, kw)
        fixes[who] = _fixpoint_inputs(snap, dev, geom, bg)
    pr_kw = dict(n=n, damping=0.85, tol=1e-8, max_iters=100)

    def timed(fn):
        ts, out = [], None
        for _ in range(3):
            sync()
            if dev.type == "cuda":
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn()
                b.record()
                b.synchronize()
                ts.append(a.elapsed_time(b))
            else:
                t0 = time.perf_counter()
                out = fn()
                ts.append((time.perf_counter() - t0) * 1e3)
        return out, float(np.median(ts))

    steps = list(fixes["change"])
    times = {k: [] for k in ("parent/pagerank", "change/pagerank",
                             "parent/tricount", "change/tricount",
                             "change/pack")}
    times.update({f"{who}/minplus {step}": [] for step in steps
                  for who in ("parent", "change")})
    iters, fix_rounds = {}, {}
    same, err = True, 0.0
    for rnd in range(rounds):
        order = ("parent", "change") if rnd % 2 == 0 else ("change", "parent")
        outs, planes = {}, {}
        for who in order:
            sys.modules.update(snaps[who])
            sr, g, kw = runs[who]
            for step, (table, bcol, init, from_tab, fkw) in fixes[who].items():
                def fix():
                    return sr.minplus_fixpoint(table, bcol, init,
                                               from_tab=from_tab, **fkw)
                fix()  # warm
                (plane, r), ms = timed(fix)
                times[f"{who}/minplus {step}"].append(ms)
                fix_rounds[who, step] = r
                planes[who, step] = plane
            sr.pagerank_blocked(g.tab, g.bcol, g.deg, **pr_kw, **kw)  # warm
            (ranks, it, _d), ms = timed(lambda: sr.pagerank_blocked(
                g.tab, g.bcol, g.deg, **pr_kw, **kw))
            times[f"{who}/pagerank"].append(ms)
            iters[who] = it
            sr.triangles_chunk_blocked(g.tab, g.bcol, 0, **kw)  # warm
            tri, ms = timed(lambda: sr.triangles_chunk_blocked(
                g.tab, g.bcol, 0, **kw))
            times[f"{who}/tricount"].append(ms)
            if who == "change":
                _bits, ms = timed(lambda: sr.pack_tile_rows(g.tab))
                times["change/pack"].append(ms)
            outs[who] = (ranks.cpu(), it, int(tri))
        pa, ch = outs["parent"], outs["change"]
        diff = float((pa[0] - ch[0]).abs().max())
        err = max(err, diff)
        same &= diff <= RANK_ERR and pa[1] == ch[1] and pa[2] == ch[2]
        same &= all(torch.equal(planes["parent", st], planes["change", st])
                    and fix_rounds["parent", st] == fix_rounds["change", st]
                    for st in steps)
        del planes
    bg = runs["change"][1]
    line = {"geometry": geom, "n": n, "nblocks": bg.nblocks,
            "bwidth": bg.bwidth, "rounds": rounds,
            "same_results": bool(same), "max_abs_rank_diff": err}
    for key, v in times.items():
        line[key] = {"median_ms": float(np.median(v)),
                     "p25_ms": float(np.percentile(v, 25)),
                     "p75_ms": float(np.percentile(v, 75)), "runs": len(v)}
        if key.endswith("pagerank"):
            line[key]["iters"] = iters[key.split("/")[0]]
        if "/minplus " in key:
            who, step = key.split("/minplus ")
            line[key]["rounds"] = fix_rounds[who, step]
    return line


#: the blocked A/B's grids: (rows, columns), as chip_smoke.py phase 10
STORE_GRAPHS = ("gnp-deg8-s20",)
STORE_SEED = 171  # the seeded delta's edges


def _store_delta(n: int, pairs: np.ndarray, adds: int, dels: int):
    """``adds`` seeded non-edges and ``dels`` seeded base edges of the
    canonical ``pairs``, as ``(u, v)`` tuples with ``u < v``."""
    rng = np.random.default_rng(STORE_SEED)
    und = pairs[pairs[:, 0] < pairs[:, 1]]
    keys = und[:, 0] * np.int64(n) + und[:, 1]
    gone = [tuple(map(int, e)) for e in
            und[rng.choice(len(und), size=dels, replace=False)]]
    fresh: set = set()
    while len(fresh) < adds:
        u, v = sorted(int(x) for x in rng.integers(0, n, 2))
        k = u * n + v
        i = int(np.searchsorted(keys, k))
        if u != v and not (i < keys.size and keys[i] == k):
            fresh.add((u, v))
    return sorted(fresh), gone


def _store_ab(snaps, geom: str, rounds: int, adds: int, dels: int) -> dict:
    """Overlay compactions of both checkouts in turns (module
    docstring)."""
    kind, _, shape = geom.partition("-")
    if kind != "gnp" or not shape.startswith("deg8-s") or \
            not shape[len("deg8-s"):].isdigit():
        raise ValueError(f"--store: no geometry {geom!r}")
    n = 1 << int(shape[len("deg8-s"):])
    bases, delta = {}, None
    for who, snap in snaps.items():
        sys.modules.update(snap)
        edges = snap[f"{PKG}.graph.generate"].gnp_random_graph(n, 8 / n,
                                                                 seed=7)
        bases[who] = snap[f"{PKG}.store.snapshot"].GraphSnapshot.build(n,
                                                                      edges)
        if delta is None:
            delta = _store_delta(n, bases[who].pairs, adds, dels)
    times = {(w, step): [] for w in snaps for step in ("apply", "snapshot")}
    same = True
    for rnd in range(rounds):
        order = ("parent", "change") if rnd % 2 == 0 else ("change", "parent")
        outs = {}
        for who in order:
            sys.modules.update(snaps[who])
            ov = snaps[who][f"{PKG}.store.delta"].DeltaOverlay(bases[who])
            t0 = time.perf_counter()
            ov.apply(*delta)
            t1 = time.perf_counter()
            outs[who] = ov.snapshot()[0]
            t2 = time.perf_counter()
            times[(who, "apply")].append((t1 - t0) * 1e3)
            times[(who, "snapshot")].append((t2 - t1) * 1e3)
        same &= (np.array_equal(outs["parent"].pairs, outs["change"].pairs)
                 and outs["parent"].digest == outs["change"].digest)
        del outs
    line = {"geometry": geom, "n": n,
            "edges": int(bases["change"].pairs.shape[0] // 2),
            "adds": adds, "dels": dels, "rounds": rounds,
            "same_results": bool(same)}
    for (who, step), v in times.items():
        line[f"{who}/{step}"] = {
            "median_ms": float(np.median(v)),
            "p25_ms": float(np.percentile(v, 25)),
            "p75_ms": float(np.percentile(v, 75)), "runs": len(v)}
    return line


BLOCKED_GRIDS = {"grid-128x1024": (128, 1024), "grid-64x64": (64, 64)}


def _blocked_ab(snaps, geom: str, b: int, rounds: int, dev, sync) -> dict:
    """Blocked batches of both checkouts in turns (module docstring)."""
    rows, cols = BLOCKED_GRIDS[geom]
    n = rows * cols
    pairs = np.random.default_rng(7).integers(0, n, (b, 2))
    thunks, reads = {}, {}
    for who, snap in snaps.items():
        sys.modules.update(snap)
        edges = snap[f"{PKG}.graph.generate"].grid_graph(
            rows, cols, perforation=0.02, seed=1)
        bg = snap[f"{PKG}.graph.blocked"].build_blocked(n, edges)
        g = snap[f"{PKG}.solvers.dense"].BlockedDeviceGraph.from_host(
            bg, device=dev)
        reads[who] = {"host_syncs": 0}
        thunks[who] = snap[f"{PKG}.solvers.batch_minor"].blocked_batch_dispatch(
            g, pairs, stats=reads[who])[1]
    times = {w: [] for w in snaps}
    same = True
    for rnd in range(rounds):
        order = ("parent", "change") if rnd % 2 == 0 else ("change", "parent")
        outs = {}
        for who in order:
            sys.modules.update(snaps[who])
            outs[who] = thunks[who]()  # warm
            sync()
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                thunks[who]()
                sync()
                ts.append(time.perf_counter() - t0)
            times[who].append(float(np.median(ts)) * 1e3)
        same &= all(torch.equal(x.contiguous(), y.contiguous())
                    for x, y in zip(outs["parent"], outs["change"]))
        del outs
    line = {"geometry": geom, "n": n, "batch": b, "rounds": rounds,
            "same_results": bool(same)}
    for who, v in times.items():
        hr = reads[who]["host_syncs"] // (4 * rounds)
        line[f"{who}/blocked"] = {
            "median_ms": float(np.median(v)),
            "p25_ms": float(np.percentile(v, 25)),
            "p75_ms": float(np.percentile(v, 75)), "batches": len(v),
            "host_reads_per_batch": hr,
            "ms_per_round": float(np.median(v)) / max(hr - 1, 1)}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path, help="root of the other checkout")
    ap.add_argument("--modes", default="pallas_alt,pallas,beamer,sync")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=0,
                    help="time lock-step batches of this many queries")
    ap.add_argument("--pad", action="store_true",
                    help="a batch of the deepest pair and pad lanes (0, 0)")
    ap.add_argument("--blocked", choices=sorted(BLOCKED_GRIDS),
                    help="time blocked batches on this grid")
    ap.add_argument("--oracle", choices=ORACLE_GRAPHS,
                    help="time the oracle's index build on this graph")
    ap.add_argument("--k", type=int, default=64,
                    help="landmarks of the --oracle index")
    ap.add_argument("--kinds", metavar="GEOM",
                    help="time the query kinds' kernels on this graph "
                         f"({', '.join(KIND_GRAPHS)}, grid-RxC, gnp-deg8-sK)")
    ap.add_argument("--analytics", metavar="GEOM",
                    help="time the analytics kernels on this "
                         f"graph ({', '.join(ANALYTICS_GRAPHS)}, gnp-N-dD)")
    ap.add_argument("--store", metavar="GEOM",
                    help="time a delta overlay's compaction on this graph "
                         f"({', '.join(STORE_GRAPHS)}, gnp-deg8-sK)")
    ap.add_argument("--adds", type=int, default=24,
                    help="seeded edge inserts of the --store delta")
    ap.add_argument("--dels", type=int, default=8,
                    help="seeded edge deletes of the --store delta")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("ab: CUDA is not available", file=sys.stderr)
        return 2

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    saved = {m: mod for m, mod in sys.modules.items() if _ours(m)}
    snaps = {"change": _load(None), "parent": _load(args.parent.resolve())}
    if args.blocked or args.oracle or args.kinds or args.analytics or \
            args.store:
        try:
            if args.store:
                line = _store_ab(snaps, args.store, args.rounds, args.adds,
                                 args.dels)
                if dev.type == "cuda":
                    line["nvidia_smi"] = _card_line()
            elif args.analytics:
                line = _analytics_ab(snaps, args.analytics, args.rounds, dev,
                                     sync)
                if dev.type == "cuda":
                    line["nvidia_smi"] = _card_line()
            elif args.blocked:
                line = _blocked_ab(snaps, args.blocked, args.batch or 256,
                                   args.rounds, dev, sync)
            elif args.oracle:
                line = _oracle_ab(snaps, args.oracle, args.k, args.rounds,
                                  dev, sync)
            else:
                line = _kinds_ab(snaps, args.kinds, args.rounds, dev, sync)
        finally:
            _restore(saved)
        card = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
        print(json.dumps({"card": card, **line}), flush=True)
        return 0
    try:
        n = 1 << args.scale
        graphs, dense = {}, {}
        for who, snap in snaps.items():
            sys.modules.update(snap)
            mods = {m: snap[f"{PKG}.{m}"] for m in
                    ("solvers.dense", "graph.generate", "graph.csr")}
            edges = mods["graph.generate"].gnp_random_graph(n, 8 / n, seed=7)
            canon = mods["graph.csr"].canonical_pairs(n, edges)
            dense[who] = mods["solvers.dense"]
            graphs[who] = dense[who].DeviceGraph.build(
                n, edges, layout="ell", device=dev, pairs=canon)
        rng = np.random.default_rng(7)
        pairs = [(int(a), int(b)) for a, b in rng.integers(0, n, (8, 2))]
        modes = args.modes.split(",")
        times = {(w, m): [] for w in snaps for m in modes}
        same = True
        if args.batch:
            sys.modules.update(snaps["change"])
            bpairs = _batch_pairs(dense["change"], graphs["change"], pairs,
                                  rng, args.batch, args.pad)
        for rnd in range(args.rounds):
            order = ("parent", "change") if rnd % 2 == 0 else ("change", "parent")
            for mode in modes:
                if args.batch:
                    outs = {}
                    for who in order:
                        sys.modules.update(snaps[who])
                        g = graphs[who]
                        _p, dispatch, finish = dense[who]._batch_dispatch(
                            g, bpairs, mode)
                        outs[who] = finish(dispatch())
                        ts = dense[who].time_batch_only(g, bpairs, repeats=3,
                                                        mode=mode)
                        times[(who, mode)].append(float(np.median(ts)) * 1e3)
                    same &= all(torch.equal(x, y) for x, y in
                                zip(outs["parent"], outs["change"]))
                    continue
                for s, d in pairs:
                    outs = {}
                    for who in order:
                        sys.modules.update(snaps[who])
                        run = dense[who]._run
                        outs[who] = run(graphs[who], s, d, mode, 1, None)  # warm
                        sync()
                        ts = []
                        for _ in range(3):
                            t0 = time.perf_counter()
                            run(graphs[who], s, d, mode, 1, None)
                            sync()
                            ts.append(time.perf_counter() - t0)
                        times[(who, mode)].append(float(np.median(ts)) * 1e3)
                    same &= _same(outs["parent"], outs["change"])
    finally:
        _restore(saved)
    card = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    print(json.dumps({
        "card": card, "n": n, "pairs": len(pairs), "rounds": args.rounds,
        "batch": args.batch, "pad": args.pad,
        "same_results": bool(same),
        **{f"{w}/{m}": {"median_ms": float(np.median(v)),
                        "p25_ms": float(np.percentile(v, 25)),
                        "p75_ms": float(np.percentile(v, 75)), "solves": len(v)}
           for (w, m), v in times.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
