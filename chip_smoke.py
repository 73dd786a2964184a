#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Usage: ``python3 chip_smoke.py`` from the root of a checkout, with one
NVIDIA Hopper card. It exits non-zero on any failed phase and when CUDA
is unavailable. Phases:

1. Device and build: the card's name and power limit (``nvidia-smi``),
   then ``nvcc`` builds the CUDA sources of ``bibfs_tpu_torch/csrc``.
2. Kernels against their plain torch versions, on the card, at the
   geometry of phase 3 and at a small ragged one, from a seeded random
   mid-search state: exact equality, median time per launch (CUDA events,
   25 launches), the least time the card could take (bytes moved over
   3.35 TB/s) and the least time any launch takes (an empty kernel,
   ``launch_floor_ms``), which is the real floor of the one-thread fold.
   Both instantiations of kernel 2, staged (the wrapper) and unstaged
   (:data:`UNSTAGED`), are held against the plain twin and timed. One
   ``step`` line per kernel instantiation and geometry carries its time,
   its bound and an estimate of the table sectors the claim touches
   (``est_sector_mb``, from the inputs); the pull kernels' lines also
   carry the bound with a byte frontier row (``bound_ms_byte_row``), and
   two more lines time the tiered route's rebuild of the next frontier
   after the tier pass (``rebuild_bits``, ``rebuild_pair``).
3. Main path: G(2^20, 8/2^20) (1,048,576 vertices, about 4.19M edges),
   plain ELL, 8 seeded pairs plus one src == dst pair, modes sync, alt,
   beamer, pallas, pallas_alt, fused and fused_alt. Every answer matches
   the serial oracle and passes ``validate_path``; fused == pallas == sync
   and fused_alt == pallas_alt == alt exactly on (best, meet, par_s,
   par_t, levels, edges); fused gives the same result with unroll 1 and 8;
   every kernel's launch count rises.
   Phase 2 also holds the batch-minor level (``minor_level``, both
   instantiations: int32 planes for ``minor``, int8 for ``minor8``)
   against its packed plain twin at the batch geometry of 256 queries on
   gnp-deg8-s20 and of 128 on the 3001-row graph and on one with five
   hubs of about 90 neighbours (rows wider than the slots the kernel
   stages), from a seeded mid-search state made on the card (the packed
   frontier and visited words, the planes, counters and meet keys
   exactly equal; the input key is the state's full vote), with a
   ``step`` line per instantiation
   (kernel ms, the twin's ms, the bound on the packed state, the bound of
   the int planes the kernel read before, an estimate of the dist and
   parent sectors the claims touch, the level launches of one batch).
4. Tiered: RMAT scale 20, edge factor 16 (about 15.7M edges); the
   kernels against their plain versions at its base table (kernels 3 and
   4 timed there too), then modes
   sync, pallas, pallas_alt and fused (which runs as pallas); oracle hops
   and pallas == sync exactly. Then batch routing on it: ``auto`` with
   256 queries takes the per-query ``sync`` path and ``minor`` is refused
   (a tier's parent key overflows int32); ``auto`` with 8 pairs runs per
   query and matches the oracle.
5. Batches (run between phases 3 and 4 on the phase 3 graph): 256 seeded
   pairs (one ``src == dst``, one to an isolated vertex) through
   ``time_batch_graph`` in modes minor8, minor and auto (a warm-up, then
   the median of 5), one ``batch`` line each with the batch ms, the ms per
   query beside a single ``fused`` solve's and the host reads per batch;
   minor8 (decoded) == minor == auto on every output, parent rows
   included; 16 pairs equal the single-query ``fused`` search in (best,
   meet, levels, edges) and the oracle in hops; every path passes
   ``validate_path``; both instantiations' launch counts rise.
6. Tiered batches on RMAT scale 17, edge factor 16 (the largest scale of
   the family whose tiers ``minor`` admits): 256 pairs in mode minor,
   checked as in phase 5 against the single-query ``sync`` search; then a
   600-vertex path graph whose deepest query passes the int8 cap: the
   minor8 refill equals minor.
7. The serving engine (run after phase 5 on the phase 3 graph):
   ``QueryEngine(n, edges, max_batch=256, cache_entries=512)`` on the
   default device (``cuda``). Wave A, 256 distinct seeded pairs (one
   ``src == dst``, one to an isolated vertex) under ``mode="auto"``: one
   ``minor8`` device flush of 255 queries, equal to
   ``solve_batch_graph(g, pairs, mode="minor8")`` on every field but the
   time, hops equal to the serial oracle, paths valid. Wave B, 256 pairs
   whose sources are wave A's (exact repeats, reverse twins, meet
   vertices): all from the distance cache, no new device batch. Wave C,
   16 fresh pairs below the crossover: the native host route; then the
   same 16 pairs as one device flush (``C[device]``, ``flush_threshold=1``
   on a second engine), the card's side of the crossover. Wave D,
   64 pairs through a second engine in ``mode="pallas"`` (kernel 3) and a
   third in ``mode="pallas_alt"`` (kernel 4), each equal to
   ``solve_batch_graph`` in that mode. Every wave fails on any fallback,
   retry, injected fault, error or breaker that is not closed; each
   prints one ``{"phase": "engine", ...}`` line (queries and routes,
   flush ms, queries/s from submit to result, the launches of each
   kernel, the summed ms of the engine's trace spans, and the build
   seconds of the snapshot, the bucketed table and the native runtime).

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the card's name and power limit, and before that the ``kernels``
JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from bibfs_tpu_torch.graph.csr import build_csr, canonical_pairs
from bibfs_tpu_torch.graph.generate import gnp_random_graph, rmat_graph
from bibfs_tpu_torch.ops import _cuda
from bibfs_tpu_torch.ops import bitmap as bm
from bibfs_tpu_torch.ops import fused_level as fl
from bibfs_tpu_torch.ops import minor_level as ml
from bibfs_tpu_torch.ops import pull_expand as pe
from bibfs_tpu_torch.ops.expand import pack_dual
from bibfs_tpu_torch.solvers import batch_minor as bmin
from bibfs_tpu_torch.obs.trace import Tracer, set_tracer
from bibfs_tpu_torch.serve import QueryEngine
from bibfs_tpu_torch.solvers import dense
from bibfs_tpu_torch.solvers.api import validate_path
from bibfs_tpu_torch.solvers.serial import solve_serial_csr

INF32 = 1 << 30
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
ALU_OPS_PER_S = 67e12  # H100 SXM non-tensor-core rate (NVIDIA data sheet)
SLEEP_CYCLES = 2_000_000  # keeps the card busy while the host enqueues a launch
REPS = 25

KERNELS = {  # wrapper, plain twin, source, the Pallas kernel it replaces
    "fused_dual_round": (fl.fused_dual_round, fl.fused_dual_round_plain,
                         "bibfs_tpu_torch/csrc/fused_level.cu",
                         "bibfs_tpu/ops/pallas_fused.py:145"),
    "fused_single_round": (fl.fused_single_round, fl.fused_single_round_plain,
                           "bibfs_tpu_torch/csrc/fused_level.cu",
                           "bibfs_tpu/ops/pallas_fused.py:249"),
    "pull_dual": (pe.pull_dual, pe.pull_dual_plain,
                  "bibfs_tpu_torch/csrc/pull_expand.cu",
                  "bibfs_tpu/ops/pallas_expand.py:195"),
    "pull_single": (pe.pull_single, pe.pull_single_plain,
                    "bibfs_tpu_torch/csrc/pull_expand.cu",
                    "bibfs_tpu/ops/pallas_expand.py:186"),
    # not a Pallas kernel: the scalar fixup after each fused round
    "fold_round": (fl.fold_round, fl.fold_round_plain,
                   "bibfs_tpu_torch/csrc/fused_level.cu",
                   "bibfs_tpu/solvers/dense.py:812"),
}
# the batch-minor level, one entry per instantiation (int32 planes for mode
# "minor", int8 for "minor8"); not a Pallas kernel but the XLA program of
# the reference's _level_scan. Its wrapper counts per instantiation.
MINOR = {
    "minor_level[minor]": ("minor", "bibfs_tpu_torch/csrc/batch_minor.cu",
                           "bibfs_tpu/solvers/batch_minor.py:133"),
    "minor_level[minor8]": ("minor8", "bibfs_tpu_torch/csrc/batch_minor.cu",
                            "bibfs_tpu/solvers/batch_minor.py:133"),
}
BATCH = 256  # queries of a batch at full size


# the unstaged instantiation of kernel 2, which the wrapper takes only
# where the bitmap does not fit shared memory (not counted in .launches)
UNSTAGED = fl._single_round_unstaged


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def reset_counts() -> None:
    for wrapper, *_ in KERNELS.values():
        wrapper.launches = 0
    for key in ml.minor_level.launches:
        ml.minor_level.launches[key] = 0


def counts() -> dict:
    out = {name: k[0].launches for name, k in KERNELS.items()}
    for name, (key, *_r) in MINOR.items():
        out[name] = ml.minor_level.launches[key]
    return out


def max_abs_err(a, b) -> int:
    """Largest absolute difference over matching outputs (ints)."""
    err = 0
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            check(x.shape == y.shape, f"shape {tuple(x.shape)} != {tuple(y.shape)}")
            if x.numel():
                err = max(err, int((x.long() - y.long()).abs().max()))
        else:
            err = max(err, abs(int(x) - int(y)))
    return err


def time_launch(fn, prep=None, reps: int = REPS) -> float:
    """Median ms of one call of ``fn`` over ``reps`` calls (after 2
    warm-ups), each between two CUDA events; ``prep`` restores the inputs
    outside the timed interval, and a sleep kernel keeps the card busy
    while the host enqueues the call."""
    times = []
    for i in range(reps + 2):
        if prep is not None:
            prep()
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        if i >= 2:
            times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def slots_needed(nbr_t, n_rows: int, front, want) -> int:
    """Table slots a row-at-a-time claim must read for this state: live
    slots of each row, in order, until every wanted side has a hit."""
    vals = pe.gather_bits(front, nbr_t, n_rows)
    live = nbr_t[:, :n_rows] < front.shape[0]
    want = want.to(torch.uint8)
    found = torch.zeros(n_rows, dtype=torch.uint8, device=nbr_t.device)
    read = torch.zeros(n_rows, dtype=torch.int64, device=nbr_t.device)
    for j in range(nbr_t.shape[0]):
        going = (found != want) & live[j]
        read += going.long()
        found |= torch.where(going, vals[j] & want, 0).to(torch.uint8)
    return int(read.sum())


def sector_bytes(nbr_t, n_rows: int, front, want, chunk: int) -> int:
    """Table bytes a claim in chunks of ``chunk`` slots pulls from device
    memory on this state, counted in 32-byte sectors (one slot of 8
    consecutive rows in the slot-major table): a row reads whole chunks
    of its live slots until every wanted side has a hit, and a sector is
    read when any of its 8 rows reads that slot."""
    width = nbr_t.shape[0]
    vals = pe.gather_bits(front, nbr_t, n_rows)
    live = nbr_t[:, :n_rows] < front.shape[0]
    want = want.to(torch.uint8)
    found = torch.zeros_like(want)
    read = torch.zeros(n_rows, dtype=torch.int64, device=nbr_t.device)
    for c in range(0, width, chunk):
        going = found != want
        hits = torch.zeros_like(want)
        for j in range(c, min(c + chunk, width)):
            read += going & live[j]
            hits |= torch.where(live[j], vals[j] & want, 0).to(torch.uint8)
        found |= torch.where(going, hits, 0).to(torch.uint8)
    touched = torch.arange(width, device=nbr_t.device)[:, None] < read[None, :]
    touched = torch.nn.functional.pad(touched, (0, -n_rows % 8))
    return int(touched.view(width, -1, 8).any(2).sum()) * 32


def mid_search(rng, n: int, rows: int, level: int):
    """A seeded mid-search side: ~30% of the vertices visited at levels
    0..level, the frontier being those at ``level``; parents random ids
    where visited."""
    dist = np.full(rows, INF32, np.int32)
    vis = rng.random(n) < 0.3
    dist[:n][vis] = rng.integers(0, level + 1, int(vis.sum()))
    par = np.where(dist < INF32, rng.integers(0, n, rows), -1).astype(np.int32)
    return dist, dist == level, par


def step_line(kernel: str, geometry: str, step: str, ms: float, **extra) -> None:
    print(json.dumps({"phase": "step", "kernel": kernel, "geometry": geometry,
                      "step": step, "ms": ms, **extra}), flush=True)


def pull_phase(nbr_t, deg, n: int, rng, geometry: str, timed: bool,
               results: dict | None) -> None:
    """Kernels 3 and 4 against their plain versions on one seeded
    mid-search state; with ``timed``, one ``step`` line per kernel, and
    the times into ``results`` when given."""
    dev = nbr_t.device
    n_pad = nbr_t.shape[1]
    cu = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    ds, frs, _ = mid_search(rng, n, n_pad, 2)
    dt, frt, _ = mid_search(rng, n, n_pad, 2)
    fr_s, fr_t = cu(frs), cu(frt)
    vis_s, vis_t = cu(ds < INF32), cu(dt < INF32)
    dual = pack_dual(fr_s, fr_t).contiguous()
    words = bm.frontier_words(n_pad)
    bits_s = bm.pack_bits(fr_s, words)
    pair = pe.pack_front(fr_s, fr_t, n_pad)
    unvisited_s = (~vis_s).to(torch.uint8)
    cases = {  # arguments, the sides each row wants, sides
        "pull_single": ((nbr_t, deg, bits_s, vis_s), unvisited_s, 1),
        "pull_dual": ((nbr_t, deg, pair, vis_s, vis_t),
                      unvisited_s | ((~vis_t).to(torch.uint8) << 1), 2),
    }
    for name, (args, want, k) in cases.items():
        wrapper, plain = KERNELS[name][:2]
        ref = plain(*args)
        got = wrapper(*args)
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        check(err == 0, f"{name} differs from its plain version (max {err})")
        if not timed:
            continue
        sl = slots_needed(nbr_t, n_pad, dual, want)
        # the function's bytes: per side the frontier bitmap read and the
        # next one written, the visited byte and 5 B of output per row;
        # 4 B per table slot needed; beside it, the bound with a byte
        # frontier row (one byte per vertex) in place of the bitmaps
        bits_row = 4 * ((n_pad + 31) // 32)
        nbytes = k * (2 * bits_row + 6 * n_pad) + 4 * sl
        b, by = bound_ms(nbytes, 4 * sl)
        b1, _ = bound_ms((1 + k) * n_pad + 5 * k * n_pad + 4 * sl, 4 * sl)
        # an estimate from this state, not measured: the table's sectors a
        # claim in chunks touches, plus the row entries read and written
        est = sector_bytes(nbr_t, n_pad, dual, want, pe.CHUNK) + n_pad * (4 + 6 * k)
        ms = time_launch(lambda: wrapper(*args))
        step_line(name, geometry, "bitmap" if k == 1 else "pair", ms,
                  bound_ms=b, bound_ms_byte_row=b1,
                  est_sector_mb=est / 1e6, est_sector_tb_per_s=est / ms / 1e9)
        if results is not None:
            results[name] = dict(max_abs_err=err, ms=ms,
                                 plain_ms=time_launch(lambda: plain(*args)),
                                 bound_ms=b, bound_by=by)
    if timed:
        # the tiered route rebuilds the next frontier after the tier pass
        nf_s, _, nf_t = pe.pull_dual(*cases["pull_dual"][0])[:3]
        step_line("pull_single", geometry, "rebuild_bits",
                  time_launch(lambda: bm.pack_bits(nf_s, words)))
        step_line("pull_dual", geometry, "rebuild_pair",
                  time_launch(lambda: pe.pack_front(nf_s, nf_t, n_pad)))


def kernel_phase(g, seed: int, results: dict | None, geometry: str,
                 time_pull: bool) -> None:
    """Each kernel against its plain version on one seeded state of
    graph ``g``; times and bounds go into ``results`` when given, and the
    pull kernels are timed when ``time_pull``."""
    dev = g.device
    rng = np.random.default_rng(seed)
    n, n_pad = g.n, g.n_pad
    cu = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731

    # one table serves all four kernels, as in the solver
    nbr_t, deg2 = fl.prepare_fused_tables(g.nbr, g.deg)
    rows = nbr_t.shape[1]

    pull_phase(nbr_t, deg2, n, rng, geometry, time_pull, results)

    # kernels 1 and 2 and the fold; the frontiers are bitmaps at the
    # parity of each side's level (source side at level 2, target at 3)
    ds, frs, ps = mid_search(rng, n, rows, 2)
    dt, frt, pt = mid_search(rng, n, rows, 3)
    dual = pack_dual(cu(frs), cu(frt)).contiguous()
    base = dict(
        bits=fl._bits_of_row(dual, 2, 3, rows),
        dist_s=cu(ds), dist_t=cu(dt), par_s=cu(ps), par_t=cu(pt),
    )
    cnt_s, cnt_t = int(frs.sum()), int(frt.sum())
    for name, alt, side_s in (("fused_dual_round", False, 0),
                              ("fused_single_round", True, 0),
                              ("fused_single_round", True, 1)):
        st0 = torch.tensor([2, 3, INF32, -1, cnt_s if side_s == 0 else cnt_t + 1,
                            cnt_t, 0, 0, 5, 7, 9, 11], dtype=torch.int32)

        def fresh():
            acc, key = fl.new_scratch(dev)
            return dict(bits=base["bits"].clone(),
                        dist_s=base["dist_s"].clone(), dist_t=base["dist_t"].clone(),
                        par_s=base["par_s"].clone(), par_t=base["par_t"].clone(),
                        state=st0.to(dev), acc=acc, key=key)

        def run(fn, b):
            fn(nbr_t, deg2, b["bits"], b["dist_s"], b["dist_t"],
               b["par_s"], b["par_t"], b["state"], b["acc"], b["key"])

        wrapper, plain = KERNELS[name][:2]
        p = fresh()
        run(plain, p)
        outs = ("bits", "dist_s", "dist_t", "par_s", "par_t", "acc", "key")
        # kernel 1, or kernel 2 unstaged and then through the wrapper (which
        # stages, as every geometry here fits), each exactly against the
        # plain twin; the fold below takes the wrapper's round
        for label, fn in ([("unstaged", UNSTAGED)] if alt else []) + [
                ("wrapper", wrapper)]:
            k = fresh()
            run(fn, k)
            torch.cuda.synchronize()
            err = max_abs_err([k[o] for o in outs], [p[o] for o in outs])
            check(err == 0, f"{name} ({label}, side {side_s}) differs from "
                  "its plain version")
        # the fold of this round's reductions, kernel against plain
        fl.fold_round(k["state"], k["acc"], k["key"], alt=alt)
        fl.fold_round_plain(p["state"], p["acc"], p["key"], alt=alt)
        torch.cuda.synchronize()
        ferr = max_abs_err([k["state"], k["acc"], k["key"]],
                           [p["state"], p["acc"], p["key"]])
        check(ferr == 0, f"fold_round (alt={alt}) differs from its plain version")
        if results is None or name in results:
            continue
        sides = (0, 1) if not alt else (side_s,)
        want = torch.zeros(rows, dtype=torch.uint8, device=dev)
        for s in sides:
            want |= ((base["dist_s" if s == 0 else "dist_t"] >= INF32)
                     .to(torch.uint8) << s)
        sl = slots_needed(nbr_t, rows, dual, want)
        new = [int((k[d] != base[d]).sum()) for d in ("dist_s", "dist_t")]
        # each advancing side reads its frontier bitmap and writes the next
        bitmaps = 2 * len(sides) * 4 * ((rows + 31) // 32)
        nbytes = 8 * rows + bitmaps + 4 * sl + 4 * sum(new) + 8 * sum(new)
        work = fresh()

        def prep(b=work):
            for key in ("dist_s", "dist_t", "par_s", "par_t"):
                b[key].copy_(base[key])
            b["state"].copy_(st0)
            b["acc"].zero_()
            b["key"].fill_(fl.NO_MEET)

        t_k = time_launch(lambda: run(wrapper, work), prep)
        t_p = time_launch(lambda: run(plain, work), prep)
        bms, by = bound_ms(nbytes, 4 * sl)
        steps = ({"persistent": time_launch(lambda: run(UNSTAGED, work), prep),
                  "staged": t_k} if alt else {"persistent": t_k})
        # estimates from this state, not measured: the whole table sectors
        # a claim touches in chunks of CHUNK slots and in a row-at-a-time
        # chain, plus the dist rows of both sides and the degree row
        est = {c: sector_bytes(nbr_t, rows, dual, want, c) + 12 * rows
               for c in (1, pe.CHUNK)}
        for step, ms in steps.items():
            step_line(name, geometry, step, ms, bound_ms=bms,
                      est_sector_mb=est[pe.CHUNK] / 1e6,
                      est_sector_mb_chain=est[1] / 1e6,
                      est_sector_tb_per_s=est[pe.CHUNK] / ms / 1e9)
        results[name] = dict(max_abs_err=err, ms=t_k, plain_ms=t_p,
                             bound_ms=bms, bound_by=by, steps_ms=steps)
        if "fold_round" not in results:
            def fold_prep(b=work):
                prep()
                run(wrapper, b)

            results["fold_round"] = dict(
                max_abs_err=ferr,
                ms=time_launch(lambda: fl.fold_round(work["state"], work["acc"],
                                                     work["key"], alt=False),
                               fold_prep),
                plain_ms=time_launch(
                    lambda: fl.fold_round_plain(work["state"], work["acc"],
                                                work["key"], alt=False),
                    fold_prep),
                # reads and writes the state row, accumulators and key; one
                # thread, so the launch floor binds long before the bytes
                bound_ms=2 * (4 * 12 + 4 * 6 + 8) / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes",
            )


def oracle(n, csr, pairs):
    return [solve_serial_csr(n, csr[0], csr[1], s, d) for s, d in pairs]


def raw(g, s, d, mode, unroll=1):
    best, meet, par_s, par_t, levels, edges = dense._run(g, s, d, mode, unroll, None)
    return (best, meet, par_s, par_t, levels, edges)


def same_raw(a, b) -> bool:
    return (a[0] == b[0] and a[1] == b[1] and a[4] == b[4] and a[5] == b[5]
            and torch.equal(a[2], b[2]) and torch.equal(a[3], b[3]))


def drive(g, csr, pairs, want, modes, groups, repeats: int) -> list[dict]:
    """Solve every pair in every mode through ``time_search``; check each
    against the oracle and ``validate_path``, and each mode of a group
    against the group's first mode exactly."""
    rows = []
    ref = {}
    for mode in modes:
        times, teps, syncs, ran = [], [], [], set()
        for (s, d), w in zip(pairs, want):
            ts, res = dense.time_search(g, s, d, repeats=repeats, mode=mode)
            check(res.found == w.found and res.hops == w.hops,
                  f"{mode} {s}->{d}: hops {res.hops} != oracle {w.hops}")
            if res.found:
                check(validate_path(csr, res.path, s, d, hops=res.hops),
                      f"{mode} {s}->{d}: invalid path")
            out = raw(g, s, d, mode)
            check(out[2].shape == (g.n_pad,) and out[3].shape == (g.n_pad,),
                  f"{mode}: parent rows of the wrong shape")
            for group in groups:
                if mode in group:
                    key = (group[0], s, d)
                    if mode == group[0]:
                        ref[key] = out
                    else:
                        check(same_raw(out, ref[key]),
                              f"{mode} != {group[0]} on {s}->{d}")
            times.append(float(np.median(ts)))
            teps.append(res.edges_scanned / float(np.median(ts)))
            syncs.append(res.host_syncs)
            ran.add(res.mode)
        rows.append(dict(mode=mode, ran=sorted(ran),
                         median_search_ms=float(np.median(times)) * 1e3,
                         median_teps=float(np.median(teps)),
                         host_syncs_per_solve=float(np.mean(syncs))))
        print(json.dumps({"phase": "solve", **rows[-1]}), flush=True)
    return rows


def seeded_pairs(rng, candidates, k: int) -> list[tuple[int, int]]:
    pick = rng.choice(candidates, size=(k, 2))
    pairs = [(int(a), int(b)) for a, b in pick]
    return pairs + [(pairs[0][0], pairs[0][0])]


def hub_edges(n: int, seed: int) -> np.ndarray:
    """G(n, 3/n) plus five hubs of about 90 neighbours each."""
    rng = np.random.default_rng(seed)
    hubs = [(h, int(v)) for h in range(5)
            for v in rng.choice(np.arange(5, n), 90, replace=False)]
    return np.concatenate([gnp_random_graph(n, 3.0 / n, seed=seed),
                           np.array(hubs)])


def minor_state(g, rows: int, b: int, dt8: bool, seed: int):
    """A seeded mid-search state of the batch-minor planes ``[rows, b]``,
    made on the card: about 30% of the vertices visited per side at levels
    0..2 (the frontier those at 2), about a fifth of the queries inactive,
    and the last two queries pad queries (``src == dst == 0``)."""
    dev = g.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pdt = torch.int8 if dt8 else torch.int32
    inf = ml.plane_inf(pdt)
    live = torch.arange(rows, device=dev)[:, None] < g.n

    def rand_int(hi):
        return torch.randint(0, hi, (rows, b), generator=gen, device=dev,
                             dtype=torch.int32)

    def side():
        vis = (torch.rand((rows, b), generator=gen, device=dev) < 0.3) & live
        return torch.where(vis, rand_int(3), inf).to(pdt)

    ds, dt = side(), side()
    hi = g.width if dt8 else g.n
    ps = torch.where(ds < inf, rand_int(hi), -1).to(pdt)
    pt = torch.where(dt < inf, rand_int(hi), -1).to(pdt)
    for plane, start in ((ds, inf), (dt, inf), (ps, -1), (pt, -1)):
        plane[:, -2:] = start
    ds[0, -2:] = 0
    dt[0, -2:] = 0
    dual = (ds == 2).to(pdt) | ((dt == 2).to(pdt) << 1)
    active = (torch.rand(b, generator=gen, device=dev) < 0.8).to(torch.int32)
    active[-2:] = 0
    return dual, [ds, dt, ps, pt], active


def minor_kernel_phase(g, geometry: str, seed: int, results: dict | None,
                       bpairs=None):
    """The batch-minor level (both instantiations) against its packed plain
    twin on one seeded mid-search state at the batch geometry of ``BATCH``
    queries (``batch_minor._minor_geometry``): the packed frontier and
    visited words, the distance and parent planes, counters and meet keys
    exactly equal. The input key is the full vote of the state's planes
    (the state is random and has no earlier level). With ``results``, one
    ``step`` line per instantiation: kernel ms over 25 launches, the
    twin's ms over 5, the bound on the packed state, the bound of the
    int planes the kernel read before (``bound_ms_int_planes``), an
    estimate of the dist and parent sectors the claims touch, and the
    level launches of one batch of ``bpairs``."""
    nbr_t = dense._kernel_table(g.tables, g.nbr, g.deg)
    n_tab = nbr_t.shape[1]
    b = bmin.pad_batch(BATCH if results is not None else BATCH // 2)
    for name, (mode, *_src) in MINOR.items():
        dt8 = mode == "minor8"
        n_pad2, _wp, tc, _b = bmin._minor_geometry(g, b, dt8)
        dual, (ds, dt, ps, pt), active = minor_state(g, n_pad2, b, dt8, seed)
        front = ml.pack_front(dual)
        key = ml.meet_vote(ds, dt)
        base = [ml.pack_vis(ds, dt), ds, dt, ps, pt]
        del dual
        lvl = 3
        work_k = [p.clone() for p in base]
        work_p = [p.clone() for p in base]
        got = ml.minor_level(nbr_t, g.deg, front, *work_k, lvl, active, key)
        want = ml.minor_level_packed_plain(nbr_t, g.deg, front, *work_p, lvl,
                                           active, key, tc=tc)
        torch.cuda.synchronize()
        err = max_abs_err(list(got) + work_k, list(want) + work_p)
        check(err == 0, f"{name} differs from its plain twin at {geometry}")
        if results is None:
            continue
        e = ds.element_size()
        inf = ml.plane_inf(ds.dtype)
        new_s, new_t = work_p[1] != ds, work_p[2] != dt
        claims = int(new_s.sum() + new_t.sum())
        # votes that read the other side's dist: a claim on one side only,
        # where the other side was visited before
        vote_reads = int((new_s & ~new_t & (dt < inf)).sum()
                         + (new_t & ~new_s & (ds < inf)).sum())
        # rows where some active query is unvisited on a side read their
        # live table slots, and each slot one neighbour's front words
        wants = (((ds[:n_tab] >= inf) | (dt[:n_tab] >= inf))
                 & (active[None, :] > 0)).any(1)
        slots = int(torch.minimum(g.deg, torch.tensor(g.width, device=g.device))
                    [wants].sum())
        row = b // 4  # bytes of a pair row: 2 bits per query
        vis_words = int((work_p[0] != base[0]).sum())
        # the function's bytes on the packed state: front and vis read and
        # front_n written once, the vis words that change, a dist and a
        # parent entry per claim, the dist entries the votes read, the live
        # slots of the wanting rows, the degree row; 2 bit tests per slot
        # and query
        nbytes = (3 * n_pad2 * row + 4 * vis_words
                  + (2 * claims + vote_reads) * e + 4 * slots + 4 * n_tab)
        b_ms, by = bound_ms(nbytes, 2 * slots * b)
        # the int-plane count: dual, dist_s and dist_t read and dual_n
        # written once, a dist and a parent entry per claim, the slots
        plane = n_pad2 * b * e
        b_int, _ = bound_ms(4 * plane + 2 * e * claims + 4 * slots + 4 * n_tab,
                            2 * slots * b)
        # 32-byte sectors of the dist and parent planes holding a claim
        per = 32 // e
        sectors = sum(int(c.view(n_pad2, b // per, per).any(2).sum())
                      for c in (new_s, new_t))
        del new_s, new_t, wants

        def restore(work):
            for x, y in zip(work, base):
                x.copy_(y)

        ms = time_launch(lambda: ml.minor_level(nbr_t, g.deg, front, *work_k,
                                                lvl, active, key, checked=True),
                         lambda: restore(work_k))
        plain_ms = time_launch(lambda: ml.minor_level_packed_plain(
            nbr_t, g.deg, front, *work_p, lvl, active, key, tc=tc),
            lambda: restore(work_p), reps=5)
        before = ml.minor_level.launches[mode]
        batch_raw(g, bpairs, mode)
        per_batch = ml.minor_level.launches[mode] - before
        step_line(name, geometry, "packed", ms, plain_ms=plain_ms, bound_ms=b_ms,
                  bound_ms_int_planes=b_int,
                  est_claim_sector_mb=2 * sectors * 32 / 1e6,
                  gather_gb=slots * row / 1e9, launches_per_batch=per_batch,
                  n_pad2=n_pad2, b=b, tc=tc, claims=claims,
                  vote_reads=vote_reads)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=by)
        del front, base, work_k, work_p, got, want, ds, dt, ps, pt
        torch.cuda.empty_cache()


def batch_pairs(rng, n: int, csr, k: int) -> np.ndarray:
    """``k`` seeded pairs over ``[0, n)``; pair 0 is ``src == dst`` and
    pair 1 ends at an isolated vertex (when the graph has one)."""
    pairs = rng.integers(0, n, size=(k, 2))
    pairs[0, 1] = pairs[0, 0]
    isolated = np.flatnonzero(np.diff(csr[0]) == 0)
    if isolated.size:
        pairs[1, 1] = isolated[0]
    return pairs


def batch_raw(g, pairs, mode):
    """The finished raw outputs of one batch (6 tensors on the card)."""
    _, thunk, finish = dense._batch_dispatch(g, pairs, mode)
    out = finish(thunk())
    torch.cuda.synchronize()
    return out


def same_batch(a, b, n: int) -> bool:
    """Every output equal, the parent rows on the live columns."""
    for x, y in zip(a, b):
        if x.dim() == 2:
            x, y = x[:, :n], y[:, :n]
        if not torch.equal(x, y):
            return False
    return True


def batch_drive(g, csr, pairs, geometry: str, modes, single: str,
                k_check: int = 16) -> dict:
    """Time each batch mode (``time_batch_graph``: a warm-up, then the
    median of 5), check every found path, and hold the first ``k_check``
    pairs against the single-query ``single`` search and the serial
    oracle. Returns each mode's finished raw outputs."""
    n = g.n
    raws = {}
    sub = [(int(s), int(d)) for s, d in pairs[:k_check]]
    want = oracle(n, csr, sub)
    ones = [raw(g, s, d, single) for s, d in sub]
    single_ms = float(np.median([
        np.median(dense.time_search(g, s, d, repeats=5, mode=single)[0])
        for s, d in sub])) * 1e3
    for mode in modes:
        times, res = dense.time_batch_graph(g, pairs, repeats=5, mode=mode)
        out = batch_raw(g, pairs, mode)
        raws[mode] = out
        best, meet, _ps, _pt, levels, edges = (o.cpu() for o in out)
        for i, ((s, d), w, one) in enumerate(zip(sub, want, ones)):
            check((int(best[i]), int(meet[i]), int(levels[i]), int(edges[i]))
                  == (one[0], one[1], one[4], one[5]),
                  f"{geometry} {mode} {s}->{d} differs from single {single}")
            check(res[i].found == w.found and res[i].hops == w.hops,
                  f"{geometry} {mode} {s}->{d}: hops {res[i].hops} != oracle "
                  f"{w.hops}")
        for (s, d), r in zip(pairs, res):
            if r.found:
                check(validate_path(csr, r.path, int(s), int(d), hops=r.hops),
                      f"{geometry} {mode} {s}->{d}: invalid path")
        ms = float(np.median(times)) * 1e3
        print(json.dumps({
            "phase": "batch", "geometry": geometry, "mode": mode,
            "ran": res[0].mode, "b": len(pairs), "batch_ms": ms,
            "ms_per_query": ms / len(pairs), "single_mode": single,
            "single_ms": single_ms, "host_reads_per_batch": res[0].host_syncs,
            "found": sum(r.found for r in res), "times_ms": [t * 1e3 for t in times],
        }), flush=True)
    return raws


def refill_phase(dev) -> None:
    """A path graph with one query deeper than the int8 cap: the capped
    query comes back through the refill equal to the int32 batch."""
    n = 600
    edges = np.array([[i, i + 1] for i in range(n - 1)])
    g = dense.DeviceGraph.build(n, edges, device=dev)
    pairs = np.array([[0, n - 1], [0, 10], [5, 5], [100, 480], [7, 300]])
    _, thunk, finish = dense._batch_dispatch(g, pairs, "minor8")
    rawk = thunk()
    check(bool(rawk[-1][0]) and not bool(rawk[-1][1]),
          "the deep query was not capped under minor8")
    a = finish(rawk)
    b = batch_raw(g, pairs, "minor")
    check(same_batch(a, b, n), "minor8 refill differs from minor")
    res = dense.solve_batch_graph(g, pairs, mode="minor8")
    check(res[0].hops == n - 1 and res[0].path == list(range(n)),
          "the refilled query's path is wrong")
    print(json.dumps({"phase": "batch_refill", "ok": True,
                      "hops": [r.hops for r in res]}), flush=True)


def routing_phase(g2, csr2, pairs2, want2) -> None:
    """rmat-s20-ef16: a 256-query batch routes to the per-query path and
    ``minor`` is refused (a tier's key overflows int32); 8 pairs under
    ``auto`` go per query and match the oracle."""
    check(bmin.auto_batch_mode(g2, BATCH) == "sync", "auto did not pick sync")
    try:
        dense.solve_batch_graph(g2, np.zeros((BATCH, 2), np.int64), mode="minor")
    except ValueError as e:
        refused = str(e)
    else:
        fail("minor was not refused on rmat-s20-ef16")
    res = dense.solve_batch_graph(g2, pairs2[:8], mode="auto")
    for (s, d), w, r in zip(pairs2[:8], want2[:8], res):
        check(r.mode == "sync" and r.found == w.found and r.hops == w.hops,
              f"auto (8 pairs) {s}->{d} differs from the oracle")
    print(json.dumps({"phase": "batch_routing", "ok": True, "auto_256": "sync",
                      "minor_refused": refused,
                      "host_reads_8": res[0].host_syncs}), flush=True)


FIELDS = ("found", "hops", "path", "meet", "levels", "edges_scanned")


def fields(r) -> tuple:
    return tuple(getattr(r, f) for f in FIELDS)


def engine_clean(eng, wave: str) -> dict:
    """Fail unless the engine never degraded: no fallback, retry, error,
    bisection or injected fault, and a closed breaker."""
    st = eng.stats()
    res = st["resilience"]
    check(not any(res["fallbacks"].values()), f"wave {wave}: fallbacks {res['fallbacks']}")
    check(res["retries"] == 0, f"wave {wave}: {res['retries']} retries")
    check(not any(res["errors"].values()), f"wave {wave}: errors {res['errors']}")
    check(res["bisections"] == 0, f"wave {wave}: host batch bisected")
    check(res["faults"] is None, f"wave {wave}: a fault plan is set")
    check(res["breaker"]["state"] == "closed", f"wave {wave}: breaker {res['breaker']}")
    return st


def against_oracle(n, csr, pairs, results, wave: str) -> None:
    for (s, d), r, w in zip(pairs, results, oracle(n, csr, pairs)):
        check(r.found == w.found and r.hops == w.hops,
              f"engine wave {wave} {s}->{d}: hops {r.hops} != oracle {w.hops}")
        if r.found:
            check(validate_path(csr, r.path, s, d, hops=r.hops),
                  f"engine wave {wave} {s}->{d}: invalid path")


def engine_wave(eng, pairs, wave: str, **extra) -> tuple[list, dict]:
    """Serve ``pairs`` through ``eng`` with every kernel count set to 0
    just before; returns the results and the line it prints."""
    before = dict(eng.counters)
    tracer = Tracer()
    prev = set_tracer(tracer)
    reset_counts()
    t0 = time.perf_counter()
    try:
        res = eng.query_many(pairs)
    finally:
        wall = time.perf_counter() - t0
        set_tracer(prev)
    launches = counts()
    spans: dict = {}
    for ev in tracer.events():
        if ev.get("ph") == "X":
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    st = engine_clean(eng, wave)
    routed = {k: st[k] - before[k] for k in (
        "trivial", "cache_served", "device_queries", "host_queries",
        "device_batches")}
    ran = sorted({r.mode for r in res if r.mode is not None})
    line = {"phase": "engine", "wave": wave, "queries": len(pairs), **routed,
            "modes": ran,
            # the batch's own clock (device or native batch); 0 from the cache
            "flush_ms": max(r.time_s for r in res) * 1e3,
            "wall_ms": wall * 1e3, "queries_per_s": len(pairs) / wall,
            "launches": {k: v for k, v in launches.items() if v},
            "spans_ms": spans,
            "host_backend": st["host_backend"], "bucket": st["bucket"], **extra}
    print(json.dumps(line), flush=True)
    return res, line


def engine_phase(g, n, edges, pairs_all, csr) -> None:
    """Phase 7: the serving engine on the main-path graph (module
    docstring). ``g`` is the phase 3 graph the waves are held against."""
    from bibfs_tpu_torch.native.build import ensure_built

    t0 = time.perf_counter()
    eng = QueryEngine(n, edges, max_batch=BATCH, cache_entries=512)
    snapshot_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.graph  # the bucketed table, built and uploaded
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ensure_built()
    native_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng._rt.get_host_solver()  # the native CSR and scratch
    native_graph_s = time.perf_counter() - t0
    builds = dict(snapshot_s=snapshot_s, table_s=table_s,
                  native_build_s=native_build_s, native_graph_s=native_graph_s)

    # wave A: one minor8 flush of 255 queries, equal to solve_batch_graph.
    # Every endpoint is distinct, so each banked forest is its root's
    # only one and wave B's meet vertices are in it
    rng = np.random.default_rng(29)
    isolated = np.flatnonzero(np.diff(csr[0]) == 0)
    check(isolated.size > 0, "the main-path graph has no isolated vertex")
    ends = rng.choice(np.setdiff1d(np.arange(n), isolated[:1]), 2 * BATCH,
                      replace=False).reshape(BATCH, 2)
    ends[0, 1] = ends[0, 0]  # src == dst: resolved at submit
    ends[1, 1] = isolated[0]
    pairs_a = [(int(s), int(d)) for s, d in ends]
    res_a, line = engine_wave(eng, pairs_a, "A", **builds)
    check(line["device_batches"] == 1 and line["device_queries"] == BATCH - 1
          and line["trivial"] == 1 and line["host_queries"] == 0,
          f"wave A routes: {line}")
    check(line["modes"] == ["minor8"], f"wave A ran {line['modes']}")
    check(line["launches"].get("minor_level[minor8]", 0) > 0,
          "wave A did not launch minor_level_kernel<int8_t>")
    want = dense.solve_batch_graph(g, pairs_a, mode="minor8")
    for (s, d), r, w in zip(pairs_a, res_a, want):
        if s == d:
            check((r.found, r.hops, r.path) == (w.found, w.hops, w.path),
                  f"wave A trivial {s}: {r}")
        else:
            check(fields(r) == fields(w),
                  f"wave A {s}->{d}: engine {fields(r)} != batch {fields(w)}")
    against_oracle(n, csr, pairs_a, res_a, "A")

    # wave B: sources of wave A, all answered from the distance cache
    pairs_b = []
    for k, ((s, d), r) in enumerate(zip(pairs_a[1:], res_a[1:])):
        if len(pairs_b) == BATCH:
            break
        if k % 3 == 0 or not r.found:
            pairs_b.append((s, d))
        elif k % 3 == 1:
            pairs_b.append((d, s))
        else:
            j = r.path.index(r.meet)
            pairs_b.append((s, r.path[j]) if j else (d, s))
    pairs_b += pairs_a[1: 1 + BATCH - len(pairs_b)]
    res_b, line = engine_wave(eng, pairs_b, "B")
    check(line["cache_served"] == BATCH and line["device_batches"] == 0
          and line["host_queries"] == 0 and not line["launches"],
          f"wave B was not served from the cache: {line}")
    against_oracle(n, csr, pairs_b, res_b, "B")

    # wave C: 16 fresh pairs below the crossover, on the native host route
    used = {v for p in pairs_a for v in p}
    fresh = np.setdiff1d(np.random.default_rng(31).choice(n, 64, replace=False),
                         np.array(sorted(used)))
    pairs_c = [(int(s), int(d)) for s, d in fresh[:32].reshape(16, 2)]
    res_c, line = engine_wave(eng, pairs_c, "C")
    check(line["host_queries"] == 16 and line["device_batches"] == 0,
          f"wave C routes: {line}")
    check(eng.host_backend_resolved == "native",
          f"wave C host backend {eng.host_backend_resolved}")
    against_oracle(n, csr, pairs_c, res_c, "C")
    del eng, res_a, res_b, want
    torch.cuda.empty_cache()

    # wave C[device]: the same 16 pairs as one device flush, the reading
    # the host route is held against below the crossover
    t0 = time.perf_counter()
    eng_c = QueryEngine(n, edges, pairs=pairs_all, flush_threshold=1,
                        max_batch=BATCH, cache_entries=512)
    eng_c.graph
    res_cd, line = engine_wave(eng_c, pairs_c, "C[device]",
                               setup_s=time.perf_counter() - t0)
    check(line["device_batches"] == 1 and line["device_queries"] == 16
          and line["host_queries"] == 0, f"wave C[device] routes: {line}")
    for (s, d), r, w in zip(pairs_c, res_cd, res_c):
        check((r.found, r.hops) == (w.found, w.hops),
              f"wave C[device] {s}->{d}: hops {r.hops} != host {w.hops}")
    against_oracle(n, csr, pairs_c, res_cd, "C[device]")
    del eng_c
    torch.cuda.empty_cache()

    # wave D: the pull kernels through the engine (kernel 3 under pallas,
    # kernel 4 under pallas_alt), each engine over the same graph
    pairs_d = [(int(s), int(d)) for s, d in np.random.default_rng(37).choice(
        n, 128, replace=False).reshape(64, 2)]
    for mode, kernel in (("pallas", "pull_dual"), ("pallas_alt", "pull_single")):
        t0 = time.perf_counter()
        eng_d = QueryEngine(n, edges, pairs=pairs_all, mode=mode,
                            max_batch=BATCH, cache_entries=512)
        eng_d.graph
        res_d, line = engine_wave(eng_d, pairs_d, f"D[{mode}]",
                                  setup_s=time.perf_counter() - t0)
        check(line["device_batches"] == 1
              and line["device_queries"] == len(pairs_d)
              and line["modes"] == [mode], f"wave D[{mode}] routes: {line}")
        check(line["launches"].get(kernel, 0) > 0,
              f"wave D[{mode}] did not launch {kernel}")
        want = dense.solve_batch_graph(g, pairs_d, mode=mode)
        for (s, d), r, w in zip(pairs_d, res_d, want):
            check(fields(r) == fields(w),
                  f"wave D[{mode}] {s}->{d}: engine {fields(r)} != batch {fields(w)}")
        against_oracle(n, csr, pairs_d, res_d, f"D[{mode}]")
        del eng_d
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    # phase 1: build
    t0 = time.perf_counter()
    build_s = _cuda.build()
    print(json.dumps({"phase": "build", "nvcc_s": build_s,
                      "total_s": time.perf_counter() - t0}), flush=True)
    for name, log in _cuda.build_logs().items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill")):
                print(f"ptxas {name}: {line.strip()}")

    # the main-path graph: G(2^20, 8/2^20), plain ELL
    t0 = time.perf_counter()
    n = 1 << 20
    edges = gnp_random_graph(n, 8 / n, seed=7)
    pairs_all = canonical_pairs(n, edges)
    csr = build_csr(n, pairs=pairs_all)
    g = dense.DeviceGraph.build(n, edges, layout="ell", device=dev, pairs=pairs_all)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "graph", "name": "gnp-deg8-s20", "n": n,
                      "edges": int(edges.shape[0]), "width": g.width,
                      "build_s": time.perf_counter() - t0}), flush=True)

    # phase 2: kernels against their plain versions
    results: dict = {}
    kernel_phase(g, seed=11, results=results, geometry="gnp-deg8-s20",
                 time_pull=True)
    n_small = 3001  # a row count that is a multiple of no block
    e_small = gnp_random_graph(n_small, 3.0 / n_small, seed=5)
    g_small = dense.DeviceGraph.build(n_small, e_small, device=dev)
    kernel_phase(g_small, seed=12, results=None, geometry="gnp-3001",
                 time_pull=False)
    # the batch-minor level at the batch geometries, both instantiations
    bpairs = batch_pairs(np.random.default_rng(17), n, csr, BATCH)
    minor_kernel_phase(g, "gnp-deg8-s20", 21, results, bpairs)
    minor_kernel_phase(g_small, "gnp-3001", 22, None)
    del g_small
    # ELL rows wider than the 32 table slots the level kernel stages
    g_hubs = dense.DeviceGraph.build(n_small, hub_edges(n_small, 6), device=dev)
    check(g_hubs.width > 32, "the hub graph has no wide rows")
    minor_kernel_phase(g_hubs, "hubs-3001", 23, None)
    del g_hubs
    # the least time any launch takes: an empty kernel between two events
    floor_ms = time_launch(lambda: torch.cuda._sleep(0))
    print(json.dumps({"phase": "kernels_vs_plain", "ok": True,
                      "launch_floor_ms": floor_ms}), flush=True)

    # phase 3: the main path
    rng = np.random.default_rng(7)
    pairs = seeded_pairs(rng, np.arange(n), 8)
    want = oracle(n, csr, pairs)
    reset_counts()
    drive(g, csr, pairs, want,
          ["sync", "alt", "beamer", "pallas", "pallas_alt", "fused", "fused_alt"],
          [("sync", "pallas", "fused"), ("alt", "pallas_alt", "fused_alt")],
          repeats=5)
    for s, d in pairs:
        check(same_raw(raw(g, s, d, "fused", 1), raw(g, s, d, "fused", 8)),
              f"fused unroll 1 != unroll 8 on {s}->{d}")
    main_counts = counts()
    print(json.dumps({"phase": "main_path_launches", **main_counts}), flush=True)
    for name in KERNELS:
        check(main_counts[name] > 0, f"kernel {name} was not launched on the main path")

    # phase 5: the batched search on the main-path graph, 256 queries
    reset_counts()
    raws = batch_drive(g, csr, bpairs, "gnp-deg8-s20", ["minor8", "minor", "auto"],
                       "fused")
    batch_counts = counts()
    print(json.dumps({"phase": "batch_launches", **batch_counts}), flush=True)
    for name in MINOR:
        check(batch_counts[name] > 0, f"kernel {name} was not launched by the batches")
    check(same_batch(raws["minor8"], raws["minor"], n),
          "minor8 (decoded) differs from minor")
    check(same_batch(raws["auto"], raws["minor8"], n), "auto differs from minor8")
    del raws
    torch.cuda.empty_cache()

    # phase 7: the serving engine on the main-path graph
    engine_phase(g, n, edges, pairs_all, csr)

    # phase 4: tiered RMAT scale 20
    del g
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    n2, e2 = rmat_graph(20, edge_factor=16, seed=7)
    p2 = canonical_pairs(n2, e2)
    csr2 = build_csr(n2, pairs=p2)
    g2 = dense.DeviceGraph.build(n2, e2, layout="tiered", device=dev, pairs=p2)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "graph", "name": "rmat-s20-ef16", "n": n2,
                      "edges": int(e2.shape[0]), "width": g2.width,
                      "tiers": [list(m) for m in g2.tier_meta],
                      "build_s": time.perf_counter() - t0}), flush=True)
    # the kernels against their plain versions at the tiered base table
    kernel_phase(g2, seed=13, results=None, geometry="rmat-s20-ef16",
                 time_pull=True)
    print(json.dumps({"phase": "kernels_vs_plain_tiered", "ok": True}),
          flush=True)
    linked = np.flatnonzero(np.diff(csr2[0]) > 0)
    pairs2 = seeded_pairs(np.random.default_rng(7), linked, 8)
    want2 = oracle(n2, csr2, pairs2)
    reset_counts()
    rows = drive(g2, csr2, pairs2, want2, ["sync", "pallas", "pallas_alt", "fused"],
                 [("sync", "pallas", "fused")], repeats=3)
    check(rows[-1]["ran"] == ["pallas"], "tiered fused did not run as pallas")
    tier_counts = counts()
    print(json.dumps({"phase": "tiered_launches", **tier_counts}), flush=True)
    for name in ("pull_dual", "pull_single"):
        check(tier_counts[name] > 0, f"kernel {name} not launched on the tiered path")
    routing_phase(g2, csr2, pairs2, want2)

    # phase 6: tiered batches at RMAT scale 17 (the largest scale of the
    # family whose tiers the minor layout admits), and the int8 refill
    del g2
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    n3, e3 = rmat_graph(17, edge_factor=16, seed=7)
    p3 = canonical_pairs(n3, e3)
    csr3 = build_csr(n3, pairs=p3)
    g3 = dense.DeviceGraph.build(n3, e3, layout="tiered", device=dev, pairs=p3)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "graph", "name": "rmat-s17-ef16", "n": n3,
                      "edges": int(e3.shape[0]), "width": g3.width,
                      "tiers": [list(m) for m in g3.tier_meta],
                      "build_s": time.perf_counter() - t0}), flush=True)
    linked3 = np.flatnonzero(np.diff(csr3[0]) > 0)
    pairs3 = batch_pairs(np.random.default_rng(19), n3, csr3, BATCH)
    pairs3[2:] = np.random.default_rng(19).choice(linked3, size=(BATCH - 2, 2))
    batch_drive(g3, csr3, pairs3, "rmat-s17-ef16", ["minor"], "sync")
    del g3
    refill_phase(dev)

    kernels = []
    for name, (_w, _p, source, replaces) in KERNELS.items():
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=main_counts[name],
                            **results[name], library_ms=None,
                            launch_floor_ms=floor_ms))
    for name, (_mode, source, replaces) in MINOR.items():
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=batch_counts[name],
                            **results[name], library_ms=None,
                            launch_floor_ms=floor_ms))
    print(json.dumps({"phase": "done", "total_s": time.perf_counter() - t_start}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
