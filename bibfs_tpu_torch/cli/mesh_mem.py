"""Parent against change: the sharded batch's device memory and time on a
rank pool, at ``chip_smoke.py`` phase 15's sharded waves.

``python -m bibfs_tpu_torch.cli.mesh_mem PARENT_ROOT`` runs one child
process a turn, in the order ``--order`` (default ``pccp``: parent,
change, change, parent); ``p`` imports the package of the checkout at
PARENT_ROOT, ``c`` the one this module comes from. Each child builds
G(2^scale, 8/2^scale) (``--scale`` 20, seed 7: phase 3's graph) as the
host ELL of a 4-rank mesh, starts a 4-rank ``MeshPool`` (staged gloo on
one card, NCCL on four), and on every rank, after one warm-up batch of 2
pairs a mode, runs phase 15's sharded waves (``fused`` 16, ``pallas``
16, ``pallas_alt`` 8 pairs of linked vertices, rng 163 a mode) and one
``fused`` wave of ``--big`` pairs (default 128):

- ``solve_batch_sharded_graph`` (what the engine's mesh route runs on
  the ranks for a sharded flush): its wall on the host clock, and the
  peak of ``torch.cuda.max_memory_allocated`` above what was allocated
  before it;
- ``time_batch_sharded`` with ``--repeats`` (default 2): the median of
  its timed batches, and its peak the same way;
- ``--alternate`` (default 2) rounds of ``solve_batch_sharded_graph``
  beside one ``solve_sharded_graph`` a pair (a batch without the seam,
  as the parent ran it), in turns within the rank: each one's wall.

It prints one JSON line a turn (the checkout, the card's name and power
limit, every rank's numbers a wave), then one line that says whether
every turn gave the same answers (found, hops, meet, levels, edges).
``--device cpu`` rehearses it on gloo ranks (no memory read).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

RANKS = 4
WAVES = (("fused", 16), ("pallas", 16), ("pallas_alt", 8))
HERE = Path(__file__).resolve()


def rank_probe(rj, key: str, waves: list, repeats: int,
               alternate: int) -> dict:
    """Run on every rank of the pool (a ``call`` job): each wave through
    both batch calls, each with its wall and its device-memory peak.
    Returns every rank's numbers, and rank 0's answers."""
    import torch

    from bibfs_tpu_torch.solvers import sharded as sh

    g = rj.shard(key)
    dev = g.device
    cuda = dev.type == "cuda"

    def measure(fn):
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        peak = ((torch.cuda.max_memory_allocated(dev) - base) / 2**20
                if cuda else None)
        return out, wall, peak

    for mode in sorted({m for m, _p in waves}):  # kernels loaded, caches warm
        sh.solve_batch_sharded_graph(g, waves[0][1][:2], mode=mode)
    mine, answers = [], []
    for mode, pairs in waves:
        res, wall, peak = measure(
            lambda: sh.solve_batch_sharded_graph(g, pairs, mode=mode))
        (times, res2), _w, tpeak = measure(
            lambda: sh.time_batch_sharded(g, pairs, repeats=repeats,
                                          mode=mode))
        got = [(r.found, r.hops, r.meet, r.levels, r.edges_scanned)
               for r in res]
        if got != [(r.found, r.hops, r.meet, r.levels, r.edges_scanned)
                   for r in res2]:
            raise RuntimeError(f"{mode}: the two batch calls differ")
        # the batch against one solve a query (the batch of a checkout
        # without the seam), in turns in this process
        walls = {"batch": [], "loop": []}
        for i in range(alternate):
            for kind in (("batch", "loop") if i % 2 == 0
                         else ("loop", "batch")):
                t0 = time.perf_counter()
                if kind == "batch":
                    sh.solve_batch_sharded_graph(g, pairs, mode=mode)
                else:
                    for s, d in pairs:
                        sh.solve_sharded_graph(g, s, d, mode=mode)
                walls[kind].append(time.perf_counter() - t0)
        mine.append({"mode": mode, "queries": len(pairs), "solve_s": wall,
                     "solve_peak_mb": peak,
                     "timed_ms": float(np.median(times)) * 1e3,
                     "timed_peak_mb": tpeak, "batch_s": walls["batch"],
                     "loop_s": walls["loop"]})
        answers.append(got)
    base = torch.cuda.memory_allocated(dev) / 2**20 if cuda else None
    every = rj.mesh.all_gather_object({"rank": rj.mesh.rank, "waves": mine,
                                       "graph_mb": base})
    return {"ranks": every, "answers": answers}


def _inner(args) -> int:
    import torch

    import bibfs_tpu_torch
    from bibfs_tpu_torch.graph.generate import gnp_random_graph
    from bibfs_tpu_torch.parallel.pool import MeshPool
    from bibfs_tpu_torch.solvers import sharded as sh

    on_card = args.device == "cuda"
    card = None
    if on_card:
        from bibfs_tpu_torch.ops import _cuda

        _cuda.build()
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    n = 1 << args.scale
    edges = gnp_random_graph(n, 8 / n, seed=7)
    host = sh.build_host_graph(n, edges, RANKS)
    deg = np.zeros(n, dtype=np.int64)
    np.add.at(deg, np.asarray(edges).ravel(), 1)
    linked = np.flatnonzero(deg > 0)
    waves = [(m, np.random.default_rng(163).choice(linked, size=(k, 2))
              .tolist()) for m, k in (*WAVES, ("fused", args.big))]
    pool = MeshPool(RANKS, args.device, timeout_s=1200)
    try:
        with tempfile.TemporaryDirectory(prefix="mesh-mem-") as tmp:
            pool.graph("gnp", sh.save_host_graph(host, os.path.join(tmp, "g")))
            t0 = time.perf_counter()
            out = pool.call("jobs", [dict(
                kind="call", fn=f"{HERE.stem}:rank_probe",
                args=dict(key="gnp", waves=waves, repeats=args.repeats,
                          alternate=args.alternate))])["results"][0]
            probe_s = time.perf_counter() - t0
    finally:
        pool.close()
    print(json.dumps({
        "checkout": str(Path(bibfs_tpu_torch.__file__).parent.parent),
        "card": card, "torch": torch.__version__,
        "transport": pool.transport, "scale": args.scale,
        "waves": [(m, len(p)) for m, p in waves], "probe_s": probe_s,
        "ranks": out["ranks"], "answers": out["answers"]}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", nargs="?", help="the parent checkout's root")
    ap.add_argument("--order", default="pccp")
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--big", type=int, default=128)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--alternate", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--inner", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.inner:
        return _inner(args)
    roots = {"p": Path(args.parent).resolve(), "c": HERE.parents[2]}
    lines = []
    for turn in args.order:
        # run as a script, so its directory (not a package) holds the
        # ranks' ``call`` target, and PYTHONPATH picks the checkout
        env = dict(os.environ, PYTHONPATH=str(roots[turn]))
        proc = subprocess.run(
            [sys.executable, str(HERE), "--inner", "--scale",
             str(args.scale), "--big", str(args.big), "--repeats",
             str(args.repeats), "--alternate", str(args.alternate),
             "--device", args.device],
            env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        line["turn"] = turn
        lines.append(line)
        print(json.dumps({k: v for k, v in line.items() if k != "answers"}),
              flush=True)
    print(json.dumps({"same_answers": all(
        ln["answers"] == lines[0]["answers"] for ln in lines),
        "order": args.order}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
