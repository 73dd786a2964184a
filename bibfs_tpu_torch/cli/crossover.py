"""Where a CUDA engine's flushes should cross from the host route to the card.

``python -m bibfs_tpu_torch.cli.crossover`` builds G(2^20, 8/2^20) (the
graph of ``chip_smoke.py``), one ``QueryEngine`` routed to the host
(``device_batches=False``: the native runtime) and one routed to the card
per batch mode (``flush_threshold=1``; ``auto`` and ``minor8``), none
with a distance cache (``cache_entries=0``: every query is solved). For
each flush size k it serves the same k fresh pairs through every engine
(``--repeats`` disjoint pair sets, after one warm-up flush per engine and
size) and prints one JSON line: per route the median submit-to-result ms
of the flush, and for the card also the batch's own clock (``flush_ms``,
the rest being the host finish: copies, decode, paths). A last line
holds, per mode, the crossover: the smallest measured k from which the
card is faster at every larger measured size (null where it never is).
Then the card's name and power limit. A card is required.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

SIZES = (1, 2, 4, 8, 16, 32, 64, 128)
MODES = ("auto", "minor8")


def _serve(eng, pairs) -> tuple[float, float, set]:
    """Submit-to-result ms of one flush of ``pairs``, the batch's own
    clock in ms (the largest ``time_s`` of the results) and the batch
    modes that ran."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.query_many(pairs)
    wall = time.perf_counter() - t0
    return (wall * 1e3, max(r.time_s for r in res) * 1e3,
            {r.mode for r in res if r.mode is not None})


def _fresh_pairs(rng, pool: list, k: int) -> list[tuple[int, int]]:
    """k pairs of vertices no earlier flush used."""
    ends = [pool.pop() for _ in range(2 * k)]
    rng.shuffle(ends)
    return [(int(ends[2 * i]), int(ends[2 * i + 1])) for i in range(k)]


def crossover(sizes, ms_host, ms_dev):
    """The smallest size from which the card wins at every larger size."""
    best = None
    for k in reversed(sizes):
        if ms_dev[k] >= ms_host[k]:
            break
        best = k
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("crossover: CUDA is not available", file=sys.stderr)
        return 2
    from bibfs_tpu_torch.graph.csr import canonical_pairs
    from bibfs_tpu_torch.graph.generate import gnp_random_graph
    from bibfs_tpu_torch.serve import QueryEngine

    sizes = tuple(int(s) for s in args.sizes.split(","))
    n = 1 << args.scale
    edges = gnp_random_graph(n, 8 / n, seed=7)
    pairs_all = canonical_pairs(n, edges)
    kw = dict(pairs=pairs_all, cache_entries=0, max_batch=max(sizes))
    engines = {"host": QueryEngine(n, edges, device_batches=False, **kw)}
    for mode in MODES:
        engines[mode] = QueryEngine(n, edges, mode=mode, flush_threshold=1,
                                    **kw)
        engines[mode].graph  # the bucketed table, built and uploaded
    engines["host"]._rt.get_host_solver()  # the native build and CSR
    rng = np.random.default_rng(41)
    need = 2 * sum(sizes) * (args.repeats + 1)
    pool = list(rng.choice(n, need, replace=False))
    ms = {name: {} for name in engines}
    for k in sizes:
        warm = _fresh_pairs(rng, pool, k)
        for eng in engines.values():
            _serve(eng, warm)
        walls = {name: [] for name in engines}
        clocks = {name: [] for name in engines}
        ran = {name: set() for name in engines}
        for _ in range(args.repeats):
            pairs = _fresh_pairs(rng, pool, k)
            for name, eng in engines.items():
                wall, clock, modes = _serve(eng, pairs)
                walls[name].append(wall)
                clocks[name].append(clock)
                ran[name] |= modes
        line = {"size": k}
        for name in engines:
            ms[name][k] = float(np.median(walls[name]))
            line[name] = {"wall_ms": ms[name][k], "walls_ms": walls[name],
                          "flush_ms": float(np.median(clocks[name])),
                          "modes": sorted(ran[name])}
        print(json.dumps(line), flush=True)
    for name, eng in engines.items():
        res = eng.stats()["resilience"]
        if any(res["fallbacks"].values()) or res["retries"] or any(
                res["errors"].values()):
            print(f"crossover: engine {name} degraded: {res}", file=sys.stderr)
            return 1
    print(json.dumps({"crossover": {
        mode: crossover(sizes, ms["host"], ms[mode]) for mode in MODES
    }, "host_backend": engines["host"].host_backend_resolved}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
