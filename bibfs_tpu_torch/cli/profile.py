"""Where a dense search's time goes on one CUDA card.

``python -m bibfs_tpu_torch.cli.profile [--unroll 1]`` builds
G(2^20, 8/2^20) as plain ELL (the main path of ``chip_smoke.py``) and, for
8 seeded pairs and each dense mode, prints one JSON line: the median over
the pairs of 5 timed searches (CUDA events, as ``time_search`` reports it),
then, from a ``torch.profiler`` run of the same solves, the device's
kernel time per solve, the idle share of the search (1 - kernel time /
search time), host reads per solve, each hand-written kernel's launches
per solve and the five kernels with the most device time. ``--unroll``
sets the rounds per host read of the fused modes. ``--batch B`` profiles
batches of B seeded pairs instead, in modes minor8 and minor or in the
batch modes ``--batch-modes`` names (the lock-step modes ``sync``,
``sync_unfused``, ``alt``, ``beamer``, ``beamer_alt``, ``pallas``,
``pallas_alt``, ``fused`` and ``fused_alt`` among them): the same numbers
per batch (``time_batch_graph``, then a profiled run of 5 batches), with
the launches per batch of the batch-minor level and of the batched pull
kernels. A card is required.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

MODES = ("sync", "alt", "beamer", "pallas", "pallas_alt", "fused", "fused_alt")
SCALE, DEGREE, PAIRS, REPEATS, SEED = 20, 8.0, 8, 5, 7


def _kernel_events(prof):
    """(name, microseconds) of every device kernel the profiler saw."""
    out = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            out.append((evt.name, evt.time_range.elapsed_us()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--unroll", type=int, default=1,
                    help="rounds per host read of the fused modes")
    ap.add_argument("--batch", type=int, default=0, metavar="B",
                    help="profile batches of B pairs")
    ap.add_argument("--batch-modes", default="minor8,minor",
                    help="comma-separated batch modes of --batch")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile: CUDA is not available", file=sys.stderr)
        return 2

    from bibfs_tpu_torch.graph.generate import gnp_random_graph
    from bibfs_tpu_torch.ops import fused_level as fl
    from bibfs_tpu_torch.ops import minor_level as ml
    from bibfs_tpu_torch.ops import pull_expand as pe
    from bibfs_tpu_torch.solvers import dense

    wrappers = {"fused_dual_round": fl.fused_dual_round,
                "fused_single_round": fl.fused_single_round,
                "fold_round": fl.fold_round, "pull_dual": pe.pull_dual,
                "pull_single": pe.pull_single}

    n = 1 << SCALE
    edges = gnp_random_graph(n, DEGREE / n, seed=SEED)
    g = dense.DeviceGraph.build(n, edges, layout="ell", device="cuda")
    rng = np.random.default_rng(SEED)
    pairs = [(int(a), int(b)) for a, b in rng.integers(0, n, (PAIRS, 2))]
    print(json.dumps({"card": torch.cuda.get_device_name(0), "n": n,
                      "edges": int(edges.shape[0]), "pairs": len(pairs),
                      "unroll": args.unroll, "batch": args.batch}))
    if args.batch:
        bpairs = rng.integers(0, n, (args.batch, 2))
        batch_wrappers = {"pull_dual_batch": pe.pull_dual_batch,
                          "pull_single_batch": pe.pull_single_batch}
        for mode in args.batch_modes.split(","):
            times, res = dense.time_batch_graph(g, bpairs, repeats=REPEATS,
                                                mode=mode)
            _p, dispatch, _f = dense._batch_dispatch(g, bpairs, mode)
            torch.cuda.synchronize()
            for key in ml.minor_level.launches:
                ml.minor_level.launches[key] = 0
            for w in batch_wrappers.values():
                w.launches = 0
            with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA],
            ) as prof:
                for _ in range(REPEATS):
                    dispatch()
                torch.cuda.synchronize()
            launches = {f"minor_level[{k}]": v / REPEATS
                        for k, v in ml.minor_level.launches.items() if v}
            launches.update({k: w.launches / REPEATS
                             for k, w in batch_wrappers.items() if w.launches})
            _report(mode, _kernel_events(prof), REPEATS,
                    float(np.median(times)) * 1e3, res[0].host_syncs,
                    launches, "batch")
        return 0
    for mode in MODES:
        search_ms, syncs = [], []
        for s, d in pairs:
            times, res = dense.time_search(g, s, d, repeats=REPEATS,
                                           mode=mode, unroll=args.unroll)
            search_ms.append(float(np.median(times)) * 1e3)
            syncs.append(res.host_syncs)
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
        ) as prof:
            for s, d in pairs:
                for _ in range(REPEATS):
                    dense._run(g, s, d, mode, args.unroll, None)
            torch.cuda.synchronize()
        solves = len(pairs) * REPEATS
        _report(mode, _kernel_events(prof), solves,
                float(np.median(search_ms)), float(np.mean(syncs)),
                {k: w.launches / solves for k, w in wrappers.items()
                 if w.launches}, "solve")
    return 0


def _report(mode, kernels, runs, med_ms, host_reads, launches, unit) -> None:
    """One JSON line: device time, idle share and device ops per ``unit``
    (a solve or a batch) over ``runs`` profiled runs."""
    per_us = sum(us for _n, us in kernels) / runs
    by_name: dict[str, float] = {}
    for name, us in kernels:
        by_name[name] = by_name.get(name, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(json.dumps({
        "mode": mode,
        f"median_{'search' if unit == 'solve' else unit}_ms": med_ms,
        f"kernel_ms_per_{unit}": per_us / 1e3 if kernels else None,
        "idle_share": 1 - per_us / 1e3 / med_ms if kernels else None,
        f"device_ops_per_{unit}": len(kernels) / runs,
        f"launches_per_{unit}": launches,
        f"host_reads_per_{unit}": host_reads,
        "top_kernels_ms": [[name[:60], us / 1e3] for name, us in top],
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
