"""CLI solver: ``bibfs-torch-solve <graph.bin> <src> <dst>``, or
``bibfs-torch-solve <graph.bin> --pairs FILE`` for a batch.

Prints the same lines as ``bibfs-solve``: ``Shortest path length = N``,
``Path: ...``, the ``[Time]`` line and the ``[TEPS]`` line; with
``--pairs`` (a file of ``src dst`` lines, dense or native backend) one
line per pair and the ``[Time] <backend> batch of N searches took ...``
line. The batch-only modes ``minor``, ``minor8`` and ``auto`` need
``--pairs``. The default is the dense search on the CUDA card;
``--device cpu`` runs its plain torch versions on the host,
``--backend serial`` the host oracle and ``--backend native`` the C++
host runtime (built with ``g++`` at first use; ``--pairs`` runs its
threaded batch). Without a card and without ``--device cpu`` the dense
search raises.
"""

from __future__ import annotations

import argparse
import sys

from bibfs_tpu_torch.solvers.dense import DENSE_MODES

BATCH_ONLY = ("minor", "minor8", "auto")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Bidirectional BFS (PyTorch / CUDA)"
    )
    ap.add_argument("graph", help="binary graph file (uint32 N,M + edge pairs)")
    ap.add_argument("src", type=int, nargs="?", default=None)
    ap.add_argument("dst", type=int, nargs="?", default=None)
    ap.add_argument("--pairs", default=None, metavar="FILE",
                    help='batch mode (dense/native backends): a file of '
                    '"src dst" lines solved as one batch (native: the '
                    "threaded host batch); replaces the positional src/dst")
    ap.add_argument("--backend", default="dense",
                    choices=["serial", "dense", "native"],
                    help="the dense device search (default), the serial "
                    "host oracle or the native C++ host runtime")
    ap.add_argument("--mode", default="sync",
                    choices=sorted(DENSE_MODES) + list(BATCH_ONLY),
                    help="dense schedule (default sync): sync/alt/beamer/"
                    "beamer_alt/sync_unfused as torch ops, pallas/pallas_alt "
                    "on the pull kernels, fused/fused_alt as one level "
                    "kernel per round with the state on the device; "
                    "minor/minor8 are batch-only layouts (--pairs): the "
                    "queries on the minor axis of [n, B] planes, one level "
                    "kernel per round, minor8 with int8 planes (plain ELL); "
                    "auto (batch only) picks the best eligible layout")
    ap.add_argument("--layout", default="ell", choices=["ell", "tiered"],
                    help="dense adjacency layout: one table, or a base table "
                    "plus geometric hub tiers (power-law graphs)")
    ap.add_argument("--unroll", type=int, default=1, metavar="K",
                    help="dense fused modes: rounds launched per read of the "
                    "device state (exact for every K)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="report the median of K timed repeats after a "
                    "warm-up run")
    ap.add_argument("--no-path", action="store_true", help="skip path printing")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="device of the dense backend (default cuda; no "
                    "silent CPU fallback); the serial oracle runs on the "
                    "host only")
    args = ap.parse_args(argv)
    if args.mode in BATCH_ONLY:
        if args.pairs is None or args.backend != "dense":
            ap.error("--mode minor/minor8/auto are batch-only: use "
                     "--pairs FILE with --backend dense")
        if args.layout == "tiered" and args.mode == "minor8":
            ap.error("--mode minor8 is plain-ELL only (slot-coded "
                     "parents); tiered graphs batch through --mode "
                     "minor or sync")
    if args.pairs is not None:
        if args.backend == "serial":
            ap.error("--pairs batch mode is supported by --backend dense "
                     "and native")
        if args.src is not None or args.dst is not None:
            ap.error("--pairs replaces the positional src/dst arguments")
    elif args.src is None or args.dst is None:
        ap.error("src and dst are required (or use --pairs FILE)")
    if args.unroll > 1 and args.pairs is not None:
        ap.error("--unroll is single-query only (no --pairs)")
    if args.unroll < 1:
        ap.error("--unroll must be >= 1")
    if args.repeat < 1:
        ap.error("--repeat must be >= 1")
    host = args.backend in ("serial", "native")
    if host and (
        args.layout != "ell" or args.mode != "sync" or args.unroll != 1
    ):
        ap.error("--mode/--layout/--unroll apply to --backend dense only")
    if host and args.device == "cuda":
        ap.error(f"--backend {args.backend} runs on the host and cannot "
                 "run on cuda")

    from bibfs_tpu_torch.graph.io import read_graph_bin

    try:
        n, edges = read_graph_bin(args.graph)
    except (OSError, ValueError) as e:
        print(f"Error reading graph: {e}", file=sys.stderr)
        return 2
    if args.pairs is not None:
        return _batch_main(args, n, edges)
    try:
        res = _solve(args, n, edges)
    except (ValueError, RuntimeError, OSError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2

    if res.found:
        print(f"Shortest path length = {res.hops}")
        if res.path and not args.no_path:
            print("Path: " + " -> ".join(str(v) for v in res.path))
    else:
        print("No path found.")
    print(f"[Time] {args.backend} bidirectional BFS took {res.time_s:.9f} seconds")
    print(f"[TEPS] {res.teps:.3e} traversed edges/second ({res.edges_scanned} edges)")
    return 0


def _solve(args, n, edges):
    if args.backend in ("serial", "native"):
        from bibfs_tpu_torch.solvers.timing import timed_repeats

        if args.backend == "serial":
            from bibfs_tpu_torch.graph.csr import build_csr
            from bibfs_tpu_torch.solvers.serial import solve_serial_csr

            row_ptr, col_ind = build_csr(n, edges)

            def run():
                return solve_serial_csr(n, row_ptr, col_ind, args.src, args.dst)
        else:
            from bibfs_tpu_torch.solvers.native import (
                NativeGraph,
                solve_native_graph,
            )

            g = NativeGraph.build(n, edges)

            def run():
                return solve_native_graph(g, args.src, args.dst)

        if args.repeat > 1:
            return timed_repeats(run, run, args.repeat, force=None)[1]
        return run()
    from bibfs_tpu_torch.solvers.dense import (
        DeviceGraph,
        solve_dense_graph,
        time_search,
    )

    g = DeviceGraph.build(n, edges, layout=args.layout, device=args.device)
    if args.repeat > 1:
        return time_search(g, args.src, args.dst, repeats=args.repeat,
                           mode=args.mode, unroll=args.unroll)[1]
    return solve_dense_graph(g, args.src, args.dst, mode=args.mode,
                             unroll=args.unroll)


def _batch_main(args, n, edges):
    import numpy as np

    try:
        pairs = np.loadtxt(args.pairs, dtype=np.int64, ndmin=2)
    except (OSError, ValueError) as e:
        print(f"Error reading pairs: {e}", file=sys.stderr)
        return 2
    if pairs.shape[1] != 2:
        print(f"Error: {args.pairs} must have two columns (src dst)",
              file=sys.stderr)
        return 2
    try:
        if args.backend == "native":
            from bibfs_tpu_torch.solvers.native import (
                NativeGraph,
                solve_batch_native_graph,
                time_batch_native,
            )

            g = NativeGraph.build(n, edges)
            if args.repeat > 1:
                _times, results = time_batch_native(g, pairs,
                                                    repeats=args.repeat)
            else:
                results = solve_batch_native_graph(g, pairs)
        else:
            from bibfs_tpu_torch.solvers.dense import (
                DeviceGraph,
                solve_batch_graph,
                time_batch_graph,
            )

            g = DeviceGraph.build(n, edges, layout=args.layout,
                                  device=args.device)
            if args.repeat > 1:
                _times, results = time_batch_graph(g, pairs,
                                                   repeats=args.repeat,
                                                   mode=args.mode)
            else:
                results = solve_batch_graph(g, pairs, mode=args.mode)
    except (ValueError, RuntimeError, OSError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2
    for (src, dst), res in zip(pairs, results):
        if res.found:
            line = f"{src} -> {dst}: length = {res.hops}"
            if res.path and not args.no_path:
                line += "  path: " + " -> ".join(str(v) for v in res.path)
        else:
            line = f"{src} -> {dst}: no path"
        print(line)
    batch_s = results[0].time_s if results else 0.0
    print(
        f"[Time] {args.backend} batch of {len(results)} searches took "
        f"{batch_s:.9f} seconds ({batch_s / max(len(results), 1):.9f} s/query)"
    )
    return 0


def _main():
    try:
        return main()
    except BrokenPipeError:  # e.g. piped into `head`
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    raise SystemExit(_main())
