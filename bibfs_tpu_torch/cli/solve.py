"""CLI solver: ``bibfs-torch-solve <graph.bin> <src> <dst>``.

Prints the same lines as ``bibfs-solve``: ``Shortest path length = N``,
``Path: ...``, the ``[Time]`` line and the ``[TEPS]`` line. The default
is the dense search on the CUDA card; ``--device cpu`` runs its plain
torch versions on the host, and ``--backend serial`` the host oracle.
Without a card and without ``--device cpu`` the dense search raises.
"""

from __future__ import annotations

import argparse
import sys

from bibfs_tpu_torch.solvers.dense import DENSE_MODES


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Bidirectional BFS (PyTorch / CUDA)"
    )
    ap.add_argument("graph", help="binary graph file (uint32 N,M + edge pairs)")
    ap.add_argument("src", type=int)
    ap.add_argument("dst", type=int)
    ap.add_argument("--backend", default="dense", choices=["serial", "dense"],
                    help="the dense device search (default) or the serial "
                    "host oracle")
    ap.add_argument("--mode", default="sync", choices=sorted(DENSE_MODES),
                    help="dense schedule (default sync): sync/alt/beamer/"
                    "beamer_alt/sync_unfused as torch ops, pallas/pallas_alt "
                    "on the pull kernels, fused/fused_alt as one level "
                    "kernel per round with the state on the device")
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
    if args.unroll < 1:
        ap.error("--unroll must be >= 1")
    if args.repeat < 1:
        ap.error("--repeat must be >= 1")
    if args.backend == "serial" and (
        args.layout != "ell" or args.mode != "sync" or args.unroll != 1
    ):
        ap.error("--mode/--layout/--unroll apply to --backend dense only")
    if args.backend == "serial" and args.device == "cuda":
        ap.error("--backend serial is the host oracle and cannot run on cuda")

    from bibfs_tpu_torch.graph.io import read_graph_bin

    try:
        n, edges = read_graph_bin(args.graph)
    except (OSError, ValueError) as e:
        print(f"Error reading graph: {e}", file=sys.stderr)
        return 2
    try:
        res = _solve(args, n, edges)
    except (ValueError, RuntimeError) as e:
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
    if args.backend == "serial":
        from bibfs_tpu_torch.graph.csr import build_csr
        from bibfs_tpu_torch.solvers.serial import solve_serial_csr
        from bibfs_tpu_torch.solvers.timing import timed_repeats

        row_ptr, col_ind = build_csr(n, edges)

        def run():
            return solve_serial_csr(n, row_ptr, col_ind, args.src, args.dst)

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


def _main():
    try:
        return main()
    except BrokenPipeError:  # e.g. piped into `head`
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    raise SystemExit(_main())
