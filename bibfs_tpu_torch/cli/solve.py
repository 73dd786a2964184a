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
search raises. ``--backend sharded --devices N`` runs the vertex-sharded
search on N ranks spawned on this host (one card each over NCCL when
there are N cards, else all on one card over staged gloo; ``--device
cpu``: gloo ranks on the host), with ``--mode``, ``--layout``,
``--unroll`` and ``--pairs`` (its queries one after another).
``--backend sharded2d --grid RxC`` runs the 2D block-partitioned search
on an R x C grid of ranks (default: the squarest grid of ``--devices``),
``--mode sync`` or ``alt``, with ``--pairs``.
``--level-stats`` (one query, the serial, native and dense backends)
prints one ``[Level]`` line per level after the answer, then the meet
level.

``--checkpoint FILE`` runs one query of a device backend (dense, sharded,
sharded2d) in chunks of ``--chunk K`` rounds (default 8), writing the
search's state to FILE after every chunk; ``--resume`` continues the
search in FILE on any of the three (the file format is ``bibfs-solve``'s,
so either tool resumes the other's).

``--sources S1,S2,...`` (multi-source: the hops from every source to the
positional dst), ``--kshortest K`` (Yen's K shortest loopless paths) and
``--weighted`` (delta-stepping over the derived weights of
``--weight-seed``) ask one typed query of :mod:`bibfs_tpu_torch.query`
through :func:`bibfs_tpu_torch.solvers.api.solve_query` and print
``bibfs-solve``'s lines for them: on the card by default (the kinds'
device rungs), on the host tier with ``--device cpu``.
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
                    help='batch mode (dense/sharded/native backends): a '
                    'file of "src dst" lines solved as one batch (native: '
                    "the threaded host batch; sharded: one query after "
                    "another); replaces the positional src/dst")
    ap.add_argument("--backend", default="dense",
                    choices=["serial", "dense", "sharded", "sharded2d",
                             "native"],
                    help="the dense device search (default), the "
                    "vertex-sharded search over --devices ranks, the 2D "
                    "block-partitioned search over a --grid of ranks, the "
                    "serial host oracle or the native C++ host runtime")
    ap.add_argument("--devices", type=int, default=None, metavar="N",
                    help="ranks of --backend sharded / sharded2d (default: "
                    "every card; one rank with --device cpu; sharded2d "
                    "factorizes it into the squarest grid unless --grid is "
                    "given)")
    ap.add_argument("--grid", default=None, metavar="RxC",
                    help="grid of --backend sharded2d (e.g. 2x2): the "
                    "adjacency blocked over R x C ranks, so a level's "
                    "frontier traffic scales as n/C + n/R instead of n")
    ap.add_argument("--checkpoint", default=None, metavar="FILE",
                    help="device backends (dense/sharded/sharded2d): run the "
                    "search in chunks and write its state to FILE after "
                    "every chunk (atomic .npz); with --resume, continue the "
                    "search in FILE (portable across the three backends)")
    ap.add_argument("--chunk", type=int, default=None, metavar="K",
                    help="rounds per chunk of the checkpointed search "
                    "(default 8); implies chunked execution even without "
                    "--checkpoint")
    ap.add_argument("--resume", action="store_true",
                    help="resume the search in --checkpoint FILE (src/dst "
                    "must match its fingerprint)")
    ap.add_argument("--mode", default=None,
                    choices=sorted(DENSE_MODES) + list(BATCH_ONLY),
                    help="dense schedule (default sync; with --resume the "
                    "checkpoint's): sync/alt/beamer/"
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
    ap.add_argument("--level-stats", action="store_true",
                    help="record per-level telemetry (frontier sizes, edges "
                    "scanned, push/pull direction, meet level) during the "
                    "solve and print it after the answer; single query "
                    "only (the dense backend steps its search level by "
                    "level from the host)")
    ap.add_argument("--no-path", action="store_true", help="skip path printing")
    ap.add_argument("--sources", default=None, metavar="S1,S2,...",
                    help="multi-source query: hop distance from EVERY "
                    "listed source to dst, one bitmask-packed msBFS sweep "
                    "per 64 sources (replaces the positional src: put the "
                    "dst positional BEFORE this flag, "
                    "`bibfs-torch-solve g.bin DST --sources S1,S2`)")
    ap.add_argument("--kshortest", type=int, default=None, metavar="K",
                    help="the K shortest loopless src->dst paths (Yen's "
                    "over batched restricted BFS solves), non-decreasing in "
                    "length")
    ap.add_argument("--weighted", action="store_true",
                    help="weighted shortest path by delta-stepping, edge "
                    "weights derived from the seeded symmetric hash "
                    "(--weight-seed)")
    ap.add_argument("--weight-seed", type=int, default=0,
                    help="weight-derivation seed for --weighted (same seed "
                    "= same weights on every replica; default 0)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="device of the dense and sharded backends and of "
                    "the query kinds (default cuda; no silent CPU fallback; "
                    "cpu runs the kinds on the host tier and the sharded "
                    "ranks over gloo); the serial oracle runs on the host "
                    "only")
    args = ap.parse_args(argv)
    # None: sync everywhere but --resume, where it keeps the file's mode
    mode = args.mode or "sync"
    args.mode_given = args.mode
    taxonomy = (
        args.sources is not None or args.kshortest is not None
        or args.weighted
    )
    if taxonomy:
        if sum((args.sources is not None, args.kshortest is not None,
                args.weighted)) > 1:
            ap.error("--sources / --kshortest / --weighted are mutually "
                     "exclusive query kinds")
        if args.pairs is not None or args.repeat > 1 or args.level_stats:
            ap.error("taxonomy queries are single-query (no --pairs / "
                     "--repeat / --level-stats)")
        from bibfs_tpu_torch.graph.io import read_graph_bin

        try:
            n, edges = read_graph_bin(args.graph)
        except (OSError, ValueError) as e:
            print(f"Error reading graph: {e}", file=sys.stderr)
            return 2
        return _taxonomy_main(ap, args, n, edges)
    if args.devices is not None and (
            args.backend not in ("sharded", "sharded2d") or args.devices < 1):
        ap.error("--devices N (N >= 1) applies to --backend sharded / "
                 "sharded2d only")
    rows = cols = None
    if args.grid is not None:
        if args.backend != "sharded2d":
            ap.error("--grid only applies to --backend sharded2d")
        try:
            rows, cols = (int(x) for x in args.grid.lower().split("x"))
            if rows < 1 or cols < 1:
                raise ValueError
        except ValueError:
            ap.error(f"--grid must look like 2x4, got {args.grid!r}")
    if args.backend == "sharded2d":
        if mode not in ("sync", "alt"):
            ap.error("--backend sharded2d supports --mode sync/alt only "
                     "(pull-only 2D partition)")
        if args.layout != "ell":
            ap.error("--backend sharded2d has its own block layout; "
                     "--layout does not apply")
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
            ap.error("--pairs batch mode is supported by --backend dense, "
                     "sharded, sharded2d and native")
        if args.src is not None or args.dst is not None:
            ap.error("--pairs replaces the positional src/dst arguments")
    elif args.src is None or args.dst is None:
        ap.error("src and dst are required (or use --pairs FILE)")
    checkpointed = (args.checkpoint is not None or args.chunk is not None
                    or args.resume)
    if checkpointed:
        if args.backend not in ("dense", "sharded", "sharded2d"):
            ap.error("--checkpoint/--chunk/--resume need a device backend "
                     "(dense/sharded/sharded2d); host backends finish in "
                     "one shot")
        if args.pairs is not None or args.repeat > 1:
            ap.error("--checkpoint/--chunk are single-query (no --pairs / "
                     "--repeat)")
        if args.resume and args.checkpoint is None:
            ap.error("--resume needs --checkpoint FILE to resume from")
        if args.chunk is not None and args.chunk < 1:
            ap.error("--chunk must be >= 1")
    if args.unroll > 1 and (args.pairs is not None or checkpointed):
        ap.error("--unroll is single-query only (no --pairs / "
                 "--checkpoint / --chunk / --resume)")
    if args.unroll < 1:
        ap.error("--unroll must be >= 1")
    if args.repeat < 1:
        ap.error("--repeat must be >= 1")
    if args.level_stats and (args.pairs is not None or args.repeat > 1
                             or checkpointed):
        ap.error("--level-stats is single-query only (no --pairs / "
                 "--checkpoint / --repeat)")
    host = args.backend in ("serial", "native")
    if host and (
        args.layout != "ell" or mode != "sync" or args.unroll != 1
    ):
        ap.error("--mode/--layout/--unroll apply to the device backends "
                 "(dense, sharded, sharded2d) only")
    if args.level_stats and args.backend in ("sharded", "sharded2d"):
        ap.error(f"--level-stats is not supported by --backend "
                 f"{args.backend}")
    if args.unroll > 1 and args.backend == "sharded2d":
        ap.error("--unroll applies to the dense/sharded backends only")
    if host and args.device == "cuda":
        ap.error(f"--backend {args.backend} runs on the host and cannot "
                 "run on cuda")

    from bibfs_tpu_torch.graph.io import read_graph_bin

    try:
        n, edges = read_graph_bin(args.graph)
    except (OSError, ValueError) as e:
        print(f"Error reading graph: {e}", file=sys.stderr)
        return 2
    args.mode, args.rows, args.cols = mode, rows, cols
    if args.pairs is not None:
        return _batch_main(args, n, edges)
    if checkpointed:
        return _checkpoint_main(args, n, edges)
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
    if args.level_stats and res.level_stats is not None:
        for lv in res.level_stats["levels"]:
            print(
                "[Level] {level:>3} side={side} dir={dir:<4} "
                "frontier={frontier:>8} edges={edges}".format(**lv)
            )
        print(f"[Level] meet_level={res.level_stats['meet_level']}")
    return 0


def _solve(args, n, edges):
    tel = {"telemetry": True} if args.level_stats else {}
    if args.backend in ("serial", "native"):
        from bibfs_tpu_torch.solvers.timing import timed_repeats

        if args.backend == "serial":
            from bibfs_tpu_torch.graph.csr import build_csr
            from bibfs_tpu_torch.solvers.serial import solve_serial_csr

            row_ptr, col_ind = build_csr(n, edges)

            def run():
                return solve_serial_csr(n, row_ptr, col_ind, args.src,
                                        args.dst, **tel)
        else:
            from bibfs_tpu_torch.solvers.native import (
                NativeGraph,
                solve_native_graph,
            )

            g = NativeGraph.build(n, edges)

            def run():
                return solve_native_graph(g, args.src, args.dst, **tel)

        if args.repeat > 1:
            return timed_repeats(run, run, args.repeat, force=None)[1]
        return run()
    if args.backend == "sharded2d":
        from bibfs_tpu_torch.solvers.sharded2d import solve_sharded2d

        return solve_sharded2d(n, edges, args.src, args.dst, rows=args.rows,
                               cols=args.cols, num_devices=args.devices,
                               mode=args.mode, device=args.device,
                               repeats=args.repeat)
    if args.backend == "sharded":
        from bibfs_tpu_torch.solvers.sharded import solve_sharded

        return solve_sharded(n, edges, args.src, args.dst,
                             num_devices=args.devices, mode=args.mode,
                             layout=args.layout, unroll=args.unroll,
                             device=args.device, repeats=args.repeat)
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
                             unroll=args.unroll, **tel)


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
        elif args.backend == "sharded2d":
            from bibfs_tpu_torch.solvers.sharded2d import solve_batch_sharded2d

            results = solve_batch_sharded2d(
                n, edges, pairs, rows=args.rows, cols=args.cols,
                num_devices=args.devices, mode=args.mode, device=args.device,
                repeats=args.repeat)
        elif args.backend == "sharded":
            from bibfs_tpu_torch.solvers.sharded import solve_batch_sharded

            results = solve_batch_sharded(
                n, edges, pairs, num_devices=args.devices, mode=args.mode,
                layout=args.layout, device=args.device, repeats=args.repeat)
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


def _checkpoint_main(args, n, edges):
    """``--checkpoint/--chunk/--resume``: one query in chunks on the dense
    search, a 1D mesh or a 2D grid (:mod:`bibfs_tpu_torch.solvers.
    checkpoint`), printing the answer lines and the checkpoint line."""
    from bibfs_tpu_torch.solvers import checkpoint as ck

    chunk = args.chunk if args.chunk is not None else 8
    mode = args.mode_given if args.resume else args.mode
    try:
        if args.backend == "dense":
            from bibfs_tpu_torch.solvers.dense import DeviceGraph

            g = DeviceGraph.build(n, edges, layout=args.layout,
                                  device=args.device)
            if args.resume:
                res = ck.resume(args.checkpoint, g, src=args.src,
                                dst=args.dst, mode=mode, chunk=chunk)
            else:
                res = ck.solve_checkpointed(g, args.src, args.dst, mode=mode,
                                            chunk=chunk, path=args.checkpoint)
        else:
            res = ck.checkpoint_on_mesh(
                n, edges, args.src, args.dst,
                substrate="2d" if args.backend == "sharded2d" else "1d",
                num_devices=args.devices, rows=args.rows, cols=args.cols,
                mode=mode, layout=args.layout, chunk=chunk,
                path=args.checkpoint, resume_from=args.resume,
                device=args.device)
    except (ValueError, RuntimeError, OSError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2
    if res.found:
        print(f"Shortest path length = {res.hops}")
        if res.path and not args.no_path:
            print("Path: " + " -> ".join(str(v) for v in res.path))
    else:
        print("No path found.")
    print(f"[Time] {args.backend} bidirectional BFS took {res.time_s:.9f} "
          "seconds")
    print(f"[TEPS] {res.teps:.3e} traversed edges/second "
          f"({res.edges_scanned} edges)")
    if args.checkpoint:
        print(f"[Checkpoint] {args.checkpoint} (chunk={chunk} levels)")
    return 0


def _taxonomy_main(ap, args, n, edges):
    """``--sources`` / ``--kshortest`` / ``--weighted``: the typed
    query kinds (bibfs_tpu_torch/query) through :func:`api.solve_query`
    on ``--device`` (default the card), with the reference's scrapeable
    output shapes kept where they apply."""
    from bibfs_tpu_torch.query import KShortest, MultiSource, Weighted
    from bibfs_tpu_torch.solvers.api import solve_query

    if args.dst is None:
        # --sources replaces src only; every kind still needs a dst
        # (with --sources the one positional argument IS the dst)
        if args.sources is not None and args.src is not None:
            args.dst, args.src = args.src, None
        else:
            ap.error("taxonomy queries need a destination vertex")
    if args.sources is not None:
        if args.src is not None:
            ap.error("--sources replaces the positional src")
        try:
            sources = tuple(
                int(x) for x in args.sources.split(",") if x.strip()
            )
        except ValueError:
            ap.error(f"--sources must be a comma list of ints, got "
                     f"{args.sources!r}")
        q = MultiSource(sources, args.dst)
    elif args.kshortest is not None:
        if args.src is None:
            ap.error("--kshortest needs positional src and dst")
        q = KShortest(args.src, args.dst, k=args.kshortest)
    else:
        if args.src is None:
            ap.error("--weighted needs positional src and dst")
        q = Weighted(args.src, args.dst, weight_seed=args.weight_seed)
    try:
        res = solve_query(n, edges, q, device=args.device)
    except (ValueError, RuntimeError, OSError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2
    if isinstance(q, MultiSource):
        for s, hops in zip(q.sources, res.per_source):
            print(f"{s} -> {q.dst}: "
                  + (f"length = {hops}" if hops is not None else "no path"))
        if res.found and res.path and not args.no_path:
            print(f"Best ({q.sources[res.best]}): Path: "
                  + " -> ".join(str(v) for v in res.path))
        print(f"[Time] msbfs {res.sweeps} sweep(s) over {len(q.sources)} "
              f"sources took {res.time_s:.9f} seconds")
    elif isinstance(q, KShortest):
        if not res.found:
            print("No path found.")
        for i, (p, hops) in enumerate(zip(res.paths, res.hops), 1):
            line = f"[{i}] length = {hops}"
            if not args.no_path:
                line += "  path: " + " -> ".join(str(v) for v in p)
            print(line)
        print(f"[Time] kshortest k={q.k} took {res.time_s:.9f} seconds")
    else:
        if res.found:
            print(f"Weighted distance = {res.dist:g} ({res.hops} edges)")
            if res.path and not args.no_path:
                print("Path: " + " -> ".join(str(v) for v in res.path))
        else:
            print("No path found.")
        print(f"[Time] weighted delta-stepping took {res.time_s:.9f} "
              f"seconds ({res.buckets} buckets, "
              f"{res.relaxations} relaxations)")
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
