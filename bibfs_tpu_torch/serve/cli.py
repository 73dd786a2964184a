"""``bibfs-torch-serve`` — serve shortest-path queries over one graph: the
counterpart of ``bibfs-serve`` (``bibfs_tpu/serve/cli.py``) for one
``.bin`` graph.

The engine keeps the graph on the card, micro-batches queued queries into
batched device searches above the crossover (the native host runtime
below it), and answers repeat traffic from the distance cache. Queries
come from ``--pairs FILE`` or stdin (one ``src dst`` per line); results
print in the ``bibfs-torch-solve --pairs`` line format, the same lines
``bibfs-serve`` prints for the same graph and input, and ``--stats-json``
writes the engine's serving counters.

``--pipeline`` serves through the asynchronous
:class:`~bibfs_tpu_torch.serve.pipeline.PipelinedQueryEngine`: a
background flusher launches batches while a finish worker resolves the
previous one, and ``--max-wait-ms`` is the latency SLO (a sub-crossover
queue flushes on its deadline instead of waiting for depth).

On stdin, ``health`` and ``stats`` answer one-line JSON replies in the
result stream; a malformed line answers an ``error invalid: ...`` line
and the stream goes on; SIGTERM drains (health reads draining, queued
queries resolve and print) and exits 0.

``--blocked`` adds the blocked tile rung ahead of the device rung
(``blocked -> device -> host``), and ``--adaptive`` orders the ladder per
graph from measured route latencies.

The engine runs on ``cuda`` unless ``--device cpu`` is given. The store,
mesh, oracle, network, load-harness, metrics and trace flags of
``bibfs-serve`` come with later slices of the port (ROADMAP Queue 1).
"""

from __future__ import annotations

import argparse
import json
import sys


class _SigTerm(Exception):
    """Raised by the SIGTERM handler out of the blocking stdin read: the
    graceful drain (health flips to draining, in-flight flushes finish,
    queued results print, exit 0)."""


def _control_reply(engine, cmd: str) -> str:
    """The stdin ``health`` / ``stats`` commands' one-line JSON reply
    (``health {...}`` / ``stats {...}``). No flush is forced, so a probe
    never perturbs batching."""
    if cmd == "health":
        payload = engine.health_snapshot()
    else:
        payload = engine.stats()
        # the Prometheus text rides the stats reply (a subprocess replica
        # has no HTTP port of its own)
        from bibfs_tpu_torch.obs.metrics import REGISTRY

        payload["metrics_render"] = REGISTRY.render()
    return cmd + " " + json.dumps(
        payload, sort_keys=True, default=str, separators=(",", ":")
    )


def _print_result(src, dst, res, no_path: bool) -> None:
    if res.found:
        line = f"{src} -> {dst}: length = {res.hops}"
        if res.path and not no_path:
            line += "  path: " + " -> ".join(str(v) for v in res.path)
    else:
        line = f"{src} -> {dst}: no path"
    print(line)


def main(argv=None):
    from bibfs_tpu_torch.serve.engine import BATCH_LAYOUT_MODES
    from bibfs_tpu_torch.solvers.dense import DENSE_MODES

    ap = argparse.ArgumentParser(
        description="Serve (src, dst) queries through the micro-batching "
        "engine (PyTorch / CUDA)"
    )
    ap.add_argument("graph", help=".bin graph file (uint32 N,M + edge pairs)")
    ap.add_argument("--pairs", default=None, metavar="FILE",
                    help='query file of "src dst" lines (default: stream '
                    "stdin)")
    ap.add_argument("--mode", default="auto",
                    choices=list(BATCH_LAYOUT_MODES) + sorted(DENSE_MODES),
                    help="batch mode of device flushes (default auto: "
                    "minor8 where the graph and batch fit, else minor, "
                    "else lock-step sync)")
    ap.add_argument("--layout", default="ell", choices=["ell", "tiered"],
                    help="adjacency layout (ell is shape-bucketed; tiered "
                    "for power-law graphs)")
    ap.add_argument("--threshold", type=int, default=None,
                    help="queue depth at which a flush dispatches as a "
                    "device batch (default: the device's batch crossover); "
                    "below it queries run on the host runtime")
    ap.add_argument("--blocked", action="store_true",
                    help='enable route="blocked": above-crossover flushes on '
                    "tile-compact (dense-ish or grid) graphs advance as int8 "
                    "block products over the 128x128 tiled adjacency instead "
                    "of ELL gathers. The rung leads the ladder (blocked -> "
                    "device -> host) with its own breaker and retry policy; "
                    "its crossover constants come from calibration.json "
                    "(the platform's blocked block), else 128 queries and a "
                    "waste cap of 128")
    ap.add_argument("--adaptive", action="store_true",
                    help="adaptive routing: learn a per-graph route order "
                    "from measured per-route latencies and sampled level "
                    "telemetry instead of the static ladder (in memory)")
    ap.add_argument("--max-batch", type=int, default=1024,
                    help="largest single device flush (default 1024)")
    ap.add_argument("--cache-entries", type=int, default=64,
                    help="distance-cache forest capacity (default 64)")
    ap.add_argument("--pipeline", action="store_true",
                    help="serve through the pipelined engine: a background "
                    "deadline flusher, the device launch overlapped with "
                    "the host-side finish")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="latency SLO of --pipeline: a sub-crossover queue "
                    "flushes once its oldest query has waited this long "
                    "(default 5.0)")
    ap.add_argument("--inject-faults", default=None, metavar="SPEC",
                    help="inject faults at the serving seams per SPEC (the "
                    "grammar of bibfs_tpu_torch/serve/faults, e.g. "
                    "'device:p=0.1'); BIBFS_FAULTS is the flagless "
                    "equivalent and this flag wins")
    ap.add_argument("--no-path", action="store_true",
                    help="skip path printing")
    ap.add_argument("--stats-json", default=None, metavar="FILE",
                    help="write the engine's serving counters to FILE as "
                    "JSON")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="device of the batched search (default cuda; no "
                    "silent CPU fallback)")
    args = ap.parse_args(argv)

    from bibfs_tpu_torch.graph.io import read_graph_bin

    try:
        n, edges = read_graph_bin(args.graph)
    except (OSError, ValueError) as e:
        print(f"Error reading graph: {e}", file=sys.stderr)
        return 2
    return _serve(args, n, edges)


def _build_engine(args, n, edges):
    from bibfs_tpu_torch.serve import PipelinedQueryEngine, QueryEngine

    kwargs = dict(
        mode=args.mode,
        layout=args.layout,
        flush_threshold=args.threshold,
        max_batch=args.max_batch,
        cache_entries=args.cache_entries,
        device=args.device,
    )
    if args.blocked:
        kwargs["blocked"] = True
    if args.adaptive:
        kwargs["adaptive"] = True
    if args.inject_faults is not None:
        import os

        from bibfs_tpu_torch.serve.faults import FaultPlan

        kwargs["faults"] = FaultPlan.parse(
            args.inject_faults,
            seed=int(os.environ.get("BIBFS_FAULTS_SEED", 0)),
        )
    if args.pipeline:
        return PipelinedQueryEngine(n, edges, max_wait_ms=args.max_wait_ms,
                                    **kwargs)
    return QueryEngine(n, edges, **kwargs)


def _serve(args, n, edges) -> int:
    try:
        engine = _build_engine(args, n, edges)
    except (KeyError, ValueError, RuntimeError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2
    try:
        if args.pairs is not None:
            import numpy as np

            pairs = np.loadtxt(args.pairs, dtype=np.int64, ndmin=2)
            if pairs.shape[1] != 2:
                print(f"Error: {args.pairs} must have two columns (src dst)",
                      file=sys.stderr)
                return 2
            results = engine.query_many(pairs)
            for (src, dst), res in zip(pairs, results):
                _print_result(src, dst, res, args.no_path)
        elif _serve_stdin(args, engine):
            return 1
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2
    finally:
        engine.close()

    stats = engine.stats()
    print(
        "[Serve] {q} queries: {mq} mesh, {dq} device-batched "
        "({db} flushes), {hq} host, {ov} overlay-exact, "
        "{orc} oracle-served, {cs} cache-served; "
        "exec programs {ep} ({eh} reused)".format(
            q=stats["queries"], mq=stats["mesh_queries"],
            dq=stats["device_queries"], db=stats["device_batches"],
            hq=stats["host_queries"], ov=stats["overlay_queries"],
            orc=stats["oracle_served"], cs=stats["cache_served"],
            ep=stats["exec_cache"]["programs"],
            eh=stats["exec_cache"]["hits"],
        ),
        file=sys.stderr,
    )
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(stats, f, indent=1, sort_keys=True, default=str)
            f.write("\n")
    return 0


def _serve_stdin(args, engine) -> int:
    """Stream stdin: tickets resolve at each engine flush (the queue fills
    to ``max_batch`` or EOF drains the rest; under ``--pipeline`` the
    deadline flusher resolves them on its own). A malformed line answers
    an ``error ...`` line and the loop goes on. Returns the failed
    tickets."""
    import signal

    from bibfs_tpu_torch.serve.resilience import QueryError

    tickets: list = []
    emitted = 0
    failed = 0

    def drain():
        nonlocal emitted, failed
        while emitted < len(tickets):
            t = tickets[emitted]
            if t.error is not None:
                # a failed ticket surfaces in the stream, never stalls it
                kind = getattr(t.error, "kind", "internal")
                print(f"error {kind}: {t.src} -> {t.dst}: {t.error}")
                failed += 1
            elif t.result is None:
                break
            else:
                _print_result(t.src, t.dst, t.result, args.no_path)
            emitted += 1

    def _on_sigterm(signum, frame):
        # one-shot: disarm BEFORE raising, so a second SIGTERM during the
        # drain cannot abort it
        try:
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
        except ValueError:
            pass
        raise _SigTerm()

    prev_handler = None
    sigterm = False
    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        pass  # not the main thread (in-process embedding)
    try:
        for line in sys.stdin:
            parts = line.split()
            if not parts:
                continue
            if parts[0] in ("health", "stats"):
                if len(parts) != 1:
                    print(f"error invalid: usage: {parts[0]}")
                    continue
                # resolved results first: the reply doubles as a drain nudge
                drain()
                print(_control_reply(engine, parts[0]))
                continue
            if len(parts) != 2:
                print("error invalid: expected 'src dst', got "
                      f"{line.strip()!r}")
                continue
            try:
                src, dst = int(parts[0]), int(parts[1])
            except ValueError:
                print("error invalid: non-integer node id in "
                      f"{line.strip()!r}")
                continue
            try:
                tickets.append(engine.submit(src, dst))
            except QueryError as e:
                # a draining engine refuses with a structured capacity
                # error: answer it and keep serving what is queued
                print(f"error {e.kind}: {src} -> {dst}: {e}")
                continue
            except RuntimeError as e:
                print(f"error capacity: {src} -> {dst}: {e}")
                continue
            except ValueError as e:
                print(f"error invalid: {src} -> {dst}: {e}")
                continue
            drain()
    except _SigTerm:
        sigterm = True
        try:
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
        except ValueError:
            pass
        engine.begin_drain()  # health -> draining
        print("[Serve] SIGTERM: draining (finishing in-flight flushes)",
              file=sys.stderr, flush=True)
    finally:
        if prev_handler is not None and not sigterm:
            try:
                signal.signal(signal.SIGTERM, prev_handler)
            except ValueError:
                pass
    engine.flush()
    drain()
    sys.stdout.flush()
    return failed


if __name__ == "__main__":
    raise SystemExit(main())
