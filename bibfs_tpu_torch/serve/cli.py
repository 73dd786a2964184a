"""``bibfs-torch-serve`` — serve shortest-path queries over one graph or a
graph store: the counterpart of ``bibfs-serve``
(``bibfs_tpu/serve/cli.py``).

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
graph from measured route latencies. ``--mesh N|auto`` adds the mesh rung
ahead of both: a pool of N ranks on this host (one card each, or sharing
one; gloo ranks with ``--device cpu``) serves above-crossover flushes,
data-parallel or vertex-sharded (``serve/routes/mesh.py``);
``--mesh-shard-min-n`` sets the vertex-sharded crossover.

``--store DIR`` serves a whole
:class:`~bibfs_tpu_torch.store.GraphStore` instead of one ``.bin``: every
``DIR/*.bin`` registers under its file stem, and the stdin stream takes
store commands beside ``src dst`` queries: ``use NAME`` switches the
stream's graph, ``update add U V`` / ``update del U V`` applies a live
edge update (answered exactly through the delta overlay until
compaction), ``swap`` forces a compaction and hot-swap of the current
graph, and ``graphs`` lists the graphs with their versions.

``--oracle K`` turns on the landmark distance oracle: under ``--store``
the store keeps one index per graph (built in the background on the
engine's device), with a ``.bin`` the engine builds one at startup. The
stdin command ``oracle`` prints the current graph's index status and hit
counts. Command replies land in the result stream.

``--durable`` (with ``--store``) turns on the store's durability layer
(``bibfs_tpu_torch/store/wal.py``): every acked update is written ahead
to the log under the ``--fsync`` policy before the ack, compactions and
swaps commit checkpoints, and startup recovers manifest + WAL, so a
killed server comes back at its last acked state. Recovery maps each
checkpoint's arrays sidecar unless ``--no-mmap`` is given (then it
rebuilds from the ``.bin``). ``--residency-budget BYTES`` demotes the
least recently used graphs past the budget to the compressed cold tier,
and the stdin command ``memory`` prints each graph's tier and bytes.

The engine runs on ``cuda`` unless ``--device cpu`` is given. The mesh,
network, load-harness, metrics and trace flags of ``bibfs-serve`` come
with later slices of the port (ROADMAP Queue 1).
"""

from __future__ import annotations

import argparse
import json
import sys

_STORE_COMMANDS = ("use", "update", "swap", "graphs")


class _SigTerm(Exception):
    """Raised by the SIGTERM handler out of the blocking stdin read: the
    graceful drain (health flips to draining, in-flight flushes finish,
    queued results print, exit 0)."""


def _control_reply(engine, store, cmd: str) -> str:
    """The stdin ``health`` / ``stats`` / ``memory`` commands' one-line
    JSON reply (``health {...}`` / ``stats {...}``, the store's stats
    inside the latter / ``memory {...}``, the store's tiers and bytes). No
    flush is forced, so a probe never perturbs batching."""
    if cmd == "health":
        payload = engine.health_snapshot()
    elif cmd == "memory":
        payload = store.memory_stats()
    else:
        payload = engine.stats()
        if store is not None:
            payload["store"] = store.stats()
        # the Prometheus text rides the stats reply (a subprocess replica
        # has no HTTP port of its own)
        from bibfs_tpu_torch.obs.metrics import REGISTRY

        payload["metrics_render"] = REGISTRY.render()
    return cmd + " " + json.dumps(
        payload, sort_keys=True, default=str, separators=(",", ":")
    )


def _oracle_status(engine, store, current) -> str:
    """The stdin ``oracle`` command's reply line: the current graph's index
    status and hit counts (store-backed or engine-local)."""
    if store is not None:
        if store.oracle_k is None:
            return "oracle: off (serve with --oracle K)"
        st = store.stats()["graphs"][current]["oracle"]
        state = ("ready" if st["ready"]
                 else "building" if st["building"] else "stale")
        head = (
            f"oracle {current}: {state} k={st['k']} gen={st['gen']} "
            f"builds={st['builds']} repairs={st['repairs']}"
        )
        idx = st.get("index")
        if idx is not None:
            head += f" age={idx['age_s']}s"
    else:
        st = engine.stats().get("oracle")
        if st is None:
            return "oracle: off (serve with --oracle K)"
        idx = st["index"]
        head = f"oracle: ready k={idx['k']} age={idx['age_s']}s"
    hits = st.get("hits")
    if hits:
        head += "  hits " + " ".join(f"{k}={v}" for k, v in hits.items())
    return head


def _store_command(store, current: str, parts: list[str]) -> tuple[str, str]:
    """Execute one stdin store command. Returns ``(reply_line,
    current_graph)``; replies, malformed-command errors included, land in
    the result stream."""
    cmd = parts[0]
    if cmd == "graphs":
        if len(parts) != 1:
            return "error invalid: usage: graphs", current
        st = store.stats()["graphs"]
        listing = " ".join(
            "{star}{name}(v{v})".format(
                star="*" if name == current else "", name=name,
                v=st[name]["version"],
            )
            for name in sorted(st)
        )
        return f"graphs: {listing}", current
    if cmd == "use":
        if len(parts) != 2:
            return "error invalid: usage: use NAME", current
        name = parts[1]
        try:
            snap = store.current(name)
        except KeyError as e:
            return f"error invalid: {e.args[0]}", current
        return f"use {name}: v{snap.version} digest {snap.digest[:12]}", name
    if cmd == "swap":
        if len(parts) != 1:
            return "error invalid: usage: swap", current
        old = store.current(current)
        new = store.compact(current)  # synchronous fold + hot-swap
        if new.version == old.version:
            return (f"swap {current}: no pending delta (v{old.version})",
                    current)
        return (
            f"swap {current}: v{old.version} -> v{new.version} "
            f"digest {new.digest[:12]}"
        ), current
    # update add|del U V
    if len(parts) != 4 or parts[1] not in ("add", "del"):
        return "error invalid: usage: update add|del U V", current
    try:
        u, v = int(parts[2]), int(parts[3])
    except ValueError:
        return ("error invalid: non-integer node id in "
                f"{' '.join(parts)!r}"), current
    try:
        out = store.update(
            current,
            adds=[(u, v)] if parts[1] == "add" else (),
            dels=[(u, v)] if parts[1] == "del" else (),
        )
    except ValueError as e:
        return f"error invalid: {e}", current
    return (
        "update {g}: +{a}/-{d} pending{c}".format(
            g=current, a=out["adds"], d=out["dels"],
            c=" (compacting)" if out["compacting"] else "",
        )
    ), current


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
    ap.add_argument("graph", nargs="?", default=None,
                    help=".bin graph file (uint32 N,M + edge pairs), or "
                    "serve a directory of graphs with --store")
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="serve every *.bin graph in DIR through one "
                    "versioned GraphStore (each under its file stem): "
                    "per-query graph routing, live edge updates answered "
                    "exactly through the delta overlay, and hot-swap, via "
                    "the stdin commands use/update/swap/graphs")
    ap.add_argument("--use", default=None, metavar="NAME",
                    help="initial current graph under --store (default: "
                    "the store's first graph, alphabetically)")
    ap.add_argument("--compact-threshold", type=int, default=256,
                    metavar="EDGES",
                    help="pending delta edges at which a store graph "
                    "compacts in the background (default 256); 0 disables "
                    "auto-compaction (explicit 'swap' only)")
    ap.add_argument("--oracle", type=int, default=None, metavar="K",
                    help="the landmark distance oracle with K landmark BFS "
                    "trees, built on the engine's device: landmark-endpoint, "
                    "bound-pinned and provably disconnected queries answer "
                    "with no search (route oracle), the rest with a search "
                    "cutoff. Under --store the store keeps one index per "
                    "graph; the stdin command 'oracle' prints its status")
    ap.add_argument("--durable", action="store_true",
                    help="the store's durability layer (needs --store): every "
                    "acked edge update is written ahead to the log before the "
                    "ack, compactions and swaps commit checkpoints (.bin, "
                    "arrays sidecar, manifest rename, WAL segment switch), "
                    "and startup recovers every graph that left a manifest "
                    "or WAL behind")
    ap.add_argument("--fsync", default="batch",
                    choices=["always", "batch", "off"],
                    help="WAL fsync policy under --durable: always = an fsync "
                    "per update (survives OS or power loss), batch = group "
                    "commit (survives process death; the default), off = OS "
                    "flush only")
    ap.add_argument("--residency-budget", type=int, default=None,
                    metavar="BYTES",
                    help="private (not mapped) snapshot bytes past which the "
                    "store demotes the least recently used graphs to the "
                    "compressed cold tier (promoted back on access; default: "
                    "no limit). The stdin command 'memory' prints each "
                    "graph's tier and bytes")
    ap.add_argument("--no-mmap", action="store_true",
                    help="no arrays sidecars: durable recovery rebuilds "
                    "snapshots from the .bin instead of mapping the "
                    "checkpointed arrays")
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
    ap.add_argument("--mesh", default=None, metavar="DEVICES",
                    help='enable route="mesh": serve batches from a pool of '
                    "DEVICES ranks on this host (serve/routes/mesh.py): "
                    "data-parallel flushes (queries sharded, no collective) "
                    "for throughput, the 1D vertex-sharded search with the "
                    "packed frontier exchange for mesh-scale graphs. 'auto' "
                    "takes every card (one rank with --device cpu). "
                    "Below-crossover traffic (calibration.json, the "
                    "platform's mesh block) goes to the single-device rungs; "
                    "the mesh rung has its own breaker and retry policy")
    ap.add_argument("--mesh-shard-min-n", type=int, default=None,
                    metavar="N",
                    help="the mesh rung's vertex-sharded crossover: graphs "
                    "of N vertices or more route sharded (default: the "
                    "calibrated constant, else 2^20)")
    ap.add_argument("--adaptive", action="store_true",
                    help="adaptive routing: learn a per-graph route order "
                    "from measured per-route latencies and sampled level "
                    "telemetry instead of the static ladder. With --store "
                    "--durable the learned policy persists as policy.json "
                    "in the store directory, and a restart serves its first "
                    "flush on the learned route")
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
    if args.mesh is not None and args.mesh != "auto":
        try:
            if int(args.mesh) < 1:
                raise ValueError
        except ValueError:
            ap.error(f"--mesh takes a device count >= 1 or 'auto', got "
                     f"{args.mesh!r}")
    if args.mesh_shard_min_n is not None and args.mesh is None:
        ap.error("--mesh-shard-min-n applies to --mesh only")

    if args.store is not None:
        if args.graph is not None:
            print("Error: pass a .bin graph OR --store DIR, not both",
                  file=sys.stderr)
            return 2
        from bibfs_tpu_torch.store import GraphStore

        try:
            store = GraphStore.from_dir(
                args.store,
                compact_threshold=(args.compact_threshold or None),
                oracle_k=args.oracle,
                device=args.device,
                durable=args.durable,
                fsync=args.fsync,
                mmap_arrays=not args.no_mmap,
                residency_budget=args.residency_budget,
            )
        except (OSError, ValueError, RuntimeError) as e:
            print(f"Error reading store: {e}", file=sys.stderr)
            return 2
        print("[Store] serving {k} graph(s): {names}{d}".format(
            k=len(store.names()), names=", ".join(store.names()),
            d=f" (durable, fsync={args.fsync})" if args.durable else ""),
            file=sys.stderr, flush=True)
        sstats = store.stats()["graphs"]
        for gname in store.names():
            rec = (sstats[gname].get("durable") or {}).get("recovered")
            if rec is not None:
                print(
                    "[Store] recovered {g}: v{v}, {r} WAL record(s) "
                    "replayed{t}".format(
                        g=gname, v=rec["version"], r=rec["replayed_records"],
                        t=(", torn tail truncated"
                           if rec["torn_tail_truncated"] else ""),
                    ),
                    file=sys.stderr, flush=True,
                )
        return _serve(args, None, None, store)
    if args.durable:
        print("Error: --durable needs --store DIR", file=sys.stderr)
        return 2
    if args.graph is None:
        print("Error: a .bin graph (or --store DIR) is required",
              file=sys.stderr)
        return 2
    from bibfs_tpu_torch.graph.io import read_graph_bin

    try:
        n, edges = read_graph_bin(args.graph)
    except (OSError, ValueError) as e:
        print(f"Error reading graph: {e}", file=sys.stderr)
        return 2
    return _serve(args, n, edges, None)


def _build_engine(args, n, edges, store):
    from bibfs_tpu_torch.serve import PipelinedQueryEngine, QueryEngine

    kwargs = dict(
        mode=args.mode,
        layout=args.layout,
        flush_threshold=args.threshold,
        max_batch=args.max_batch,
        cache_entries=args.cache_entries,
        device=args.device,
    )
    if args.mesh is not None:
        from bibfs_tpu_torch.serve.routes import MeshConfig

        kwargs["mesh"] = MeshConfig(
            devices=None if args.mesh == "auto" else int(args.mesh),
            shard_min_n=args.mesh_shard_min_n)
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
    if store is not None:
        kwargs.update(store=store, graph=args.use)
    else:
        kwargs.update(n=n, edges=edges)
        if args.oracle is not None:
            kwargs["oracle_k"] = args.oracle
    if args.pipeline:
        return PipelinedQueryEngine(max_wait_ms=args.max_wait_ms, **kwargs)
    return QueryEngine(**kwargs)


def _serve(args, n, edges, store) -> int:
    try:
        engine = _build_engine(args, n, edges, store)
    except (KeyError, ValueError, RuntimeError) as e:
        print(f"Error: {e}", file=sys.stderr)
        if store is not None:
            store.close()
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
        elif _serve_stdin(args, engine, store):
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
    if store is not None:
        store.close()  # join in-flight compactions and index builds
        sstats = store.stats()
        stats["store"] = sstats
        print(
            "[Store] {k} graph(s), {sw} swap(s), {co} compaction(s), "
            "{de} delta edge(s) pending".format(
                k=len(sstats["graphs"]),
                sw=sum(g["swaps"] for g in sstats["graphs"].values()),
                co=sum(g["compactions"] for g in sstats["graphs"].values()),
                de=sum(g["delta_edges"] for g in sstats["graphs"].values()),
            ),
            file=sys.stderr,
        )
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(stats, f, indent=1, sort_keys=True, default=str)
            f.write("\n")
    return 0


def _serve_stdin(args, engine, store) -> int:
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
    current = None if store is None else (args.use or store.default_graph())

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
            if parts[0] == "oracle":
                if len(parts) != 1:
                    print("error invalid: usage: oracle")
                    continue
                print(_oracle_status(engine, store, current))
                continue
            if parts[0] in ("health", "stats", "memory"):
                if len(parts) != 1:
                    print(f"error invalid: usage: {parts[0]}")
                    continue
                if parts[0] == "memory" and store is None:
                    print("error invalid: 'memory' needs --store")
                    continue
                # resolved results first: the reply doubles as a drain nudge
                drain()
                print(_control_reply(engine, store, parts[0]))
                continue
            if parts[0] in _STORE_COMMANDS:
                if store is None:
                    print(f"error invalid: {parts[0]!r} needs --store")
                    continue
                # resolve everything queued before the command changes the
                # store, so a query answers on the graph it was typed
                # against (only when something is unresolved: a no-op
                # flush would arm the pipelined flusher's drain request)
                if any(t.result is None and t.error is None
                       for t in tickets[emitted:]):
                    engine.flush()
                drain()
                reply, current = _store_command(store, current, parts)
                print(reply)
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
                tickets.append(engine.submit(src, dst, current))
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
