"""``bibfs-torch-fleet`` — serve queries through a health-aware router
over N engine replicas: the counterpart of ``bibfs-fleet``
(``bibfs_tpu/fleet/cli.py``).

The horizontal counterpart of ``bibfs-torch-serve``: one front-end
process owns ``--replicas N`` serving replicas (in-process engines by
default, each over its OWN versioned graph store; ``--subprocess``
spawns real ``bibfs-torch-serve`` children instead) and routes each
``src dst`` query by
consistent hash on graph name, spilling hot graphs to the least-loaded
replica, demoting degraded replicas and ejecting dead ones as the
health poller sees them, and re-routing failures so a dead replica
costs retries, not lost queries (:mod:`bibfs_tpu_torch.fleet`). Every
replica serves on ``--device`` (default ``cuda``; ``cpu`` runs the host
route and the plain torch versions), the in-process engines and the
``--subprocess`` children alike; a child that cannot reach the device
fails its spawn and the CLI exits 2.

Stdin grows fleet commands alongside ``src dst`` queries:

- ``use NAME`` switches the stream's current graph;
- ``update add U V`` / ``update del U V`` STAGES an edge update (fleet
  updates land with the swap, not before);
- ``roll`` performs the rolling swap: the staged batch is applied and
  compacted replica-at-a-time (drain -> roll -> ready-probe ->
  re-admit), so the fleet serves mixed versions mid-roll and every
  answer is exact for the version its replica declares;
- ``kill NAME`` / ``restart NAME`` are the chaos drills;
- ``replicas`` prints the routing table (state, declared version,
  routed count, load);
- ``health`` prints the router's table summary as one JSON line.

SIGTERM drains gracefully — parity with ``bibfs-torch-serve``'s one-shot
handler: the fleet stops reading stdin, every replica is demoted into
its drain state (new submits refused with structured capacity errors
while queued tickets still resolve), everything queued prints, and the
process exits 0. A second SIGTERM during the drain is ignored — the
restart manager's re-send must not abort the drain it asked for.

Results print in the ``bibfs-torch-serve`` line format as their tickets
resolve (failover included). ``--metrics-port`` serves the process
registry — fleet families ``bibfs_fleet_replicas{state}``,
``bibfs_fleet_routed_total{replica}``, ``bibfs_fleet_reroutes_total``,
``bibfs_fleet_rolls_total``, ``bibfs_fleet_spills_total``,
``bibfs_fleet_catchups_total`` — over HTTP, plus ``/healthz`` backed
by the router's table (degraded with per-replica reasons — dead,
draining, catchup-stuck — stays 200 while anything still routes;
unready is 503).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


class _SigTerm(Exception):
    """Raised by the SIGTERM handler out of the blocking stdin read —
    the graceful-drain path (module docstring), same one-shot contract
    as ``bibfs-torch-serve``'s handler."""


def _print_result(t, no_path: bool) -> None:
    res = t.result
    if res.found:
        line = f"{t.src} -> {t.dst}: length = {res.hops}"
        if res.path and not no_path:
            line += "  path: " + " -> ".join(str(v) for v in res.path)
    else:
        line = f"{t.src} -> {t.dst}: no path"
    print(line)


def _relabel_metrics(text: str, replica: str) -> str:
    """Inject ``replica="name"`` as the first label of every sample
    line in a child replica's Prometheus text (comment lines dropped —
    the local registry already declared the families)."""
    out = []
    tag = f'replica="{replica}"'
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        name, sep, rest = ln.partition("{")
        if sep:
            out.append(f"{name}{{{tag},{rest}")
        else:
            fam, _, val = ln.partition(" ")
            out.append(f"{fam}{{{tag}}} {val}")
    return "\n".join(out) + ("\n" if out else "")


class _FleetScrape:
    """The aggregated fleet scrape behind ``--metrics-port``: the
    router process's own registry plus every out-of-process replica's
    registry (fetched over its control surface at scrape time), each
    sample re-labelled with its replica name. Duck-types the registry
    interface the metrics server renders (``render()``)."""

    def __init__(self):
        self.router = None  # set once the Router is built

    def render(self) -> str:
        from bibfs_tpu_torch.obs.metrics import REGISTRY

        parts = [REGISTRY.render()]
        if self.router is not None:
            try:
                snap = self.router.metrics_snapshot()
            except Exception:
                snap = {}
            for name in sorted(snap):
                if snap[name]:
                    parts.append(_relabel_metrics(snap[name], name))
        return "".join(parts)


def _replicas_listing(router) -> str:
    st = router.stats()
    rows = []
    for name in sorted(st["replicas"]):
        r = st["replicas"][name]
        rows.append(
            "{n}({k}) state={s} routed={q} load={ld}".format(
                n=name, k=r["kind"], s=r["state"], q=r["routed"],
                ld=r["load"],
            )
        )
    return "replicas: " + "  ".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve (src, dst) queries through a health-aware "
        "router over N engine replicas"
    )
    ap.add_argument("graph", nargs="?", default=None,
                    help=".bin graph file (or --store DIR)")
    ap.add_argument(
        "--store", default=None, metavar="DIR",
        help="serve every *.bin graph in DIR (file stems name the "
        "graphs); each replica gets its own store over the same "
        "graphs, which is what makes per-replica versions (and rolling "
        "swaps) meaningful",
    )
    ap.add_argument("--replicas", type=int, default=3,
                    help="fleet size (default 3)")
    ap.add_argument(
        "--subprocess", action="store_true",
        help="spawn real bibfs-torch-serve subprocesses as replicas "
        "instead "
        "of in-process engines (process-level isolation; kill/restart "
        "are real process kills)",
    )
    ap.add_argument(
        "--pipeline", action="store_true",
        help="in-process replicas use the pipelined async engine "
        "(default: the synchronous engine; subprocess replicas always "
        "pipeline)",
    )
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="pipelined replicas' latency SLO (default 5)")
    ap.add_argument("--cache-entries", type=int, default=64,
                    help="per-replica distance-cache forests "
                    "(default 64)")
    ap.add_argument("--max-batch", type=int, default=256,
                    help="per-replica flush bound (default 256)")
    ap.add_argument(
        "--spill-after", type=int, default=1024,
        help="hash-owner queue depth at which a query spills to the "
        "least-loaded replica (default 1024 = 4x the default "
        "--max-batch: spill on real backlog, not on a queue that "
        "merely filled its next micro-batch; 0 disables)",
    )
    ap.add_argument("--use", default=None, metavar="NAME",
                    help="initial current graph under --store")
    ap.add_argument("--no-path", action="store_true",
                    help="skip path printing")
    ap.add_argument(
        "--metrics-port", type=int, default=None, metavar="PORT",
        help="serve /metrics (fleet families included) and /healthz "
        "over HTTP; PORT 0 binds an ephemeral port",
    )
    ap.add_argument(
        "--trace-spool", default=None, metavar="DIR",
        help="distributed tracing: spool this process's spans to "
        "DIR/fleet.<pid>.jsonl; ProcessReplica children inherit the "
        "env knob and spool alongside (merge with 'bibfs-torch-trace merge "
        "DIR'). Equivalent to BIBFS_TRACE_SPOOL",
    )
    ap.add_argument(
        "--trace-sample", type=float, default=None, metavar="RATE",
        help="fraction of router-ingress queries to sample into the "
        "distributed trace spool (default 1.0 when --trace-spool is "
        "set). Equivalent to BIBFS_TRACE_SAMPLE",
    )
    ap.add_argument("--stats-json", default=None, metavar="FILE",
                    help="write the router stats to FILE as JSON on "
                    "exit")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of every replica's engine, in process "
                    "and in --subprocess children (default cuda; no "
                    "silent CPU fallback)")
    args = ap.parse_args(argv)

    # the trace flags set the env knobs install_from_env (and every
    # spawned replica, which inherits os.environ) reads — one config
    # surface whether tracing came from the CLI or the environment
    from bibfs_tpu_torch.obs import dtrace

    if args.trace_spool is not None:
        os.environ[dtrace.ENV_SPOOL] = args.trace_spool
    if args.trace_sample is not None:
        os.environ[dtrace.ENV_SAMPLE] = str(args.trace_sample)

    if (args.graph is None) == (args.store is None):
        print("Error: pass a .bin graph OR --store DIR", file=sys.stderr)
        return 2
    if args.replicas < 1:
        print("Error: --replicas must be >= 1", file=sys.stderr)
        return 2

    from bibfs_tpu_torch.fleet import ProcessReplica, Router, engine_replica
    from bibfs_tpu_torch.serve.resilience import QueryError

    replicas = []
    try:
        if args.subprocess:
            for i in range(args.replicas):
                replicas.append(ProcessReplica(
                    f"r{i}",
                    graph=args.graph,
                    store_dir=args.store,
                    max_wait_ms=args.max_wait_ms,
                    device=args.device,
                ))
        else:
            if args.store is not None:
                from bibfs_tpu_torch.graph.io import read_graph_bin
                from bibfs_tpu_torch.store import GraphStore

                names = sorted(
                    f for f in os.listdir(args.store)
                    if f.endswith(".bin")
                )
                if not names:
                    print(f"Error: no *.bin graphs in {args.store!r}",
                          file=sys.stderr)
                    return 2
                loaded = {
                    os.path.splitext(f)[0]: read_graph_bin(
                        os.path.join(args.store, f)
                    )
                    for f in names
                }

                def make_store():
                    st = GraphStore()
                    for g, (n, edges) in loaded.items():
                        st.add(g, n, edges)
                    return st
            else:
                from bibfs_tpu_torch.graph.io import read_graph_bin
                from bibfs_tpu_torch.store import GraphStore

                n, edges = read_graph_bin(args.graph)

                stem = os.path.splitext(
                    os.path.basename(args.graph)
                )[0]

                def make_store():
                    st = GraphStore()
                    st.add(stem, n, edges)
                    return st

            for i in range(args.replicas):
                replicas.append(engine_replica(
                    f"r{i}", make_store(),
                    pipelined=args.pipeline,
                    cache_entries=args.cache_entries,
                    max_batch=args.max_batch,
                    device=args.device,
                    **({"max_wait_ms": args.max_wait_ms}
                       if args.pipeline else {}),
                ))
    except (OSError, ValueError, RuntimeError) as e:
        # ReplicaDead is a RuntimeError: a child that could not reach its
        # device; an in-process engine without one raises RuntimeError
        print(f"Error building replicas: {e}", file=sys.stderr)
        for r in replicas:
            try:
                r.close()
            except Exception:
                pass
        return 2

    # per-process distributed-trace spool (BIBFS_TRACE_SPOOL): the
    # router is a trace ingress — sampled queries carry their context
    # onto whichever replica wire protocol serves them
    from bibfs_tpu_torch.obs import dtrace

    dtracer = dtrace.install_from_env("fleet")

    metrics_server = None
    scrape = _FleetScrape()
    if args.metrics_port is not None:
        from bibfs_tpu_torch.obs.http import start_metrics_server

        try:
            metrics_server = start_metrics_server(
                args.metrics_port, registry=scrape
            )
        except OSError as e:
            print(f"Error: cannot bind metrics port: {e}",
                  file=sys.stderr)
            for r in replicas:
                r.close()
            return 2
        print(f"[Obs] serving /metrics on {metrics_server.url} "
              "(fleet-aggregated: replica-labelled child registries)",
              file=sys.stderr, flush=True)

    router = Router(replicas, spill_after=args.spill_after)
    scrape.router = router
    if metrics_server is not None:
        # /healthz speaks the router's table: ready, degraded (with
        # per-replica reasons — dead, draining, catchup-stuck) still
        # 200, unready 503 when nothing routes
        metrics_server.set_health(router.health_snapshot)
    print(
        "[Fleet] {k} replica(s): {names}".format(
            k=len(replicas),
            names=", ".join(router.replica_names),
        ),
        file=sys.stderr, flush=True,
    )

    from collections import deque

    current = args.use
    staged_adds: list = []
    staged_dels: list = []
    tickets: deque = deque()  # unprinted only: a long-lived front-end
    # must hold O(outstanding) tickets, not one per query ever served
    failed = 0

    def drain():
        nonlocal failed
        while tickets:
            t = tickets[0]
            if not t.poll():
                break
            tickets.popleft()
            if t.error is not None:
                kind = getattr(t.error, "kind", "internal")
                print(f"error {kind}: {t.src} -> {t.dst}: {t.error}")
                failed += 1
            else:
                _print_result(t, args.no_path)

    # graceful drain on SIGTERM (rolling restarts): the handler raises
    # out of the blocking stdin read; the except arm demotes every
    # replica into its drain state, the shared post-loop path below
    # flushes, resolves and prints everything queued, and the process
    # exits 0 — parity with bibfs-torch-serve's one-shot handler
    import signal

    def _on_sigterm(signum, frame):
        # one-shot: disarm BEFORE raising, so a second SIGTERM landing
        # anywhere in the drain path cannot re-raise outside the try
        # and abort the drain
        try:
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
        except ValueError:
            pass
        raise _SigTerm()

    prev_handler = None
    sigterm = False
    rc = 0
    try:
        try:
            # installed INSIDE the try: a signal landing at any point
            # after this line is caught by the except arm below
            try:
                prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
            except ValueError:
                pass  # not the main thread (in-process embedding)
            for line in sys.stdin:
                parts = line.split()
                if not parts:
                    continue
                cmd = parts[0]
                if cmd == "replicas":
                    print(_replicas_listing(router))
                    continue
                if cmd == "health":
                    print("health " + json.dumps(
                        router.table(), sort_keys=True
                    ))
                    continue
                if cmd == "use":
                    if len(parts) != 2:
                        print("error invalid: usage: use NAME")
                        continue
                    current = parts[1]
                    print(f"use {current}")
                    continue
                if cmd == "update":
                    if len(parts) != 4 or parts[1] not in ("add", "del"):
                        print("error invalid: usage: update add|del U V")
                        continue
                    try:
                        u, v = int(parts[2]), int(parts[3])
                    except ValueError:
                        print("error invalid: non-integer node id")
                        continue
                    (staged_adds if parts[1] == "add"
                     else staged_dels).append((u, v))
                    print(
                        "update staged: +{a}/-{d} (roll applies them)".format(
                            a=len(staged_adds), d=len(staged_dels)
                        )
                    )
                    continue
                if cmd == "roll":
                    if len(parts) != 1:
                        print("error invalid: usage: roll")
                        continue
                    router.flush(timeout=120.0)
                    drain()
                    try:
                        out = router.rolling_swap(
                            current, adds=staged_adds, dels=staged_dels
                        )
                    except ValueError as e:
                        print(f"error invalid: {e}")
                        continue
                    staged_adds, staged_dels = [], []
                    print("roll {g}: ok={ok} {rows}".format(
                        g=out["graph"] or "(default)", ok=out["ok"],
                        rows=" ".join(
                            "{r}:v{a}->v{b}".format(
                                r=row["replica"],
                                a=(row.get("version") or ["?", "?"])[0],
                                b=(row.get("version") or ["?", "?"])[1],
                            )
                            for row in out["replicas"]
                        ),
                    ))
                    continue
                if cmd in ("kill", "restart"):
                    if len(parts) != 2:
                        print(f"error invalid: usage: {cmd} REPLICA")
                        continue
                    name = parts[1]
                    if name not in router.replica_names:
                        print(f"error invalid: unknown replica {name!r} "
                              f"(have: {router.replica_names})")
                        continue
                    try:
                        getattr(router.replica(name), cmd)()
                    except Exception as e:
                        print(f"error internal: {cmd} {name}: {e}")
                        continue
                    print(f"{cmd} {name}: ok")
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
                    tickets.append(router.submit(src, dst, current))
                except QueryError as e:
                    print(f"error {e.kind}: {src} -> {dst}: {e}")
                    continue
                except (ValueError, TypeError) as e:
                    print(f"error invalid: {src} -> {dst}: {e}")
                    continue
                drain()
        except _SigTerm:
            sigterm = True
            # demote every replica into its drain state: new submits
            # answer structured capacity refusals while the shared
            # drain tail below resolves and prints everything queued
            for name in router.replica_names:
                try:
                    router.replica(name).begin_drain()
                except Exception:
                    pass
            print("[Fleet] SIGTERM: draining (resolving queued "
                  "tickets)", file=sys.stderr, flush=True)
        # the drain tail runs with SIGTERM IGNORED on the EOF path too:
        # a restart manager's signal landing during the final flush
        # (which can take minutes of ticket waits) must not kill the
        # process mid-drain after a clean stdin close — exactly the
        # window the graceful-drain contract exists for. The previous
        # disposition is restored in the outer finally, once everything
        # queued has printed.
        try:
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
        except ValueError:
            pass
        router.flush(timeout=120.0)
        # final failover pass: wait() drives any pending re-routes
        for t in list(tickets):
            try:
                t.wait(timeout=60.0)
            except Exception:
                pass
        drain()
        if failed:
            rc = 1
    finally:
        st = router.stats()
        print(
            "[Fleet] {q} routed ({rr} rerouted, {sp} spilled), "
            "{ro} roll(s); table {tb}".format(
                q=sum(
                    r["routed"] for r in st["replicas"].values()
                ),
                rr=st["reroutes"], sp=st["spills"], ro=st["rolls"],
                tb=router.table(),
            ),
            file=sys.stderr,
        )
        if args.stats_json:
            try:
                with open(args.stats_json, "w") as f:
                    json.dump(st, f, indent=1, sort_keys=True,
                              default=str)
                    f.write("\n")
            except OSError as e:
                print(f"could not write {args.stats_json}: {e}",
                      file=sys.stderr)
        router.close()
        if metrics_server is not None:
            metrics_server.close()
        if dtracer is not None:
            dtrace.set_dtracer(None)
            dtracer.close()
        # restore only on the EOF path (in-process embedders get their
        # handler back once the drain is done); a SIGNAL-initiated
        # drain keeps ignoring repeats until the process exits — a
        # restart manager's re-send landing after the drain but before
        # exit must not flip a completed run to 143
        if prev_handler is not None and not sigterm:
            try:
                signal.signal(signal.SIGTERM, prev_handler)
            except ValueError:
                pass
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
