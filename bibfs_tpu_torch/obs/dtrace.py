"""Distributed tracing and per-query cost attribution across processes:
the counterpart of ``bibfs_tpu/obs/dtrace.py``.

The in-process tracer (:mod:`bibfs_tpu_torch.obs.trace`) shows what
overlapped inside one process; a query served through the TCP front door
(:mod:`bibfs_tpu_torch.serve.net`) or a spawned ``bibfs-torch-serve``
crosses processes, and this module follows it across them:

- **Propagated context.** A :class:`TraceContext` is a 128-bit trace id
  plus the current span id. The sampling decision is made once, at
  ingress (:meth:`DTracer.sample`); an unsampled query carries
  ``ctx=None`` on every hop, so the disabled path is one global load, one
  ``is None`` check and no allocation. The context rides net frames as
  the ``trace`` / ``span`` keys (:func:`ctx_fields`) and stdin query
  lines as an ``@t:<trace>:<span>`` token (:func:`ctx_token` /
  :func:`parse_token`), in the JAX package's encoding, so either
  package's client and server join one trace.
- **Per-process spool.** Each sampled span appends one complete JSON line
  to ``<spool>/<proc>.<pid>.jsonl`` and flushes: a killed process's spool
  reads up to its last complete line, which is how the merger reads it.
  Writes after the file closed, a full disk or an injected
  ``trace_flush`` fault drop the span and count it, never raise.
- **Merger.** ``bibfs-torch-trace merge SPOOL_DIR -o out.json`` joins
  every spool into one Perfetto-loadable Chrome-trace JSON with
  ``process_name`` metadata per pid, and validates parentage (every
  non-root parent id must resolve to a span recorded in the same trace).
  Stamps are wall-clock microseconds, so spans of several processes land
  on one timeline.
- **Flight recorder.** Always on and bounded: a per-process ring of the
  last N query timelines, batches, route decisions and fault trips
  (:class:`FlightRecorder`), dumped atomically to a ``*.flightrec.json``
  when a fault site trips (rate-limited) and on demand through the
  ``flightrec`` control op of the stdin loop and the net protocol.

The environment names are the JAX package's (``BIBFS_TRACE_SPOOL``,
``BIBFS_TRACE_SAMPLE``, ``BIBFS_FLIGHTREC``), so an operator's settings
mean the same to either package. Metric families: ``bibfs_trace_spans_
total{proc}`` at :class:`DTracer` construction, ``bibfs_flightrec_dumps_
total{reason}`` at import (the recorder is a process singleton), and
``bibfs_stage_seconds{stage}`` through :func:`stage_histogram`, minted by
the engines and the front door at their construction.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from collections import deque

from bibfs_tpu_torch.obs.metrics import REGISTRY

#: env vars spawned children inherit: set the spool dir and sample rate
#: once in the parent process and every process of the job traces into
#: the same directory
ENV_SPOOL = "BIBFS_TRACE_SPOOL"
ENV_SAMPLE = "BIBFS_TRACE_SAMPLE"
ENV_FLIGHTREC = "BIBFS_FLIGHTREC"

#: the per-query stage timeline (ingress -> queue -> launch -> finish ->
#: resolve, plus the wire stage measured from both sides' clocks)
STAGES = ("ingress", "queue", "launch", "finish", "resolve", "wire")

#: wall-clock epoch of perf_counter()'s zero, measured once at import:
#: spans time themselves on the monotonic clock and STAMP themselves on
#: the wall clock, so cross-process merge aligns without per-span
#: time.time() calls on hot paths
_PERF_EPOCH = time.time() - time.perf_counter()


def wall_us(t_perf: float) -> float:
    """A perf_counter() reading as wall-clock microseconds."""
    return (t_perf + _PERF_EPOCH) * 1e6


class TraceContext:
    """One hop's worth of trace identity: which trace, which span to
    parent under. ``span_id == ""`` marks a root context (the ingress
    sampling decision before any span exists)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str = ""):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id!r}, {self.span_id!r})"


# ---- wire encoding ---------------------------------------------------
def ctx_fields(ctx: TraceContext | None) -> dict:
    """The two JSON fields a net frame carries."""
    if ctx is None:
        return {}
    return {"trace": ctx.trace_id, "span": ctx.span_id}


def ctx_from_fields(msg: dict) -> TraceContext | None:
    """Adopt a frame's context, or None when it carries
    none (or carries garbage — a malformed trace id from a foreign
    client must not kill the query it rode in on)."""
    trace = msg.get("trace")
    if not isinstance(trace, str) or not trace:
        return None
    span = msg.get("span")
    return TraceContext(trace, span if isinstance(span, str) else "")


TOKEN_PREFIX = "@t:"


def ctx_token(ctx: TraceContext) -> str:
    """The REPL line-protocol form: ``@t:<trace>:<span>`` appended to a
    ``src dst`` query line."""
    return f"{TOKEN_PREFIX}{ctx.trace_id}:{ctx.span_id}"


def parse_token(tok: str) -> TraceContext | None:
    """Inverse of :func:`ctx_token`; None on anything malformed."""
    if not tok.startswith(TOKEN_PREFIX):
        return None
    trace, _, span = tok[len(TOKEN_PREFIX):].partition(":")
    if not trace:
        return None
    return TraceContext(trace, span)


# ---- spans -----------------------------------------------------------
class _NullDSpan:
    """The disabled path: one shared, reentrant no-op (the in-process tracer's contract).
    ``ctx`` is None so propagation sites can read ``sp.ctx``
    unconditionally."""

    __slots__ = ()
    ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def finish(self, **args):
        pass


_NULL_DSPAN = _NullDSpan()


class DSpan:
    """One sampled span: starts at construction (so its id can ride a
    frame BEFORE the work completes), records on ``finish()`` or
    ``with``-exit. ``.ctx`` is the child context downstream hops parent
    under."""

    __slots__ = ("_tracer", "name", "ctx", "parent", "_t0", "_args",
                 "_done")

    def __init__(self, tracer: "DTracer", name: str,
                 parent: TraceContext, args: dict):
        self._tracer = tracer
        self.name = name
        self.parent = parent.span_id
        self.ctx = TraceContext(parent.trace_id, _span_id())
        self._args = args
        self._t0 = time.perf_counter()
        self._done = False

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._args = {**self._args, "error": exc_type.__name__}
        self.finish()
        return False

    def finish(self, **args) -> None:
        """Record the span (idempotent — a reply path and a teardown
        path may both try to close it)."""
        if self._done:
            return
        self._done = True
        if args:
            self._args = {**self._args, **args}
        dur = time.perf_counter() - self._t0
        self._tracer._record(
            self.name, self.ctx, self.parent, self._t0, dur, self._args
        )


def _span_id() -> str:
    return os.urandom(8).hex()


class DTracer:
    """The per-process distributed-trace spool writer (module
    docstring). One instance per process, installed via
    :func:`set_dtracer` (or :func:`install_from_env` in spawned
    children); every sampled span appends one JSON line to
    ``<spool>/<proc>.<pid>.jsonl`` and flushes."""

    def __init__(self, spool_dir: str, proc: str, *,
                 sample: float = 1.0, faults=None):
        os.makedirs(spool_dir, exist_ok=True)
        self.spool_dir = spool_dir
        self.proc = proc
        self.sample_rate = max(0.0, min(1.0, float(sample)))
        self.faults = faults
        self._pid = os.getpid()
        self.path = os.path.join(spool_dir, f"{proc}.{self._pid}.jsonl")
        self._lock = threading.Lock()
        self._f = open(self.path, "a")
        self.dropped = 0
        # minted at construction (render-at-zero before the first span)
        self._spans = REGISTRY.counter(
            "bibfs_trace_spans_total",
            "Distributed-trace spans spooled, per process name",
            ("proc",),
        ).labels(proc=proc)
        # sampling uses os.urandom-derived ids, but the RATE decision
        # wants a cheap PRNG; seedable would couple runs across
        # processes, so module random is fine here
        import random

        self._rng = random.Random()

    # ---- ingress -----------------------------------------------------
    def sample(self) -> TraceContext | None:
        """The once-per-query ingress decision: a fresh root context
        when this query is sampled, else None (which then rides every
        hop as the no-op marker)."""
        if self.sample_rate <= 0.0:
            return None
        if self.sample_rate < 1.0 and self._rng.random() >= self.sample_rate:
            return None
        return TraceContext(os.urandom(16).hex(), "")

    # ---- recording ---------------------------------------------------
    def span(self, name: str, ctx: TraceContext, **args) -> DSpan:
        """A live span under ``ctx`` (context manager, or explicit
        ``finish()``); its ``.ctx`` is what downstream hops carry."""
        return DSpan(self, name, ctx, args)

    def emit(self, name: str, ctx: TraceContext, t0_perf: float,
             dur_s: float, **args) -> None:
        """A retrospective span under ``ctx`` from already-measured
        perf_counter() endpoints — how ticket stage timelines become
        spans at resolve time without wrapping the hot path in context
        managers."""
        self._record(name, TraceContext(ctx.trace_id, _span_id()),
                     ctx.span_id, t0_perf, dur_s, args)

    def _record(self, name, ctx, parent, t0_perf, dur_s, args) -> None:
        rec = {
            "t": ctx.trace_id, "s": ctx.span_id, "n": name,
            "ts": round(wall_us(t0_perf), 3),
            "d": round(dur_s * 1e6, 3),
            "pid": self._pid, "tid": threading.get_ident(),
            "pr": self.proc,
        }
        if parent:
            rec["p"] = parent
        if args:
            rec["a"] = args
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        try:
            if self.faults is not None:
                self.faults.fire("trace_flush")
            with self._lock:
                self._f.write(line)
                self._f.flush()
        except (ValueError, OSError, RuntimeError):
            # closed spool on interpreter teardown, full disk, or an
            # injected trace_flush fault: tracing must never take the
            # serving path down — drop the span and keep serving
            self.dropped += 1
            return
        self._spans.inc()

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass


# ---- the process-global hookpoint ------------------------------------
_GLOBAL: DTracer | None = None


def set_dtracer(tracer: DTracer | None) -> DTracer | None:
    """Install (or clear) the process-global distributed tracer;
    returns the previous one."""
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = tracer
    return prev


def get_dtracer() -> DTracer | None:
    return _GLOBAL


def dspan(name: str, ctx: TraceContext | None, **args):
    """A span under ``ctx`` on the global tracer — or the shared no-op
    when tracing is off OR this query is unsampled (``ctx is None``):
    one global load + two ``is None`` checks, no allocation."""
    t = _GLOBAL
    if t is None or ctx is None:
        return _NULL_DSPAN
    return t.span(name, ctx, **args)


def emit_span(name: str, ctx: TraceContext | None, t0_perf: float,
              dur_s: float, **args) -> None:
    """Retrospective-span form of :func:`dspan` (same gating)."""
    t = _GLOBAL
    if t is not None and ctx is not None:
        t.emit(name, ctx, t0_perf, dur_s, **args)


def sample_ctx() -> TraceContext | None:
    """The module-level ingress decision: None when tracing is off."""
    t = _GLOBAL
    if t is None:
        return None
    return t.sample()


def install_from_env(proc: str, environ=None) -> DTracer | None:
    """Install a :class:`DTracer` (and arm the flight recorder's dump
    path) from ``BIBFS_TRACE_SPOOL`` / ``BIBFS_TRACE_SAMPLE`` — how
    spawned children join the parent's trace job
    without new argv. No spool var set: returns None, changes
    nothing."""
    environ = os.environ if environ is None else environ
    spool = environ.get(ENV_SPOOL, "").strip()
    if not spool:
        return None
    try:
        sample = float(environ.get(ENV_SAMPLE, "1") or "1")
    except ValueError:
        sample = 1.0
    tracer = DTracer(spool, proc, sample=sample)
    set_dtracer(tracer)
    FLIGHT.configure(dump_path=os.path.join(
        spool, f"{proc}.{os.getpid()}.flightrec.json"
    ))
    return tracer


def stage_histogram():
    """The per-query cost-attribution histogram, pre-labeled so serving
    never allocates a label cell per query. Engines and the net front
    door mint it at construction (render-at-zero)."""
    fam = REGISTRY.histogram(
        "bibfs_stage_seconds",
        "Per-query time in each serving stage "
        "(ingress/queue/launch/finish/resolve/wire)",
        ("stage",),
    )
    return {stage: fam.labels(stage=stage) for stage in STAGES}


# ---- flight recorder -------------------------------------------------
class FlightRecorder:
    """Always-on bounded post-mortem buffer: the last ``capacity``
    query timelines, route decisions and fault trips this process saw.
    ``dump()`` writes the ring atomically
    (:func:`~bibfs_tpu_torch.graph.io._atomic_replace`); ``on_fault`` dumps
    rate-limited when a dump path is configured (the fault
    seams of serve/faults), and the ``flightrec`` control op dumps on
    demand."""

    def __init__(self, capacity: int = 128):
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._dump_path: str | None = None
        self._last_fault_dump = 0.0
        self.fault_dump_interval_s = 5.0
        self._dumps = REGISTRY.counter(
            "bibfs_flightrec_dumps_total",
            "Flight-recorder ring dumps, by trigger",
            ("reason",),
        )

    def configure(self, *, dump_path: str | None = None,
                  capacity: int | None = None) -> None:
        with self._lock:
            if dump_path is not None:
                self._dump_path = dump_path
            if capacity is not None and int(capacity) != self.capacity:
                self.capacity = int(capacity)
                self._ring = deque(self._ring, maxlen=self.capacity)

    def note(self, kind: str, **fields) -> None:
        """Append one entry (``kind`` in query/route/fault); O(1),
        bounded, never raises into the serving path."""
        fields["kind"] = kind
        fields["at"] = round(time.time(), 6)
        with self._lock:
            self._ring.append(fields)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "pid": os.getpid(),
                "capacity": self.capacity,
                "entries": list(self._ring),
                "dump_path": self._dump_path,
            }

    def dump(self, path: str | None = None, *,
             reason: str = "demand") -> str | None:
        """Atomically write the ring to ``path`` (default: the
        configured dump path). Returns the path written, or None when
        no path is known or the write failed — a post-mortem helper
        must never add a second failure to the one being recorded."""
        from bibfs_tpu_torch.graph.io import _atomic_replace

        path = path or self._dump_path
        if path is None:
            return None
        snap = self.snapshot()
        snap["reason"] = reason
        try:
            _atomic_replace(
                path,
                lambda f: json.dump(snap, f, sort_keys=True, default=str),
                mode="w",
            )
        except OSError:
            return None
        self._dumps.labels(reason=reason).inc()
        return path

    def on_fault(self, site: str) -> None:
        """The fault-site hook (``serve/faults`` calls this as a rule
        fires): record the trip, and dump the ring if a path is armed —
        rate-limited so a fault storm costs one file write per
        interval, not one per injection."""
        self.note("fault", site=site)
        with self._lock:
            path = self._dump_path
            now = time.monotonic()
            if path is None \
                    or now - self._last_fault_dump < self.fault_dump_interval_s:
                return
            self._last_fault_dump = now
        self.dump(path, reason="fault")


#: the per-process recorder every engine/front door notes into
FLIGHT = FlightRecorder()


def flight_on_fault(site: str) -> None:
    """Module-level indirection for ``serve/faults`` (lazy import
    there keeps the faults module free of obs dependencies at parse
    time)."""
    FLIGHT.on_fault(site)


# ---- merger ----------------------------------------------------------
def read_spool(path: str) -> tuple[list, int]:
    """Parse one spool file: complete JSON lines become records; a torn
    tail (the SIGKILL case) or a corrupt line is counted, not raised.
    Returns ``(records, bad_lines)``."""
    records, bad = [], 0
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            for line in f:
                if not line.endswith("\n"):
                    bad += 1  # torn tail: the process died mid-write
                    continue
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    bad += 1
                    continue
                if isinstance(rec, dict) and "t" in rec and "s" in rec:
                    records.append(rec)
                else:
                    bad += 1
    except OSError:
        return [], 0
    return records, bad


def merge_spools(spool_dir: str, out_path: str | None = None) -> dict:
    """Assemble every ``*.jsonl`` spool under ``spool_dir`` into one
    Chrome-trace event array with per-pid ``process_name`` metadata,
    and validate parentage per trace. Returns the report dict
    (``events``, per-trace summaries, orphan list); with ``out_path``
    the event array is also written atomically as Perfetto-loadable
    JSON."""
    records: list[dict] = []
    files = 0
    truncated = 0
    for name in sorted(os.listdir(spool_dir)):
        if not name.endswith(".jsonl"):
            continue
        recs, bad = read_spool(os.path.join(spool_dir, name))
        files += 1
        truncated += bad
        records.extend(recs)

    # parentage: every non-root parent id resolves to a span recorded
    # in the SAME trace (the cross-process causality check)
    by_trace: dict[str, list[dict]] = {}
    for rec in records:
        by_trace.setdefault(rec["t"], []).append(rec)
    traces = []
    orphans = []
    for tid, recs in sorted(by_trace.items()):
        ids = {r["s"] for r in recs}
        torn = [r for r in recs if r.get("p") and r["p"] not in ids]
        orphans.extend(torn)
        traces.append({
            "trace": tid,
            "spans": len(recs),
            "pids": sorted({r["pid"] for r in recs}),
            "procs": sorted({r["pr"] for r in recs}),
            "orphan_parents": len(torn),
        })

    # Chrome-trace events: normalize ts to the earliest span so the
    # Perfetto timeline starts at ~0 instead of the wall-clock epoch
    t0 = min((r["ts"] for r in records), default=0.0)
    events: list[dict] = []
    seen_pids: dict[int, str] = {}
    for rec in records:
        if rec["pid"] not in seen_pids:
            seen_pids[rec["pid"]] = rec["pr"]
            events.append({
                "name": "process_name", "ph": "M", "pid": rec["pid"],
                "tid": 0, "args": {"name": rec["pr"]},
            })
    for rec in sorted(records, key=lambda r: r["ts"]):
        args = dict(rec.get("a") or {})
        args["trace"] = rec["t"]
        args["span"] = rec["s"]
        if rec.get("p"):
            args["parent"] = rec["p"]
        events.append({
            "name": rec["n"], "cat": "dtrace", "ph": "X",
            "ts": round(rec["ts"] - t0, 3), "dur": rec["d"],
            "pid": rec["pid"], "tid": rec["tid"], "args": args,
        })

    report = {
        "files": files,
        "spans": len(records),
        "truncated_lines": truncated,
        "traces": traces,
        "orphan_parents": len(orphans),
        "events": events,
    }
    if out_path is not None:
        from bibfs_tpu_torch.graph.io import _atomic_replace

        def _payload(f):
            f.write("[\n")
            for i, ev in enumerate(events):
                comma = "," if i < len(events) - 1 else ""
                f.write(json.dumps(ev, separators=(",", ":")) + comma
                        + "\n")
            f.write("]\n")

        _atomic_replace(out_path, _payload, mode="w")
    return report


def cross_process_traces(report: dict, min_procs: int = 2) -> list:
    """The smoke-gate predicate: traces whose spans cover at least
    ``min_procs`` distinct OS processes with zero orphan parents."""
    return [
        t for t in report["traces"]
        if len(t["pids"]) >= min_procs and t["orphan_parents"] == 0
    ]


def main(argv=None) -> int:
    """``bibfs-torch-trace`` — merge per-process spool files into one
    Perfetto-loadable trace."""
    ap = argparse.ArgumentParser(
        description="Merge distributed-trace spools "
        "(<proc>.<pid>.jsonl) into one Chrome-trace JSON"
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    mp = sub.add_parser(
        "merge", help="merge every *.jsonl spool in SPOOL_DIR"
    )
    mp.add_argument("spool_dir", help="directory of per-process spools")
    mp.add_argument("-o", "--out", default=None, metavar="FILE",
                    help="write the merged Chrome-trace JSON here "
                    "(default: SPOOL_DIR/merged_trace.json)")
    mp.add_argument("--min-procs", type=int, default=1, metavar="N",
                    help="exit 1 unless >= 1 trace spans N processes "
                    "with fully-resolved parentage (default 1)")
    args = ap.parse_args(argv)

    if not os.path.isdir(args.spool_dir):
        print(f"Error: {args.spool_dir} is not a directory",
              file=sys.stderr)
        return 2
    out = args.out or os.path.join(args.spool_dir, "merged_trace.json")
    report = merge_spools(args.spool_dir, out_path=out)
    good = cross_process_traces(report, min_procs=args.min_procs)
    print(
        "[Trace] merged {f} spool(s): {s} spans, {t} trace(s), "
        "{o} orphan parent(s), {tr} truncated line(s) -> {out}".format(
            f=report["files"], s=report["spans"],
            t=len(report["traces"]), o=report["orphan_parents"],
            tr=report["truncated_lines"], out=out,
        ),
        file=sys.stderr,
    )
    for t in report["traces"][:10]:
        print(
            "[Trace]   {id}: {n} span(s) across pids {p} ({pr})".format(
                id=t["trace"][:16], n=t["spans"],
                p=",".join(str(x) for x in t["pids"]),
                pr=",".join(t["procs"]),
            ),
            file=sys.stderr,
        )
    if not good:
        print(
            f"Error: no trace spans >= {args.min_procs} process(es) "
            "with resolved parentage", file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
