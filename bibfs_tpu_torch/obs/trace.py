"""Tracing spans exported as Chrome-trace / Perfetto JSON: the
counterpart of ``bibfs_tpu/obs/trace.py``.

Context-manager spans recorded per thread and written in the Chrome
Trace Event format, which Perfetto (https://ui.perfetto.dev) and
``chrome://tracing`` open directly. The serving engine wraps its
flushes, device launches and finishes, host batches and cache
operations in spans.

Zero-cost when off: the module-level :func:`span` checks one global and
returns a shared no-op context manager — no dict, no timestamps, no
allocation — until a :class:`Tracer` is installed with
:func:`set_tracer`.

File format: the *JSON Array Format* of the Trace Event spec, written
one event per line (line-parseable like JSONL, and still a valid JSON
document — the spec also permits a missing ``]``, so even a truncated
file from a crashed process loads). Each event is a complete
``"ph": "X"`` (duration) record with microsecond ``ts``/``dur``;
thread-name metadata events label the lanes.
"""

from __future__ import annotations

import json
import os
import threading
import time


class _NullSpan:
    """The disabled path: one shared, reentrant, no-op context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer, name, cat, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        if exc_type is not None:
            self.args = {**self.args, "error": exc_type.__name__}
        self._tracer._complete(
            self.name, self.cat, self._t0, t1 - self._t0, self.args
        )
        return False


class Tracer:
    """Collects trace events in memory; ``save()`` writes the file.

    Bounded: past ``max_events`` new events are counted as dropped
    instead of growing without limit (a serving process can run for
    days with tracing accidentally left on). Thread-safe throughout —
    the flusher, finish worker, and any number of submitters record
    into one tracer.
    """

    def __init__(self, max_events: int = 500_000):
        self.max_events = int(max_events)
        self.dropped = 0
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._named_tids: set[int] = set()
        self._t0 = time.perf_counter()
        self._pid = os.getpid()

    # ---- recording ---------------------------------------------------
    def span(self, name: str, cat: str = "bibfs", **args) -> _Span:
        """A context manager recording one complete ("X") event over
        its ``with`` body."""
        return _Span(self, name, cat, args)

    def _ts(self, t: float) -> float:
        return round((t - self._t0) * 1e6, 3)  # µs, Chrome-trace unit

    def _tid(self) -> int:
        tid = threading.get_ident()
        if tid not in self._named_tids:
            # first event from this thread: label its lane (Perfetto
            # shows the name instead of a bare ident)
            with self._lock:
                if tid not in self._named_tids:
                    self._named_tids.add(tid)
                    self._events.append({
                        "name": "thread_name", "ph": "M",
                        "pid": self._pid, "tid": tid,
                        "args": {
                            "name": threading.current_thread().name
                        },
                    })
        return tid

    def _complete(self, name, cat, t0, dur, args) -> None:
        self._append({
            "name": name, "cat": cat, "ph": "X",
            "ts": self._ts(t0), "dur": round(dur * 1e6, 3),
            "pid": self._pid, "tid": self._tid(), "args": args,
        })

    def _append(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    # ---- reading / export --------------------------------------------
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def save(self, path: str) -> int:
        """Write the Chrome-trace JSON array, one event per line,
        committed atomically (same-dir tmp + fsync + rename — a crash
        mid-save leaves the previous trace, never a torn one). Returns
        the number of events written."""
        from bibfs_tpu_torch.graph.io import _atomic_replace

        evs = self.events()

        def _payload(f):
            f.write("[\n")
            for i, ev in enumerate(evs):
                comma = "," if i < len(evs) - 1 else ""
                f.write(json.dumps(ev, separators=(",", ":")) + comma + "\n")
            f.write("]\n")

        _atomic_replace(path, _payload, mode="w")
        return len(evs)


# ---- the process-global tracer hookpoint ----------------------------
_GLOBAL: Tracer | None = None


def set_tracer(tracer: Tracer | None) -> Tracer | None:
    """Install (or clear, with None) the process-global tracer that
    :func:`span` records into; returns the previous one."""
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = tracer
    return prev


def get_tracer() -> Tracer | None:
    return _GLOBAL


def span(name: str, cat: str = "bibfs", **args):
    """Record a span on the global tracer, or do nothing (one global
    load + one comparison) when tracing is off — the form every
    instrumented hot path uses."""
    t = _GLOBAL
    if t is None:
        return _NULL_SPAN
    return t.span(name, cat, **args)
