"""Process-wide metrics registry with Prometheus text exposition: the
counterpart of ``bibfs_tpu/obs/metrics.py``, with its own process
:data:`REGISTRY`.

The serving components of this package mint the same ``bibfs_*``
family names, labels and kinds as the JAX package's, so a component's
``stats()`` dict and a registry scrape mean the same thing in both.

- **Counters** — monotonically increasing event counts
  (``bibfs_queries_total``).
- **Gauges** — point-in-time values and watermarks
  (``bibfs_exec_programs``).
- **Histograms** — :class:`LogHistogram`, log-bucketed with O(1)
  memory: 2^(1/4) geometric buckets, upper-edge percentile reads,
  rendered as cumulative Prometheus ``_bucket{le=...}`` series.

Every family carries labels (engine, route, cache, program): one family,
many children, each child a cheap cell created once at component
construction or first label use, so the serving hot path only
increments existing cells. :meth:`MetricsRegistry.render` is the
``/metrics`` payload (the HTTP surface comes with the network slice);
component ``stats()`` dicts are snapshot views over these cells
(:class:`MetricBank`).
"""

from __future__ import annotations

import itertools
import math
import os
import sys
import threading

# one shared label used by components constructed without an explicit
# instance label (the common serving-process case: one engine, one cache)
_SEQ = itertools.count()


def next_instance_label(prefix: str) -> str:
    """A process-unique label value for one component instance
    (``engine-3``, ``exec-0``): keeps per-instance ``stats()`` exact
    while every instance still lands in the one process registry.

    Callers passing an EXPLICIT label instead must keep it unique per
    instance of a component class — two same-class instances sharing a
    label share cells, which merges their stats and (cells being
    lock-free) races their increments across the two instances' locks.

    The flip side of per-instance labels: cells are never removed, so
    a process that constructs engines per request grows its registry
    (and ``/metrics`` payload) by a few dozen small cells per engine.
    That is the intended trade for a serving process (one or two
    long-lived engines); bench harnesses that churn engines per rate
    point accept a bounded, run-scoped accumulation."""
    return f"{prefix}-{next(_SEQ)}"


_BUILD_INFO: dict | None = None


def _read_git_rev() -> str:
    """The working tree's HEAD commit (12 hex chars), read straight
    from ``.git`` — no subprocess: this runs at registry construction,
    which sits on every serving process's import path, and forking git
    there would tax exactly the processes (replica fleets) the gauge
    exists to identify."""
    try:
        from pathlib import Path

        root = Path(__file__).resolve().parents[2]
        head = (root / ".git" / "HEAD").read_text().strip()
        if not head.startswith("ref:"):
            return head[:12] or "unknown"
        ref = head.split(None, 1)[1]
        ref_file = root / ".git" / ref
        if ref_file.exists():
            return ref_file.read_text().strip()[:12] or "unknown"
        packed = root / ".git" / "packed-refs"
        if packed.exists():
            for ln in packed.read_text().splitlines():
                if ln.endswith(" " + ref):
                    return ln.split()[0][:12]
    except Exception:
        pass
    return "unknown"


def build_info_fields() -> dict:
    """The build-identity labels ``bibfs_build_info`` carries — the
    same fields every ``bench_*.json`` artifact's ``meta`` block stamps
    (git rev, os, machine, python, torch, numpy; the meta block's
    timestamp is run provenance, not build identity, so it stays out).
    Versions come from package metadata, not imports: minting a gauge
    must never import a framework. Computed once per process."""
    global _BUILD_INFO
    if _BUILD_INFO is None:
        from importlib import metadata

        def _ver(pkg: str) -> str:
            try:
                return metadata.version(pkg)
            except Exception:
                return "unknown"

        uname = os.uname()
        _BUILD_INFO = {
            "git_rev": _read_git_rev(),
            "os": f"{uname.sysname} {uname.release}",
            "machine": uname.machine,
            "python": sys.version.split()[0],
            "torch": _ver("torch"),
            "numpy": _ver("numpy"),
        }
    return _BUILD_INFO


def _validate_name(name: str) -> str:
    if not name or not all(c.isalnum() or c in "_:" for c in name):
        raise ValueError(f"bad metric name {name!r}")
    return name


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n"
    )


def _fmt_value(v) -> str:
    if isinstance(v, float):
        if v == math.inf:
            return "+Inf"
        if v != v:  # NaN
            return "NaN"
        return repr(v)
    return str(v)


def _labels_suffix(labelnames, labelvalues) -> str:
    if not labelnames:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"'
        for k, v in zip(labelnames, labelvalues)
    )
    return "{" + inner + "}"


# Counter/Gauge cells are deliberately LOCK-FREE: every serving-path
# mutation site is externally serialized (the engine's flush, the
# caches' own locks), and the cells inherit exactly that contract —
# concurrent mutators of ONE cell must hold the component's lock, reads
# are GIL-atomic snapshots. A per-cell lock would put two lock handoffs
# on every hot-path increment.


class Counter:
    """One monotonically increasing cell (a family child)."""

    __slots__ = ("_value",)

    def __init__(self):
        self._value = 0

    def inc(self, amount=1):
        if amount < 0:
            raise ValueError(f"counters only go up (inc {amount})")
        self._value += amount

    def set(self, value):
        """Direct assignment — exists so dict-style back-compat views
        (``bank[k] = bank[k] + 1``) keep working; still monotonic."""
        if value < self._value:
            raise ValueError(
                f"counters only go up ({self._value} -> {value})"
            )
        self._value = value

    @property
    def value(self):
        return self._value


class Gauge:
    """One point-in-time cell: settable up or down, plus a watermark
    helper for the engines' ``*_max_ms`` counters."""

    __slots__ = ("_value",)

    def __init__(self):
        self._value = 0

    def set(self, value):
        self._value = value

    def inc(self, amount=1):
        self._value += amount

    def dec(self, amount=1):
        self._value -= amount

    def set_max(self, value):
        """Watermark update: keep the larger of current and ``value``."""
        if value > self._value:
            self._value = value

    @property
    def value(self):
        return self._value


class LogHistogram:
    """Thread-safe log-bucketed histogram (seconds by default).

    O(1) memory at any traffic volume: samples land in geometric buckets
    (ratio 2^1/4 ≈ 19% resolution, 1 µs .. ~100 s) and percentiles read
    the bucket upper edge where the cumulative count crosses the rank —
    a ~19% overestimate bound, which is plenty for an SLO dashboard and
    never samples away tail events (exact ``max`` is tracked aside).

    The registry's histograms (``bibfs_stage_seconds``) use it, with the
    JAX package's bucket geometry, so the two packages' buckets line up.
    """

    _BASE = 1e-6  # 1 µs
    _RATIO = 2 ** 0.25
    _NBUCKETS = 108  # last edge ~ 1e-6 * 2^(107/4) ≈ 127 s

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = [0] * self._NBUCKETS
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0

    @classmethod
    def bucket_edge(cls, i: int) -> float:
        """Upper edge (inclusive) of bucket ``i``, in seconds."""
        return cls._BASE * cls._RATIO ** i

    def _bucket(self, s: float) -> int:
        if s <= self._BASE:
            return 0
        return min(
            int(math.log(s / self._BASE, self._RATIO)) + 1,
            self._NBUCKETS - 1,
        )

    def record(self, seconds: float) -> None:
        s = max(float(seconds), 0.0)
        i = self._bucket(s)
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.total_s += s
            if s > self.max_s:
                self.max_s = s

    # Counter-cell protocol alias so histograms can live in a
    # MetricBank next to counters if ever needed.
    observe = record

    def record_many(self, seconds_list) -> None:
        """One lock acquisition for a whole batch of samples — the
        per-query histogram cost in the serving hot loop is the bucket
        index, not a lock handoff."""
        if not seconds_list:
            return
        samples = [(max(float(s), 0.0)) for s in seconds_list]
        with self._lock:
            for s in samples:
                self._counts[self._bucket(s)] += 1
                self.total_s += s
                if s > self.max_s:
                    self.max_s = s
            self.count += len(samples)

    def percentile(self, q: float) -> float:
        """Upper-edge estimate of the ``q``-quantile (0 < q <= 1), in
        seconds; 0.0 when empty."""
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = q * self.count
            seen = 0
            for i, c in enumerate(self._counts):
                seen += c
                if seen >= rank:
                    return min(self._BASE * self._RATIO ** i, self.max_s)
            return self.max_s

    def summary_ms(self) -> dict:
        """The stats() block: count/mean plus the SLO percentiles."""
        p50, p95, p99 = (self.percentile(q) for q in (0.5, 0.95, 0.99))
        with self._lock:
            mean = self.total_s / self.count if self.count else 0.0
            return {
                "count": self.count,
                "mean_ms": round(mean * 1e3, 4),
                "p50_ms": round(p50 * 1e3, 4),
                "p95_ms": round(p95 * 1e3, 4),
                "p99_ms": round(p99 * 1e3, 4),
                "max_ms": round(self.max_s * 1e3, 4),
            }

    def cumulative(self) -> list:
        """(upper_edge_seconds, cumulative_count) pairs for Prometheus
        rendering; empty trailing buckets are collapsed into +Inf."""
        with self._lock:
            out = []
            seen = 0
            for i, c in enumerate(self._counts):
                seen += c
                if c:
                    out.append((self.bucket_edge(i), seen))
            return out

    @property
    def value(self):  # MetricBank read protocol
        return self.count


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": LogHistogram}


class MetricFamily:
    """One named metric + its labeled children.

    ``labels(**kv)`` returns (creating on first use) the child cell for
    one label-value combination; a zero-label family proxies the cell
    methods directly (``family.inc()``)."""

    def __init__(self, name: str, help: str, kind: str, labelnames=()):
        self.name = _validate_name(name)
        self.help = help
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict = {}
        if not self.labelnames:
            self._children[()] = _KINDS[kind]()

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != "
                f"declared {sorted(self.labelnames)}"
            )
        key = tuple(str(kv[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _KINDS[self.kind]()
                self._children[key] = child
            return child

    def children(self) -> dict:
        with self._lock:
            return dict(self._children)

    # zero-label convenience: the family IS its only child
    def _solo(self):
        return self._children[()]

    def inc(self, amount=1):
        self._solo().inc(amount)

    def set(self, value):
        self._solo().set(value)

    def set_max(self, value):
        self._solo().set_max(value)

    def dec(self, amount=1):
        self._solo().dec(amount)

    def observe(self, value):
        self._solo().observe(value)

    @property
    def value(self):
        return self._solo().value

    def render(self) -> str:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ]
        for key, child in sorted(self.children().items()):
            suffix = _labels_suffix(self.labelnames, key)
            if self.kind == "histogram":
                cum = child.cumulative()
                base = list(zip(self.labelnames, key))
                for edge, count in cum:
                    le = ",".join(
                        [f'{k}="{_escape_label(v)}"' for k, v in base]
                        + [f'le="{_fmt_value(float(edge))}"']
                    )
                    lines.append(f"{self.name}_bucket{{{le}}} {count}")
                inf = ",".join(
                    [f'{k}="{_escape_label(v)}"' for k, v in base]
                    + ['le="+Inf"']
                )
                lines.append(f"{self.name}_bucket{{{inf}}} {child.count}")
                lines.append(
                    f"{self.name}_sum{suffix} {_fmt_value(child.total_s)}"
                )
                lines.append(f"{self.name}_count{suffix} {child.count}")
            else:
                lines.append(
                    f"{self.name}{suffix} {_fmt_value(child.value)}"
                )
        return "\n".join(lines)


class MetricBank:
    """Dict-style view over named registry cells.

    The serving engines' ``counters`` / ``pipe_counters`` dicts predate
    the registry and are read (and ``bank[k] += 1``-mutated) all over
    the engines, the bench harness, and the tests. A bank keeps that
    exact surface — ``bank["queries"] += 1``, ``dict(bank)``,
    ``bank["queries"]`` — while every value lives in a registry cell,
    so ``stats()`` dicts ARE registry snapshots and ``/metrics`` sees
    the same numbers. Cells are created once at component construction;
    the bank itself never allocates afterwards."""

    __slots__ = ("_cells",)

    def __init__(self, cells: dict):
        self._cells = dict(cells)

    def __getitem__(self, key):
        return self._cells[key].value

    def __setitem__(self, key, value):
        self._cells[key].set(value)

    def __contains__(self, key):
        return key in self._cells

    def __iter__(self):
        return iter(self._cells)

    def __len__(self):
        return len(self._cells)

    def keys(self):
        return self._cells.keys()

    def items(self):
        return [(k, c.value) for k, c in self._cells.items()]

    def inc(self, key, amount=1):
        """Atomic increment (the read-modify-write ``bank[k] += 1`` form
        is kept for call-site compatibility but takes two cell locks)."""
        self._cells[key].inc(amount)

    def cell(self, key):
        return self._cells[key]


class MetricsRegistry:
    """Named metric families, one namespace per process.

    ``counter/gauge/histogram`` are get-or-create and idempotent: the
    serving layer's components all ask for the same family names and
    share them; asking again with a different kind or label set is a
    bug and raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, MetricFamily] = {}
        self._collectors: list = []
        # bibfs_build_info: minted at registry init so EVERY /metrics
        # render identifies its build (a fleet of replicas mid-rolling-
        # restart is exactly when "which build is this node" matters).
        # Prometheus convention: value is always 1, the labels carry
        # the identity — join other series against it by instance.
        try:
            fields = build_info_fields()
            self.gauge(
                "bibfs_build_info",
                "Build identity of this process (value is always 1; "
                "labels carry the bench_*.json meta fields)",
                tuple(sorted(fields)),
            ).labels(**fields).set(1)
        except Exception:
            pass  # provenance must never break metrics

    def add_collector(self, fn) -> None:
        """Register a render-time hook: ``fn()`` runs at the top of
        every :meth:`render` (and :meth:`snapshot`), refreshing gauges
        whose truth is computed on demand rather than event-driven —
        the health state machine's ``bibfs_health_state`` is the
        motivating case (breaker windows elapse and error windows age
        out with NO event; a /metrics-only scraper must still see the
        current state). A hook that returns ``False`` is UNREGISTERED —
        how weakly-bound hooks prune themselves once their component is
        gone, so engine-churning processes don't accumulate dead hooks
        on every scrape. Hook failures are swallowed: a broken
        collector must not take down the scrape that would reveal
        it."""
        with self._lock:
            self._collectors.append(fn)

    def _collect(self) -> None:
        with self._lock:
            hooks = list(self._collectors)
        dead = []
        for fn in hooks:
            try:
                if fn() is False:
                    dead.append(fn)
            except Exception:
                pass
        if dead:
            with self._lock:
                self._collectors = [
                    f for f in self._collectors if f not in dead
                ]

    def _get_or_create(self, name, help, kind, labelnames):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered as {kind}"
                        f"{tuple(labelnames)} (was {fam.kind}"
                        f"{fam.labelnames})"
                    )
                return fam
            fam = MetricFamily(name, help, kind, labelnames)
            self._families[name] = fam
            return fam

    def counter(self, name, help="", labelnames=()) -> MetricFamily:
        return self._get_or_create(name, help, "counter", labelnames)

    def gauge(self, name, help="", labelnames=()) -> MetricFamily:
        return self._get_or_create(name, help, "gauge", labelnames)

    def histogram(self, name, help="", labelnames=()) -> MetricFamily:
        return self._get_or_create(name, help, "histogram", labelnames)

    def get(self, name) -> MetricFamily | None:
        with self._lock:
            return self._families.get(name)

    def families(self) -> list:
        with self._lock:
            return list(self._families.values())

    def render(self) -> str:
        """The whole registry in Prometheus text exposition format
        (version 0.0.4) — the ``/metrics`` payload."""
        self._collect()
        out = [f.render() for f in sorted(
            self.families(), key=lambda f: f.name
        )]
        return "\n".join(out) + ("\n" if out else "")

    def snapshot(self) -> dict:
        """JSON-friendly dump: {family: {label_tuple_str: value}} for
        counters/gauges, histogram summaries for histograms."""
        self._collect()
        snap = {}
        for fam in self.families():
            entry = {}
            for key, child in fam.children().items():
                label = ",".join(
                    f"{k}={v}" for k, v in zip(fam.labelnames, key)
                )
                entry[label] = (
                    child.summary_ms() if fam.kind == "histogram"
                    else child.value
                )
            snap[fam.name] = entry
        return snap


#: the process-wide default registry every serving component lands in
REGISTRY = MetricsRegistry()
