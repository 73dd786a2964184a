"""Fault injection for the serving stack — chaos against the REAL
engine: the counterpart of ``bibfs_tpu/serve/faults.py``.

A :class:`FaultPlan` is a set of rules that fire at the engine's named
seams. This package's synchronous engine fires three of them:

- ``device`` — the batched device dispatch (the first half of
  :meth:`~bibfs_tpu_torch.serve.engine.QueryEngine._device_solve`),
  the seam a dead or flaky card route fails at;
- ``device_finish`` — the forced value read and host-side decode (its
  second half);
- ``host_batch`` — the host batch
  (:meth:`~bibfs_tpu_torch.serve.engine.QueryEngine._solve_host`), the
  native-solver failure seam.

The parser accepts every site the JAX package knows (:data:`KNOWN_SITES`),
so one ``BIBFS_FAULTS`` spec drives both packages; the mesh, blocked,
store, query-kind and analytics layers fire their sites as the JAX
package's do. ``trace_flush`` fires in the distributed-trace spool writer
(:class:`~bibfs_tpu_torch.obs.dtrace.DTracer`): a trip there drops one
span, never a query. Every trip is noted in the flight recorder
(:func:`~bibfs_tpu_torch.obs.dtrace.flight_on_fault`) before it acts.

A rule either raises :class:`InjectedFault` (kind ``error``) or sleeps
(kind ``latency``), probabilistically (``p=0.1``, seeded — chaos runs
are reproducible) or deterministically (``every=3``: every 3rd call;
``times=2``: the first 2 calls), optionally only when a specific
query is in the batch (``pair=SRC-DST`` — the poison-batch case the
bisection isolator exists for).

Spec grammar (the ``BIBFS_FAULTS`` env var)::

    SPEC   := RULE (';' RULE)*
    RULE   := SITE ':' FIELD (',' FIELD)*
    FIELD  := 'p=' FLOAT | 'every=' INT | 'times=' INT
            | 'kind=' ('error'|'latency') | 'ms=' FLOAT
            | 'pair=' INT '-' INT

e.g. ``device:p=0.15`` (15% of device dispatches raise),
``host_batch:every=4,kind=latency,ms=20`` (every 4th host batch stalls
20 ms), ``host_batch:pair=7-19,times=3`` (the first 3 host batches
containing query (7, 19) raise — everyone else sails through).

Injections land in the process metrics registry
(``bibfs_faults_injected_total{site,kind}``). An engine built without a
plan (and without ``BIBFS_FAULTS``) carries ``faults=None`` and pays
exactly one attribute check per seam.
"""

from __future__ import annotations

import os
import random
import threading
import time

from bibfs_tpu_torch.obs.metrics import REGISTRY

ENV_VAR = "BIBFS_FAULTS"

#: seams the serving engines actually fire (parse rejects anything else:
#: a typo'd site in a chaos spec must fail loudly, not silently inject
#: nothing and pass the soak)
KNOWN_SITES = ("device", "device_finish", "mesh", "mesh_finish",
               "blocked", "blocked_finish",
               "host_batch", "wal_write", "wal_fsync", "manifest_rename",
               # arrays-sidecar directory commit (store/sidecar.py):
               # fires just before the rename-last that publishes the
               # mmap-able checkpoint arrays — the crash soak's torn-
               # sidecar recovery leg targets it
               "sidecar_rename",
               # taxonomy query kinds (serve/routes/taxonomy.py): the
               # packed multi-source sweep, the delta-stepping solve,
               # the Yen's batch, and the as-of historical replay
               "msbfs", "weighted", "kshortest", "asof_replay",
               # the kinds' DEVICE rungs (serve/routes/
               # taxonomy_device.py): each degrades to its host kind
               # rung when faulted
               "msbfs_device", "weighted_device", "kshortest_device",
               # the whole-graph analytics tier (serve/routes/
               # analytics.py): fired entering / leaving EVERY
               # analytics solve, host and blocked rung alike — one
               # spec line degrades the whole tier to its fallbacks
               "analytics", "analytics_finish",
               # the distributed-trace spool append (obs/dtrace.py):
               # a failed flush drops the span, never the query
               "trace_flush")

KINDS = ("error", "latency")


class InjectedFault(RuntimeError):
    """The exception a ``kind=error`` rule raises at its seam. On a CUDA
    engine it is the only device-route failure the ladder degrades to the
    host; any other fails its tickets."""

    def __init__(self, site: str, detail: str = ""):
        self.site = site
        msg = f"injected fault at {site}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


def _injected_counter():
    return REGISTRY.counter(
        "bibfs_faults_injected_total",
        "Faults injected into the serving stack, by seam and kind",
        ("site", "kind"),
    )


class FaultRule:
    """One injection rule at one site (module docstring grammar)."""

    __slots__ = (
        "site", "kind", "p", "every", "times", "latency_ms", "pair",
        "calls", "fired",
    )

    def __init__(
        self,
        site: str,
        *,
        kind: str = "error",
        p: float | None = None,
        every: int | None = None,
        times: int | None = None,
        latency_ms: float = 10.0,
        pair: tuple[int, int] | None = None,
    ):
        if site not in KNOWN_SITES:
            raise ValueError(
                f"unknown fault site {site!r} "
                f"(known: {', '.join(KNOWN_SITES)})"
            )
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} (known: {KINDS})")
        if p is not None and not (0.0 <= p <= 1.0):
            raise ValueError(f"fault probability p={p} outside [0, 1]")
        if every is not None and every < 1:
            raise ValueError(f"every={every} must be >= 1")
        if times is not None and times < 1:
            raise ValueError(f"times={times} must be >= 1")
        if p is not None and every is not None:
            # a spec must fail loudly (KNOWN_SITES note): with both,
            # p= would win and every= would be silently dead
            raise ValueError(
                "fault rule cannot combine p= and every= triggers "
                "(pick one; times= caps either)"
            )
        if p is None and every is None and times is None:
            every = 1  # bare rule: fire on every call
        self.site = site
        self.kind = kind
        self.p = p
        self.every = every
        self.times = times
        self.latency_ms = float(latency_ms)
        self.pair = pair
        self.calls = 0
        self.fired = 0

    def describe(self) -> str:
        bits = []
        if self.p is not None:
            bits.append(f"p={self.p}")
        if self.every is not None:
            bits.append(f"every={self.every}")
        if self.times is not None:
            bits.append(f"times={self.times}")
        if self.pair is not None:
            bits.append(f"pair={self.pair[0]}-{self.pair[1]}")
        if self.kind == "latency":
            bits.append(f"latency={self.latency_ms}ms")
        return f"{self.site}:{','.join(bits) or 'always'}"


def _parse_rule(text: str) -> FaultRule:
    site, _, rest = text.partition(":")
    site = site.strip()
    kw: dict = {}
    for field in filter(None, (f.strip() for f in rest.split(","))):
        key, eq, val = field.partition("=")
        if not eq:
            raise ValueError(f"bad fault field {field!r} (expected key=value)")
        key = key.strip()
        val = val.strip()
        try:
            if key == "p":
                kw["p"] = float(val)
            elif key == "every":
                kw["every"] = int(val)
            elif key == "times":
                kw["times"] = int(val)
            elif key == "kind":
                kw["kind"] = val
            elif key == "ms":
                kw["latency_ms"] = float(val)
            elif key == "pair":
                s, _, d = val.partition("-")
                kw["pair"] = (int(s), int(d))
            else:
                raise ValueError(f"unknown fault field {key!r}")
        except ValueError as e:
            if "unknown fault field" in str(e):
                raise
            raise ValueError(f"bad fault field {field!r}: {e}") from e
    return FaultRule(site, **kw)


class FaultPlan:
    """A parsed set of :class:`FaultRule` s, fired at the engine seams.

    Thread-safe (engines on several threads may share a plan);
    ``set_active(False)`` disables every rule at
    once — the chaos harness's "fault clears" edge. ``seed`` makes the
    probabilistic rules reproducible run-to-run.
    """

    def __init__(self, rules: list[FaultRule], *, seed: int = 0):
        self._rules = list(rules)
        self._by_site: dict[str, list[FaultRule]] = {}
        for r in self._rules:
            self._by_site.setdefault(r.site, []).append(r)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._active = True
        self._counter = _injected_counter()

    # ---- construction -----------------------------------------------
    @classmethod
    def parse(cls, spec: str, *, seed: int = 0) -> "FaultPlan":
        """Parse the module-docstring grammar into a plan."""
        rules = [
            _parse_rule(part)
            for part in filter(None, (p.strip() for p in spec.split(";")))
        ]
        if not rules:
            raise ValueError(f"empty fault spec {spec!r}")
        return cls(rules, seed=seed)

    @classmethod
    def from_env(cls, environ=None) -> "FaultPlan | None":
        """The engine-construction default: a plan when ``BIBFS_FAULTS``
        is set (seeded by ``BIBFS_FAULTS_SEED``, default 0), else None —
        the no-injection fast path stays one ``is None`` check."""
        environ = os.environ if environ is None else environ
        spec = environ.get(ENV_VAR, "").strip()
        if not spec:
            return None
        return cls.parse(spec, seed=int(environ.get("BIBFS_FAULTS_SEED", 0)))

    # ---- firing ------------------------------------------------------
    def set_active(self, active: bool) -> None:
        with self._lock:
            self._active = bool(active)

    @property
    def active(self) -> bool:
        return self._active

    def fire(self, site: str, pairs=None) -> None:
        """Evaluate every rule at ``site``: may sleep (latency rules),
        may raise :class:`InjectedFault`. ``pairs`` is the flush's
        query list, for ``pair=``-targeted rules."""
        rules = self._by_site.get(site)
        if not rules or not self._active:
            return
        sleep_ms = 0.0
        boom: InjectedFault | None = None
        with self._lock:
            for r in rules:
                if r.pair is not None and (
                    pairs is None or tuple(r.pair) not in (
                        (int(s), int(d)) for s, d in pairs
                    )
                ):
                    continue
                r.calls += 1
                if r.times is not None and r.fired >= r.times:
                    continue
                hit = False
                if r.p is not None:
                    hit = self._rng.random() < r.p
                elif r.every is not None:
                    hit = r.calls % r.every == 0
                elif r.times is not None:
                    hit = True  # bounded purely by the times cap above
                if not hit:
                    continue
                r.fired += 1
                self._counter.labels(site=site, kind=r.kind).inc()
                if r.kind == "latency":
                    sleep_ms += r.latency_ms
                elif boom is None:
                    boom = InjectedFault(site, r.describe())
        if sleep_ms > 0.0 or boom is not None:
            # the flight recorder's fault hook: record the trip (and dump
            # the ring, rate-limited, when a dump path is armed) before
            # the injected error propagates; the post-mortem never adds a
            # failure of its own
            try:
                from bibfs_tpu_torch.obs.dtrace import flight_on_fault

                flight_on_fault(site)
            except Exception:  # pragma: no cover - defensive
                pass
        if sleep_ms > 0.0:
            time.sleep(sleep_ms / 1e3)
        if boom is not None:
            raise boom

    # ---- introspection ----------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "active": self._active,
                "rules": [
                    {
                        "rule": r.describe(),
                        "calls": r.calls,
                        "fired": r.fired,
                    }
                    for r in self._rules
                ],
                "fired_total": sum(r.fired for r in self._rules),
            }

    def __repr__(self) -> str:
        return (
            "FaultPlan("
            + "; ".join(r.describe() for r in self._rules)
            + ("" if self._active else " [inactive]")
            + ")"
        )
