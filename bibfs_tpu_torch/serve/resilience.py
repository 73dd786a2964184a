"""Failure handling for the serving stack: error taxonomy, retry with
backoff, circuit breaking, and the health state machine — the
counterpart of ``bibfs_tpu/serve/resilience.py``, unchanged in
behaviour; the breaker adds :meth:`CircuitBreaker.release`, for the
failures a CUDA engine does not degrade.

A failing route degrades THROUGHPUT, never availability:

- :class:`QueryError` — the structured per-query failure the engines
  hand a ticket instead of a raw backend traceback, with a small
  taxonomy (``invalid`` / ``timeout`` / ``capacity`` / ``internal``)
  that callers and the ``bibfs_errors_total{kind}`` metric share.
- :class:`RetryPolicy` — bounded retries with exponential backoff and
  jitter (seeded, so chaos runs reproduce): the transient-blip answer.
- :class:`CircuitBreaker` — consecutive-failure threshold opens the
  device route; after ``reset_s`` a half-open probe is let through and
  its outcome closes or re-opens the breaker. A dead accelerator costs
  one failed batch per reset window, not one per flush.
- :class:`HealthMonitor` — the ``live`` / ``ready`` / ``degraded`` /
  ``draining`` state machine ``/healthz`` serves (200 for
  ready/degraded with detail, 503 otherwise), derived from breaker
  state, recent error rate, and queue depth vs the admission bound.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque

#: the error taxonomy (README "Robustness"): what a failed query means
#: - invalid:  the query itself is malformed (out-of-range node id, bad
#:             arity) — retrying cannot help
#: - timeout:  the caller stopped waiting (ticket cancelled after a
#:             wait timeout) or a bounded wait expired
#: - capacity: the engine refused work it cannot absorb (admission
#:             queue full in a non-blocking submit, engine draining)
#: - internal: a solver/dispatch failure (including injected faults)
#:             that survived every retry and fallback rung
ERROR_KINDS = ("invalid", "timeout", "capacity", "internal")


class QueryError(RuntimeError):
    """A structured per-query failure (one ticket, not its batch)."""

    def __init__(self, message: str, *, kind: str = "internal",
                 query=None, cause: BaseException | None = None):
        if kind not in ERROR_KINDS:
            raise ValueError(
                f"unknown error kind {kind!r} (known: {ERROR_KINDS})"
            )
        self.kind = kind
        self.query = None if query is None else (
            int(query[0]), int(query[1])
        )
        self.cause = cause
        prefix = f"[{kind}]"
        if self.query is not None:
            prefix += f" query {self.query[0]}->{self.query[1]}"
        super().__init__(f"{prefix}: {message}")


def classify_exception(exc: BaseException) -> str:
    """Map an arbitrary failure onto the taxonomy (the fallback ladder
    wraps whatever the last rung raised). ``invalid`` is deliberately
    NOT inferred here: a ValueError out of a solver rung is an internal
    failure, not the client's — only submit-time validation (which
    knows it is looking at client input) may tag ``invalid``, via the
    explicit ``kind=`` on :func:`to_query_error`."""
    if isinstance(exc, QueryError):
        return exc.kind
    if isinstance(exc, TimeoutError):
        return "timeout"
    return "internal"


def to_query_error(exc: BaseException, query=None,
                   kind: str | None = None) -> QueryError:
    if isinstance(exc, QueryError):
        return exc
    return QueryError(
        f"{type(exc).__name__}: {exc}",
        kind=classify_exception(exc) if kind is None else kind,
        query=query, cause=exc,
    )


#: taxonomy kinds that degrade /healthz: server-side failures only.
#: A client sending malformed queries (invalid) or abandoning tickets
#: (timeout) must not be able to drive a healthy node's health state —
#: that would hand health alerts to whoever talks to the socket.
HEALTH_ERROR_KINDS = ("internal", "capacity")


class RetryPolicy:
    """Bounded retry with exponential backoff and jitter.

    ``attempts`` counts TOTAL tries of a route (so 2 = one retry before
    the fallback rung). Backoff for the sleep between try ``k`` and
    ``k+1`` is ``base_ms * 2**k`` capped at ``max_ms``, scaled by a
    uniform jitter in ``[1-jitter, 1+jitter]`` — jitter is what keeps N
    engines that failed together from hammering the recovered route in
    lockstep, which is exactly why the default is UNSEEDED (identical
    seeds would reproduce the lockstep jitter exists to break). Pass
    ``seed=`` explicitly when a chaos run must reproduce its
    schedule."""

    def __init__(self, attempts: int = 2, *, base_ms: float = 1.0,
                 max_ms: float = 50.0, jitter: float = 0.5,
                 seed: int | None = None):
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        if not (0.0 <= jitter <= 1.0):
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        self.attempts = int(attempts)
        self.base_ms = float(base_ms)
        self.max_ms = float(max_ms)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)

    def delay_s(self, attempt: int) -> float:
        """Backoff before retry number ``attempt + 1`` (0-based)."""
        d = min(self.base_ms * (2.0 ** attempt), self.max_ms)
        lo, hi = 1.0 - self.jitter, 1.0 + self.jitter
        return d * self._rng.uniform(lo, hi) / 1e3

    def snapshot(self) -> dict:
        return {
            "attempts": self.attempts,
            "base_ms": self.base_ms,
            "max_ms": self.max_ms,
            "jitter": self.jitter,
        }


#: breaker state -> the ``bibfs_breaker_state`` gauge value
BREAKER_STATE_CODES = {"closed": 0, "half_open": 1, "open": 2}


class CircuitBreaker:
    """Consecutive-failure circuit breaker for one route.

    closed --[``fail_threshold`` consecutive failures]--> open
    open --[``reset_s`` elapsed]--> half_open (ONE probe allowed)
    half_open --[probe success]--> closed
    half_open --[probe failure]--> open (timer re-armed)

    ``allow()`` is the route gate: True means "try the route" (and, in
    half-open, claims the single probe slot — every True MUST be
    followed by ``record_success``, ``record_failure`` or ``release``).
    Thread-safe;
    transition listeners (``on_transition`` at construction, more via
    :meth:`add_listener` — a breaker SHARED by several engines keeps
    every engine's gauge exact) fire under the lock on every state
    change.
    """

    def __init__(self, fail_threshold: int = 3, *, reset_s: float = 5.0,
                 clock=time.monotonic, on_transition=None):
        if fail_threshold < 1:
            raise ValueError(
                f"fail_threshold must be >= 1, got {fail_threshold}"
            )
        self.fail_threshold = int(fail_threshold)
        self.reset_s = float(reset_s)
        self._clock = clock
        self._listeners = [] if on_transition is None else [on_transition]
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive_failures = 0
        self._opened_at: float | None = None
        self._probe_in_flight = False
        self._opens = 0

    def add_listener(self, on_transition) -> None:
        """Subscribe to state changes (fires under the breaker lock).
        A listener that returns ``False`` is UNREGISTERED — how
        weakly-bound listeners prune themselves once their engine is
        gone (same contract as the registry's ``add_collector``), so a
        breaker shared across churning engines doesn't accumulate dead
        subscribers firing on every transition."""
        self._listeners.append(on_transition)

    def _transition(self, state: str) -> None:
        self._state = state
        self._listeners = [
            cb for cb in self._listeners if cb(state) is not False
        ]

    @property
    def state(self) -> str:
        with self._lock:
            # an elapsed open window reads as half_open: the state a
            # health probe should report even before traffic arrives
            if (self._state == "open"
                    and self._clock() - self._opened_at >= self.reset_s):
                return "half_open"
            return self._state

    def allow(self) -> bool:
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if self._clock() - self._opened_at < self.reset_s:
                    return False
                self._transition("half_open")
                self._probe_in_flight = True
                return True
            # half_open: one probe at a time
            if self._probe_in_flight:
                return False
            self._probe_in_flight = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probe_in_flight = False
            if self._state != "closed":
                self._transition("closed")

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            if self._state == "half_open":
                # failed probe: straight back to open, timer re-armed
                self._probe_in_flight = False
                self._opened_at = self._clock()
                self._opens += 1
                self._transition("open")
            elif (self._state == "closed"
                    and self._consecutive_failures >= self.fail_threshold):
                self._opened_at = self._clock()
                self._opens += 1
                self._transition("open")

    def release(self) -> None:
        """Give back an ``allow()`` without an outcome: a failure that is
        not the route's to absorb (the engine fails its tickets instead)
        moves no state, but a claimed half-open probe slot is freed."""
        with self._lock:
            self._probe_in_flight = False

    def snapshot(self) -> dict:
        with self._lock:
            state = self._state
            if (state == "open"
                    and self._clock() - self._opened_at >= self.reset_s):
                state = "half_open"
            return {
                "state": state,
                "consecutive_failures": self._consecutive_failures,
                "fail_threshold": self.fail_threshold,
                "reset_s": self.reset_s,
                "opens": self._opens,
            }


#: health state -> the ``bibfs_health_state`` gauge value
HEALTH_STATE_CODES = {"live": 0, "ready": 1, "degraded": 2, "draining": 3}


class HealthMonitor:
    """The serving health state machine (module docstring).

    Inputs are pulled lazily at :meth:`state` time (a /healthz probe or
    a ``stats()`` read), so steady-state serving pays nothing:

    - ``breaker`` — any non-closed breaker state degrades;
    - recent errors — ticket failures noted via :meth:`note_error`
      within the last ``window_s`` degrade (and age out on their own:
      this is what "recovered" means after a fault clears);
    - ``queue_depth``/``max_queue`` — a queue at or past
      ``queue_high`` of the admission bound degrades (the server is
      up but saturating).

    ``live`` is the before-ready state (constructed, not yet serving);
    ``draining`` is terminal (close() started). 200 vs 503 mapping
    lives in :func:`healthz_status`.
    """

    def __init__(self, *, breaker: CircuitBreaker | None = None,
                 window_s: float = 5.0, error_threshold: int = 1,
                 queue_depth=None, max_queue: int | None = None,
                 queue_high: float = 0.9, clock=time.monotonic,
                 gauge=None):
        self._breaker = breaker
        self.window_s = float(window_s)
        self.error_threshold = max(int(error_threshold), 1)
        self._queue_depth = queue_depth
        self._max_queue = max_queue
        self._queue_high = float(queue_high)
        self._clock = clock
        self._gauge = gauge
        self._lock = threading.Lock()
        self._errors: deque[float] = deque(maxlen=4096)
        self._errors_total = 0
        self._ready = False
        self._draining = False

    def set_ready(self) -> None:
        self._ready = True

    def set_draining(self) -> None:
        self._draining = True

    def clear_draining(self) -> None:
        """Leave the draining state — the rolling-swap re-admit path
        (``engine.end_drain()``): the monitor goes back to deriving
        ready/degraded from its live inputs. A ``close()``-style
        terminal drain simply never calls this."""
        self._draining = False

    def note_error(self, count: int = 1) -> None:
        now = self._clock()
        with self._lock:
            self._errors_total += count
            for _ in range(min(count, self._errors.maxlen)):
                self._errors.append(now)

    def recent_errors(self) -> int:
        cutoff = self._clock() - self.window_s
        with self._lock:
            while self._errors and self._errors[0] < cutoff:
                self._errors.popleft()
            return len(self._errors)

    def state(self) -> tuple[str, list[str]]:
        """``(state, reasons)``; reasons name every degradation input
        that tripped (empty for live/ready/draining)."""
        if self._draining:
            state, reasons = "draining", []
        elif not self._ready:
            state, reasons = "live", []
        else:
            reasons = []
            if self._breaker is not None:
                bstate = self._breaker.state
                if bstate != "closed":
                    reasons.append(f"breaker_{bstate}")
            errs = self.recent_errors()
            if errs >= self.error_threshold:
                reasons.append(
                    f"errors={errs} in last {self.window_s:g}s"
                )
            if self._queue_depth is not None and self._max_queue:
                depth = self._queue_depth()
                if depth >= self._queue_high * self._max_queue:
                    reasons.append(
                        f"queue_depth={depth}/{self._max_queue}"
                    )
            state = "degraded" if reasons else "ready"
        if self._gauge is not None:
            self._gauge.set(HEALTH_STATE_CODES[state])
        return state, reasons

    def snapshot(self) -> dict:
        """The /healthz payload (and the ``stats()['health']`` block)."""
        state, reasons = self.state()
        out = {
            "state": state,
            "reasons": reasons,
            "errors_total": self._errors_total,
            "recent_errors": self.recent_errors(),
            "window_s": self.window_s,
        }
        if self._breaker is not None:
            out["breaker"] = self._breaker.snapshot()
        if self._queue_depth is not None and self._max_queue:
            out["queue_depth"] = self._queue_depth()
            out["max_queue"] = self._max_queue
        return out


def healthz_status(state: str) -> int:
    """HTTP status for a health state: a degraded server still SERVES
    (200 — load balancers must not eject a node that is answering,
    merely slowly), a live-not-ready or draining one must not receive
    traffic (503)."""
    return 200 if state in ("ready", "degraded") else 503
