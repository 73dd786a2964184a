"""The pluggable Route seam — one dispatch contract for every way a
query batch can resolve: the counterpart of
``bibfs_tpu/serve/routes/base.py``.

A :class:`Route` owns one way of solving a ``(src, dst)`` batch against
a bound :class:`~bibfs_tpu_torch.serve.engine._GraphRuntime`, plus the
failure policy that wraps it:

- ``eligible(rt, pairs)`` — the routing predicate (the batch crossover,
  the device check);
- ``solve(rt, pairs)`` — one synchronous solve of the batch;
- ``attempt(rt, pairs)`` — the resilient wrapper: bounded retries with
  backoff behind the route's own
  :class:`~bibfs_tpu_torch.serve.resilience.CircuitBreaker`. Returns the
  batch results, or None when the route is unavailable (breaker open /
  retries exhausted) — the caller degrades down the fallback ladder and
  counts the degrade in ``bibfs_route_fallbacks_total``. A failure the
  engine may not degrade (``engine._may_degrade``: on a CUDA engine
  anything but an injected fault) is neither retried nor fed to the
  breaker: it raises to the engine, which fails the batch's tickets.

The JAX package's two-stage ``launch``/``finish`` seam serves its
pipelined engine and comes with that slice of the port. The engine keeps
the orchestration (ticket resolution, banking); routes own *how a batch
solves* and *when that way is worth trying*.
"""

from __future__ import annotations

import time

from bibfs_tpu_torch.solvers.api import BFSResult


class Route:
    """One way of resolving a query batch (module docstring).

    ``engine`` is the owning engine (routes live and die with it);
    ``retry``/``breaker`` are the route's failure policy (None = the
    route is not retried / not breaker-gated). ``is_dispatch`` marks
    routes that dispatch to the device.
    """

    name: str = "route"
    is_dispatch = False

    def __init__(self, engine, *, retry=None, breaker=None):
        self.engine = engine
        self.retry = retry
        self.breaker = breaker

    # ---- selection ---------------------------------------------------
    def eligible(self, rt, pairs) -> bool:
        """Whether this route should carry ``pairs`` against ``rt``
        right now (calibrated crossovers, substrate, batch depth). An
        ineligible route is skipped silently — it is a routing
        decision, not a failure."""
        return True

    def solve(self, rt, pairs) -> list[BFSResult]:
        """One synchronous solve of ``pairs`` (no retry policy)."""
        raise NotImplementedError

    # ---- the resilient synchronous wrapper ---------------------------
    def attempt(self, rt, pairs) -> list[BFSResult] | None:
        """Bounded retries with backoff behind the route breaker.
        Returns the batch results, or None when the route is
        unavailable (breaker open / retries exhausted) and the caller
        should degrade down the ladder; raises a failure the engine may
        not degrade. The fault-free fast path is one
        ``allow()``/``record_success()`` pair per batch."""
        breaker = self.breaker
        retry = self.retry
        if breaker is not None and not breaker.allow():
            return None
        n_try = 0
        try:
            while True:
                try:
                    results = self.solve(rt, pairs)
                except Exception as exc:
                    if not self.engine._may_degrade(exc):
                        hard = exc
                        break
                    if breaker is not None:
                        breaker.record_failure()
                    n_try += 1
                    # gate BEFORE counting/sleeping (exactly one allow()
                    # per launch, every True followed by a record): when
                    # this failure just opened the breaker there is no
                    # retry to count and no backoff worth blocking for
                    if (retry is not None and n_try < retry.attempts
                            and (breaker is None or breaker.allow())):
                        self._note_retry()
                        time.sleep(retry.delay_s(n_try - 1))
                        continue
                    return None
                if breaker is not None:
                    breaker.record_success()
                return results
        except BaseException:
            # an escape past the Exception handler (KeyboardInterrupt
            # mid-launch, or during the backoff sleep whose allow() is
            # already claimed) must not leave the admitting allow()
            # unrecorded — a leaked half-open probe claim makes allow()
            # return False forever and the route never recovers (an
            # extra record_failure after a counted one is harmless)
            if breaker is not None:
                breaker.record_failure()
            raise
        # a failure of the kernel or the card: the breaker only ever opens
        # on degradable faults, so its claim is released uncounted
        if breaker is not None:
            breaker.release()
        raise hard

    def _note_retry(self) -> None:
        self.engine._res_cells.retry_cell(self.name).inc()

    # ---- introspection -----------------------------------------------
    def stats(self) -> dict:
        out: dict = {"name": self.name, "dispatch": self.is_dispatch}
        if self.breaker is not None:
            out["breaker"] = self.breaker.snapshot()
        if self.retry is not None:
            out["retry"] = self.retry.snapshot()
        return out
