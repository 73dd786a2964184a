"""The pluggable Route seam — one dispatch contract for every way a
query batch can resolve: the counterpart of
``bibfs_tpu/serve/routes/base.py``.

A :class:`Route` owns one way of solving a ``(src, dst)`` batch against
a bound :class:`~bibfs_tpu_torch.serve.engine._GraphRuntime`, plus the
failure policy that wraps it:

- ``eligible(rt, pairs)`` — the routing predicate (the batch crossover,
  the device check);
- ``launch(rt, pairs)`` / ``finish(out, fin, t0, pairs)`` — the
  two-stage solve seam. The pipelined engine runs a dispatch route's
  ``launch`` on its flusher and its ``finish`` on its finish worker, so
  batch k's finish overlaps batch k+1's launch; ``solve`` is the two in
  turn, which is how the synchronous engine calls them;
- ``attempt(rt, pairs)`` — the resilient wrapper: bounded retries with
  backoff behind the route's own
  :class:`~bibfs_tpu_torch.serve.resilience.CircuitBreaker`. Returns the
  batch results, or None when the route is unavailable (breaker open /
  retries exhausted) — the caller degrades down the fallback ladder and
  counts the degrade in ``bibfs_route_fallbacks_total``. A failure the
  route may not degrade (``may_degrade``; for a route on the engine's
  device, ``engine._may_degrade``: on a CUDA engine anything but an
  injected fault) is not retried and reaches the breaker only through
  the route's ``hard_failure`` (a released claim, except the mesh route's
  dead pool): it raises to the engine, which fails the batch's tickets.

The engines keep the orchestration (ticket resolution, banking, the
pipelined finish worker); routes own *how a batch solves* and *when
that way is worth trying*.
"""

from __future__ import annotations

import time

from bibfs_tpu_torch.solvers.api import BFSResult


class Route:
    """One way of resolving a query batch (module docstring).

    ``engine`` is the owning engine (routes live and die with it);
    ``retry``/``breaker`` are the route's failure policy (None = the
    route is not retried / not breaker-gated). ``is_dispatch`` marks
    routes whose ``launch`` dispatches to the device; the pipelined
    engine runs their ``finish`` on its worker thread.
    """

    name: str = "route"
    is_dispatch = False
    #: a host-tier route (NumPy on every engine) degrades on any failure
    host_tier = False

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

    # ---- the two-stage solve seam ------------------------------------
    def launch(self, rt, pairs):
        """Stage 1: start solving ``pairs``. Returns ``(out, fin, t0)``
        for :meth:`finish`."""
        raise NotImplementedError

    def finish(self, out, fin, t0, pairs) -> list[BFSResult]:
        """Stage 2: materialize per-query results from what
        :meth:`launch` returned (host work: the pipelined engine runs it
        on a worker thread)."""
        raise NotImplementedError

    def solve(self, rt, pairs) -> list[BFSResult]:
        """One synchronous launch and finish (no retry policy)."""
        out, fin, t0 = self.launch(rt, pairs)
        return self.finish(out, fin, t0, pairs)

    # ---- the resilient synchronous wrapper ---------------------------
    def attempt(self, rt, pairs, *extra) -> list[BFSResult] | None:
        """Bounded retries with backoff behind the route breaker.
        Returns the batch results, or None when the route is
        unavailable (breaker open / retries exhausted) and the caller
        should degrade down the ladder; raises a failure the route may
        not degrade (:meth:`may_degrade`). ``extra`` rides to
        :meth:`solve` (the query-kind routes take their flush context
        there). The fault-free fast path is one
        ``allow()``/``record_success()`` pair per batch."""
        breaker = self.breaker
        retry = self.retry
        if breaker is not None and not breaker.allow():
            return None
        n_try = 0
        try:
            while True:
                try:
                    results = self.solve(rt, pairs, *extra)
                except Exception as exc:
                    if not self.may_degrade(exc):
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
        # a failure of the kernel or the card: the route decides what its
        # breaker makes of it (hard_failure)
        self.hard_failure(hard)
        raise hard

    def may_degrade(self, exc: BaseException) -> bool:
        """Whether a failure of this route may degrade down its ladder:
        always for a host-tier route (:attr:`host_tier`), else the
        engine's rule (``engine._may_degrade``: on a CUDA engine only an
        injected fault)."""
        return self.host_tier or self.engine._may_degrade(exc)

    def hard_failure(self, exc: BaseException) -> None:
        """The breaker's side of a failure the route may not degrade (the
        engine fails the batch's tickets): by default its claim is
        released uncounted, so the breaker only opens on degradable
        faults; the mesh route counts a dead pool."""
        if self.breaker is not None:
            self.breaker.release()

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
