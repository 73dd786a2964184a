"""The PyTorch port's resilience layer (``bibfs_tpu_torch.serve.
resilience`` and ``.faults``) and its integration through the port's
synchronous engine, held against ``bibfs_tpu.serve`` on the CPU: the
error taxonomy, retry backoff, the circuit-breaker lifecycle, the health
state machine, the fault grammar, and the fallback ladder device -> host
-> serial — device faults degrading to the host, the breaker opening and
recovering, the native batch dying and bisecting to the serial rung, a
poison query isolated to a ``QueryError``, and ``return_errors``. Each
engine scenario runs through both packages' engines with the same fault
spec; the answers (every ``BFSResult`` field except ``time_s``) and the
resilience accounting must be equal, and every answer oracle-correct."""

import time

import numpy as np
import pytest

FIELDS = ("found", "hops", "path", "meet", "levels", "edges_scanned")
RES_KEYS = ("errors", "fallbacks", "retries", "bisections")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    import torch

    torch.set_num_threads(2)


def _skiplink_graph(n: int) -> np.ndarray:
    edges = [[i, i + 1] for i in range(n - 1)]
    edges += [[i, i + 7] for i in range(n - 7)]
    return np.array(edges)


def _fresh(k, lo, span=50):
    return [(lo + i, lo + i + span) for i in range(k)]


def _outcome(r):
    return (type(r).__name__, getattr(r, "kind", None)) if isinstance(
        r, Exception) else tuple(getattr(r, f) for f in FIELDS)


def _check_oracle(n, edges, pairs, results):
    from bibfs_tpu_torch.solvers.serial import solve_serial

    for (src, dst), r in zip(pairs, results):
        ref = solve_serial(n, edges, int(src), int(dst))
        assert r.found == ref.found, (src, dst)
        if ref.found:
            assert r.hops == ref.hops, (src, dst)


def _engines(n, edges, spec=None, **kw):
    """The port's and the reference's engine over one graph, each with
    its own package's fault plan parsed from ``spec``."""
    from bibfs_tpu.serve import ExecutableCache as RefExec
    from bibfs_tpu.serve import FaultPlan as RefPlan
    from bibfs_tpu.serve import QueryEngine as RefEngine

    from bibfs_tpu_torch.serve import ExecutableCache, FaultPlan, QueryEngine

    port = QueryEngine(
        n, edges, device="cpu", exec_cache=ExecutableCache(),
        faults=None if spec is None else FaultPlan.parse(spec), **kw,
    )
    ref = RefEngine(
        n, edges, exec_cache=RefExec(),
        faults=None if spec is None else RefPlan.parse(spec), **kw,
    )
    return port, ref


def _same_resilience(port, ref):
    sp, sr = port.stats(), ref.stats()
    for key in RES_KEYS:
        assert sp["resilience"][key] == sr["resilience"][key], key
    assert sp["resilience"]["breaker"] == sr["resilience"]["breaker"]
    assert dict(port.counters) == dict(ref.counters)
    return sp


def _run_both(port, ref, pairs, **kw):
    got = port.query_many(pairs, **kw)
    want = ref.query_many(pairs, **kw)
    assert [_outcome(r) for r in got] == [_outcome(r) for r in want]
    return got


# ---- taxonomy, retry, breaker, health --------------------------------
@pytest.mark.parametrize("exc,kind", [
    (TimeoutError(), "timeout"), (RuntimeError("x"), "internal"),
    (ValueError("x"), "internal"), (KeyError("x"), "internal"),
])
def test_classification_equals_reference(exc, kind):
    from bibfs_tpu.serve.resilience import classify_exception as ref_classify
    from bibfs_tpu.serve.resilience import to_query_error as ref_wrap

    from bibfs_tpu_torch.serve.resilience import (
        QueryError,
        classify_exception,
        to_query_error,
    )

    assert classify_exception(exc) == ref_classify(exc) == kind
    got, want = to_query_error(exc, (1, 2)), ref_wrap(exc, (1, 2))
    assert isinstance(got, QueryError)
    assert (got.kind, got.query, str(got)) == (want.kind, want.query, str(want))
    assert to_query_error(got) is got  # already structured: no re-wrap


def test_query_error_taxonomy():
    from bibfs_tpu_torch.serve import QueryError
    from bibfs_tpu_torch.serve.resilience import to_query_error

    e = QueryError("boom", kind="capacity", query=(3, 9))
    assert e.kind == "capacity" and e.query == (3, 9)
    assert "capacity" in str(e) and "3->9" in str(e)
    with pytest.raises(ValueError):
        QueryError("x", kind="mystery")
    w = to_query_error(ValueError("bad id"), (1, 2), kind="invalid")
    assert w.kind == "invalid"


def test_retry_policy_equals_reference():
    from bibfs_tpu.serve import RetryPolicy as RefRetry

    from bibfs_tpu_torch.serve import RetryPolicy

    p = RetryPolicy(attempts=4, base_ms=2.0, max_ms=10.0, jitter=0.5)
    for attempt, nominal in enumerate([2.0, 4.0, 8.0, 10.0]):
        for _ in range(20):
            assert 0.5 * nominal <= p.delay_s(attempt) * 1e3 <= 1.5 * nominal
    with pytest.raises(ValueError):
        RetryPolicy(attempts=0)
    with pytest.raises(ValueError):
        RetryPolicy(jitter=2.0)
    a, b = RetryPolicy(seed=3), RefRetry(seed=3)
    assert [a.delay_s(k % 3) for k in range(8)] == [
        b.delay_s(k % 3) for k in range(8)]
    assert a.snapshot() == b.snapshot()


def test_breaker_lifecycle_equals_reference():
    """One scripted failure/recovery sequence drives both packages'
    breakers through the same states and transitions."""
    from bibfs_tpu.serve import CircuitBreaker as RefBreaker

    from bibfs_tpu_torch.serve import CircuitBreaker

    logs = []
    for cls in (CircuitBreaker, RefBreaker):
        t = [0.0]
        transitions = []
        br = cls(fail_threshold=2, reset_s=10.0, clock=lambda: t[0],
                 on_transition=transitions.append)
        log = [br.state, br.allow()]
        br.record_failure()
        log.append(br.state)
        br.record_failure()
        log += [br.state, br.allow()]
        t[0] = 10.5
        log += [br.state, br.allow(), br.allow()]
        br.record_failure()
        log += [br.state, br.allow()]
        t[0] = 21.0
        log.append(br.allow())
        br.record_success()
        log += [br.state, br.allow(), transitions, br.snapshot()]
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[0][-2] == ["open", "half_open", "open", "half_open", "closed"]
    assert logs[0][-1]["opens"] == 2


def test_breaker_success_resets_consecutive_count():
    from bibfs_tpu_torch.serve import CircuitBreaker

    br = CircuitBreaker(fail_threshold=3)
    for outcome in ("f", "f", "s", "f", "f"):
        br.record_failure() if outcome == "f" else br.record_success()
    assert br.state == "closed"  # never 3 consecutive


def test_health_state_machine():
    from bibfs_tpu_torch.serve import CircuitBreaker, HealthMonitor
    from bibfs_tpu_torch.serve.resilience import healthz_status

    t = [0.0]
    br = CircuitBreaker(fail_threshold=1, reset_s=100.0, clock=lambda: t[0])
    depth = [0]
    h = HealthMonitor(breaker=br, window_s=5.0, queue_depth=lambda: depth[0],
                      max_queue=10, clock=lambda: t[0])
    assert h.state()[0] == "live"
    h.set_ready()
    assert h.state()[0] == "ready"
    br.record_failure()
    state, reasons = h.state()
    assert state == "degraded" and any("breaker" in r for r in reasons)
    br.record_success()
    h.note_error()
    assert h.state()[0] == "degraded"
    t[0] += 6.0
    assert h.state()[0] == "ready"  # recent errors age out
    depth[0] = 9
    state, reasons = h.state()
    assert state == "degraded" and any("queue" in r for r in reasons)
    depth[0] = 0
    h.set_draining()
    assert h.state()[0] == "draining"
    h.clear_draining()
    assert h.state()[0] == "ready"
    assert [healthz_status(s) for s in ("ready", "degraded", "live",
                                        "draining")] == [200, 200, 503, 503]


# ---- fault grammar ---------------------------------------------------
@pytest.mark.parametrize("spec", [
    "device:p=0.15", "host_batch:every=4,kind=latency,ms=20",
    "host_batch:pair=7-19,times=3", "device;device_finish:times=2",
    "mesh:every=2",
    # rejected by both: unknown site, unknown field, p with every, bad p
    "bogus:p=0.1", "device:frequency=2", "device:p=0.1,every=2",
    "device:p=1.5", "device:pair=7", "",
])
def test_fault_grammar_equals_reference(spec):
    from bibfs_tpu.serve import FaultPlan as RefPlan

    from bibfs_tpu_torch.serve import FaultPlan

    def parse(cls):
        try:
            return repr(cls.parse(spec))
        except ValueError as e:
            return ("ValueError", str(e))

    assert parse(FaultPlan) == parse(RefPlan)


def test_fault_firing_equals_reference():
    """Seeded probabilistic, periodic, capped and pair-targeted rules fire
    on the same calls in both packages."""
    from bibfs_tpu.serve import FaultPlan as RefPlan

    from bibfs_tpu_torch.serve import FaultPlan, InjectedFault

    spec = "device:p=0.5;device_finish:every=3;host_batch:pair=1-2,times=2"
    traces = []
    for cls in (FaultPlan, RefPlan):
        plan = cls.parse(spec, seed=7)
        trace = []
        for i in range(12):
            for site, pairs in (("device", None), ("device_finish", None),
                                ("host_batch", [(1, 2)] if i % 2 else [(0, 5)])):
                try:
                    plan.fire(site, pairs)
                    trace.append(0)
                except RuntimeError as e:
                    trace.append(str(e))
        plan.set_active(False)
        plan.fire("device")
        traces.append((trace, plan.stats()))
    assert traces[0] == traces[1]
    assert traces[0][1]["fired_total"] > 0
    with pytest.raises(InjectedFault):
        FaultPlan.parse("device").fire("device")


# ---- engine integration: the fallback ladder -------------------------
def test_device_fault_falls_back_to_host():
    n = 220
    edges = _skiplink_graph(n)
    port, ref = _engines(n, edges, "device:every=1", flush_threshold=8,
                         device_batches=True)
    pairs = _fresh(12, 0)
    _check_oracle(n, edges, pairs, _run_both(port, ref, pairs))
    st = _same_resilience(port, ref)["resilience"]
    assert st["fallbacks"]["device->host"] == 1
    assert st["retries"] >= 1
    assert st["errors"] == {k: 0 for k in st["errors"]}  # no ticket died
    assert port.counters["host_queries"] == 12


def test_device_finish_fault_falls_back_to_host():
    n = 220
    edges = _skiplink_graph(n)
    port, ref = _engines(n, edges, "device_finish:every=1", flush_threshold=8,
                         device_batches=True)
    pairs = _fresh(10, 3)
    _check_oracle(n, edges, pairs, _run_both(port, ref, pairs))
    st = _same_resilience(port, ref)["resilience"]
    assert st["fallbacks"]["device->host"] == 1
    assert port.counters["device_batches"] == 0


def test_transient_device_fault_retries_in_place():
    """times=1: the first dispatch fails and the retry succeeds — no
    fallback, no ticket failure, the breaker stays closed."""
    n = 220
    edges = _skiplink_graph(n)
    port, ref = _engines(n, edges, "device:times=1", flush_threshold=8,
                         device_batches=True)
    pairs = _fresh(10, 0)
    _check_oracle(n, edges, pairs, _run_both(port, ref, pairs))
    st = _same_resilience(port, ref)["resilience"]
    assert st["retries"] == 1
    assert st["fallbacks"]["device->host"] == 0
    assert st["breaker"]["state"] == "closed"
    assert port.counters["device_batches"] == 1


def test_breaker_opens_gates_device_then_recovers():
    n = 220
    edges = _skiplink_graph(n)
    port, ref = _engines(n, edges, "device:every=1", flush_threshold=8,
                         device_batches=True)
    for eng in (port, ref):
        eng.query_many(_fresh(10, 0))   # 2 consecutive failures
        eng.query_many(_fresh(10, 60))  # the 3rd opens the breaker
    st = _same_resilience(port, ref)
    assert st["resilience"]["breaker"]["state"] == "open"
    assert st["health"]["state"] == "degraded"
    # the open breaker short-circuits the device route: the fault seam is
    # not even reached
    fired = port._faults.stats()["fired_total"]
    _run_both(port, ref, _fresh(10, 100))
    assert port._faults.stats()["fired_total"] == fired
    for eng in (port, ref):
        eng._faults.set_active(False)
        eng._breaker.reset_s = 0.01
    time.sleep(0.05)
    results = _run_both(port, ref, _fresh(10, 120))
    _check_oracle(n, edges, _fresh(10, 120), results)
    st = _same_resilience(port, ref)
    assert st["resilience"]["breaker"]["state"] == "closed"
    assert st["health"]["state"] == "ready"
    assert st["resilience"]["breaker"]["opens"] == 1
    assert port.counters["device_batches"] == 1


def test_host_batch_fault_bisects_to_serial_rung():
    """The native batch seam dies wholesale: bisection drills down and
    every query still resolves through the serial rung."""
    n = 150
    edges = _skiplink_graph(n)
    port, ref = _engines(n, edges, "host_batch:every=1", flush_threshold=1000)
    pairs = _fresh(8, 0)
    _check_oracle(n, edges, pairs, _run_both(port, ref, pairs))
    st = _same_resilience(port, ref)["resilience"]
    assert st["bisections"] >= 1
    assert st["fallbacks"]["host->serial"] == 8  # every singleton
    assert st["errors"]["internal"] == 0


def test_poison_query_fails_alone_with_structured_error():
    """One poisoned query (its batch raises whenever it is present AND
    its serial rung is broken) fails exactly its ticket; its 7 peers
    resolve oracle-correct, in both packages alike."""
    from bibfs_tpu_torch.serve import QueryError

    n = 150
    edges = _skiplink_graph(n)
    poison = (3, 53)
    port, ref = _engines(n, edges, f"host_batch:pair={poison[0]}-{poison[1]}",
                         flush_threshold=1000)
    for eng in (port, ref):
        real = eng._solve_serial_one

        def broken(src, dst, *rest, _real=real):
            if (src, dst) == poison:
                raise RuntimeError("serial rung poisoned too")
            return _real(src, dst, *rest)

        eng._solve_serial_one = broken
    pairs = _fresh(8, 0)
    out = _run_both(port, ref, pairs, return_errors=True)
    for (s, d), r in zip(pairs, out):
        if (s, d) == poison:
            assert isinstance(r, QueryError)
            assert r.kind == "internal" and r.query == poison
        else:
            _check_oracle(n, edges, [(s, d)], [r])
    st = _same_resilience(port, ref)
    assert st["resilience"]["errors"]["internal"] == 1
    assert st["resilience"]["bisections"] >= 1
    assert st["health"]["state"] == "degraded"
    with pytest.raises(QueryError, match="internal"):
        port.query_many([poison])


def test_query_many_return_errors_invalid_inputs():
    from bibfs_tpu_torch.serve import QueryError

    port, ref = _engines(50, np.array([[0, 1], [1, 2]]))
    out = _run_both(port, ref, [(0, 2), (0, 10 ** 9), (1, 2), (1,)],
                    return_errors=True)
    assert out[0].found and out[2].found
    assert isinstance(out[1], QueryError) and out[1].kind == "invalid"
    assert out[3].kind == "invalid" and out[3].query is None
    assert _same_resilience(port, ref)["resilience"]["errors"]["invalid"] == 2
    with pytest.raises(ValueError):
        port.query_many([(0, 10 ** 9)])


def test_latency_fault_slows_but_never_fails():
    n = 150
    edges = _skiplink_graph(n)
    port, _ref = _engines(n, edges, "host_batch:every=1,kind=latency,ms=20",
                          flush_threshold=1000)
    t0 = time.perf_counter()
    results = port.query_many(_fresh(5, 0))
    assert time.perf_counter() - t0 >= 0.015
    _check_oracle(n, edges, _fresh(5, 0), results)
    st = port.stats()["resilience"]
    assert st["fallbacks"]["host->serial"] == 0
    assert st["errors"]["internal"] == 0
    assert st["faults"]["fired_total"] == 1


def test_faults_from_env_reach_engine(monkeypatch):
    from bibfs_tpu_torch.serve import QueryEngine
    from bibfs_tpu_torch.serve.faults import ENV_VAR

    n = 150
    edges = _skiplink_graph(n)
    monkeypatch.setenv(ENV_VAR, "host_batch:every=1")
    eng = QueryEngine(n, edges, flush_threshold=1000, device="cpu")
    _check_oracle(n, edges, _fresh(6, 0), eng.query_many(_fresh(6, 0)))
    st = eng.stats()["resilience"]
    assert st["faults"]["fired_total"] >= 1
    assert st["fallbacks"]["host->serial"] == 6


def test_client_errors_do_not_degrade_health():
    from bibfs_tpu_torch.serve import QueryEngine, QueryError

    eng = QueryEngine(50, np.array([[0, 1], [1, 2]]), device="cpu")
    for _ in range(5):
        out = eng.query_many([(0, 10 ** 9)], return_errors=True)
        assert isinstance(out[0], QueryError)
    st = eng.stats()
    assert st["resilience"]["errors"]["invalid"] == 5
    assert st["health"]["state"] == "ready"
    assert st["health"]["recent_errors"] == 0


def test_shared_breaker_updates_every_engines_gauge():
    from bibfs_tpu_torch.obs.metrics import REGISTRY
    from bibfs_tpu_torch.serve import CircuitBreaker, QueryEngine

    edges = np.array([[0, 1], [1, 2]])
    shared = CircuitBreaker(fail_threshold=1)
    a = QueryEngine(30, edges, breaker=shared, device="cpu")
    b = QueryEngine(30, edges, breaker=shared, device="cpu")
    gauges = [REGISTRY.gauge("bibfs_breaker_state", "", ("engine",))
              .labels(engine=e.obs_label) for e in (a, b)]
    assert [g.value for g in gauges] == [0, 0]
    shared.record_failure()  # -> open
    assert [g.value for g in gauges] == [2, 2]
    assert a.health_snapshot()["state"] == "degraded"
    assert b.health_snapshot()["state"] == "degraded"


def test_breaker_metrics_track_state():
    from bibfs_tpu_torch.obs.metrics import REGISTRY
    from bibfs_tpu_torch.serve import (
        CircuitBreaker,
        ExecutableCache,
        FaultPlan,
        QueryEngine,
    )

    n = 220
    eng = QueryEngine(n, _skiplink_graph(n), flush_threshold=8,
                      device_batches=True, device="cpu",
                      faults=FaultPlan.parse("device:every=1"),
                      exec_cache=ExecutableCache(),
                      breaker=CircuitBreaker(fail_threshold=2))
    gauge = REGISTRY.gauge("bibfs_breaker_state", "", ("engine",)).labels(
        engine=eng.obs_label)
    assert gauge.value == 0
    eng.query_many(_fresh(10, 0))  # 2 failures -> open
    assert gauge.value == 2
    trans = REGISTRY.counter("bibfs_breaker_transitions_total", "",
                             ("engine", "to")).labels(engine=eng.obs_label,
                                                      to="open")
    assert trans.value == 1
    text = REGISTRY.render()
    assert f'bibfs_route_fallbacks_total{{engine="{eng.obs_label}",from="device",to="host"}} 1' in text


# ---- a CUDA engine degrades injected faults only ----------------------
def _cuda_typed_engine(monkeypatch, n, edges, **kw):
    """A port engine whose device reads as ``cuda`` (no card needed:
    ``mode="sync"`` builds no kernel and no flush here reaches a tensor
    on the card)."""
    import torch

    from bibfs_tpu_torch.serve import ExecutableCache, QueryEngine
    from bibfs_tpu_torch.serve import engine as engine_mod

    monkeypatch.setattr(engine_mod, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    return QueryEngine(n, edges, mode="sync", host_backend="serial",
                       exec_cache=ExecutableCache(), **kw)


def _card_fault(pairs):
    raise RuntimeError("bibfs_minor_level: CUDA launch failed (719)")


@pytest.mark.parametrize("failure", ["launch", "out_of_memory"])
def test_cuda_engine_fails_tickets_instead_of_host(monkeypatch, failure):
    """A device flush that fails on the card fails its tickets with a
    ``kind='internal'`` QueryError: no retry, no fallback, nothing
    answered on the host, and the breaker never opens however often it
    happens."""
    from bibfs_tpu_torch.serve import QueryError

    n = 220
    eng = _cuda_typed_engine(monkeypatch, n, _skiplink_graph(n),
                             flush_threshold=4)
    exc = (RuntimeError("bibfs_minor_level: CUDA launch failed (719)")
           if failure == "launch" else MemoryError("CUDA out of memory"))

    def broken(pairs):
        raise exc

    eng._device_solve = broken
    for wave in range(4):
        out = eng.query_many(_fresh(6, 10 * wave), return_errors=True)
        assert all(isinstance(r, QueryError) and r.kind == "internal"
                   and r.cause is exc for r in out)
    with pytest.raises(QueryError, match="internal"):
        eng.query_many(_fresh(6, 100))
    st = eng.stats()
    res = st["resilience"]
    assert not any(res["fallbacks"].values()) and res["retries"] == 0
    assert res["errors"]["internal"] == 30
    assert res["breaker"]["state"] == "closed" and res["breaker"]["opens"] == 0
    assert st["host_queries"] == st["device_queries"] == 0
    # below the crossover the host route is a routing decision, not a degrade
    assert eng.query_many(_fresh(3, 150))[0].found
    assert eng.counters["host_queries"] == 3


def test_cuda_engine_degrades_injected_faults_only(monkeypatch):
    """On a CUDA engine the chaos seam still drives the ladder: an
    injected fault retries, opens the breaker and degrades to the host,
    counted. A card failure during the half-open probe that follows
    fails its tickets and frees the probe without a recorded outcome."""
    from bibfs_tpu_torch.serve import (
        CircuitBreaker,
        FaultPlan,
        QueryError,
        RetryPolicy,
    )

    n = 220
    edges = _skiplink_graph(n)
    eng = _cuda_typed_engine(
        monkeypatch, n, edges, flush_threshold=4,
        faults=FaultPlan.parse("device:times=2"),
        retry=RetryPolicy(2, base_ms=0.0),
        breaker=CircuitBreaker(fail_threshold=2, reset_s=0.0),
    )
    pairs = _fresh(6, 0)
    _check_oracle(n, edges, pairs, eng.query_many(pairs))
    res = eng.stats()["resilience"]
    assert res["fallbacks"]["device->host"] == 1 and res["retries"] == 1
    assert res["breaker"]["opens"] == 1
    assert eng.counters["host_queries"] == 6
    eng._device_solve = _card_fault
    for lo in (20, 40):  # the probe is freed each time: allow() admits again
        out = eng.query_many(_fresh(6, lo), return_errors=True)
        assert all(isinstance(r, QueryError) and r.kind == "internal"
                   for r in out)
    res = eng.stats()["resilience"]
    assert res["fallbacks"]["device->host"] == 1
    assert res["breaker"]["state"] == "half_open"
    assert res["breaker"]["opens"] == 1
    assert eng.counters["host_queries"] == 6


def test_breaker_release_frees_the_probe_without_an_outcome():
    from bibfs_tpu_torch.serve import CircuitBreaker

    now = [0.0]
    br = CircuitBreaker(fail_threshold=1, reset_s=1.0, clock=lambda: now[0])
    assert br.allow()
    br.release()  # closed: nothing claimed, nothing moves
    assert br.snapshot()["consecutive_failures"] == 0
    br.record_failure()
    assert br.state == "open" and not br.allow()
    now[0] = 2.0
    assert br.allow() and not br.allow()  # the probe is claimed
    br.release()
    assert br.state == "half_open" and br.allow()
    br.record_success()
    assert br.state == "closed"
