"""The PyTorch port's additions to ``bibfs_tpu_torch.obs.trace`` and
``obs.metrics`` against the JAX package's on the CPU: ``Tracer.instant``
and ``instant`` (the same "i" event fields), ``uninstall_and_save`` (the
hook cleared, the file written, a bad path reported and not raised),
``overlapping_pairs`` (the same pairs from the same events, and from a
pipelined run, the launch overlapping the finish on another thread),
``LogHistogram.to_dict`` (the same export for the same samples) and
``MetricsRegistry.child_count``."""

import io
import json
import time

import numpy as np
import pytest


@pytest.fixture
def both_tracers():
    from bibfs_tpu.obs import trace as rtrace
    from bibfs_tpu_torch.obs import trace as ptrace

    out = []
    for mod in (rtrace, ptrace):
        t = mod.Tracer()
        prev = mod.set_tracer(t)
        out.append((mod, t, prev))
    try:
        yield out
    finally:
        for mod, _t, prev in out:
            mod.set_tracer(prev)


def _fields(ev):
    return {k: v for k, v in ev.items() if k not in ("ts", "pid", "tid")}


def test_instant_same_event(both_tracers):
    evs = []
    for mod, t, _prev in both_tracers:
        t.instant("mark", cat="c", a=1)
        mod.instant("global_mark", b=2)
        evs.append([_fields(e) for e in t.events() if e.get("ph") == "i"])
    assert evs[0] == evs[1]
    assert [e["name"] for e in evs[1]] == ["mark", "global_mark"]
    assert evs[1][0] == {"name": "mark", "cat": "c", "ph": "i", "s": "t",
                         "args": {"a": 1}}


def test_instant_disabled_is_noop():
    from bibfs_tpu_torch.obs import trace

    prev = trace.set_tracer(None)
    try:
        trace.instant("nothing", x=1)  # no tracer: no error, no event
    finally:
        trace.set_tracer(prev)


def test_uninstall_and_save(tmp_path, both_tracers):
    outs = []
    for mod, t, _prev in both_tracers:
        with mod.span("work", x=1):
            t.instant("tick")
        path = str(tmp_path / f"{mod.__name__}.json")
        stream = io.StringIO()
        nev = mod.uninstall_and_save(t, path, stream=stream)
        assert mod.get_tracer() is None
        events = json.load(open(path))
        outs.append((nev, len(events), stream.getvalue().split(" trace ")[0],
                     sorted(e["name"] for e in events if e.get("ph") != "M")))
        bad = io.StringIO()
        assert mod.uninstall_and_save(
            t, str(tmp_path / "no" / "dir.json"), stream=bad) is None
        assert bad.getvalue().startswith("warning: could not write trace")
    assert outs[0] == outs[1]
    assert outs[1][3] == ["tick", "work"]


def test_overlapping_pairs_same_as_reference():
    from bibfs_tpu.obs.trace import overlapping_pairs as ref_pairs
    from bibfs_tpu_torch.obs.trace import overlapping_pairs

    rng = np.random.default_rng(3)
    events = []
    for i in range(40):
        events.append({"name": "ab"[i % 2], "ph": "X",
                       "ts": float(rng.integers(0, 100)),
                       "dur": float(rng.integers(0, 20)),
                       "tid": int(rng.integers(0, 3))})
    events.append({"name": "a", "ph": "i", "ts": 5.0, "tid": 9})
    got = overlapping_pairs(events, "a", "b")
    assert got == ref_pairs(events, "a", "b")
    assert got and all(a["tid"] != b["tid"] for a, b in got)
    assert overlapping_pairs(events, "a", "zzz") == []


def test_pipelined_run_shows_overlapping_launch_and_finish():
    """A pipelined run on the device route (the plain twins on the CPU)
    records a ``device_launch`` span overlapping a ``device_finish`` span
    on another thread. The finish is stretched from inside its span (the
    banking runs under it), so the flusher's next launch lands mid-finish
    on any host, as in the JAX package's test."""
    from bibfs_tpu_torch.obs.trace import Tracer, overlapping_pairs, set_tracer
    from bibfs_tpu_torch.serve import ExecutableCache, PipelinedQueryEngine

    n = 220
    edges = [[i, i + 1] for i in range(n - 1)] + [[i, i + 7]
                                                 for i in range(n - 7)]
    tracer = Tracer()
    prev = set_tracer(tracer)
    eng = PipelinedQueryEngine(
        n, np.array(edges), device="cpu", flush_threshold=4, max_wait_ms=2.0,
        device_batches=True, cache_entries=0, exec_cache=ExecutableCache(),
    )
    real_bank = eng._bank_forests

    def slow_bank(pairs, par_s, par_t):
        time.sleep(0.01)
        real_bank(pairs, par_s, par_t)

    eng._bank_forests = slow_bank
    try:
        for w in range(6):
            for i in range(12):
                q = 12 * w + i
                eng.submit(q % n, (q + 60) % n)
            time.sleep(0.004)
        eng.flush(timeout=120.0)
    finally:
        eng.close()
        set_tracer(prev)
    evs = tracer.events()
    names = {e["name"] for e in evs}
    assert "device_launch" in names and "device_finish" in names
    assert overlapping_pairs(evs, "device_launch", "device_finish")


def test_log_histogram_to_dict_same_as_reference():
    from bibfs_tpu.obs.metrics import LogHistogram as RHist
    from bibfs_tpu_torch.obs.metrics import LogHistogram as PHist

    samples = np.random.default_rng(9).lognormal(-6, 2, size=500).tolist()
    samples += [0.0, 1e-9, 3600.0]
    r, p = RHist(), PHist()
    for s in samples:
        r.record(s)
        p.record(s)
    assert p.to_dict() == r.to_dict()
    d = p.to_dict()
    assert d["count"] == len(samples)
    assert sum(c for _i, c in d["buckets"]) == len(samples)
    assert PHist().to_dict()["buckets"] == []


def test_child_count_counts_labeled_cells():
    from bibfs_tpu.obs.metrics import MetricsRegistry as RReg
    from bibfs_tpu_torch.obs.metrics import MetricsRegistry

    counts = []
    for Reg in (RReg, MetricsRegistry):
        reg = Reg()
        base = reg.child_count()
        fam = reg.counter("x_total", "x", ("a",))
        fam.labels(a="1").inc()
        fam.labels(a="2")
        fam.labels(a="1").inc()
        reg.histogram("h_seconds", "h", ("s",)).labels(s="q").record(0.1)
        reg.gauge("g", "g").set(3)
        counts.append(reg.child_count() - base)
    assert counts[0] == counts[1] == 4
