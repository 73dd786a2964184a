"""The PyTorch port's distributed tracing (``bibfs_tpu_torch.obs.dtrace``)
against ``bibfs_tpu.obs.dtrace`` on the CPU: context fields and tokens
across the packages; the disabled path (no tracer, rate 0, unsampled
submits minting no metric cell); the spool and the merger (the same span
sequence spooled by both packages and merged by both into reports of
equal structure: parentage, stage spans, orphan flags, a torn tail
tolerated); the ``trace_flush`` seam; the flight recorder (bounded ring,
dump on an injected device fault, the pipelined engine's notes);
sampled queries' ``queue`` / ``resolve`` spans through both engines; the
stdin loop's ``@t:`` tokens; and a traced query through a
``bibfs-torch-serve --port`` child merged across the two processes.

The tracer, ``FLIGHT`` and the registry are process-wide: every test
that installs a tracer or arms a dump path restores them in a
``finally``."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from bibfs_tpu_torch.obs import dtrace
from bibfs_tpu_torch.obs.dtrace import (
    STAGES,
    DTracer,
    FlightRecorder,
    TraceContext,
    cross_process_traces,
    ctx_fields,
    ctx_from_fields,
    ctx_token,
    dspan,
    merge_spools,
    parse_token,
    read_spool,
    set_dtracer,
    stage_histogram,
)

N = 400
WAIT_S = 60.0


def _skiplink_graph(n: int) -> np.ndarray:
    edges = [[i, i + 1] for i in range(n - 1)]
    edges += [[i, i + 7] for i in range(n - 7)]
    return np.array(edges)


EDGES = _skiplink_graph(N)


@pytest.fixture
def tracer(tmp_path):
    """A fresh installed port DTracer; uninstalled and closed on exit."""
    t = DTracer(str(tmp_path / "spool"), "testproc", sample=1.0)
    prev = set_dtracer(t)
    try:
        yield t
    finally:
        set_dtracer(prev)
        t.close()


def _pipe(**kw):
    from bibfs_tpu_torch.serve.pipeline import PipelinedQueryEngine

    return PipelinedQueryEngine(N, EDGES, device="cpu", **kw)


# ---- wire encodings -----------------------------------------------------

CTX_FIELDS = [
    {}, {"trace": 42}, {"trace": ""}, {"trace": "ab" * 16},
    {"trace": "ab" * 16, "span": "cd" * 8}, {"trace": "t", "span": 7},
    {"trace": ["x"], "span": "s"}, {"span": "only"},
]
TOKENS = ["@t:", "not-a-token", "@t:abc", "@t:abc:def", "@t::def",
          "@t:a:b:c", "@T:abc:def", "@t:" + "ab" * 16 + ":" + "cd" * 8]


def test_ctx_fields_and_tokens_agree_with_reference():
    from bibfs_tpu.obs import dtrace as ref

    assert (dtrace.ENV_SPOOL, dtrace.ENV_SAMPLE, dtrace.ENV_FLIGHTREC,
            dtrace.TOKEN_PREFIX, dtrace.STAGES) == (
        ref.ENV_SPOOL, ref.ENV_SAMPLE, ref.ENV_FLIGHTREC, ref.TOKEN_PREFIX,
        ref.STAGES)

    def pair(c):
        return None if c is None else (c.trace_id, c.span_id)

    for msg in CTX_FIELDS:
        assert pair(ctx_from_fields(msg)) == pair(ref.ctx_from_fields(msg))
    for tok in TOKENS:
        assert pair(parse_token(tok)) == pair(ref.parse_token(tok))
    for trace, span in (("aa" * 16, "bb" * 8), ("t", ""), ("x", "y")):
        mine, theirs = TraceContext(trace, span), ref.TraceContext(trace, span)
        assert ctx_fields(mine) == ref.ctx_fields(theirs)
        assert ctx_token(mine) == ref.ctx_token(theirs)
        # each package adopts the other's encodings
        assert pair(ctx_from_fields(ref.ctx_fields(theirs))) == (trace, span)
        assert pair(ref.parse_token(ctx_token(mine))) == (trace, span)
        assert repr(mine) == repr(theirs)
    assert ctx_fields(None) == {} == ref.ctx_fields(None)


# ---- disabled path ----------------------------------------------------------

def test_disabled_sampling_is_the_shared_noop(tracer):
    set_dtracer(None)
    assert dspan("x", None) is dspan("y", None)
    assert dspan("x", TraceContext("t")) is dspan("y", None)
    assert dtrace.sample_ctx() is None
    set_dtracer(tracer)
    assert dspan("x", None) is dspan("y", None)
    sp = dspan("x", None)
    assert sp.ctx is None
    sp.finish(ignored=1)
    with sp:
        pass
    dtrace.emit_span("queue", None, time.perf_counter(), 0.001)
    assert read_spool(tracer.path) == ([], 0)


@pytest.mark.parametrize("rate", [0.0, -1.0])
def test_sample_rate_zero_never_samples(tmp_path, rate):
    t = DTracer(str(tmp_path), "p", sample=rate)
    try:
        assert t.sample_rate == 0.0
        assert all(t.sample() is None for _ in range(256))
    finally:
        t.close()


def test_sample_rate_one_always_samples_root_contexts(tmp_path):
    t = DTracer(str(tmp_path), "p", sample=2.0)
    try:
        assert t.sample_rate == 1.0
        ctxs = [t.sample() for _ in range(64)]
        assert all(c is not None and c.span_id == "" and len(c.trace_id) == 32
                   for c in ctxs)
        assert len({c.trace_id for c in ctxs}) == 64
    finally:
        t.close()


def test_unsampled_submits_mint_no_metric_cells(tracer):
    """With a tracer installed but the queries unsampled (ctx=None), the
    pre-labeled cells stay the only ones: no registry object per query."""
    from bibfs_tpu_torch.obs.metrics import REGISTRY
    from bibfs_tpu_torch.solvers.serial import solve_serial

    eng = _pipe(max_wait_ms=5.0)
    try:
        eng.submit(0, 50).wait(timeout=WAIT_S)  # warm every lazy mint
        before = REGISTRY.child_count()
        for s, d in ((1, 60), (2, 70), (3, 80), (4, 4)):
            res = eng.submit(s, d, ctx=None).wait(timeout=WAIT_S)
            assert res.hops == solve_serial(N, EDGES, s, d).hops
        assert REGISTRY.child_count() == before
        assert read_spool(tracer.path) == ([], 0)
    finally:
        eng.close()


# ---- spool + merger -----------------------------------------------------------

def _span_sequence(mod, tracer):
    """One fixed span sequence: a root with a child, a retrospective
    stage span, a second trace with an orphan, then a torn tail."""
    ctx = tracer.sample()
    with mod.dspan("ingress_test", ctx, src=0, dst=9) as root:
        child = mod.dspan("inner", root.ctx)
        child.finish(batch=3)
    t0 = time.perf_counter() - 0.01
    mod.emit_span("queue", root.ctx, t0, 0.005)
    mod.emit_span("resolve", root.ctx, t0 + 0.005, 0.005)
    ctx2 = tracer.sample()
    mod.dspan("ok", ctx2).finish()
    mod.emit_span("orphan", mod.TraceContext(ctx2.trace_id, "feed" * 4),
                  time.perf_counter(), 0.001)
    try:
        with mod.dspan("raises", ctx2):
            raise KeyError("x")
    except KeyError:
        pass
    with open(tracer.path, "a") as f:
        f.write('{"t":"x","s":"y","n":"torn"')
    return ctx, root, ctx2


def _shape(report: dict, ctxs) -> dict:
    """A merge report with its random ids, pids and times mapped away."""
    ids = {}

    def norm(v):
        return ids.setdefault(v, f"id{len(ids)}")

    for c in ctxs:
        norm(c)
    traces = sorted(
        (norm(t["trace"]), t["spans"], t["procs"], t["orphan_parents"],
         len(t["pids"])) for t in report["traces"])
    events = []
    for ev in report["events"]:
        if ev["ph"] == "M":
            events.append(("M", ev["args"]["name"]))
            continue
        a = dict(ev["args"])
        events.append((ev["name"], ev["cat"], norm(a.pop("trace")),
                       norm(a.pop("span")),
                       norm(a.pop("parent")) if "parent" in a else None,
                       tuple(sorted(a.items()))))
    return {"files": report["files"], "spans": report["spans"],
            "truncated_lines": report["truncated_lines"],
            "orphan_parents": report["orphan_parents"],
            "traces": traces, "events": sorted(events, key=str)}


def test_both_packages_spool_and_merge_to_equal_structure(tmp_path):
    from bibfs_tpu.obs import dtrace as ref

    shapes = []
    for mod in (ref, dtrace):
        spool = str(tmp_path / mod.__name__)
        t = mod.DTracer(spool, "proc", sample=1.0)
        prev = mod.set_dtracer(t)
        try:
            ctx, root, ctx2 = _span_sequence(mod, t)
        finally:
            mod.set_dtracer(prev)
            t.close()
        recs, bad = read_spool(t.path)
        assert bad == 1 and len(recs) == 7
        assert recs == ref.read_spool(t.path)[0]
        # either merger reads either package's spool the same way
        for merger in (ref, dtrace):
            rep = merger.merge_spools(spool)
            shapes.append(_shape(rep, [ctx.trace_id, root.ctx.span_id,
                                       ctx2.trace_id]))
        assert (dtrace.cross_process_traces(rep, min_procs=1)
                == ref.cross_process_traces(rep, min_procs=1))
        assert dtrace.main(["merge", spool]) == ref.main(["merge", spool])
    assert all(s == shapes[0] for s in shapes)
    shape = shapes[0]
    assert shape["truncated_lines"] == 1 and shape["orphan_parents"] == 1
    assert [t[1:4] for t in shape["traces"]] in (
        [(4, ["proc"], 0), (3, ["proc"], 1)],
        [(3, ["proc"], 1), (4, ["proc"], 0)])
    # the stage spans hang under the ingress span, the child under it too
    named = {e[0]: e for e in shape["events"] if e[0] != "M"}
    assert named["queue"][4] == named["resolve"][4] == named["inner"][4] \
        == named["ingress_test"][3]
    assert dict(named["raises"][5])["error"] == "KeyError"


def test_merge_writes_perfetto_json(tmp_path, tracer):
    ctx = tracer.sample()
    with dspan("ingress_test", ctx, src=0, dst=9) as root:
        dspan("inner", root.ctx).finish(batch=3)
    out = tmp_path / "merged.json"
    rep = merge_spools(tracer.spool_dir, out_path=str(out))
    events = json.load(open(out))
    assert events == json.loads(json.dumps(rep["events"]))
    assert [e["ph"] for e in events].count("X") == 2
    meta = [e for e in events if e["ph"] == "M"]
    assert meta and meta[0]["args"]["name"] == "testproc"
    inner = next(e for e in events if e["name"] == "inner")
    assert inner["args"]["parent"] == root.ctx.span_id
    assert min(e["ts"] for e in events if e["ph"] == "X") == 0.0
    assert dtrace.main(["merge", tracer.spool_dir, "-o", str(out)]) == 0
    assert dtrace.main(["merge", tracer.spool_dir, "--min-procs", "2"]) == 1
    assert dtrace.main(["merge", str(tmp_path / "nope")]) == 2


def test_trace_flush_chaos_seam_drops_spans_not_queries(tmp_path):
    from bibfs_tpu_torch.serve.faults import FaultPlan

    plan = FaultPlan.parse("trace_flush:times=1")
    t = DTracer(str(tmp_path), "p", sample=1.0, faults=plan)
    try:
        ctx = t.sample()
        t.span("a", ctx).finish()  # eaten by the injected fault
        t.span("b", ctx).finish()
        assert t.dropped == 1
        recs, _ = read_spool(t.path)
        assert [r["n"] for r in recs] == ["b"]
    finally:
        t.close()


def test_spool_write_after_close_drops_not_raises(tmp_path):
    t = DTracer(str(tmp_path), "p", sample=1.0)
    t.close()
    t.span("late", t.sample()).finish()
    assert t.dropped == 1


def test_span_records_match_reference_fields(tmp_path):
    from bibfs_tpu.obs import dtrace as ref

    keys = []
    for mod in (ref, dtrace):
        t = mod.DTracer(str(tmp_path / mod.__name__), "p", sample=1.0)
        try:
            ctx = t.sample()
            sp = t.span("a", ctx, x=1)
            t.span("b", sp.ctx).finish(y=2)
            sp.finish()
            sp.finish()  # idempotent
            t.emit("c", sp.ctx, time.perf_counter(), 0.0, z=3)
            recs, _ = read_spool(t.path)
            keys.append([(r["n"], sorted(r), r.get("a"), r["pr"])
                         for r in recs])
            assert t.path.endswith(f"p.{os.getpid()}.jsonl")
        finally:
            t.close()
    assert keys[0] == keys[1]


def test_install_from_env(tmp_path):
    from bibfs_tpu_torch.obs.dtrace import FLIGHT

    assert dtrace.install_from_env("x", environ={}) is None
    spool = str(tmp_path / "spool")
    prev = dtrace.get_dtracer()
    old_path = FLIGHT._dump_path
    try:
        t = dtrace.install_from_env(
            "serve", environ={dtrace.ENV_SPOOL: spool,
                              dtrace.ENV_SAMPLE: "0.25"})
        assert dtrace.get_dtracer() is t and t.sample_rate == 0.25
        assert t.path == os.path.join(spool, f"serve.{os.getpid()}.jsonl")
        assert FLIGHT.snapshot()["dump_path"] == os.path.join(
            spool, f"serve.{os.getpid()}.flightrec.json")
        t.close()
        t = dtrace.install_from_env(
            "serve", environ={dtrace.ENV_SPOOL: spool,
                              dtrace.ENV_SAMPLE: "junk"})
        assert t.sample_rate == 1.0
        t.close()
    finally:
        set_dtracer(prev)
        FLIGHT._dump_path = old_path


# ---- stage attribution -----------------------------------------------------

def test_stage_histogram_cells_and_engine_stage_stats():
    from bibfs_tpu_torch.obs.metrics import REGISTRY

    cells = stage_histogram()
    assert set(cells) == set(STAGES)
    eng = _pipe(max_wait_ms=5.0)
    try:
        for s, d in ((0, 50), (5, 90), (7, 140)):
            eng.submit(s, d).wait(timeout=WAIT_S)
        flat: dict = {}
        for acc in eng.stats()["stages"].values():
            for stage, cell in acc.items():
                f = flat.setdefault(stage, [0, 0.0])
                f[0] += cell["n"]
                f[1] += cell["s"]
        assert flat["queue"][0] >= 3
        for st in ("launch", "resolve"):
            assert flat[st][0] >= 1 and flat[st][1] >= 0.0
        assert 'bibfs_stage_seconds_count{stage="queue"}' in REGISTRY.render()
    finally:
        eng.close()


# ---- sampled queries through the engines -----------------------------------

def _spans(path):
    recs, bad = read_spool(path)
    assert bad == 0
    return recs


def test_sampled_queries_emit_queue_and_resolve_under_ingress(tracer):
    """A sampled ticket's timeline becomes ``queue`` and ``resolve`` spans
    parented under the context it was submitted with (a trivial one only
    ``resolve``), and a flight-recorder ``query`` note; the reference
    engine emits the same span names for the same submits."""
    from bibfs_tpu.obs import dtrace as ref
    from bibfs_tpu.serve.pipeline import PipelinedQueryEngine as RPipe
    from bibfs_tpu_torch.obs.dtrace import FLIGHT

    pairs = [(0, 50), (3, 3), (9, 300)]
    shapes = []
    for mod, make in ((dtrace, lambda: _pipe(max_wait_ms=5.0)),
                      (ref, lambda: RPipe(N, EDGES, max_wait_ms=5.0))):
        t = tracer if mod is dtrace else ref.DTracer(
            tracer.spool_dir + "-ref", "testproc")
        prev = mod.set_dtracer(t)
        eng = make()
        try:
            roots = []
            for s, d in pairs:
                sp = mod.dspan("ingress", t.sample(), src=s, dst=d)
                eng.submit(s, d, ctx=sp.ctx).wait(timeout=WAIT_S)
                sp.finish()
                roots.append(sp)
        finally:
            eng.close()
            mod.set_dtracer(prev)
        recs = _spans(t.path)
        shape = []
        for sp in roots:
            kids = sorted(r["n"] for r in recs
                          if r["t"] == sp.ctx.trace_id
                          and r.get("p") == sp.ctx.span_id)
            shape.append(kids)
        shapes.append(shape)
        if mod is dtrace:
            notes = [e for e in FLIGHT.snapshot()["entries"]
                     if e["kind"] == "query"
                     and e["trace"] in {sp.ctx.trace_id for sp in roots}]
            assert len(notes) == len(pairs)
        else:
            t.close()
    assert shapes[0] == shapes[1] == [["queue", "resolve"], ["resolve"],
                                      ["queue", "resolve"]]


def test_launch_ctx_is_the_first_sampled_ticket(tracer):
    """Both engines hand the flush's first sampled context to the ladder
    walk and clear it after."""
    from bibfs_tpu_torch.serve.engine import QueryEngine

    seen = []
    for eng in (QueryEngine(N, EDGES, device="cpu"),
                _pipe(max_wait_ms=None, flush_threshold=4)):
        solve = eng._solve_host_isolated

        def spy(pairs, cutoffs=None, _solve=solve, _eng=eng):
            seen.append(_eng._launch_ctx)
            return _solve(pairs, cutoffs)

        eng._solve_host_isolated = spy
        c1, c2 = tracer.sample(), tracer.sample()
        try:
            tickets = [eng.submit(1, 60), eng.submit(2, 70, ctx=c1),
                       eng.submit(3, 80, ctx=c2), eng.submit(4, 90)]
            eng.flush()
            for t in tickets:
                assert t.result is not None
            # the pipelined flusher clears the context in a ``finally``
            # after the host rung has resolved the tickets: wait (bounded)
            # for its round to end before reading the field
            deadline = time.monotonic() + WAIT_S
            while (eng._launch_ctx is not None
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            assert eng._launch_ctx is None
        finally:
            eng.close()
        assert seen[-1] is c1
    assert len(seen) == 2


# ---- flight recorder ----------------------------------------------------------

def test_flight_recorder_ring_is_bounded(tmp_path):
    from bibfs_tpu.obs.dtrace import FlightRecorder as RefRecorder

    recs = [FlightRecorder(capacity=8), RefRecorder(capacity=8)]
    for rec in recs:
        for i in range(50):
            rec.note("query", i=i)
    snaps = [r.snapshot() for r in recs]
    assert snaps[0].keys() == snaps[1].keys()
    for snap in snaps:
        assert len(snap["entries"]) == 8
        assert [e["i"] for e in snap["entries"]] == list(range(42, 50))
    recs[0].configure(capacity=4)
    assert [e["i"] for e in recs[0].snapshot()["entries"]] == [46, 47, 48, 49]
    path = str(tmp_path / "fr.json")
    assert recs[0].dump(path, reason="demand") == path
    dumped = json.load(open(path))
    assert dumped["reason"] == "demand" and len(dumped["entries"]) == 4
    assert FlightRecorder().dump() is None  # no path known
    assert recs[0].dump(str(tmp_path / "no" / "dir.json")) is None


def test_flight_recorder_dumps_on_injected_device_fault(tmp_path):
    from bibfs_tpu_torch.serve.faults import FaultPlan, InjectedFault

    dump = str(tmp_path / "fault.flightrec.json")
    old_path = dtrace.FLIGHT._dump_path
    old_last = dtrace.FLIGHT._last_fault_dump
    dtrace.FLIGHT.configure(dump_path=dump)
    dtrace.FLIGHT._last_fault_dump = 0.0  # defeat the rate limiter
    dtrace.FLIGHT.note("query", src=3, dst=40)
    plan = FaultPlan.parse("device:times=1")
    try:
        with pytest.raises(InjectedFault):
            plan.fire("device")
        dumped = json.load(open(dump))
        assert dumped["reason"] == "fault"
        assert any(e["kind"] == "fault" and e.get("site") == "device"
                   for e in dumped["entries"])
        assert any(e["kind"] == "query" for e in dumped["entries"])
        # rate-limited: a second trip inside the interval notes, not dumps
        os.unlink(dump)
        with pytest.raises(InjectedFault):
            FaultPlan.parse("device:times=1").fire("device")
        assert not os.path.exists(dump)
    finally:
        dtrace.FLIGHT._dump_path = old_path
        dtrace.FLIGHT._last_fault_dump = old_last


def test_engine_notes_batches_and_fallbacks():
    """The pipelined engine notes every resolved batch, and a route
    fallback, in the flight recorder."""
    from bibfs_tpu_torch.serve.faults import FaultPlan

    eng = _pipe(max_wait_ms=5.0, device_batches=True, flush_threshold=1,
                faults=FaultPlan.parse("device:every=1"))
    try:
        t0 = time.time()
        eng.query_many([(1, 60), (2, 70)])
        entries = [e for e in dtrace.FLIGHT.snapshot()["entries"]
                   if e["at"] >= t0 - 1e-3]
        kinds = {e["kind"] for e in entries}
        assert {"batch", "fault"} <= kinds
        assert any(e["kind"] == "route" and e["fallback"] == "device"
                   for e in entries)
    finally:
        eng.close()


# ---- the stdin loop's tokens and the cross-process trace --------------------

def test_stdin_token_parents_repl_ingress(tmp_path, monkeypatch, capsys,
                                          tracer):
    import io

    from bibfs_tpu_torch.graph.io import write_graph_bin
    from bibfs_tpu_torch.serve.cli import main

    gpath = str(tmp_path / "g.bin")
    write_graph_bin(gpath, N, EDGES)
    monkeypatch.delenv(dtrace.ENV_SPOOL, raising=False)
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "0 50 @t:abc:def\n3 40\n1 2 @t:x\nflightrec\nflightrec bad\n"))
    assert main([gpath, "--no-path", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    # the synchronous engine resolves the queued queries at EOF
    assert out[-3].startswith("0 -> 50: length = ")
    assert out[-1].startswith("1 -> 2: length = 1")
    assert any(ln.startswith("flightrec {") for ln in out)
    assert "error invalid: usage: flightrec [dump]" in out
    recs = _spans(tracer.path)
    ingress = [r for r in recs if r["n"] == "repl_ingress"]
    assert len(ingress) == 3
    by_trace = {r["t"]: r for r in ingress}
    assert by_trace["abc"]["p"] == "def"
    assert "p" not in by_trace["x"]  # an empty parent span: a root
    # the bare line was sampled here, as a root of its own trace
    (own,) = [r for r in ingress if r["t"] not in ("abc", "x")]
    assert "p" not in own and own["a"] == {"src": 3, "dst": 40}


def test_cross_process_trace_through_net_child(tmp_path):
    """Sampled queries through a ``bibfs-torch-serve --port`` child: the
    client's ``net_client`` span and the child's ``net_ingress`` /
    ``queue`` / ``resolve`` spans land in two per-pid spools and merge into
    one trace each across the two processes, with no orphan; the child's
    ``/metrics`` lists the net families and ``/healthz`` answers 200."""
    import urllib.request

    from bibfs_tpu_torch.graph.io import write_graph_bin
    from bibfs_tpu_torch.obs.names import NET_METRIC_FAMILIES
    from bibfs_tpu_torch.serve.net import NetClient, read_port_file
    from bibfs_tpu_torch.solvers.serial import solve_serial

    gpath = str(tmp_path / "g.bin")
    write_graph_bin(gpath, N, EDGES)
    spool = str(tmp_path / "spool")
    port_file = str(tmp_path / "net.port")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "bibfs_tpu_torch.serve.cli", gpath,
         "--pipeline", "--no-path", "--device", "cpu", "--max-wait-ms", "5",
         "--port", "0", "--port-file", port_file, "--metrics-port", "0",
         "--trace-spool", spool],
        stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONUNBUFFERED": "1", "PYTHONPATH": root},
    )
    client = None
    mine = DTracer(spool, "client", sample=1.0)
    prev = set_dtracer(mine)
    try:
        deadline = time.monotonic() + 120.0
        addr = None
        while addr is None:
            assert proc.poll() is None, "child died before binding"
            assert time.monotonic() < deadline, "no port file"
            addr = read_port_file(port_file)
            if addr is None:
                time.sleep(0.05)
        client = NetClient(addr[0], addr[1])
        for s, d in ((0, 50), (3, 40)):
            res = client.submit(s, d).wait(timeout=WAIT_S)
            assert res.hops == solve_serial(N, EDGES, s, d).hops
        # the metrics port is on the child's stderr
        line = ""
        while "[Obs] serving /metrics on" not in line:
            line = proc.stderr.readline()
            assert line, "no metrics line"
        url = line.split(" on ", 1)[1].strip()
        with urllib.request.urlopen(url, timeout=10) as r:
            body = r.read().decode()
        for fam in NET_METRIC_FAMILIES:
            assert fam in body, fam
        with urllib.request.urlopen(url.replace("/metrics", "/healthz"),
                                    timeout=10) as r:
            assert r.status == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60.0) == 0
    finally:
        set_dtracer(prev)
        mine.close()
        if client is not None:
            client.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10.0)
    rep = merge_spools(spool)
    assert rep["truncated_lines"] == 0
    good = cross_process_traces(rep, min_procs=2)
    assert len(good) == 2
    for tr in good:
        assert tr["orphan_parents"] == 0
        assert set(tr["procs"]) == {"client", "serve"}
    names = {r["n"] for f in os.listdir(spool) if f.endswith(".jsonl")
             for r in read_spool(os.path.join(spool, f))[0]}
    assert {"net_client", "net_ingress", "queue", "resolve"} <= names
    assert dtrace.main(["merge", spool, "--min-procs", "2"]) == 0
