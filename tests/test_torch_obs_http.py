"""The PyTorch port's ``/metrics`` and ``/healthz`` endpoint
(``bibfs_tpu_torch.obs.http``) against ``bibfs_tpu.obs.http`` on the CPU:
a port engine's traffic in one Prometheus scrape under the JAX package's
family names; the same status codes and first tokens for each engine
state (ready, degraded with the breaker open, draining, detached) on
both packages' servers over engines driven through the same faults; the
health gauge fresh on a ``/metrics``-only scrape; a custom registry's
isolation; the front door's ``bibfs_net_*`` families on a live scrape."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest


def _skiplink_graph(n: int) -> np.ndarray:
    edges = [[i, i + 1] for i in range(n - 1)]
    edges += [[i, i + 7] for i in range(n - 7)]
    return np.array(edges)


def _get(url: str) -> tuple[int, str]:
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _pipe(n, edges, **kw):
    from bibfs_tpu_torch.serve import PipelinedQueryEngine

    return PipelinedQueryEngine(n, edges, device="cpu", **kw)


def test_metrics_endpoint_serves_live_engine_traffic():
    from bibfs_tpu_torch.obs.http import CONTENT_TYPE, start_metrics_server

    n = 200
    edges = _skiplink_graph(n)
    with start_metrics_server(0) as srv:
        assert srv.port > 0
        with _pipe(n, edges, max_wait_ms=5.0) as eng:
            pairs = np.random.default_rng(0).integers(0, n, size=(30, 2))
            eng.query_many(pairs)
            eng.query_many(pairs)  # repeats feed the cache counters
            with urllib.request.urlopen(srv.url, timeout=10) as r:
                status, body = r.status, r.read().decode()
                ctype = r.headers["Content-Type"]
        assert status == 200 and ctype == CONTENT_TYPE
        lbl = eng.obs_label
        assert f'bibfs_queries_total{{engine="{lbl}"}} 60' in body
        for fam in ("bibfs_queries_routed_total", "bibfs_dist_cache_events_total",
                    "bibfs_flush_cause_total", "bibfs_serve_queue_depth",
                    "bibfs_query_latency_seconds_bucket", 'le="+Inf"'):
            assert fam in body, fam
        assert (f'bibfs_query_latency_seconds_count{{engine="{lbl}"}} 60'
                in body)


def test_metrics_endpoint_routes_same_as_reference():
    from bibfs_tpu.obs.http import start_metrics_server as ref_start
    from bibfs_tpu_torch.obs.http import start_metrics_server

    outs = []
    for start in (ref_start, start_metrics_server):
        with start(0) as srv:
            outs.append([_get(f"http://127.0.0.1:{srv.port}{p}")
                         for p in ("/healthz", "/healthz?x=1", "/nope")])
            outs[-1] = [(c, b if c != 404 else "") for c, b in outs[-1]]
    assert outs[0] == outs[1]
    assert outs[1][0] == (200, "ok\n") and outs[1][2][0] == 404


def test_healthz_same_status_per_engine_state():
    """Both packages' ``/healthz`` over their engines, driven through the
    same states: ready (200 ``ok``), the breaker open (200 ``degraded``),
    draining (503), detached (200 ``ok``)."""
    from bibfs_tpu.obs.http import start_metrics_server as ref_start
    from bibfs_tpu.serve import ExecutableCache as RCache
    from bibfs_tpu.serve import FaultPlan as RPlan
    from bibfs_tpu.serve import PipelinedQueryEngine as RPipe
    from bibfs_tpu_torch.obs.http import start_metrics_server
    from bibfs_tpu_torch.serve import ExecutableCache, FaultPlan

    n = 200
    edges = _skiplink_graph(n)

    def ref_engine(plan):
        return RPipe(n, edges, flush_threshold=8, device_batches=True,
                     faults=plan, exec_cache=RCache())

    def port_engine(plan):
        return _pipe(n, edges, flush_threshold=8, device_batches=True,
                     faults=plan, exec_cache=ExecutableCache())

    outs = []
    for start, make, Plan in ((ref_start, ref_engine, RPlan),
                              (start_metrics_server, port_engine, FaultPlan)):
        seq = []
        with start(0) as srv:
            plan = Plan.parse("device:every=1")
            plan.set_active(False)
            eng = make(plan)
            srv.set_health(eng.health_snapshot)
            status, body = _get(srv.health_url)
            detail = json.loads(body.splitlines()[1])
            seq.append((status, body.splitlines()[0], detail["state"],
                        detail["breaker"]["state"], sorted(detail)))
            plan.set_active(True)
            eng.query_many([(i, i + 50) for i in range(10)])
            eng.query_many([(i, i + 50) for i in range(20, 30)])
            status, body = _get(srv.health_url)
            seq.append((status, body.splitlines()[0]))
            eng.close()
            status, body = _get(srv.health_url)
            seq.append((status, body.splitlines()[0].split()[0]))
            srv.set_health(None)
            seq.append(_get(srv.health_url))
            srv.set_health(lambda: 1 / 0)  # a crashing callback: 503
            seq.append(_get(srv.health_url)[0])
        outs.append(seq)
    assert outs[0] == outs[1]
    seq = outs[1]
    assert seq[0][:4] == (200, "ok", "ready", "closed")
    assert seq[1][0] == 200 and seq[1][1].startswith("degraded")
    assert "breaker" in seq[1][1]
    assert seq[2] == (503, "draining")
    assert seq[3] == (200, "ok\n") and seq[4] == 503


def test_metrics_render_refreshes_health_gauge():
    from bibfs_tpu_torch.obs.http import start_metrics_server

    n = 100
    with start_metrics_server(0) as srv:
        eng = _pipe(n, _skiplink_graph(n))
        lbl = eng.obs_label
        _status, body = _get(srv.url)
        assert f'bibfs_health_state{{engine="{lbl}"}} 1' in body
        eng.close()
        _status, body = _get(srv.url)
        assert f'bibfs_health_state{{engine="{lbl}"}} 3' in body


def test_metrics_server_custom_registry_and_close():
    from bibfs_tpu_torch.obs.http import start_metrics_server
    from bibfs_tpu_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    reg.counter("only_here_total", "x").inc(2)
    srv = start_metrics_server(0, registry=reg)
    try:
        _status, body = _get(srv.url)
        assert "only_here_total 2" in body
        assert "bibfs_queries_total" not in body
    finally:
        srv.close()
    with pytest.raises(OSError):
        urllib.request.urlopen(srv.url, timeout=5)


def test_live_scrape_lists_net_and_dtrace_families():
    """A front door and an engine in this process: one scrape of the
    process registry lists the ``bibfs_net_*`` group at zero and the stage
    histogram, under the JAX package's family names."""
    from bibfs_tpu_torch.obs.http import start_metrics_server
    from bibfs_tpu_torch.obs.names import (
        NET_METRIC_FAMILIES,
        SERVE_ENDPOINT_METRICS,
    )
    from bibfs_tpu_torch.serve.net import NetClient, NetServer

    n = 100
    with start_metrics_server(0) as srv, _pipe(n, _skiplink_graph(n)) as eng:
        door = NetServer(eng)
        client = NetClient(door.host, door.port)
        try:
            assert client.submit(0, 50).wait(timeout=30.0).found
            _status, body = _get(srv.url)
        finally:
            client.close()
            door.close()
    for fam in NET_METRIC_FAMILIES + SERVE_ENDPOINT_METRICS:
        assert fam in body, fam
    assert 'bibfs_net_requests_total{op="query"}' in body
    assert "bibfs_flightrec_dumps_total" in body
