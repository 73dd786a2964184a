"""A small stdlib HTTP endpoint serving the metrics registry and health:
the counterpart of ``bibfs_tpu/obs/http.py``.

``bibfs-torch-serve --metrics-port N`` starts it beside the engine:
``GET /metrics`` renders :data:`bibfs_tpu_torch.obs.metrics.REGISTRY` in
Prometheus text exposition format (content type
``text/plain; version=0.0.4``); ``GET /healthz`` answers from the
engine's health state machine
(:class:`bibfs_tpu_torch.serve.resilience.HealthMonitor`) once one is
attached with :meth:`MetricsServer.set_health`:

- ``ready`` — 200, body ``ok``;
- ``degraded`` — 200, body ``degraded <reasons>`` (the node still
  serves; a load balancer must not eject an answering node);
- ``live`` / ``draining`` — 503 (not ready: route no traffic here);
- no health callback attached (a standalone registry server, or the
  window before the engine finishes constructing) — 200 ``ok``.

The body's first token is the state; the JSON detail (breaker state,
recent errors, queue depth) follows on the next line.

Stdlib only (``http.server`` on a daemon thread): a
``ThreadingHTTPServer`` is plenty for scrape traffic. Port 0 binds an
ephemeral port; the chosen one is on ``server.port`` and in the line the
CLI prints at startup.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from bibfs_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _health_body(health_cb) -> tuple[int, bytes]:
    """(status, body) for /healthz. A crashing health callback is
    itself a health signal: 503, not a traceback through the scrape."""
    if health_cb is None:
        return 200, b"ok\n"
    try:
        snap = health_cb()
        state = snap.get("state", "live")
    except Exception as e:  # pragma: no cover - defensive
        return 503, f"error {type(e).__name__}: {e}\n".encode()
    from bibfs_tpu_torch.serve.resilience import healthz_status

    status = healthz_status(state)
    head = "ok" if state == "ready" else state
    reasons = snap.get("reasons") or []
    if reasons:
        head += " " + "; ".join(str(r) for r in reasons)
    body = head + "\n" + json.dumps(snap, sort_keys=True, default=str) + "\n"
    return status, body.encode()


def _make_handler(registry: MetricsRegistry, server: "MetricsServer"):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/metrics":
                body = registry.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/healthz":
                status, body = _health_body(server._health_cb)
                self.send_response(status)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)

        def log_message(self, *a):  # scrapes must not spam stderr
            pass

    return Handler


class MetricsServer:
    """A running ``/metrics`` + ``/healthz`` endpoint; ``close()``
    tears it down. ``health`` (or a later :meth:`set_health`) attaches
    the engine's health snapshot callable — the CLI builds the server
    BEFORE the engine so the scrape endpoint exists during engine
    construction; until the callback lands, ``/healthz`` answers the
    standalone 200 ``ok``."""

    def __init__(
        self,
        port: int = 0,
        registry: MetricsRegistry | None = None,
        host: str = "127.0.0.1",
        health=None,
    ):
        registry = REGISTRY if registry is None else registry
        self._health_cb = health
        self._httpd = ThreadingHTTPServer(
            (host, int(port)), _make_handler(registry, self)
        )
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="bibfs-metrics-http",
            daemon=True,
        )
        self._thread.start()

    def set_health(self, health_cb) -> None:
        """Attach (or replace) the health callback ``/healthz`` asks —
        typically ``engine.health_snapshot``. ``None`` detaches (back
        to the standalone 200 ``ok``)."""
        self._health_cb = health_cb

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    @property
    def health_url(self) -> str:
        return f"http://{self.host}:{self.port}/healthz"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def start_metrics_server(
    port: int = 0,
    registry: MetricsRegistry | None = None,
    host: str = "127.0.0.1",
    health=None,
) -> MetricsServer:
    """Start serving ``registry`` (default: the process-wide one) on
    ``host:port`` (port 0 = ephemeral); returns the running server.
    ``health`` optionally wires ``/healthz`` to an engine's
    ``health_snapshot`` (attachable later via ``set_health``)."""
    return MetricsServer(port=port, registry=registry, host=host,
                         health=health)
