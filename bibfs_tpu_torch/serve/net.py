"""The network front door: concurrent framed-TCP serving for the engines,
the counterpart of ``bibfs_tpu/serve/net.py`` (the same frames, replies,
error kinds, admission and brownout decisions and metric families, so
either package's client talks to either package's server).

The stdin loop of ``bibfs-torch-serve`` is one sequential text stream per
process; it cannot carry many concurrent clients, per-request deadlines
or per-tenant admission. This module is the wire protocol that does:

**Wire format.** Length-prefixed JSON frames: a 4-byte big-endian payload
length followed by that many bytes of UTF-8 JSON (one object per frame).
Requests carry a caller-chosen correlation ``id`` echoed on the reply, so
any number of requests may be in flight per connection and replies
arrive in completion order, not submit order. Ops:

- ``{"op": "query", "id", "src", "dst", "graph"?, "deadline_ms"?,
  "tenant"?, "kind"?}`` → ``{"id", "ok": true, "found", "hops"}`` or
  ``{"id", "ok": false, "kind": <taxonomy>, "error": msg}``. The ``kind``
  is :data:`~bibfs_tpu_torch.serve.resilience.ERROR_KINDS` verbatim: a
  quota or admission refusal is a structured ``capacity`` error the
  client can retry elsewhere, never a dropped connection.
- control ops ``health`` / ``stats`` / ``metrics`` / ``flightrec`` /
  ``memory`` / ``graphs`` / ``version`` / ``analytics`` / ``update`` /
  ``roll`` / ``ping`` → ``{"id", "ok": true, "result": ...}``: the stdin
  loop's control surface, multiplexed beside queries on one socket.

**Deadlines.** A query's optional ``deadline_ms`` is a reply SLO measured
from frame arrival: the completer guarantees some reply by the deadline,
the result if the engine landed it, else a structured ``timeout`` error
(counted once in ``bibfs_net_deadline_misses_total``) with the ticket
cancelled, so an unlaunched query never costs a solve. Requests without
a deadline ride the engine's ``max_wait_ms`` flush SLO.

**Admission.** A server-wide in-flight bound (``max_inflight``, refused
as ``capacity`` reason=capacity) is checked first, then per-tenant token
buckets (``quota_qps`` / ``quota_burst``, reason=quota), in that order,
so a request refused for capacity never costs the tenant a quota token.
Keep the in-flight bound under the pipelined engine's blocking admission
queue (``max_queue``): the IO thread must never park inside
``engine.submit``, because every other connection's reads ride on it.

**Brownout (opt-in).** A server built with a :class:`BrownoutPolicy`
adds two admission rungs between the in-flight bound and the tenant
bucket (so a shed costs no quota token either), both counted in
``bibfs_admission_shed_total{reason}``, never in the rejection counter:

- **deadline feasibility** (reason=infeasible): once the engine's latency
  histogram holds enough samples, a query whose ``deadline_ms`` is below
  the live p99 estimate is refused up front with a structured
  ``capacity`` error carrying ``retry_after_ms``.
- **the kind ladder** (reason=kshortest/weighted/msbfs): queries declare
  an admission class in an optional ``kind`` frame field (absent = a
  point lookup, the only kind the wire computes). Under queue pressure
  the expensive kinds shed first (``kshortest`` at the lowest
  occupancy, ``msbfs`` last, point lookups never), each rung engaging and
  releasing with hysteresis so admission does not flap at a threshold.

Brownout is off by default: a plain :class:`NetServer` sheds nothing.

**Threads.** One selector IO thread owns the listener and every
connection (non-blocking reads, frame parse, submit, buffered writes);
one completer thread wakes on the engine's batch-done broadcast, sweeps
resolved tickets and expired deadlines into reply frames, and hands the
bytes back to the IO thread through per-connection out-buffers and a
socketpair wakeup. The server lock and the engine's lock are never held
together: the completer leaves the engine's condition variable before it
takes the server lock, and the IO thread releases the server lock before
``engine.submit``. The door never touches a tensor: results reach it on
the tickets, after the engine's copy to the host.
"""

from __future__ import annotations

import json
import os
import selectors
import socket
import struct
import threading
import time

from bibfs_tpu_torch.obs.dtrace import (
    FLIGHT,
    ctx_fields,
    ctx_from_fields,
    dspan,
    sample_ctx,
    stage_histogram,
    wall_us,
)
from bibfs_tpu_torch.obs.metrics import REGISTRY
from bibfs_tpu_torch.serve.resilience import ERROR_KINDS, QueryError
from bibfs_tpu_torch.solvers.api import BFSResult
from bibfs_tpu_torch.utils.annotations import guarded_by

_LEN = struct.Struct(">I")

#: default per-frame payload bound — generous for query/control traffic
#: (a roll batch of ~30k edges still fits), small enough that a hostile
#: length prefix cannot balloon a connection buffer
MAX_FRAME_BYTES = 1 << 20

#: admission-refusal reason labels on ``bibfs_net_rejections_total``
#: (tenant-less by design: tenant ids are unbounded cardinality)
REJECT_REASONS = ("quota", "capacity", "draining", "oversize",
                  "malformed")

#: the brownout kind ladder, most-expensive first: under pressure
#: ``kshortest`` sheds at the lowest occupancy, ``msbfs`` holds
#: longest, and point lookups (no ``kind`` field) are never ladder-shed
BROWNOUT_LADDER = ("kshortest", "weighted", "msbfs")

#: shed-reason labels on ``bibfs_admission_shed_total`` — the ladder
#: kinds plus the deadline-feasibility rung
SHED_REASONS = ("infeasible",) + BROWNOUT_LADDER

#: control ops the server answers beside queries (the stdin loop's
#: command surface, multiplexed; ``metrics`` returns this process's
#: Prometheus rendering, ``flightrec`` the flight-recorder ring — and
#: dumps it with ``dump: true``)
CONTROL_OPS = ("health", "stats", "memory", "graphs", "version",
               "update", "roll", "ping", "metrics", "flightrec",
               "analytics")


class FrameError(ValueError):
    """Unrecoverable framing violation (oversize length prefix): the
    stream position can no longer be trusted, so the connection must
    close — unlike malformed JSON inside a well-framed payload, which
    is answered and survived."""


def encode_frame(obj) -> bytes:
    """One wire frame: 4-byte big-endian length + compact UTF-8 JSON."""
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_FRAME_BYTES:
        raise ValueError(
            f"frame payload {len(payload)}B exceeds {MAX_FRAME_BYTES}B"
        )
    return _LEN.pack(len(payload)) + payload


def extract_frames(buf: bytearray,
                   max_frame: int = MAX_FRAME_BYTES) -> list:
    """Pop every complete frame's payload bytes off ``buf`` (mutated in
    place, partial tail left for the next read). Raises
    :class:`FrameError` on a length prefix beyond ``max_frame``."""
    out = []
    while True:
        if len(buf) < _LEN.size:
            return out
        (length,) = _LEN.unpack_from(buf)
        if length > max_frame:
            raise FrameError(
                f"frame length {length}B exceeds {max_frame}B"
            )
        if len(buf) < _LEN.size + length:
            return out
        out.append(bytes(buf[_LEN.size: _LEN.size + length]))
        del buf[: _LEN.size + length]


def write_port_file(path: str, host: str, port: int) -> None:
    """Publish the bound address as ``"host port\\n"`` atomically
    (tmp + rename): a process that spawned the server polls this file,
    and must never read a half-written line."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{host} {port}\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_port_file(path: str):
    """The ``(host, port)`` a :func:`write_port_file` published, or
    None while the file has not landed yet."""
    try:
        with open(path) as f:
            parts = f.read().split()
    except OSError:
        return None
    if len(parts) != 2:
        return None
    try:
        return parts[0], int(parts[1])
    except ValueError:
        return None


class TokenBucket:
    """One tenant's refill-on-read token bucket (``rate`` tokens/s up
    to ``burst``). NOT internally locked — the server mutates buckets
    only under its own lock, and a bucket never leaves the server."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.stamp = time.monotonic()

    def allow(self, now: float | None = None) -> bool:
        now = time.monotonic() if now is None else now
        # a caller-supplied ``now`` may predate the construction stamp
        # (the server anchors it at frame arrival, the bucket is built
        # later under the lock): elapsed clamps at zero so the burst
        # is never silently shaved
        elapsed = max(0.0, now - self.stamp)
        self.tokens = min(self.burst, self.tokens + elapsed * self.rate)
        self.stamp = max(self.stamp, now)
        # the refill is computed as (now - stamp) * rate in floats: a
        # token earned over an interval like 0.1s can land ~1e-11 shy
        # of 1.0 depending on the magnitude of ``now``. An epsilon on
        # the spend keeps "waited exactly one token's worth" admitted
        # instead of rounding-refused
        if self.tokens >= 1.0 - 1e-9:
            self.tokens = max(0.0, self.tokens - 1.0)
            return True
        return False


class _Conn:
    """One accepted connection: its socket plus the receive/transmit
    buffers the IO thread and completer share (``wbuf`` is mutated only
    under the server lock; ``rbuf`` only by the IO thread)."""

    __slots__ = ("sock", "fd", "addr", "rbuf", "wbuf", "closed",
                 "want_write")

    def __init__(self, sock, addr):
        self.sock = sock
        self.fd = sock.fileno()
        self.addr = addr
        self.rbuf = bytearray()
        self.wbuf = bytearray()
        self.closed = False
        self.want_write = False


class _PendingNet:
    """One submitted query awaiting its reply frame."""

    __slots__ = ("ticket", "conn", "rid", "deadline", "tenant", "t0",
                 "rx")

    def __init__(self, ticket, conn, rid, deadline, tenant, t0,
                 rx=None):
        self.ticket = ticket
        self.conn = conn
        self.rid = rid
        self.deadline = deadline
        self.tenant = tenant
        self.t0 = t0
        self.rx = rx  # wall-µs arrival stamp, traced queries only


class BrownoutPolicy:
    """Knobs for the front door's overload brownout (module docstring).
    Constructing one and passing it to :class:`NetServer` IS the
    opt-in — servers built without one shed nothing.

    ``ladder`` maps admission-class kinds to ENGAGE occupancy fractions
    of ``max_inflight``; a rung releases at ``engage - release`` (the
    hysteresis band). ``headroom`` scales the p99 estimate in the
    feasibility rung (>1.0 sheds earlier), which only arms once the
    engine's latency histogram holds ``min_samples`` observations."""

    __slots__ = ("feasibility", "min_samples", "headroom", "ladder",
                 "release", "retry_after_ms")

    def __init__(self, *, feasibility: bool = True,
                 min_samples: int = 50, headroom: float = 1.0,
                 ladder=None, release: float = 0.15,
                 retry_after_ms: float = 250.0):
        self.feasibility = bool(feasibility)
        self.min_samples = int(min_samples)
        self.headroom = float(headroom)
        self.ladder = dict(ladder) if ladder is not None else {
            "kshortest": 0.50, "weighted": 0.65, "msbfs": 0.80,
        }
        for k in self.ladder:
            if k not in BROWNOUT_LADDER:
                raise ValueError(
                    f"unknown ladder kind {k!r} "
                    f"(known: {BROWNOUT_LADDER})"
                )
        self.release = float(release)
        self.retry_after_ms = float(retry_after_ms)
        if self.min_samples < 1:
            raise ValueError("min_samples must be >= 1")
        if not (0.0 < self.release < 1.0):
            raise ValueError("release must be in (0, 1)")


# _state stays un-annotated by design (lock-free fast reads in the IO
# loop; every transition happens under the lock)
@guarded_by("_lock", "_conns", "_pending", "_buckets", "_submitting",
            "_seq", "_shed_engaged")
class NetServer:
    """The framed-TCP front door over one (pipelined) engine.

    Parameters
    ----------
    engine : a :class:`~bibfs_tpu_torch.serve.pipeline.PipelinedQueryEngine`
        (or anything submit-compatible whose tickets self-resolve on a
        background flusher and that exposes a batch-done condvar as
        ``_cv``; the synchronous engine does neither, and serving it
        here would strand every non-inline ticket).
    store : the engine's :class:`~bibfs_tpu_torch.store.GraphStore` when one
        is attached — enables the ``memory``/``graphs``/``update``/
        ``roll`` control ops (refused as ``invalid`` otherwise).
    host, port : bind address; port 0 picks an ephemeral port
        (republished via :attr:`port` and :func:`write_port_file`).
    max_inflight : server-wide submitted-but-unreplied bound. Keep it
        BELOW the engine's ``max_queue`` so admission refuses here with
        a structured ``capacity`` error instead of blocking the IO
        thread inside the engine's own admission gate.
    quota_qps, quota_burst : per-tenant token-bucket admission (None
        disables quotas; burst defaults to 2x qps).
    default_deadline_ms : deadline applied to queries that carry none
        (None = engine SLO only).
    brownout : a :class:`BrownoutPolicy` to arm the overload brownout
        rungs (module docstring); None (the default) sheds nothing.
    """

    def __init__(self, engine, *, store=None, host: str = "127.0.0.1",
                 port: int = 0, max_frame: int = MAX_FRAME_BYTES,
                 max_inflight: int = 512, quota_qps: float | None = None,
                 quota_burst: float | None = None,
                 default_deadline_ms: float | None = None,
                 brownout: BrownoutPolicy | None = None,
                 registry=None):
        self._engine = engine
        self._store = store
        self._max_frame = int(max_frame)
        self._max_inflight = int(max_inflight)
        self._quota_qps = None if quota_qps is None else float(quota_qps)
        self._quota_burst = (
            2.0 * self._quota_qps if quota_burst is None
            and self._quota_qps is not None else quota_burst
        )
        self._default_deadline_ms = default_deadline_ms
        self._brownout = brownout
        self._lock = threading.RLock()
        self._conns: dict[int, _Conn] = {}
        self._pending: dict[int, _PendingNet] = {}
        self._buckets: dict[str, TokenBucket] = {}
        self._shed_engaged: set = set()
        self._submitting = 0
        self._seq = 0
        self._state = "serving"

        self._registry = REGISTRY if registry is None else registry
        # the whole bibfs_net_* family group renders at zero from
        # construction — a /metrics scrape before traffic sees them
        self._m_conns = self._registry.gauge(
            "bibfs_net_connections",
            "Open front-door TCP connections",
        )
        self._m_requests = self._registry.counter(
            "bibfs_net_requests_total",
            "Frames accepted for processing, by op class",
            ("op",),
        )
        for op in ("query", "control"):
            self._m_requests.labels(op=op)
        self._m_rejects = self._registry.counter(
            "bibfs_net_rejections_total",
            "Frames refused at admission, by reason (tenant-less)",
            ("reason",),
        )
        for reason in REJECT_REASONS:
            self._m_rejects.labels(reason=reason)
        self._m_bytes = self._registry.counter(
            "bibfs_net_bytes_total",
            "Wire bytes moved through the front door",
            ("direction",),
        )
        for d in ("in", "out"):
            self._m_bytes.labels(direction=d)
        self._m_deadline = self._registry.counter(
            "bibfs_net_deadline_misses_total",
            "Queries answered with a structured timeout because their "
            "per-request deadline expired before the result landed",
        )
        # the brownout shed counter is minted only on brownout-armed
        # servers (mint-at-zero would misread as "brownout available"
        # on plain front doors); every reason cell pre-minted
        self._c_shed = None
        if brownout is not None:
            self._c_shed = self._registry.counter(
                "bibfs_admission_shed_total",
                "Brownout admission sheds at the front door, by reason "
                "(infeasible = deadline-feasibility; ladder kinds shed "
                "under queue pressure before point lookups)",
                ("reason",),
            )
            for r in SHED_REASONS:
                self._c_shed.labels(reason=r)
        # per-query cost attribution (obs/dtrace.py): the front door
        # owns the ingress stage (frame arrival -> ticket submitted)
        self._stage_cells = stage_histogram()

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(
            socket.SOL_SOCKET, socket.SO_REUSEADDR, 1
        )
        self._listener.bind((host, int(port)))
        self._listener.listen(1024)
        self._listener.setblocking(False)
        self.host, self.port = self._listener.getsockname()[:2]

        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._listener, selectors.EVENT_READ, None)
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")

        self._io_thread = threading.Thread(
            target=self._io_main, name="bibfs-net-io", daemon=True,
        )
        self._completer = threading.Thread(
            target=self._completer_main, name="bibfs-net-completer",
            daemon=True,
        )
        self._io_thread.start()
        self._completer.start()

    # ---- IO thread ---------------------------------------------------
    def _io_main(self) -> None:
        while self._state != "closed":
            with self._lock:
                dirty = [
                    c for c in self._conns.values()
                    if not c.closed
                    and bool(c.wbuf) != c.want_write
                ]
                for c in dirty:
                    c.want_write = bool(c.wbuf)
            for c in dirty:
                mask = selectors.EVENT_READ
                if c.want_write:
                    mask |= selectors.EVENT_WRITE
                try:
                    self._sel.modify(c.sock, mask, c)
                except (KeyError, ValueError, OSError):
                    pass
            try:
                events = self._sel.select(timeout=0.05)
            except OSError:
                continue
            for key, mask in events:
                data = key.data
                if data is None:
                    self._accept_ready()
                elif data == "wake":
                    try:
                        self._wake_r.recv(4096)
                    except OSError:
                        pass
                else:
                    try:
                        if mask & selectors.EVENT_READ:
                            self._read_ready(data)
                        if mask & selectors.EVENT_WRITE:
                            self._write_ready(data)
                    except Exception:
                        # the handlers contain their own faults; this
                        # is the listener's last line of defense
                        self._close_conn(data)

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\0")
        except (BlockingIOError, OSError):
            pass

    def _accept_ready(self) -> None:
        while True:
            try:
                sock, addr = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            if self._state != "serving":
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            sock.setblocking(False)
            try:
                sock.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                )
            except OSError:
                pass
            conn = _Conn(sock, addr)
            with self._lock:
                self._conns[conn.fd] = conn
                self._m_conns.inc()
            try:
                self._sel.register(sock, selectors.EVENT_READ, conn)
            except (KeyError, ValueError, OSError):
                self._close_conn(conn)

    def _read_ready(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(1 << 18)
        except BlockingIOError:
            return
        except OSError:
            self._close_conn(conn)
            return
        if not data:
            self._close_conn(conn)
            return
        conn.rbuf += data
        with self._lock:
            self._m_bytes.labels(direction="in").inc(len(data))
        try:
            frames = extract_frames(conn.rbuf, self._max_frame)
        except FrameError as e:
            with self._lock:
                self._m_rejects.labels(reason="oversize").inc()
            self._enqueue(conn, {
                "id": None, "ok": False, "kind": "invalid",
                "error": f"{e}; closing connection",
            })
            self._flush_then_close(conn)
            return
        for raw in frames:
            try:
                self._handle_frame(conn, raw)
            except Exception as e:
                # a handler bug costs this one connection, never the
                # IO thread every other connection's reads ride on
                self._enqueue(conn, {
                    "id": None, "ok": False, "kind": "internal",
                    "error": f"{type(e).__name__}: {e}; "
                             "closing connection",
                })
                self._flush_then_close(conn)
                return

    def _write_ready(self, conn: _Conn) -> None:
        with self._lock:
            chunk = b"" if conn.closed else bytes(conn.wbuf[: 1 << 18])
        if not chunk:
            return
        try:
            sent = conn.sock.send(chunk)
        except BlockingIOError:
            return
        except OSError:
            self._close_conn(conn)
            return
        with self._lock:
            del conn.wbuf[:sent]

    def _flush_then_close(self, conn: _Conn) -> None:
        """Best-effort synchronous drain of ``conn.wbuf`` (the goodbye
        frame of a fatal protocol error), then close. Runs on the IO
        thread with the socket still non-blocking: whatever does not
        send immediately is dropped with the connection."""
        with self._lock:
            chunk = bytes(conn.wbuf)
            conn.wbuf.clear()
        try:
            conn.sock.send(chunk)
        except OSError:
            pass
        self._close_conn(conn)

    def _close_conn(self, conn: _Conn) -> None:
        with self._lock:
            if conn.closed:
                return
            conn.closed = True
            self._conns.pop(conn.fd, None)
            self._m_conns.dec()
            stale = [
                (k, e) for k, e in self._pending.items()
                if e.conn is conn
            ]
            for k, _ in stale:
                self._pending.pop(k, None)
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        # a disconnected client's unlaunched queries should not burn
        # solves; cancel() is best-effort (False once launched)
        for _, e in stale:
            cancel = getattr(e.ticket, "cancel", None)
            if cancel is not None:
                try:
                    cancel()
                except Exception:
                    pass

    # ---- frame handling (IO thread) ---------------------------------
    def _handle_frame(self, conn: _Conn, raw: bytes) -> None:
        try:
            msg = json.loads(raw.decode("utf-8"))
            if not isinstance(msg, dict):
                raise ValueError("frame payload is not a JSON object")
        except (ValueError, UnicodeDecodeError):
            with self._lock:
                self._m_rejects.labels(reason="malformed").inc()
            self._enqueue(conn, {
                "id": None, "ok": False, "kind": "invalid",
                "error": "malformed frame payload",
            })
            return
        op = msg.get("op")
        rid = msg.get("id")
        if op == "query":
            self._handle_query(conn, msg, rid)
        elif op in CONTROL_OPS:
            self._handle_control(conn, op, msg, rid)
        else:
            self._enqueue(conn, {
                "id": rid, "ok": False, "kind": "invalid",
                "error": f"unknown op {op!r}",
            })

    def _handle_query(self, conn: _Conn, msg: dict, rid) -> None:
        # the deadline SLO is measured from frame arrival (module
        # docstring): anchor it here, before admission and submit
        now = time.monotonic()
        t_in = time.perf_counter()  # ingress-stage anchor
        tenant = str(msg.get("tenant") or "default")
        # deadline_ms is client-controlled: it must parse BEFORE any
        # admission state moves, so a junk value can neither burn a
        # quota token nor leak the _submitting count
        dl_ms = msg.get("deadline_ms", self._default_deadline_ms)
        if dl_ms is not None:
            try:
                dl_ms = float(dl_ms)
            except (TypeError, ValueError):
                with self._lock:
                    self._m_requests.labels(op="query").inc()
                    self._m_rejects.labels(reason="malformed").inc()
                self._enqueue(conn, {
                    "id": rid, "ok": False, "kind": "invalid",
                    "error": "deadline_ms must be a number, got "
                             f"{msg.get('deadline_ms')!r}",
                })
                return
        deadline = None if dl_ms is None else now + dl_ms / 1e3
        qkind = str(msg.get("kind") or "point")
        reason = None
        shed = None
        with self._lock:
            self._m_requests.labels(op="query").inc()
            if self._state != "serving":
                reason = "draining"
            elif (len(self._pending) + self._submitting
                    >= self._max_inflight):
                # the server-wide bound comes BEFORE the tenant bucket:
                # a capacity refusal must not also cost a quota token
                reason = "capacity"
            else:
                if self._brownout is not None:
                    # brownout rungs also come BEFORE the tenant
                    # bucket — a shed must not burn a quota token
                    shed = self._shed_locked(qkind, dl_ms)
                if shed is None and self._quota_qps is not None:
                    bucket = self._buckets.get(tenant)
                    if bucket is None:
                        bucket = TokenBucket(
                            self._quota_qps, self._quota_burst
                        )
                        self._buckets[tenant] = bucket
                    if not bucket.allow(now):
                        reason = "quota"
            if reason is None and shed is None:
                self._submitting += 1
            elif reason is not None:
                self._m_rejects.labels(reason=reason).inc()
            else:
                self._c_shed.labels(reason=shed[0]).inc()
        if reason is not None:
            self._enqueue(conn, {
                "id": rid, "ok": False, "kind": "capacity",
                "error": f"admission refused ({reason})",
            })
            return
        if shed is not None:
            self._enqueue(conn, {
                "id": rid, "ok": False, "kind": "capacity",
                "error": f"brownout shed ({shed[0]})",
                "retry_after_ms": shed[1],
            })
            return
        # distributed-trace ingress: adopt the frame's context, or make
        # the sampling decision HERE when an untraced client hits a
        # traced server (the front door is the ingress). Unsampled is
        # ctx=None all the way down — no span, no extra reply fields.
        ctx = ctx_from_fields(msg)
        if ctx is None:
            ctx = sample_ctx()
        sp = dspan("net_ingress", ctx, tenant=tenant)
        # submit OUTSIDE the server lock: the engine takes its own lock
        try:
            src = int(msg["src"])
            dst = int(msg["dst"])
            ticket = self._engine.submit(src, dst, msg.get("graph"),
                                         ctx=sp.ctx)
        except QueryError as e:
            sp.finish(error=e.kind)
            with self._lock:
                self._submitting -= 1
                if e.kind == "capacity":
                    self._m_rejects.labels(reason="capacity").inc()
            self._enqueue(conn, {
                "id": rid, "ok": False, "kind": e.kind,
                "error": str(e),
            })
            return
        except (KeyError, TypeError, ValueError) as e:
            sp.finish(error=type(e).__name__)
            with self._lock:
                self._submitting -= 1
            self._enqueue(conn, {
                "id": rid, "ok": False, "kind": "invalid",
                "error": f"{type(e).__name__}: {e}",
            })
            return
        except RuntimeError as e:  # engine closed underneath us
            sp.finish(error="closed")
            with self._lock:
                self._submitting -= 1
                self._m_rejects.labels(reason="capacity").inc()
            self._enqueue(conn, {
                "id": rid, "ok": False, "kind": "capacity",
                "error": f"{e}",
            })
            return
        # the ingress stage: frame arrival -> ticket submitted
        self._stage_cells["ingress"].record(time.perf_counter() - t_in)
        sp.finish(src=src, dst=dst)
        rx = round(wall_us(t_in), 3) if ctx is not None else None
        if ticket.result is not None or ticket.error is not None:
            # inline-resolved (cache/trivial/oracle): reply immediately
            # instead of waiting for the next completer wake
            with self._lock:
                self._submitting -= 1
            reply = self._ticket_reply(rid, ticket)
            if rx is not None:
                reply["rx"] = rx
                reply["stx"] = round(wall_us(time.perf_counter()), 3)
            self._enqueue(conn, reply)
            return
        entry = _PendingNet(ticket, conn, rid, deadline, tenant, now, rx)
        with self._lock:
            self._submitting -= 1
            self._pending[self._seq] = entry
            self._seq += 1

    def _shed_locked(self, qkind: str, dl_ms):
        """The two brownout admission rungs (module docstring), server
        lock held. Returns ``(reason, retry_after_ms)`` to shed, or
        None to admit."""
        pol = self._brownout
        # rung 1: deadline feasibility — refuse a deadline the engine's
        # own live p99 says cannot be met, once the estimate has enough
        # samples to mean anything
        if dl_ms is not None and pol.feasibility:
            lat = getattr(self._engine, "latency", None)
            if lat is not None and lat.count >= pol.min_samples:
                p99_ms = lat.percentile(0.99) * 1e3
                if dl_ms < p99_ms * pol.headroom:
                    return "infeasible", round(
                        max(p99_ms, pol.retry_after_ms), 1
                    )
        # rung 2: the kind ladder — expensive admission classes shed
        # under queue pressure, each rung with its own hysteresis band
        # so admission does not flap at the threshold
        occ = ((len(self._pending) + self._submitting)
               / max(1, self._max_inflight))
        for k, hi in pol.ladder.items():
            if k in self._shed_engaged:
                if occ <= hi - pol.release:
                    self._shed_engaged.discard(k)
            elif occ >= hi:
                self._shed_engaged.add(k)
        if qkind in self._shed_engaged:
            return qkind, pol.retry_after_ms
        return None

    def _handle_control(self, conn: _Conn, op: str, msg: dict,
                        rid) -> None:
        with self._lock:
            self._m_requests.labels(op="control").inc()
        try:
            result = self._control(op, msg)
        except QueryError as e:
            self._enqueue(conn, {
                "id": rid, "ok": False, "kind": e.kind,
                "error": str(e),
            })
            return
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            self._enqueue(conn, {
                "id": rid, "ok": False, "kind": "invalid",
                "error": f"{type(e).__name__}: {e}",
            })
            return
        except Exception as e:
            self._enqueue(conn, {
                "id": rid, "ok": False, "kind": "internal",
                "error": f"{type(e).__name__}: {e}",
            })
            return
        self._enqueue(conn, {"id": rid, "ok": True, "result": result})

    def _control(self, op: str, msg: dict):
        """One control op. Store mutations (``update``/``roll``) run on
        the IO thread — a roll stalls this server's traffic for its
        duration."""
        eng = self._engine
        if op == "ping":
            return {"pong": True}
        if op == "health":
            return eng.health_snapshot()
        if op == "stats":
            return eng.stats()
        if op == "metrics":
            # this process's full Prometheus text rendering, for a
            # scrape over the wire
            return {"render": self._registry.render()}
        if op == "flightrec":
            snap = FLIGHT.snapshot()
            if msg.get("dump"):
                snap["dumped_to"] = FLIGHT.dump(reason="demand")
            return snap
        if op == "memory":
            if self._store is None:
                raise ValueError("no store attached")
            return self._store.memory_stats()
        if op == "graphs":
            if self._store is None:
                raise ValueError("no store attached")
            return {
                "graphs": {
                    name: int(self._store.current(name).version)
                    for name in self._store.names()
                },
                "default": self._store.default_graph(),
            }
        if op == "version":
            g = msg.get("graph")
            if self._store is not None:
                name = (self._store.default_graph() if g is None
                        else str(g))
                return {
                    "graph": name,
                    "version": int(self._store.current(name).version),
                }
            st = eng.stats()
            return {
                "graph": g,
                "version": st.get("graph", {}).get("version"),
            }
        if op == "analytics":
            # the whole-graph tier over the wire: submit-and-flush one
            # typed kind and reply with the scalar summary (the vector
            # stays server-side, in the kind cache and the per-digest
            # result store — a reply frame never carries O(n) data).
            # Runs on the IO thread like update/roll: an analytics
            # flush brackets this server's traffic for its duration
            from bibfs_tpu_torch.analytics.queries import (
                analytics_query_from_spec, analytics_summary,
            )

            g = msg.get("graph")
            name = None if g is None else str(g)
            q = analytics_query_from_spec(
                str(msg.get("kind") or ""), msg.get("params") or {}
            )
            return analytics_summary(eng.query_one(q, graph=name))
        if op in ("update", "roll"):
            if self._store is None:
                raise ValueError("no store attached")
            g = msg.get("graph")
            name = self._store.default_graph() if g is None else str(g)
            adds = [(int(u), int(v)) for u, v in msg.get("adds", ())]
            dels = [(int(u), int(v)) for u, v in msg.get("dels", ())]
            if op == "update":
                self._store.update(name, adds=adds, dels=dels)
                return {
                    "graph": name, "applied": len(adds) + len(dels),
                }
            snap = self._store.roll(name, adds=adds, dels=dels)
            return {"graph": name, "version": int(snap.version)}
        raise ValueError(f"unknown control op {op!r}")

    # ---- replies -----------------------------------------------------
    @staticmethod
    def _ticket_reply(rid, ticket) -> dict:
        err = ticket.error
        if err is not None:
            kind = getattr(err, "kind", "internal")
            if kind not in ERROR_KINDS:
                kind = "internal"
            return {
                "id": rid, "ok": False, "kind": kind,
                "error": str(err),
            }
        r = ticket.result
        return {
            "id": rid, "ok": True, "found": bool(r.found),
            "hops": None if r.hops is None else int(r.hops),
        }

    def _enqueue(self, conn: _Conn, obj: dict) -> None:
        try:
            data = encode_frame(obj)
        except ValueError:
            data = encode_frame({
                "id": obj.get("id"), "ok": False, "kind": "internal",
                "error": "reply exceeded the frame bound",
            })
        with self._lock:
            if conn.closed:
                return
            conn.wbuf += data
            self._m_bytes.labels(direction="out").inc(len(data))
        self._wake()

    # ---- completer thread -------------------------------------------
    def _completer_main(self) -> None:
        # the pipelined engine broadcasts its condvar once per landed
        # batch; the short timeout bounds deadline-check latency (and
        # is the whole loop for engines without a condvar)
        cv = getattr(self._engine, "_cv", None)
        while self._state != "closed":
            if cv is not None:
                with cv:
                    cv.wait(timeout=0.01)
            else:
                time.sleep(0.005)
            # engine condvar released BEFORE the server lock: holding
            # both would order the locks both ways against the IO
            # thread's submit path (lockgraph cycle)
            with self._lock:
                items = list(self._pending.items())
            if not items:
                continue
            now = time.monotonic()
            done, missed = [], []
            for k, e in items:
                t = e.ticket
                if t.result is not None or t.error is not None:
                    done.append((k, e))
                elif e.deadline is not None and now >= e.deadline:
                    missed.append((k, e))
            if not done and not missed:
                continue
            with self._lock:
                done = [
                    (k, e) for k, e in done
                    if self._pending.pop(k, None) is not None
                ]
                missed = [
                    (k, e) for k, e in missed
                    if self._pending.pop(k, None) is not None
                ]
                if missed:
                    self._m_deadline.inc(len(missed))
            for _, e in missed:
                # the deadline passed: the reply is a timeout even if
                # the result lands between cancel and send — the SLO is
                # about WHEN the client hears back, and cancel() feeds
                # the engine's own timeout accounting for the unlaunched
                cancel = getattr(e.ticket, "cancel", None)
                if cancel is not None:
                    try:
                        cancel()
                    except Exception:
                        pass
                self._enqueue(e.conn, {
                    "id": e.rid, "ok": False, "kind": "timeout",
                    "error": "deadline exceeded before the result "
                             "landed",
                })
            for _, e in done:
                reply = self._ticket_reply(e.rid, e.ticket)
                if e.rx is not None:
                    # traced query: both server clock stamps ride the
                    # reply so the client can subtract server time from
                    # its RTT (the wire stage + clock-offset bound)
                    reply["rx"] = e.rx
                    reply["stx"] = round(wall_us(time.perf_counter()), 3)
                self._enqueue(e.conn, reply)

    # ---- lifecycle ---------------------------------------------------
    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending) + self._submitting

    def connection_count(self) -> int:
        with self._lock:
            return len(self._conns)

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting queries (structured ``capacity``
        reason=draining; control ops still answer) and wait for every
        in-flight query to be REPLIED and its bytes handed to the
        kernel. Returns True when quiet. New connections are refused
        for the drain's duration."""
        if self._state == "serving":
            self._state = "draining"
        deadline = time.monotonic() + max(float(timeout), 0.0)
        while True:
            with self._lock:
                quiet = (
                    not self._pending and not self._submitting
                    and all(
                        not c.wbuf for c in self._conns.values()
                    )
                )
            if quiet:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.02)

    def close(self) -> None:
        """Stop both threads and close every socket. Pending queries
        that never got a reply frame die with their connections (call
        :meth:`drain` first for a graceful stop)."""
        if self._state == "closed":
            return
        self._state = "closed"
        self._wake()
        self._io_thread.join(timeout=10.0)
        self._completer.join(timeout=10.0)
        with self._lock:
            conns = list(self._conns.values())
        for conn in conns:
            self._close_conn(conn)
        for sock in (self._listener, self._wake_r, self._wake_w):
            try:
                sock.close()
            except OSError:
                pass
        try:
            self._sel.close()
        except (KeyError, ValueError, OSError):
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# --------------------------------------------------------------------
# client side
# --------------------------------------------------------------------

class NetTicket:
    """One in-flight client query, resolved by the reader thread.
    ``t_done`` is the reader's ``perf_counter`` resolve stamp — the
    same per-ticket latency contract the engines' tickets expose, so
    the open-loop loadgen reads net latencies identically."""

    __slots__ = ("src", "dst", "graph", "result", "error", "event",
                 "t_done", "span", "t_sent")

    def __init__(self, src: int, dst: int, graph):
        self.src = src
        self.dst = dst
        self.graph = graph
        self.result: BFSResult | None = None
        self.error: BaseException | None = None
        self.event = threading.Event()
        self.t_done: float | None = None
        self.span = None  # the client-side DSpan, sampled queries only
        self.t_sent: float | None = None

    def wait(self, timeout: float | None = None):
        if not self.event.wait(timeout):
            raise TimeoutError(
                f"query ({self.src}, {self.dst}) unresolved"
            )
        if self.error is not None:
            raise self.error
        return self.result


class _CtrlWaiter:
    __slots__ = ("msg", "event")

    def __init__(self):
        self.msg: dict | None = None
        self.event = threading.Event()


# the waiter table is shared between submitters and the reader thread;
# _dead stays un-annotated by design (lock-free fast-refusal read)
@guarded_by("_lock", "_waiters", "_seq")
class NetClient:
    """One connection to a :class:`NetServer`: correlation-id
    multiplexed request/reply with a background reader thread.
    Thread-safe; any number of queries may be in flight. Socket writes
    serialize on their own leaf lock (``_wlock``) so concurrent
    submitters cannot interleave frame bytes."""

    def __init__(self, host: str, port: int, *,
                 connect_timeout: float = 30.0, tenant: str | None = None):
        self._sock = socket.create_connection(
            (host, port), timeout=connect_timeout
        )
        self._sock.settimeout(None)
        try:
            self._sock.setsockopt(
                socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
            )
        except OSError:
            pass
        self.tenant = tenant
        # the wire stage (client RTT minus server time) lands in this
        # process's bibfs_stage_seconds when tracing samples a query
        self._stage_cells = stage_histogram()
        self._lock = threading.RLock()
        self._wlock = threading.Lock()
        self._waiters: dict[int, object] = {}
        self._seq = 0
        self._dead = False
        self._reader = threading.Thread(
            target=self._read_main, name="bibfs-net-client-reader",
            daemon=True,
        )
        self._reader.start()

    # ---- plumbing ----------------------------------------------------
    def _send(self, data: bytes) -> None:
        try:
            with self._wlock:
                self._sock.sendall(data)
        except (BrokenPipeError, OSError, ValueError) as e:
            raise ConnectionError(f"front-door send failed: {e}") from e

    def _register(self, waiter) -> int:
        with self._lock:
            if self._dead:
                raise ConnectionError("front-door connection is closed")
            rid = self._seq
            self._seq += 1
            self._waiters[rid] = waiter
        return rid

    def _read_main(self) -> None:
        buf = bytearray()
        try:
            while True:
                data = self._sock.recv(1 << 16)
                if not data:
                    break
                buf += data
                for raw in extract_frames(buf):
                    try:
                        msg = json.loads(raw.decode("utf-8"))
                    except (ValueError, UnicodeDecodeError):
                        continue
                    self._dispatch(msg)
        except (OSError, ValueError):
            pass
        finally:
            self._fail_all()

    def _dispatch(self, msg: dict) -> None:
        rid = msg.get("id")
        with self._lock:
            waiter = self._waiters.pop(rid, None)
        if waiter is None:
            return
        if isinstance(waiter, NetTicket):
            if msg.get("ok"):
                hops = msg.get("hops")
                waiter.result = BFSResult(
                    bool(msg.get("found")),
                    None if hops is None else int(hops),
                    None, None, 0.0, 0, 0,
                )
            else:
                kind = msg.get("kind", "internal")
                if kind not in ERROR_KINDS:
                    kind = "internal"
                waiter.error = QueryError(
                    str(msg.get("error", "front-door error")),
                    kind=kind, query=(waiter.src, waiter.dst),
                )
                ra = msg.get("retry_after_ms")
                if ra is not None:
                    # brownout sheds carry a backoff hint; ride it on
                    # the structured error for the caller's retry loop
                    waiter.error.retry_after_ms = ra
            waiter.t_done = time.perf_counter()
            if waiter.span is not None:
                self._finish_traced(waiter, msg)
            waiter.event.set()
        else:
            waiter.msg = msg
            waiter.event.set()

    def _finish_traced(self, waiter: NetTicket, msg: dict) -> None:
        """Close a sampled query's client span: subtract the server's
        own processing time (its ``rx``/``stx`` wall stamps) from the
        client RTT to get the wire stage, and estimate the clock offset
        NTP-style — ``(rx - t0) + (stx - t3)) / 2`` with the wire time
        itself bounding the estimate's error."""
        rtt_s = waiter.t_done - waiter.t_sent
        rx, stx = msg.get("rx"), msg.get("stx")
        args = {"rtt_ms": round(rtt_s * 1e3, 3)}
        if isinstance(rx, (int, float)) and isinstance(stx, (int, float)):
            wire_s = max(rtt_s - (stx - rx) / 1e6, 0.0)
            self._stage_cells["wire"].record(wire_s)
            t0 = wall_us(waiter.t_sent)
            t3 = wall_us(waiter.t_done)
            args["wire_ms"] = round(wire_s * 1e3, 3)
            args["clock_offset_us"] = round(
                ((rx - t0) + (stx - t3)) / 2.0, 1
            )
            args["offset_bound_us"] = round(wire_s * 5e5, 1)
        if waiter.error is not None:
            args["error"] = getattr(waiter.error, "kind", "internal")
        waiter.span.finish(**args)

    def _fail_all(self) -> None:
        with self._lock:
            self._dead = True
            waiters = list(self._waiters.values())
            self._waiters.clear()
        for waiter in waiters:
            if isinstance(waiter, NetTicket):
                if waiter.result is None and waiter.error is None:
                    waiter.error = QueryError(
                        "connection closed with the query pending",
                        kind="internal",
                        query=(waiter.src, waiter.dst),
                    )
                waiter.t_done = time.perf_counter()
                if waiter.span is not None:
                    waiter.span.finish(error="disconnected")
                waiter.event.set()
            else:
                waiter.event.set()  # msg stays None: ConnectionError

    # ---- API ---------------------------------------------------------
    @property
    def alive(self) -> bool:
        return not self._dead

    def pending_count(self) -> int:
        """In-flight requests (queries + control) awaiting replies —
        a caller's load signal."""
        with self._lock:
            return len(self._waiters)

    def submit(self, src: int, dst: int, graph: str | None = None, *,
               deadline_ms: float | None = None,
               tenant: str | None = None, kind: str | None = None,
               ctx=None) -> NetTicket:
        ticket = NetTicket(int(src), int(dst), graph)
        rid = self._register(ticket)
        frame = {"op": "query", "id": rid, "src": ticket.src,
                 "dst": ticket.dst}
        if graph is not None:
            frame["graph"] = graph
        if deadline_ms is not None:
            frame["deadline_ms"] = float(deadline_ms)
        if kind is not None:
            # the admission class for brownout-armed servers (module
            # docstring); the wire still computes a point lookup
            frame["kind"] = str(kind)
        t = tenant if tenant is not None else self.tenant
        if t is not None:
            frame["tenant"] = t
        # distributed trace: the client IS the ingress when it holds a
        # tracer — sample here (or adopt the caller's ctx), open the
        # client span, and carry its context on the frame so the
        # server's spans parent under it
        if ctx is None:
            ctx = sample_ctx()
        if ctx is not None:
            sp = dspan("net_client", ctx, src=ticket.src, dst=ticket.dst)
            ticket.span = sp
            ticket.t_sent = time.perf_counter()
            frame.update(ctx_fields(sp.ctx))
        try:
            self._send(encode_frame(frame))
        except ConnectionError:
            with self._lock:
                self._waiters.pop(rid, None)
            raise
        return ticket

    def request(self, op: str, timeout: float = 60.0, **fields) -> dict:
        """One control op round-trip; returns the reply's ``result``.
        Structured server refusals raise :class:`QueryError` with the
        wire kind; a dead connection raises :class:`ConnectionError`."""
        waiter = _CtrlWaiter()
        rid = self._register(waiter)
        frame = {"op": op, "id": rid}
        frame.update(fields)
        try:
            self._send(encode_frame(frame))
        except ConnectionError:
            with self._lock:
                self._waiters.pop(rid, None)
            raise
        if not waiter.event.wait(timeout):
            with self._lock:
                self._waiters.pop(rid, None)
            raise TimeoutError(f"no reply to {op!r} in {timeout}s")
        msg = waiter.msg
        if msg is None:
            raise ConnectionError("connection closed mid-command")
        if not msg.get("ok"):
            kind = msg.get("kind", "internal")
            if kind not in ERROR_KINDS:
                kind = "internal"
            raise QueryError(
                str(msg.get("error", f"{op} refused")), kind=kind
            )
        return msg.get("result")

    def close(self) -> None:
        with self._lock:
            self._dead = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
