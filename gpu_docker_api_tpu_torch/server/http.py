"""Minimal threaded HTTP server + router + middleware.

Reference parity: gin engine + middleware (internal/routers/cors.go:10-32
permissive reflected-origin CORS with OPTIONS short-circuit; auth.go:11-26
static bearer token from APIKEY env, no-op when unset) and the uniform
envelope ResponseData{code,msg,data} with HTTP status always 200
(response.go:9-29). stdlib only — the image has no web framework, and a
control plane doesn't need one.

The port's copy of the JAX control plane's server/http.py.
"""

from __future__ import annotations

import json
import logging
import os
import re
import socket
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

from .. import faults
from ..obs import metrics as obs_metrics
from ..obs import trace
from .codes import ResCode

log = logging.getLogger(__name__)

Handler = Callable[["Request"], "Response"]


class Request:
    def __init__(self, method: str, path: str, query: dict[str, list[str]],
                 body: bytes, headers: dict[str, str], params: dict[str, str],
                 client_addr: str = ""):
        self.method = method
        self.path = path
        self.query = query
        self.body = body
        self.headers = headers
        self.params = params
        # remote address — the admission gate's per-client fairness key
        self.client_addr = client_addr
        # version precondition, parsed once by the mutation middleware
        # (server/app.py) from the If-Match header
        self.if_match: Optional[int] = None
        self.request_id = uuid.uuid4().hex[:16]

    def json(self) -> dict:
        if not self.body:
            return {}
        return json.loads(self.body)

    def query_flag(self, name: str) -> bool:
        return name in self.query

    def header(self, name: str, default: str = "") -> str:
        """Case-insensitive header lookup — dict(self.headers) in the
        handler discarded the stdlib's case folding, and header names
        (per RFC 9110, and W3C Trace Context explicitly) match in any
        case. Exact-case hit first: it is the overwhelmingly common
        wire form."""
        v = self.headers.get(name)
        if v is not None:
            return v
        lname = name.lower()
        for k, hv in self.headers.items():
            if k.lower() == lname:
                return hv
        return default


class Response:
    def __init__(self, code: ResCode, data: Optional[dict] = None,
                 msg: Optional[str] = None,
                 http_status: int = 200,
                 headers: Optional[dict[str, str]] = None):
        self.code = code
        self.data = data
        self.msg = msg if msg is not None else code.msg
        # the envelope convention is HTTP-200-always (reference
        # response.go); http_status exists for the ONE deliberate
        # exception — 503 + Retry-After when the backend breaker is open,
        # so load balancers and generic clients back off without parsing
        # the envelope
        self.http_status = http_status
        self.headers = dict(headers or {})
        # stamped by the ingress pipeline on ERROR envelopes so a failed
        # call is greppable server-side: GET /api/v1/traces/{traceId}
        self.trace_id = ""

    def payload(self) -> bytes:
        env = {"code": int(self.code), "msg": self.msg, "data": self.data}
        if self.trace_id:
            env["traceId"] = self.trace_id
        return json.dumps(env, default=str).encode("utf-8")


class RawResponse(Response):
    """Bypass the JSON envelope — for /metrics (Prometheus text) and
    /openapi.json (the spec document itself)."""

    def __init__(self, body: bytes, content_type: str = "application/json"):
        super().__init__(ResCode.Success, None)
        self._body = body
        self.content_type = content_type

    def payload(self) -> bytes:
        return self._body


class StreamingResponse(Response):
    """Close-delimited streaming body (SSE: GET /api/v1/events?follow=1).

    The handler returns immediately with a byte-chunk ITERATOR; the
    connection thread writes chunks as the iterator produces them and the
    socket close delimits the body (no Content-Length). The producing
    generator owns pacing — it parks on EventLog.wait_since() and yields
    heartbeats, so an idle follower costs one blocked thread and zero
    polling."""

    def __init__(self, chunks, content_type: str = "text/event-stream",
                 headers: Optional[dict[str, str]] = None):
        super().__init__(ResCode.Success, None, headers=headers)
        self.chunks = chunks
        self.content_type = content_type


def ok(data: Optional[dict] = None) -> Response:
    return Response(ResCode.Success, data)


def err(code: ResCode, msg: "str | None" = None) -> Response:
    return Response(code, None, msg=msg)


def unavailable(e: BaseException) -> Response:
    """503 + Retry-After for an open backend circuit (degraded mode):
    mutating routes answer with this; reads keep serving from the store."""
    retry = max(1, int(round(float(getattr(e, "retry_after", 5.0)))))
    return Response(ResCode.BackendUnavailable, None, http_status=503,
                    headers={"Retry-After": str(retry)})


def precondition_failed(e: BaseException) -> Response:
    """412 for a failed If-Match version check: the current version rides
    both the payload and X-Current-Version so the client can rebase."""
    current = int(getattr(e, "current", 0))
    return Response(ResCode.PreconditionFailed,
                    {"currentVersion": current}, http_status=412,
                    headers={"X-Current-Version": str(current)})


def too_many(reason: str = "", retry_after: float = 1.0) -> Response:
    """429 + Retry-After: the mutation admission gate shed this request
    before it touched any state (server/app.py MutationGate)."""
    retry = max(1, int(round(retry_after)))
    return Response(ResCode.TooManyRequests, None,
                    msg=(f"{ResCode.TooManyRequests.msg} ({reason})"
                         if reason else None),
                    http_status=429, headers={"Retry-After": str(retry)})


class DroppedResponse(Exception):
    """Injected drop_response fault (faults.py): the handler executed;
    sever the connection without writing a response byte."""


class Router:
    """(method, /path/with/:params) -> handler."""

    def __init__(self) -> None:
        self._routes: list[tuple[str, re.Pattern, Handler, str]] = []
        self._patterns: list[tuple[str, str]] = []

    def add(self, method: str, pattern: str, handler: Handler) -> None:
        regex = re.compile(
            "^" + re.sub(r":([a-zA-Z_]+)", r"(?P<\1>[^/]+)", pattern) + "$")
        self._routes.append((method.upper(), regex, handler, pattern))
        self._patterns.append((method.upper(), pattern))

    def routes(self) -> list[tuple[str, str]]:
        """(METHOD, original /path/with/:params) pairs — lets the OpenAPI
        coverage test assert the document describes every registered
        route."""
        return list(self._patterns)

    def resolve(self, method: str, path: str):
        handler, params, _ = self.resolve_full(method, path)
        return handler, params

    def resolve_full(self, method: str, path: str):
        """(handler, params, route pattern). The PATTERN — not the raw
        path — labels the request-latency histogram and names the ingress
        span, so metric/trace cardinality is bounded by the route table."""
        path_matched = False
        for m, regex, handler, pattern in self._routes:
            match = regex.match(path)
            if match:
                path_matched = True
                if m == method.upper():
                    return handler, match.groupdict(), pattern
        return (None, {"_405": "1"}, "") if path_matched else (None, {}, "")


class _KeepAliveHTTPServer(ThreadingHTTPServer):
    # listen backlog (consumed by server_activate at construction): the
    # default 5 SYN-drops any >5-client connect burst into multi-second
    # kernel retries. Keep-alive makes connects rare, but the first wave
    # of a fleet must not stall.
    request_queue_size = 128

    # SO_REUSEPORT before bind: N processes may bind the SAME port and the
    # kernel load-balances accepts across them — the multi-process data
    # plane (server/workers.py). Must be set between socket creation and
    # bind, hence the server_bind override (set on the instance by
    # ApiServer._bind before binding).
    reuse_port = False

    def server_bind(self):
        if self.reuse_port:
            self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()


class ApiServer:
    def __init__(self, router: Router, addr: str = "127.0.0.1:2378",
                 api_key: Optional[str] = None, events=None, traces=None,
                 quiet_routes: Optional[frozenset] = None,
                 reuse_port: bool = False):
        #: bind with SO_REUSEPORT (multi-process front tier): several
        #: ApiServers — across processes — share one port and the kernel
        #: load-balances accepted connections between them
        self.reuse_port = reuse_port
        self.router = router
        self.events = events
        # (METHOD, route pattern) pairs whose requests do NOT land an
        # event-log row each: DATA-PLANE routes (gateway generate). At
        # serving rates a per-request row floods the bounded ring —
        # evicting the control-plane events an operator actually greps —
        # and json-encoding the row is measurable against a single decode
        # step. Latency still lands in the route-labeled histogram, and
        # failures still trace.
        self.quiet_routes = quiet_routes or frozenset()
        # TraceCollector (obs/trace.py): when set, every request runs under
        # an ingress root span honoring the client's W3C traceparent
        self.traces = traces
        host, _, port = addr.rpartition(":")
        self.host = host or "0.0.0.0"
        self.port = int(port)
        # reference auth.go:9 — static bearer token from APIKEY env, noop if unset
        self.api_key = api_key if api_key is not None else os.environ.get("APIKEY", "")
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # graceful-drain state: stop() waits for in-flight requests to
        # complete (instead of closing sockets under them) and then severs
        # the remaining IDLE keep-alive connections so their handler
        # threads unblock
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._inflight = 0
        self._draining = False
        # sockets currently serving a StreamingResponse: stop() severs
        # these FIRST (an SSE follower is in-flight by design and would
        # otherwise eat the whole drain timeout)
        self._streams: set = set()

    # ---- request pipeline ----

    def _handle(self, method: str, raw_path: str, body: bytes,
                headers: dict[str, str],
                client_addr: str = "") -> tuple[int, dict[str, str], bytes]:
        cors = {
            # reflected-origin permissive CORS (reference cors.go:12-20)
            "Access-Control-Allow-Origin": headers.get("Origin", "*"),
            "Access-Control-Allow-Methods": "GET, POST, PATCH, DELETE, OPTIONS",
            "Access-Control-Allow-Headers": "Content-Type, Authorization",
            "Content-Type": "application/json",
        }
        if method == "OPTIONS":  # preflight short-circuit (cors.go:22-29)
            return 204, cors, b""

        if self.api_key:
            tok = headers.get("Authorization", "")
            if tok.removeprefix("Bearer ").strip() != self.api_key:
                return 200, cors, Response(ResCode.Forbidden).payload()

        parsed = urlparse(raw_path)
        handler, params, route = self.router.resolve_full(method, parsed.path)
        if handler is None:
            body_out = json.dumps({"code": 404 if "_405" not in params else 405,
                                   "msg": "route not found", "data": None}).encode()
            return 404, cors, body_out

        req = Request(method, parsed.path, parse_qs(parsed.query, keep_blank_values=True),
                      body, headers, params, client_addr=client_addr)
        # W3C trace context: header names match case-insensitively (a
        # proxy may re-case what the client sent)
        traceparent = req.header("traceparent")
        t0 = time.perf_counter()
        trace_id = ""
        with trace.root_span(self.traces, f"{method} {route}",
                             traceparent=traceparent,
                             target=params.get("name", "")) as sp:
            try:
                resp = handler(req)
            except json.JSONDecodeError:
                resp = err(ResCode.InvalidParams)
            except Exception:  # noqa: BLE001 — the envelope absorbs handler crashes
                log.exception("unhandled error on %s %s [%s]", method,
                              parsed.path, req.request_id)
                resp = err(ResCode.ServerBusy)
            if sp is not None:
                trace_id = sp.trace_id
                sp.set(code=int(resp.code), requestId=req.request_id)
        duration_ms = (time.perf_counter() - t0) * 1000
        obs_metrics.REQUEST_LATENCY.observe(duration_ms, method=method,
                                            route=route)
        # error envelopes carry the trace id: `code != 200` is exactly the
        # response an operator greps the trace for
        if trace_id and int(resp.code) != 200 \
                and not isinstance(resp, RawResponse):
            resp.trace_id = trace_id
        if self.events is not None \
                and (method, route) not in self.quiet_routes:
            extra = {"traceId": trace_id} if trace_id else {}
            self.events.record(
                op=f"{method} {parsed.path}",
                target=params.get("name", ""),
                code=int(resp.code),
                duration_ms=duration_ms,
                request_id=req.request_id, **extra)
        # duplicate-delivery injection: the handler EXECUTED; make the
        # client see a dead connection instead of the response
        if faults.should_drop_response(f"{method} {parsed.path}"):
            raise DroppedResponse()
        if isinstance(resp, (RawResponse, StreamingResponse)):
            cors["Content-Type"] = resp.content_type
        if resp.headers:
            cors.update(resp.headers)
        if isinstance(resp, StreamingResponse):
            return resp.http_status, cors, resp
        return resp.http_status, cors, resp.payload()

    # ---- lifecycle ----

    def _make_handler(self):
        server = self

        class _Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 + the Content-Length we always send = persistent
            # connections: a client keeps one TCP socket (and one server
            # thread) across requests instead of paying handshake + slow
            # start per call — the keep-alive half of the hot-path work
            # (client.py pools the other half)
            protocol_version = "HTTP/1.1"
            # small request/response envelopes: Nagle would hold the last
            # segment hostage waiting for an ACK that keep-alive defers
            disable_nagle_algorithm = True
            # idle keep-alive sockets are dropped after this (the base
            # handler catches the timeout and closes), so dead clients
            # can't pin a ThreadingHTTPServer thread forever
            timeout = 120

            def log_message(self, fmt, *args):  # route through our logger
                log.debug("http: " + fmt, *args)

            def setup(self):
                super().setup()
                with server._conns_lock:
                    server._conns.add(self.connection)

            def finish(self):
                with server._conns_lock:
                    server._conns.discard(self.connection)
                super().finish()

            def _dispatch(self):
                length = int(self.headers.get("Content-Length", 0) or 0)
                body = self.rfile.read(length) if length else b""
                # in-flight accounting spans handler AND response write:
                # stop() drains until this hits zero, so a mutation's
                # response is never cut off mid-socket
                with server._conns_lock:
                    server._inflight += 1
                try:
                    try:
                        status, hdrs, payload = server._handle(
                            self.command, self.path, body, dict(self.headers),
                            self.client_address[0])
                    except DroppedResponse:
                        # injected duplicate delivery: the mutation ran;
                        # sever without writing a byte
                        self.close_connection = True
                        try:
                            self.connection.shutdown(socket.SHUT_RDWR)
                        except OSError:
                            pass
                        return
                    if isinstance(payload, StreamingResponse):
                        self._stream(status, hdrs, payload)
                        return
                    if server._draining:
                        hdrs = dict(hdrs)
                        hdrs["Connection"] = "close"
                        self.close_connection = True
                    self.send_response(status)
                    for k, v in hdrs.items():
                        self.send_header(k, v)
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    if payload:
                        self.wfile.write(payload)
                finally:
                    with server._conns_lock:
                        server._inflight -= 1

            def _stream(self, status, hdrs, resp: StreamingResponse):
                """Write a close-delimited streaming body. The producing
                generator blocks between chunks; a client disconnect (or
                stop() severing the socket) surfaces as an OSError on
                write, which simply ends the stream."""
                self.close_connection = True
                self.send_response(status)
                for k, v in hdrs.items():
                    self.send_header(k, v)
                self.send_header("Connection", "close")
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                with server._conns_lock:
                    server._streams.add(self.connection)
                try:
                    for chunk in resp.chunks:
                        if chunk:
                            self.wfile.write(chunk)
                            self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                finally:
                    with server._conns_lock:
                        server._streams.discard(self.connection)
                    close = getattr(resp.chunks, "close", None)
                    if close is not None:
                        close()

            do_GET = do_POST = do_PATCH = do_DELETE = do_OPTIONS = _dispatch

        return _Handler

    def _bind(self) -> None:
        # bind_and_activate=False: reuse_port must land on the socket
        # BETWEEN creation and bind (server_bind reads it)
        self._httpd = _KeepAliveHTTPServer((self.host, self.port),
                                           self._make_handler(),
                                           bind_and_activate=False)
        self._httpd.reuse_port = self.reuse_port
        try:
            self._httpd.server_bind()
            self._httpd.server_activate()
        except Exception:
            self._httpd.server_close()
            self._httpd = None
            raise
        self.port = self._httpd.server_address[1]

    def serve_forever(self) -> None:
        self._bind()
        self._httpd.serve_forever(poll_interval=0.1)

    def start(self) -> None:
        """Serve on a daemon thread; returns once the socket is bound."""
        self._bind()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="api-server", daemon=True)
        self._thread.start()

    def stop(self, drain_timeout: float = 10.0) -> None:
        """Graceful shutdown: stop accepting, DRAIN in-flight requests to
        completion (a client mid-mutation gets its response, not a reset),
        then sever the remaining idle keep-alive sockets so their handler
        threads unblock instead of sitting out the 120s idle timeout."""
        if self._httpd is not None:
            self._draining = True
            self._httpd.shutdown()      # accept loop stops; workers keep going
            # SSE followers are in-flight FOREVER by design: sever their
            # sockets (the write loop ends on the OSError) instead of
            # letting each one eat the whole drain timeout below, and wake
            # their generators out of wait_since() so the dead socket is
            # noticed now, not at the next heartbeat. Repeated every drain
            # poll, not once: a follower whose generator read _draining
            # just before we set it parks AFTER this first wake, and one
            # that registered after the first snapshot was never severed.
            def _sever_streams() -> None:
                with self._conns_lock:
                    streams = list(self._streams)
                for conn in streams:
                    try:
                        conn.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                if self.events is not None:
                    self.events.wake_all()

            _sever_streams()
            deadline = time.monotonic() + max(0.0, drain_timeout)
            clear_streak = 0
            while time.monotonic() < deadline:
                _sever_streams()
                with self._conns_lock:
                    busy = self._inflight
                if busy == 0:
                    # two consecutive clear reads: a request accepted just
                    # before shutdown() may not have entered _dispatch yet
                    clear_streak += 1
                    if clear_streak >= 2:
                        break
                else:
                    clear_streak = 0
                time.sleep(0.02)
            with self._conns_lock:
                idle = list(self._conns)
            for conn in idle:
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._draining = False
