"""Spec-generated typed client.

The reference distributes its OpenAPI document for client generation; this
module IS that generator, in-process: `ApiClient` builds one method per
`operationId` from the served (or on-disk) api/openapi.json — request bodies
are validated against the spec's schemas BEFORE anything hits the wire, path
parameters are typed, and app-level envelope errors raise `ApiError` with
the code table's name. tests/test_openapi.py drives the live server with it,
which keeps the generated document honest: a schema that drifts from the
handlers fails the client smoke test.

Usage:
    c = ApiClient("127.0.0.1", 2378)         # fetches /openapi.json
    c.runReplicaSet(body={"imageName": "python", "replicaSetName": "t"})
    c.getReplicaSet(name="t")
    c.deleteReplicaSet(name="t")

The port's copy of the JAX control plane's client.py. Against the port's
daemon the spec it fetches describes the routes that daemon serves.
"""

from __future__ import annotations

import http.client
import json
import re
import threading
import time
import urllib.parse
import uuid
from typing import Any, Iterator, Optional

from .obs.trace import format_traceparent, new_span_id, new_trace_id


class ApiError(RuntimeError):
    """App-level envelope error (code != 200).

    `trace_id` is the W3C trace id the failed request ran under (from the
    error envelope when the server traced it, else the id this client
    generated) — `grep traces.jsonl` or `GET /api/v1/traces/{trace_id}`
    server-side shows exactly where the mutation failed."""

    def __init__(self, code: int, msg: str, op: str, trace_id: str = ""):
        tail = f" [trace {trace_id}]" if trace_id else ""
        super().__init__(f"{op}: code {code} ({msg}){tail}")
        self.code = code
        self.msg = msg
        self.trace_id = trace_id


class EventGapError(RuntimeError):
    """The event ring evicted past a Last-Event-ID resume point: events
    between `last_event_id` and `first_retained` are GONE, and the server
    said so (`event: gap`) instead of silently serving the survivors.
    Refetch state (GET the resources you mirror), then re-follow from
    now — the stream after this error would be complete but the hole
    before it cannot be closed."""

    def __init__(self, last_event_id: int, first_retained: int):
        super().__init__(
            f"event stream gap: resumed from seq {last_event_id} but the "
            f"ring starts at {first_retained} — events in between were "
            f"evicted; refetch state and re-follow")
        self.last_event_id = last_event_id
        self.first_retained = first_retained


class RelistRequiredError(RuntimeError):
    """The watch stream cannot serve `from_revision`: it predates the
    server's retention floor (refused up front) or the ring lapped this
    follower mid-stream (`event: gap`). Take a fresh list snapshot and
    resume from its revision — `Informer` does this automatically."""

    def __init__(self, floor: int, from_revision: int = -1):
        super().__init__(
            f"watch revision too old (floor {floor}): relist and resume "
            f"from the snapshot revision")
        self.floor = floor
        self.from_revision = from_revision


class SchemaError(ValueError):
    """Request body rejected by the spec BEFORE sending."""


def _resolve(spec: dict, schema: dict) -> dict:
    """Follow $refs into components — schemas AND parameters (the spec
    $refs the shared traceparent header param into every operation)."""
    while "$ref" in schema:
        section, name = schema["$ref"].rsplit("/", 2)[-2:]
        schema = spec["components"][section][name]
    return schema


def validate(spec: dict, schema: dict, value: Any, path: str = "$") -> None:
    """Minimal JSON-Schema subset validator covering what the generated
    document uses: type, required, properties, additionalProperties,
    items, $ref, allOf, nullable, enum, minimum. Raises SchemaError with
    the JSON path of the first violation."""
    schema = _resolve(spec, schema)
    if value is None:
        if schema.get("nullable") or not schema.get("type"):
            return
        raise SchemaError(f"{path}: null not allowed")
    for sub in schema.get("allOf", []):
        validate(spec, sub, value, path)
    t = schema.get("type")
    if t == "object":
        if not isinstance(value, dict):
            raise SchemaError(f"{path}: expected object, got "
                              f"{type(value).__name__}")
        props = schema.get("properties", {})
        for req in schema.get("required", []):
            if req not in value:
                raise SchemaError(f"{path}: missing required '{req}'")
        extra = schema.get("additionalProperties")
        for k, v in value.items():
            if k in props:
                validate(spec, props[k], v, f"{path}.{k}")
            elif isinstance(extra, dict):
                validate(spec, extra, v, f"{path}.{k}")
            elif extra is False:
                raise SchemaError(f"{path}: unknown field '{k}'")
    elif t == "array":
        if not isinstance(value, list):
            raise SchemaError(f"{path}: expected array")
        for idx, v in enumerate(value):
            validate(spec, schema.get("items", {}), v, f"{path}[{idx}]")
    elif t == "string":
        if not isinstance(value, str):
            raise SchemaError(f"{path}: expected string")
    elif t == "integer":
        if not isinstance(value, int) or isinstance(value, bool):
            raise SchemaError(f"{path}: expected integer")
        if "minimum" in schema and value < schema["minimum"]:
            raise SchemaError(f"{path}: {value} < minimum "
                              f"{schema['minimum']}")
    elif t == "number":
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            raise SchemaError(f"{path}: expected number")
    elif t == "boolean":
        if not isinstance(value, bool):
            raise SchemaError(f"{path}: expected boolean")
    if "enum" in schema and value not in schema["enum"]:
        raise SchemaError(f"{path}: {value!r} not in {schema['enum']}")


class ApiClient:
    """One method per operationId, generated from the spec at init."""

    def __init__(self, host: str, port: int,
                 spec: Optional[dict] = None, api_key: str = "",
                 timeout: float = 60.0, get_retries: int = 2,
                 retry_backoff: float = 0.1, retry_backoff_cap: float = 1.0,
                 keep_alive: bool = True, idempotency: bool = True):
        self.host, self.port = host, port
        self.api_key = api_key
        self.timeout = timeout
        # connection-error retry budget. GETs always get it (idempotent by
        # HTTP semantics and by this API's design). Mutations get the SAME
        # budget when `idempotency` is on: every mutating call is stamped
        # with a fresh Idempotency-Key, so a resend of a request the
        # server already executed replays the stored response instead of
        # double-applying (server-side result cache, idempotency.py).
        # With idempotency=False mutations are never retried — a
        # connection error may mean the daemon died AFTER applying.
        self.get_retries = max(0, int(get_retries))
        self.retry_backoff = retry_backoff
        self.retry_backoff_cap = retry_backoff_cap
        self.idempotency = idempotency
        # keep-alive pool: ONE persistent HTTPConnection per calling thread
        # (http.client connections are not thread-safe), reused across
        # requests — no TCP setup on the hot path. keep_alive=False restores
        # the connection-per-request behavior for debugging.
        self.keep_alive = keep_alive
        self._pool = threading.local()
        # every pooled connection ever handed out, so close() can release
        # ALL threads' sockets; _gen invalidates other threads' pool slots
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._gen = 0
        self._stats_lock = threading.Lock()
        self._stats = {"getRetries": 0, "mutationRetries": 0,
                       "staleRetries": 0, "replays": 0}
        if spec is None:
            spec = json.loads(self._raw("GET", "/openapi.json"))
        self.spec = spec
        # retrying a mutation is only safe when the SERVER deduplicates:
        # against an older daemon whose spec doesn't advertise the
        # Idempotency-Key header, a resend would double-apply — fall
        # back to the never-retry-mutations behavior automatically
        if self.idempotency and not self._spec_supports_idempotency():
            self.idempotency = False
        self.operations: dict[str, dict] = {}
        for path, methods in spec["paths"].items():
            for method, op in methods.items():
                if method not in ("get", "post", "patch", "delete", "put"):
                    continue
                self.operations[op["operationId"]] = {
                    "method": method.upper(), "path": path, "op": op}

    def _spec_supports_idempotency(self) -> bool:
        """True when any operation documents the Idempotency-Key header
        (servers >= 0.6.0 — the ones that replay duplicates)."""
        for methods in self.spec.get("paths", {}).values():
            for op in methods.values():
                if not isinstance(op, dict):
                    continue
                for p in op.get("parameters", []):
                    if _resolve(self.spec, p).get("name") == \
                            "Idempotency-Key":
                        return True
        return False

    def __getattr__(self, name: str):
        ops = self.__dict__.get("operations") or {}
        if name not in ops:
            raise AttributeError(
                f"no operation {name!r}; spec defines: "
                f"{', '.join(sorted(ops))}")
        entry = ops[name]

        def call(body: Any = None, **params):
            return self._invoke(name, entry, body, params)
        call.__name__ = name
        call.__doc__ = entry["op"].get("summary", "")
        return call

    # ---- wire ----

    def _connection(self) -> http.client.HTTPConnection:
        """This thread's pooled connection (created on first use). A slot
        minted before the last close() is stale — discard and re-open."""
        conn = getattr(self._pool, "conn", None)
        if conn is not None and getattr(self._pool, "gen", -1) != self._gen:
            try:
                conn.close()
            except OSError:
                pass
            conn = None
        if conn is None:
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=self.timeout)
            self._pool.conn = conn
            self._pool.gen = self._gen
            self._pool.reused = False  # no request completed on it yet
            with self._conns_lock:
                self._conns.add(conn)
        return conn

    def _discard_connection(self) -> None:
        """Close-on-error: a connection that saw any failure is never
        reused — the next request opens fresh."""
        conn = getattr(self._pool, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
            self._pool.conn = None
            with self._conns_lock:
                self._conns.discard(conn)

    def close(self) -> None:
        """Release EVERY pooled connection — all threads', not just the
        caller's (a client shared across worker threads used to leak one
        socket per thread). Other threads notice the generation bump and
        re-open lazily on their next call."""
        with self._conns_lock:
            conns, self._conns = list(self._conns), set()
            self._gen += 1
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        self._pool.conn = None

    def stats(self) -> dict:
        """Connection-retry / replay counters: getRetries and
        mutationRetries (budgeted resends after a connection error),
        staleRetries (free fresh-socket retry after a reaped keep-alive
        connection), replays (responses the server answered from its
        idempotency cache rather than executing)."""
        with self._stats_lock:
            return dict(self._stats)

    def _bump(self, stat: str) -> None:
        with self._stats_lock:
            self._stats[stat] += 1

    def _raw(self, method: str, path: str, payload: bytes | None = None,
             content_type: str = "application/json",
             extra_headers: Optional[dict] = None,
             idempotent: bool = False) -> bytes:
        # connection-level retries for requests that are safe to resend:
        # GETs (idempotent by HTTP semantics and by this API's design) and
        # mutations stamped with an Idempotency-Key (the server replays
        # the stored response instead of re-executing) — capped
        # exponential backoff. Independently of that budget, retryable
        # requests take ONE free immediate retry on a fresh socket when a
        # REUSED keep-alive connection is cleanly closed before a byte of
        # response arrives (RemoteDisconnected) — the server reaping an
        # idle socket. Un-keyed mutations NEVER retry at all: a clean
        # close can also be the daemon dying AFTER processing the request
        # but before responding, and resending would double-apply.
        retryable = method == "GET" or idempotent
        attempts = 1 + (self.get_retries if retryable else 0)
        attempt = 0
        stale_retry_left = True
        # HTTP 409 = our keyed retry raced the still-executing original
        # (e.g. the first attempt timed out client-side but kept running
        # server-side): poll for the stored result per Retry-After
        # instead of surfacing a bogus terminal error
        conflict_polls_left = max(1, self.get_retries) if idempotent else 0
        headers = {"Content-Type": content_type}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        if extra_headers:
            headers.update(extra_headers)
        # W3C trace context: ONE trace id per logical request (resends
        # included — they are the same logical operation), so the server's
        # trace shows the retry history end-to-end
        if "traceparent" not in headers:
            headers["traceparent"] = format_traceparent(new_trace_id(),
                                                        new_span_id())
        while True:
            conn = self._connection()
            reused = self._pool.reused
            try:
                conn.request(method, path, payload, headers)
                resp = conn.getresponse()
                body = resp.read()
                if resp.getheader("Idempotency-Replayed"):
                    self._bump("replays")
                if self.keep_alive and not resp.will_close:
                    self._pool.reused = True
                else:
                    self._discard_connection()
                if resp.status == 409 and conflict_polls_left > 0:
                    conflict_polls_left -= 1
                    self._bump("mutationRetries")
                    try:
                        wait = float(resp.getheader("Retry-After") or 1)
                    except ValueError:
                        wait = 1.0
                    time.sleep(min(2.0, max(0.05, wait)))
                    continue
                return body
            except (ConnectionError, TimeoutError, OSError,
                    http.client.HTTPException) as e:
                self._discard_connection()
                if (reused and stale_retry_left and retryable
                        and isinstance(e, http.client.RemoteDisconnected)):
                    stale_retry_left = False
                    self._bump("staleRetries")
                    continue
                attempt += 1
                if attempt >= attempts:
                    raise
                self._bump("getRetries" if method == "GET"
                           else "mutationRetries")
                time.sleep(min(self.retry_backoff_cap,
                               self.retry_backoff * (2 ** (attempt - 1))))

    def _invoke(self, op_id: str, entry: dict, body: Any,
                params: dict) -> Any:
        op = entry["op"]
        path = entry["path"]
        method = entry["method"]
        # reserved kwargs (header-borne; dashes can't be kwarg names):
        # if_match=N sends If-Match; idempotency_key overrides the
        # auto-generated per-call key; mesh_plan folds a gang MeshPlan
        # into the body of runReplicaSet / patchReplicaSet
        extra: dict[str, str] = {}
        if_match = params.pop("if_match", None)
        if if_match is not None:
            extra["If-Match"] = str(if_match)
        mesh_plan = params.pop("mesh_plan", None)
        if mesh_plan is not None:
            body = self._fold_mesh_plan(op_id, body, mesh_plan)
        self._check_mesh_plan(op_id, body)
        idem_key = params.pop("idempotency_key", None)
        if method != "GET" and (idem_key or self.idempotency):
            extra["Idempotency-Key"] = str(idem_key or uuid.uuid4().hex)
        query = []
        for p in op.get("parameters", []):
            p = _resolve(self.spec, p)
            if p.get("in") == "header":
                continue        # documentation-only; sent via `extra`
            val = params.pop(p["name"], None)
            if p.get("required") and val is None:
                raise SchemaError(f"{op_id}: missing path parameter "
                                  f"'{p['name']}'")
            if val is None:
                continue
            if p["name"] == "follow":
                # follow switches the server to an unbounded SSE stream
                # (presence-based, like every flag param): the generic
                # request/response path would read it forever and pin the
                # pooled keep-alive connection — streaming has a
                # dedicated generator
                raise SchemaError(
                    f"{op_id}: 'follow' streams Server-Sent Events; use "
                    f"follow_events() instead")
            validate(self.spec, p.get("schema", {}), val,
                     f"${{{p['name']}}}")
            if p["in"] == "path":
                path = path.replace("{" + p["name"] + "}", str(val))
            elif p.get("schema", {}).get("type") == "boolean":
                # flag params are PRESENCE-based server-side
                # (http.query_flag): sending 'x=False' would read as set
                if val:
                    query.append(p["name"])
            else:
                query.append(f"{p['name']}={val}")
        if params:
            raise SchemaError(f"{op_id}: unknown parameters "
                              f"{sorted(params)}")
        if re.search(r"\{[^}]+\}", path):
            raise SchemaError(f"{op_id}: unresolved path params in {path}")
        if query:
            path += "?" + "&".join(query)
        payload = None
        rb = op.get("requestBody")
        if rb is not None:
            if body is None and rb.get("required"):
                raise SchemaError(f"{op_id}: request body required")
            if body is not None:
                schema = rb["content"]["application/json"]["schema"]
                validate(self.spec, schema, body, "body")
                payload = json.dumps(body).encode()
        elif body is not None:
            raise SchemaError(f"{op_id} takes no request body")
        # auto-retry requires SERVER-side dedup: an explicit key is still
        # sent (caller's choice), but against a daemon whose spec doesn't
        # advertise the header a resend would double-apply — never retry
        tid = new_trace_id()
        extra["traceparent"] = format_traceparent(tid, new_span_id())
        raw = self._raw(method, path, payload, extra_headers=extra,
                        idempotent=(self.idempotency
                                    and bool(extra.get("Idempotency-Key"))))
        ok = op["responses"].get("200", {})
        if "application/json" not in ok.get("content", {}):
            return raw                       # /metrics, /openapi.json
        return self._envelope(raw, op_id, fallback_tid=tid).get("data")

    @staticmethod
    def _fold_mesh_plan(op_id: str, body, mesh_plan: dict):
        """Fold the mesh_plan= convenience kwarg into the op's body:
        runReplicaSet carries it top-level, patchReplicaSet inside
        tpuPatch. Any other operation has no meshPlan surface."""
        if not isinstance(mesh_plan, dict):
            raise SchemaError(f"{op_id}: mesh_plan must be a dict of axis "
                              f"factors (dp/fsdp/pp/ep/tp/sp)")
        body = dict(body or {})
        if op_id == "runReplicaSet":
            body["meshPlan"] = mesh_plan
        elif op_id == "patchReplicaSet":
            body["tpuPatch"] = dict(body.get("tpuPatch") or {})
            body["tpuPatch"]["meshPlan"] = mesh_plan
        else:
            raise SchemaError(f"{op_id}: mesh_plan only applies to "
                              f"runReplicaSet / patchReplicaSet")
        return body

    @staticmethod
    def _check_mesh_plan(op_id: str, body) -> None:
        """A meshPlan without its tpuCount is ALWAYS a mistake (the plan's
        factors must multiply to the chip count) — fail here with a
        pointed message instead of a generic server 1000."""
        if not isinstance(body, dict):
            return
        if (op_id == "runReplicaSet" and body.get("meshPlan") is not None
                and not body.get("tpuCount")):
            raise SchemaError(
                "runReplicaSet: meshPlan requires tpuCount (the plan's "
                "axis factors must multiply to the chip count)")
        tp = body.get("tpuPatch")
        if (op_id == "patchReplicaSet" and isinstance(tp, dict)
                and tp.get("meshPlan") is not None
                and not tp.get("tpuCount")):
            raise SchemaError(
                "patchReplicaSet: tpuPatch.meshPlan requires "
                "tpuPatch.tpuCount (the plan's axis factors must multiply "
                "to the chip count)")

    @staticmethod
    def _envelope(raw, op_id: str, fallback_tid: str = "") -> dict:
        """Parse a `{code, msg, data}` envelope; app errors raise ApiError
        carrying the server's traceId (or the request's own trace id when
        the envelope predates tracing)."""
        out = json.loads(raw)
        if out.get("code") != 200:
            raise ApiError(out.get("code", -1), out.get("msg", ""), op_id,
                           trace_id=out.get("traceId") or fallback_tid)
        return out

    # ---- observability helpers (obs subsystem) ----

    def traces(self, trace_id: Optional[str] = None, op: str = "",
               min_duration_ms: float = 0.0, limit: int = 100):
        """Server-side trace store: summaries (slowest first, optionally
        filtered by root-op substring / duration floor), or — with
        `trace_id` — one full trace with its assembled span tree. Pass an
        ApiError's `.trace_id` to see exactly where that call's time (or
        failure) went."""
        if trace_id:
            path = f"/api/v1/traces/{urllib.parse.quote(trace_id, safe='')}"
        else:
            q = {"limit": int(limit)}
            if op:
                # root ops contain spaces ('POST /api/v1/...') — encode
                q["op"] = op
            if min_duration_ms:
                q["minDurationMs"] = min_duration_ms
            path = "/api/v1/traces?" + urllib.parse.urlencode(q)
        out = self._envelope(self._raw("GET", path), "traces")
        data = out.get("data") or {}
        return data.get("trace") if trace_id else data.get("traces")

    # ---- placement + defrag helpers (docs/scheduling.md) ----

    def placement_status(self) -> dict:
        """GET /placement: the active scoring policy (policyActive False =
        mechanism-layer first-fit), each pool's capacity/fragmentation
        view — largestFreeBox is the biggest gang admissible right now —
        and the profile-ledger sizes."""
        data = self._envelope(self._raw("GET", "/api/v1/placement"),
                              "getPlacement").get("data") or {}
        return data.get("placement") or {}

    def defrag_status(self) -> dict:
        """The defragmenter's counters from GET /placement: budget floor,
        queued fragmentation-blocked shapes, runs/migrations/denials."""
        data = self._envelope(self._raw("GET", "/api/v1/placement"),
                              "getPlacement").get("data") or {}
        return data.get("defrag") or {}

    def run_defrag(self, tpu_count: int,
                   mesh_plan: Optional[dict] = None) -> dict:
        """POST /placement/defrag: synchronously open an ICI-contiguous
        box for a fragmentation-blocked gang shape. Returns the run
        report; `opened` True means re-POSTing the gang will admit it."""
        body: dict = {"tpuCount": int(tpu_count)}
        if mesh_plan:
            body["meshPlan"] = dict(mesh_plan)
        raw = self._raw("POST", "/api/v1/placement/defrag",
                        json.dumps(body).encode("utf-8"))
        data = self._envelope(raw, "runDefrag").get("data") or {}
        return data.get("defrag") or {}

    def follow_events(self, target: str = "",
                      last_event_id: Optional[int] = None,
                      heartbeat: Optional[float] = None,
                      yield_heartbeats: bool = False) -> Iterator[dict]:
        """Generator over `GET /api/v1/events?follow=1` (Server-Sent
        Events): yields event dicts as the daemon records them — subscribe
        instead of polling. Runs on a DEDICATED connection (the stream
        holds it open indefinitely; the keep-alive pool must stay usable
        for request/response calls). Resume after a disconnect by passing
        the last seen event's `seq` as `last_event_id`. Closing the
        generator closes the connection; heartbeat comment frames are
        skipped unless `yield_heartbeats` (then `{"heartbeat": True}`)."""
        # the stream idles legitimately between heartbeats, so the
        # request/response timeout would tear down a healthy connection
        # whenever it undercuts the heartbeat cadence (server default
        # 15s); two missed heartbeats still surface a dead server
        hb = heartbeat if heartbeat is not None else 15.0
        if not 0.0 <= hb <= 3600.0:   # mirror the server clamp; inf/nan
            hb = 3600.0               # values are refused server-side
        conn = http.client.HTTPConnection(
            self.host, self.port,
            timeout=max(self.timeout, 2.0 * hb + 10.0))
        path = "/api/v1/events?follow=1"
        if target:
            path += "&" + urllib.parse.urlencode({"target": target})
        if heartbeat is not None:
            path += f"&heartbeat={heartbeat}"
        headers: dict[str, str] = {}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        if last_event_id is not None:
            headers["Last-Event-ID"] = str(last_event_id)
        try:
            conn.request("GET", path, None, headers)
            resp = conn.getresponse()
            ct = resp.getheader("Content-Type") or ""
            if resp.status != 200 or "text/event-stream" not in ct:
                # refusals (auth, bad params) come back as HTTP 200 with a
                # JSON error envelope, not an event stream — surface them
                # instead of yielding a silent empty stream
                body = resp.read(65536)
                try:
                    self._envelope(body, "follow_events")
                except ApiError:
                    raise
                except Exception:  # noqa: BLE001 — a non-JSON refusal body
                    pass
                raise ApiError(resp.status, "event stream refused",
                               "follow_events")
            data_lines: list[str] = []
            event_type = ""
            while True:
                raw = resp.readline()
                if not raw:          # server closed (drain/shutdown)
                    return
                line = raw.decode("utf-8").rstrip("\r\n")
                if not line:         # frame boundary
                    if event_type == "gap":
                        # ring overrun on resume: the events between our
                        # Last-Event-ID and the ring's tail were evicted
                        # — typed error, never a silent hole
                        info = json.loads("\n".join(data_lines) or "{}")
                        raise EventGapError(
                            int(info.get("lastEventId",
                                         last_event_id or -1)),
                            int(info.get("firstRetained", 0)))
                    if data_lines:
                        yield json.loads("\n".join(data_lines))
                    data_lines = []
                    event_type = ""
                    continue
                if line.startswith(":"):
                    if yield_heartbeats:
                        yield {"heartbeat": True}
                elif line.startswith("event:"):
                    event_type = line[6:].strip()
                elif line.startswith("data:"):
                    data_lines.append(line[5:].strip())
                # id:/retry: fields ride inside the data JSON (seq) — no
                # separate bookkeeping needed here
        finally:
            conn.close()

    # ---- list+watch on MVCC revisions (federation watch plane) ----

    def list_resource(self, resource: str) -> tuple[int, list[dict]]:
        """Atomic `(revision, items)` snapshot of one resource — the
        revision is an exact watch resume point for that item set."""
        path = ("/api/v1/watch?list=1&"
                + urllib.parse.urlencode({"resource": resource}))
        data = self._envelope(self._raw("GET", path),
                              "list_resource").get("data") or {}
        return int(data.get("revision", 0)), list(data.get("items", []))

    def watch(self, resource: str = "",
              from_revision: Optional[int] = None,
              heartbeat: Optional[float] = None,
              yield_heartbeats: bool = False) -> Iterator[dict]:
        """Generator over `GET /api/v1/watch` (SSE): yields
        `{revision, resource, name, type, value}` events in exact
        revision order, from `from_revision` (exclusive; default = now).
        Raises RelistRequiredError when the resume point predates the
        server's retention floor or the server evicts past this follower
        mid-stream — list_resource() then yields a fresh snapshot whose
        revision is the new resume point (Informer automates the loop).
        Dedicated connection, like follow_events."""
        hb = heartbeat if heartbeat is not None else 15.0
        if not 0.0 <= hb <= 3600.0:
            hb = 3600.0
        conn = http.client.HTTPConnection(
            self.host, self.port,
            timeout=max(self.timeout, 2.0 * hb + 10.0))
        q: dict[str, Any] = {}
        if resource:
            q["resource"] = resource
        if from_revision is not None:
            q["fromRevision"] = int(from_revision)
        if heartbeat is not None:
            q["heartbeat"] = heartbeat
        path = "/api/v1/watch" + ("?" + urllib.parse.urlencode(q)
                                  if q else "")
        headers: dict[str, str] = {}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        try:
            conn.request("GET", path, None, headers)
            resp = conn.getresponse()
            ct = resp.getheader("Content-Type") or ""
            if resp.status != 200 or "text/event-stream" not in ct:
                body = resp.read(65536)
                try:
                    self._envelope(body, "watch")
                except ApiError as e:
                    if e.code == 1036:    # WatchCompacted: relist
                        try:
                            floor = json.loads(body)["data"]["floor"]
                        except Exception:  # noqa: BLE001
                            floor = 0
                        raise RelistRequiredError(
                            int(floor), int(from_revision or -1)) from e
                    raise
                raise ApiError(resp.status, "watch stream refused",
                               "watch")
            data_lines: list[str] = []
            event_type = ""
            while True:
                raw = resp.readline()
                if not raw:
                    return               # server closed (drain/shutdown)
                line = raw.decode("utf-8").rstrip("\r\n")
                if not line:
                    if event_type == "gap":
                        info = json.loads("\n".join(data_lines) or "{}")
                        raise RelistRequiredError(
                            int(info.get("floor", 0)),
                            int(from_revision or -1))
                    if data_lines:
                        yield json.loads("\n".join(data_lines))
                    data_lines = []
                    event_type = ""
                    continue
                if line.startswith(":"):
                    if yield_heartbeats:
                        yield {"heartbeat": True}
                elif line.startswith("event:"):
                    event_type = line[6:].strip()
                elif line.startswith("data:"):
                    data_lines.append(line[5:].strip())
        finally:
            conn.close()


class Informer:
    """Client-side list+watch cache over one resource.

    The kube-style informer loop on this API's watch plane: one atomic
    list snapshot seeds the cache at an exact revision, then the SSE
    watch applies every mutation after it in revision order. On ANY
    break — connection loss, daemon death, `revision too old`, a
    mid-stream gap — the informer rotates to the next endpoint and
    resumes from its last-seen revision; only when the server refuses
    that resume (compaction, or a different daemon's revision space
    after a fleet takeover) does it relist. The cache therefore survives
    daemon takeover: `revisions` records every applied revision so a
    test can assert the sequence is strictly increasing and gapless
    within one server's stream.
    """

    def __init__(self, endpoints: list[tuple[str, int]], resource: str,
                 api_key: str = "", heartbeat: float = 0.5,
                 retry_delay: float = 0.2):
        if not endpoints:
            raise ValueError("Informer needs at least one endpoint")
        self.endpoints = list(endpoints)
        self.resource = resource
        self.api_key = api_key
        self.heartbeat = heartbeat
        self.retry_delay = retry_delay
        self.cache: dict[str, dict] = {}
        self.revision = 0
        self.revisions: list[int] = []   # every applied revision, in order
        self.relists = 0
        self.rotations = 0
        self._idx = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # ---- one protocol step each; the thread just loops them ----

    def _conn(self) -> "ApiClient":
        host, port = self.endpoints[self._idx % len(self.endpoints)]
        # spec-less construction: the watch surface is fixed, fetching
        # /openapi.json per rotation would triple the reconnect cost
        return ApiClient(host, port, spec={"paths": {}},
                         api_key=self.api_key, timeout=10.0)

    def _rotate(self) -> None:
        self._idx += 1
        self.rotations += 1

    def _apply(self, evt: dict) -> None:
        with self._lock:
            rev = int(evt["revision"])
            self.revision = rev
            self.revisions.append(rev)
            if evt["type"] == "delete":
                self.cache.pop(evt["name"], None)
            else:
                self.cache[evt["name"]] = {"value": evt["value"],
                                           "modRevision": rev}

    def relist(self, client: "ApiClient") -> None:
        rev, items = client.list_resource(self.resource)
        with self._lock:
            self.cache = {i["name"]: {"value": i["value"],
                                      "modRevision": i["modRevision"]}
                          for i in items}
            self.revision = rev
            self.relists += 1

    def snapshot(self) -> tuple[int, dict[str, dict]]:
        with self._lock:
            return self.revision, {k: dict(v)
                                   for k, v in self.cache.items()}

    def run(self, stop: Optional[threading.Event] = None) -> None:
        """Drive the loop until `stop` (or stop()) is set. Endpoint
        errors rotate + retry — the informer outlives any one daemon."""
        stop = stop or self._stop
        listed = False
        while not stop.is_set():
            client = self._conn()
            try:
                if not listed:
                    self.relist(client)
                    listed = True
                for evt in client.watch(self.resource,
                                        from_revision=self.revision,
                                        heartbeat=self.heartbeat,
                                        yield_heartbeats=True):
                    if stop.is_set():
                        return
                    if "revision" in evt:
                        self._apply(evt)
            except RelistRequiredError:
                listed = False           # compaction/takeover: resync
            except (ApiError, OSError, ConnectionError,
                    http.client.HTTPException, json.JSONDecodeError):
                self._rotate()           # daemon gone: try the next seat
                stop.wait(self.retry_delay)
            finally:
                client.close()

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self.run, name=f"informer-{self.resource}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
