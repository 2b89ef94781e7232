"""Fleet control plane: the HTTP face of federation.py.

The port's copy of the JAX control plane's server/fleet.py.

Every daemon constructs a `FleetPlane`. Two roles live here, both always
wired but independently active:

- **Arbiter host**: the lease/grant REST endpoints (`/api/v1/fleet/*`)
  over this daemon's `FleetArbiter`. Any daemon can host; the fleet
  picks ONE (the `--fleet-host` the others point at) — the same honest
  single point where the reference's external etcd endpoint sits.
- **Member seat**: when the daemon is started with `--fleet-member`,
  a `FleetMember` heartbeats against the host's arbiter (its own, when
  it IS the host) and the mutation middleware enforces ring ownership:
  a mutation for a replicaSet/gateway this member does not own answers
  `FleetNotOwner` with the owning member's address so the client
  re-routes instead of split-braining a resource across daemons.

The revision watch endpoint (`GET /api/v1/watch`) is served by every
daemon over its own `WatchHub` — list+watch is per-daemon state
observation, not fleet-global arbitration.

Fleet routes register with `raw=True`: lease renewals are the fleet's
heartbeat traffic and must not consume mutation-gate slots, idempotency
records, or — fatally — ownership checks (the check calls the arbiter,
which would recurse).
"""

from __future__ import annotations

import json
import logging
import math
import time
from typing import Optional

from .. import federation
from ..federation import (
    FleetArbiter, FleetMember, LeaseError, RestArbiter, WatchCompactedError,
)
from .codes import ResCode
from .http import Request, Response, StreamingResponse, err, ok

log = logging.getLogger(__name__)

#: path segment -> grant/watch resource for ownership enforcement; only
#: these are fleet-sliced (volumes stay daemon-local: they bind to the
#: host filesystem the daemon runs on)
_OWNED_SEGMENTS = {"replicaSet": "containers", "gateways": "gateways"}

#: request-body keys that carry the resource name on create routes
#: (no :name path param yet)
_BODY_NAME_KEYS = ("replicaSetName", "name")


def _lease_err(e: LeaseError) -> Response:
    """Map a LeaseError to its envelope. data carries reason/owner so
    RestArbiter (and any client) can re-raise the typed refusal."""
    code = (ResCode.FleetNotOwner if e.reason in ("not-owner", "held")
            else ResCode.FleetLeaseFailed)
    return Response(code, {"reason": e.reason, "owner": e.owner},
                    msg=str(e))


class FleetPlane:
    """One daemon's fleet wiring: arbiter + optional member + watch."""

    def __init__(self, store, hub: federation.WatchHub, events=None,
                 ttl: float = federation.DEFAULT_TTL):
        self.store = store          # the WatchedStore (App wraps it)
        self.hub = hub
        self.events = events
        self.arbiter = FleetArbiter(store, ttl=ttl, events=events)
        self.member: Optional[FleetMember] = None
        self._member_addrs: dict[str, str] = {}

    # ------------------------------------------------------------ member

    def configure_member(self, member_id: str, addr: str,
                         host: str = "", api_key: str = "",
                         adopt=None, promote=None) -> FleetMember:
        """Give this daemon a seat. `host` empty means this daemon hosts
        the arbiter itself (in-process, no HTTP hop). `promote` runs
        after a takeover steal, before adopt — the App installs the dead
        daemon's replicated records there (replication.py)."""
        arbiter = (RestArbiter(host, api_key=api_key) if host
                   else self.arbiter)
        self.member = FleetMember(member_id, arbiter, addr=addr,
                                  adopt=adopt, promote=promote,
                                  events=self.events)
        return self.member

    def start(self) -> None:
        if self.member is not None:
            # cadence from the CONFIGURED ttl, not the arbiter object: a
            # RestArbiter carries no ttl, and the operator's --fleet-ttl
            # must match the host's anyway (documented knob) — without
            # this a remote member with a short host TTL would heartbeat
            # at the default cadence and expire its own lease
            self.member.start(interval=max(0.05, self.arbiter.ttl / 3.0))

    def stop(self) -> None:
        if self.member is not None:
            self.member.stop()

    def owner_addr(self, member: str) -> str:
        """Best-effort address of a member, for re-route hints."""
        try:
            for m in self.arbiter.members():
                if m["member"] == member:
                    return m.get("addr", "")
        # tdlint: disable=silent-swallow -- REST hop to a fleet host that may be down; the hint is optional, the refusal it decorates is not
        except Exception:  # noqa: BLE001 — a hint, never a failure
            pass
        return ""

    # ----------------------------------------- mutation ownership guard

    def guard_mutation(self, req: Request) -> Optional[Response]:
        """Called by the mutation middleware: None = proceed, or the
        FleetNotOwner refusal. Only active when this daemon holds a
        member seat; a single-daemon deployment never pays this."""
        if self.member is None:
            return None
        parts = [p for p in req.path.split("/") if p]
        # ['api', 'v1', '<segment>', '<name>', ...]
        if len(parts) < 3 or parts[2] not in _OWNED_SEGMENTS:
            return None
        resource = _OWNED_SEGMENTS[parts[2]]
        name = parts[3] if len(parts) > 3 else ""
        if not name:
            # create route: the name rides the body; an unparseable body
            # is the handler's 1000 to report, not ours
            try:
                body = req.json()
            # tdlint: disable=silent-swallow -- an unparseable body is the handler's 1000 to report, not the guard's
            except Exception:  # noqa: BLE001
                return None
            for k in _BODY_NAME_KEYS:
                if isinstance(body, dict) and body.get(k):
                    name = str(body[k])
                    break
            if not name:
                return None
        if (resource, name) in self.member.owned:
            # believed ownership is the fast path; it is exactly what
            # the tdcheck lease model checks (fenced on lease loss,
            # re-derived from the grant table every heartbeat)
            return None
        try:
            self.member.ensure_owned(resource, name)
        except LeaseError as e:
            owner = e.owner
            resp = _lease_err(e)
            resp.data["ownerAddr"] = self.owner_addr(owner)
            if self.events is not None:
                self.events.record("fed.grant", target=f"{resource}/{name}",
                                   detail={"refused": e.reason,
                                           "owner": owner},
                                   request_id=req.request_id)
            return resp
        return None

    # ------------------------------------------------------ fleet routes

    def register(self, r, v1: str) -> None:
        r.add("POST", f"{v1}/fleet/lease", self.h_lease_join, raw=True)
        r.add("POST", f"{v1}/fleet/lease/:member/renew",
              self.h_lease_renew, raw=True)
        r.add("DELETE", f"{v1}/fleet/lease/:member", self.h_lease_leave,
              raw=True)
        r.add("GET", f"{v1}/fleet/members", self.h_members)
        r.add("GET", f"{v1}/fleet/grants", self.h_grants)
        r.add("POST", f"{v1}/fleet/grants", self.h_grant_acquire,
              raw=True)
        r.add("POST", f"{v1}/fleet/grants/release", self.h_grant_release,
              raw=True)

    def h_lease_join(self, req: Request) -> Response:
        body = req.json() or {}
        member = str(body.get("member", "")).strip()
        if not member:
            return err(ResCode.InvalidParams, "member must be non-empty")
        try:
            return ok(self.arbiter.join(member,
                                        addr=str(body.get("addr", ""))))
        except LeaseError as e:
            return _lease_err(e)

    def h_lease_renew(self, req: Request) -> Response:
        try:
            return ok(self.arbiter.renew(req.params["member"]))
        except LeaseError as e:
            return _lease_err(e)

    def h_lease_leave(self, req: Request) -> Response:
        return ok(self.arbiter.leave(req.params["member"]))

    def h_members(self, req: Request) -> Response:
        return ok({"members": self.arbiter.members(),
                   "ttl": self.arbiter.ttl})

    def h_grants(self, req: Request) -> Response:
        return ok({"grants": self.arbiter.grants()})

    def h_grant_acquire(self, req: Request) -> Response:
        body = req.json() or {}
        resource = str(body.get("resource", "")).strip()
        name = str(body.get("name", "")).strip()
        member = str(body.get("member", "")).strip()
        if not (resource and name and member):
            return err(ResCode.InvalidParams,
                       "resource, name and member must be non-empty")
        try:
            return ok(self.arbiter.acquire(resource, name, member))
        except LeaseError as e:
            return _lease_err(e)

    def h_grant_release(self, req: Request) -> Response:
        body = req.json() or {}
        try:
            released = self.arbiter.release(
                str(body.get("resource", "")), str(body.get("name", "")),
                str(body.get("member", "")))
        except LeaseError as e:
            return _lease_err(e)
        return ok({"released": released})

    # ------------------------------------------------------- list+watch

    #: heartbeat cadence mirrors App.SSE_HEARTBEAT_S; ?heartbeat=
    #: overrides per request, same floor/ceiling
    WATCH_HEARTBEAT_S = 15.0

    def h_watch(self, req: Request, draining) -> Response:
        """`GET /api/v1/watch?resource=&fromRevision=` — list+watch on
        MVCC revisions.

        `?list=1` answers an atomic `{revision, items}` snapshot: the
        revision is an exact resume point for that item set. Otherwise
        an SSE stream of `id: <revision>` + `data: <event>` frames from
        fromRevision (exclusive; default = now). A fromRevision below
        the hub's retention floor is refused up front with
        `WatchCompacted` (1036) — and a follower that falls behind the
        ring mid-stream gets a terminal `event: gap` frame — so a
        consumer ALWAYS relists rather than silently missing revisions;
        the informer in client.py does exactly that.

        `draining` is the server's drain predicate (callable) — passed
        in so the plane doesn't hold a server back-reference."""
        resource = req.query.get("resource", [""])[0]
        if req.query_flag("list"):
            rev, items = self.store.list_snapshot(resource)
            return ok({"resource": resource, "revision": rev,
                       "items": items})
        try:
            hb = float(req.query.get(
                "heartbeat", [str(self.WATCH_HEARTBEAT_S)])[0])
        except ValueError:
            return err(ResCode.InvalidParams)
        if not math.isfinite(hb):
            return err(ResCode.InvalidParams)
        hb = min(max(0.05, hb), 3600.0)
        raw_from = req.query.get("fromRevision",
                                 [req.header("Last-Event-ID")])[0]
        try:
            since = int(raw_from) if str(raw_from).strip() else \
                self.hub.head
        except ValueError:
            return err(ResCode.InvalidParams)
        try:
            # refuse a too-old resume BEFORE streaming: a JSON envelope
            # the client can branch on beats a dead SSE socket
            self.hub.events_since(since, resource)
        except WatchCompactedError as e:
            return Response(ResCode.WatchCompacted,
                            {"floor": e.floor,
                             "fromRevision": e.from_revision})
        if since > self.hub.head:
            # a resume AHEAD of this daemon's head is a revision the hub
            # never minted — a foreign revision space (the informer
            # followed a different daemon before a takeover). Waiting
            # for the counter to catch up would serve the wrong history;
            # force the relist that re-anchors the cache here.
            return Response(ResCode.WatchCompacted,
                            {"floor": self.hub.floor,
                             "head": self.hub.head,
                             "fromRevision": since},
                            msg="fromRevision is ahead of this daemon's "
                                "current revision — foreign revision "
                                "space; relist required")

        def gen(since: int):
            yield b"retry: 2000\n\n"
            last_sent = time.monotonic()
            while not draining():
                try:
                    evts = self.hub.wait_since(since, resource,
                                               timeout=hb)
                except WatchCompactedError as e:
                    # the ring lapped this follower while it was parked
                    # or slow — a silent gap is the one forbidden
                    # outcome; tell it to relist, then end the stream
                    if self.events is not None:
                        self.events.record(
                            "watch.gap", target=resource or "*",
                            detail={"fromRevision": e.from_revision,
                                    "floor": e.floor})
                    yield (f"event: gap\ndata: "
                           f"{json.dumps({'floor': e.floor})}\n\n"
                           ).encode()
                    return
                if evts:
                    out = []
                    for e in evts:
                        since = e["revision"]
                        out.append(f"id: {e['revision']}\ndata: "
                                   f"{json.dumps(e)}\n\n".encode())
                    yield b"".join(out)
                    last_sent = time.monotonic()
                elif time.monotonic() - last_sent >= hb:
                    yield b": heartbeat\n\n"
                    last_sent = time.monotonic()

        return StreamingResponse(gen(since))
