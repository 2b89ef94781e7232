"""Intent journal: durable record of in-flight multi-step mutations.

The port's copy of the JAX control plane's intents.py, unchanged: the
journal's keys and records are JAX's.

Every multi-step control-plane mutation (run, patch/rolling-replace,
rollback, restart, stop, delete, volume create/scale/delete) records a
begin marker before its first side effect, a step marker after each
completed step, and a done marker (key delete) after its last. The
markers go through the MVCC store SYNCHRONOUSLY — not the write-behind
queue — so the WAL always holds the intent before the step it describes
can have happened. A control-plane crash therefore leaves behind exactly
one open intent per mid-flight mutation, telling the boot-time reconciler
(reconcile.py) which operation was interrupted, on which target, and how
far it got.

Key scheme: one key per (kind, target) under the `intents` resource —
the per-name mutation mutex in the services guarantees at most one open
mutation per target, so the key is stable and a completed mutation's
delete leaves nothing to compact away (the `intents` prefix is
deliberately NOT in KEEP_HISTORY_PREFIXES).

Journal slimming (hot path): only the markers the reconciler actually
branches on are written synchronously; informational markers update the
record in place and piggyback on the next synchronous write (Intent.step
sync=False) — the store's MVCC revisions of the single intent key remain
the full audit history of every synchronous update.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Optional

from .idempotency import active_key
from .obs import trace
from .store.client import StateClient

INTENTS = "intents"

KIND_CONTAINER = "container"
KIND_VOLUME = "volume"
KIND_GATEWAY = "gateway"


@dataclass
class IntentRecord:
    """One open intent as persisted."""
    op: str                     # run | replace | stop | delete | volume.create ...
    target: str                 # replicaSet / volume base name
    kind: str = KIND_CONTAINER
    begun_at: float = 0.0
    steps: list[dict] = field(default_factory=list)
    meta: dict = field(default_factory=dict)

    def step_names(self) -> list[str]:
        return [s["name"] for s in self.steps]

    def has_step(self, name: str) -> bool:
        return any(s["name"] == name for s in self.steps)

    def step_meta(self, name: str) -> dict:
        for s in reversed(self.steps):
            if s["name"] == name:
                return {k: v for k, v in s.items() if k not in ("name", "at")}
        return {}

    def serialize(self) -> str:
        return json.dumps({
            "op": self.op, "target": self.target, "kind": self.kind,
            "begunAt": self.begun_at, "steps": self.steps, "meta": self.meta,
        }, sort_keys=True)

    @classmethod
    def deserialize(cls, s: str) -> "IntentRecord":
        d = json.loads(s)
        return cls(op=d.get("op", ""), target=d.get("target", ""),
                   kind=d.get("kind", KIND_CONTAINER),
                   begun_at=d.get("begunAt", 0.0),
                   steps=list(d.get("steps", [])),
                   meta=dict(d.get("meta", {})))


class Intent:
    """Handle for one in-flight mutation; records step boundaries."""

    def __init__(self, journal: "IntentJournal", record: IntentRecord):
        self._journal = journal
        self.record = record
        self.closed = False
        # non-lexical trace span spanning begin->done: step markers become
        # span events, so a trace shows WHERE inside the mutation the time
        # went. None when no request trace is active (bare service tests).
        self._span = trace.start(f"intent.{record.op}", target=record.target)

    def step(self, name: str, sync: bool = True, **meta) -> None:
        """Record "step `name` is complete".

        sync=True persists the updated record before returning — required
        for any marker the boot-time reconciler CONSULTS to pick a replay
        branch ("created" with its container/version meta, "copied",
        "migrated": reconcile.py). sync=False is the journal-slimming hot
        path for purely-informational markers (granted/precopied/
        stopped_old/started_new/...): the step is folded into the in-memory record and
        rides along with the NEXT synchronous write — or is discarded by
        done(), which deletes the key anyway. Crash semantics are
        unchanged because the reconciler's decisions never read lazy
        markers; what the slimming buys is ~half the synchronous store
        round-trips per rolling replace (see docs/performance.md)."""
        if self.closed:
            return
        entry = {"name": name, "at": round(time.time(), 4)}
        entry.update(meta)
        self.record.steps.append(entry)
        if self._span is not None:
            self._span.event(name, sync=sync)
        if sync:
            self._journal._write(self.record)

    def done(self, committed: bool = False) -> None:
        """The mutation finished: clear the marker. committed=True (the
        services' success paths) additionally stamps the request's
        idempotency record as executed BEFORE the intent key is cleared,
        so a crash between here and the middleware's response store
        still resolves to "replay", never to a double-apply. Unwind
        paths use the default — an unwound mutation has no effect to
        protect."""
        if self.closed:
            return
        self.closed = True
        if committed and not self.record.meta.get("idemPartial"):
            key = self.record.meta.get("idemKey", "")
            cache = self._journal.idempotency
            if key and cache is not None:
                cache.mark_executed(key)
        self._journal._clear(self.record)
        # outcome stays "ok" — an unwound mutation's FAILURE is recorded
        # by the enclosing service span's exception; the intent span only
        # times the journaled window. committed is still visible:
        trace.finish(self._span, status="committed" if committed else "ok")


class IntentJournal:
    def __init__(self, client: Optional[StateClient]):
        self._client = client
        # set by App: lets intent.done(committed=True) stamp the active
        # idempotency record as executed before the intent key clears
        self.idempotency = None

    @staticmethod
    def _key(kind: str, target: str) -> str:
        return f"{kind}:{target}"

    def begin(self, op: str, target: str, kind: str = KIND_CONTAINER,
              **meta) -> Intent:
        # fold the request's Idempotency-Key (if any) into the journal:
        # the boot reconciler settles the key's result cache entry to the
        # SAME outcome it settles this intent to (idempotency.py)
        key = active_key()
        if key:
            meta.setdefault("idemKey", key)
        # ... and the request's trace identity: a crash mid-mutation hands
        # the reconciler these ids, so its replay spans land on the
        # ORIGINAL request's trace (JAX's obs/trace.py resume_trace)
        trace_id, span_id = trace.current_ids()
        if trace_id:
            meta.setdefault("traceId", trace_id)
            meta.setdefault("spanId", span_id)
        rec = IntentRecord(op=op, target=target, kind=kind,
                           begun_at=round(time.time(), 4), meta=meta)
        self._write(rec)
        return Intent(self, rec)

    def _write(self, rec: IntentRecord) -> None:
        if self._client is not None:
            self._client.put(INTENTS, self._key(rec.kind, rec.target),
                             rec.serialize())

    def _clear(self, rec: IntentRecord) -> None:
        if self._client is not None:
            self._client.delete(INTENTS, self._key(rec.kind, rec.target))

    def clear(self, kind: str, target: str) -> None:
        """Reconciler path: drop a replayed intent by identity."""
        if self._client is not None:
            self._client.delete(INTENTS, self._key(kind, target))

    def open_intents(self) -> list[IntentRecord]:
        """All intents whose mutation never recorded done, oldest first."""
        if self._client is None:
            return []
        out = []
        for kv in self._client.range(INTENTS):
            try:
                out.append(IntentRecord.deserialize(kv.value))
            except (json.JSONDecodeError, TypeError):
                continue  # torn record: nothing actionable in it
        out.sort(key=lambda r: r.begun_at)
        return out
