"""Idempotency-key result cache: exactly-once semantics for mutations.

The port's copy of the JAX control plane's idempotency.py, unchanged.

A client stamps a mutation with an `Idempotency-Key` header; the server
persists a record for the key BEFORE executing and stores the final
response AFTER executing, both synchronously through the MVCC store. A
duplicate delivery (dropped response, client retry, at-least-once proxy)
replays the stored response instead of re-executing — which is what makes
mutations safe for the client to retry on connection errors at all
(client.py only retries mutations it stamped with a key).

Only SUCCESSFUL outcomes are cached. An error response means the
services unwound without changing state, so re-executing a retry is
always safe — while caching one would pin a transient failure (breaker
open, substrate timeout) past its recovery for the record's whole TTL.
Exactly-once is about effects, and failed mutations have none.

Crash consistency rides the intent journal (intents.py): while a keyed
request is executing, the active key is held in a thread-local that
IntentJournal.begin() folds into the intent's meta (`idemKey`). The boot
reconciler (reconcile.py) therefore knows, for every crashed-mid-flight
mutation, BOTH what it was doing and which key it was doing it for:

- intent rolled FORWARD  -> the record is finalized as done with a
  synthetic success envelope (the original response bytes died with the
  daemon, but the outcome is the same) — the client's retry replays;
- intent UNWOUND         -> the record is dropped — the client's retry
  re-executes against the restored pre-mutation state;
- no intent (crashed before the first side effect, or a journal-less op
  like pause/execute) -> the record is dropped — re-executing is correct
  for the former and harmless for the latter (those ops are naturally
  idempotent).

Either way the key observes exactly one state change. Records are
TTL-bounded: the boot sweep and store maintenance drop expired ones.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import threading
import time
from typing import Optional

from .store.client import StateClient

RESOURCE = "idempotency"

#: records older than this are swept (boot reconcile + store maintenance)
DEFAULT_TTL = 24 * 3600.0

IN_PROGRESS = "in_progress"
# the mutation COMMITTED (intent.done(committed=True) wrote this marker
# synchronously BEFORE the intent key was cleared) but the response is
# not stored yet — closes the crash window between a service committing
# and the middleware persisting the response: the boot reconciler
# finalizes an executed record instead of dropping it, so the retry
# replays rather than double-applying
EXECUTED = "executed"
DONE = "done"

# begin() outcomes
NEW = "new"            # caller must execute, then finish() or abandon()
REPLAY = "replay"      # stored response returned; do NOT execute
IN_FLIGHT = "in_flight"  # another live request holds this key right now
MISMATCH = "mismatch"  # key reused with a different method/path/body

_RECOVERED_MSG = ("Success (mutation completed; the original response was "
                  "lost in a crash — state recovered by the boot reconciler)")


# ------------------------------------------------- active-key thread-local
# Held while a keyed request executes so IntentJournal.begin() can stamp
# the intent with the key (see module docstring).

_active = threading.local()


def active_key() -> str:
    return getattr(_active, "key", "")


@contextlib.contextmanager
def context(key: str):
    prev = active_key()
    _active.key = key
    try:
        yield
    finally:
        _active.key = prev


def fingerprint(method: str, path: str, body: bytes,
                query: Optional[dict] = None) -> str:
    """Request identity: a key reused with a DIFFERENT request is a client
    bug and must be rejected, not silently replayed (Stripe semantics).
    The query dict is part of the identity — `?noall` turns a volume
    delete into a different operation."""
    h = hashlib.sha256()
    h.update(f"{method} {path}\n".encode())
    if query:
        h.update(json.dumps(sorted(query.items())).encode())
    h.update(b"\n")
    h.update(body or b"")
    return h.hexdigest()


class IdempotencyCache:
    """Persisted, TTL-bounded key -> response cache (see module doc)."""

    def __init__(self, client: Optional[StateClient],
                 ttl: float = DEFAULT_TTL):
        self._client = client
        self.ttl = ttl
        # serializes the check-and-claim in begin(): two concurrent
        # requests with the same key must resolve to one NEW + one
        # IN_FLIGHT, never two executions. The claim itself lives in
        # _claims (key -> fingerprint) so the durable store put can
        # happen OUTSIDE the lock — an fsync-backed claim write must not
        # serialize every keyed mutation behind one global lock.
        self._lock = threading.Lock()
        # key -> (fingerprint, claimed-at): live claims in this process;
        # carrying fp+at here lets mark_executed()/finish() rebuild the
        # record without a store read on the hot path
        self._claims: dict[str, tuple[str, float]] = {}
        self._replays = 0
        # records gauge for /metrics without a per-scrape range() scan
        self._count = len(self._records()) if client is not None else 0

    @staticmethod
    def _name(key: str) -> str:
        # keys are caller-chosen free text: hash into a flat, /-free name
        return hashlib.sha256(key.encode()).hexdigest()[:40]

    def _get(self, key: str) -> Optional[dict]:
        if self._client is None:
            return None
        kv = self._client.get(RESOURCE, self._name(key))
        if kv is None:
            return None
        try:
            return json.loads(kv.value)
        except json.JSONDecodeError:
            return None

    def _put(self, key: str, rec: dict) -> None:
        if self._client is not None:
            self._client.put(RESOURCE, self._name(key),
                             json.dumps(rec, sort_keys=True))

    def _delete(self, key: str) -> bool:
        if self._client is None:
            return False
        return self._client.delete(RESOURCE, self._name(key))

    def _drop(self, key: str) -> bool:
        """Durable delete + records-gauge bookkeeping. Called WITHOUT the
        cache lock held — a WAL-backed delete must not serialize every
        concurrent begin() behind it (same reasoning as begin()'s
        outside-the-lock claim write)."""
        existed = self._delete(key)
        if existed:
            with self._lock:
                self._count -= 1
        return existed

    # ------------------------------------------------------- request path

    def begin(self, key: str, fp: str) -> tuple[str, Optional[dict]]:
        """Claim `key` for this request. Returns (state, record):
        NEW — key claimed (and persisted in_progress), caller executes;
        REPLAY — record is the finished response, caller returns it;
        IN_FLIGHT — a live request owns the key (caller answers 409);
        MISMATCH — same key, different request (caller answers 400)."""
        at = round(time.time(), 4)
        drop_expired = False
        with self._lock:
            rec = self._get(key)
            expired = rec is not None and self._expired(rec)
            if expired:
                rec = None
            live = self._claims.get(key)
            if rec is None and live is None:
                self._claims[key] = (fp, at)
                self._count += 1
                claimed = True
                # only the CLAIMANT drops the expired record (deferred,
                # below): a racing duplicate doing it could delete the
                # claimant's freshly written claim/commit marker
                drop_expired = expired
            else:
                claimed = False
                known_fp = rec.get("fp") if rec is not None else live[0]
        if drop_expired:
            self._drop(key)
        if claimed:
            # durable claim write outside the lock: concurrent keyed
            # mutations' claims can share a WAL group-commit batch
            try:
                self._put(key, {"key": key, "fp": fp,
                                "status": IN_PROGRESS, "at": at})
            except Exception:
                # a failed claim write must not wedge the key on 409
                # forever: drop the in-memory claim before propagating
                with self._lock:
                    self._claims.pop(key, None)
                    self._count -= 1
                raise
            return NEW, None
        if known_fp != fp:
            return MISMATCH, rec
        if rec is not None and rec.get("status") == DONE:
            with self._lock:
                self._replays += 1
            return REPLAY, rec
        return IN_FLIGHT, rec

    def mark_executed(self, key: str) -> None:
        """The mutation COMMITTED (called from intent.done(committed=True)
        before the intent key is cleared): record that fact durably so a
        crash before finish() finalizes to a replay instead of dropping
        the key (which would let the retry double-apply). Rebuilt from
        the live claim — no store read on the hot path."""
        with self._lock:
            claim = self._claims.get(key)
        if claim is None:
            return
        fp, at = claim
        self._put(key, {"key": key, "fp": fp, "status": EXECUTED,
                        "at": at})

    def finish(self, key: str, code: int, http_status: int,
               payload: bytes, headers: Optional[dict] = None) -> None:
        """Store the response; duplicates replay these exact bytes."""
        with self._lock:
            claim = self._claims.pop(key, None)
        if claim is not None:
            fp, at = claim
        else:
            # boot-reconciler finalize path: no live claim — read the
            # crash-surviving record for its identity fields
            rec = self._get(key) or {}
            fp, at = rec.get("fp", ""), rec.get("at", round(time.time(), 4))
        self._put(key, {"key": key, "fp": fp, "status": DONE, "at": at,
                        "code": code, "httpStatus": http_status,
                        "payload": payload.decode("utf-8", "replace"),
                        "headers": dict(headers or {})})

    def abandon(self, key: str) -> None:
        """The mutation did not change state (handler raised and unwound,
        or returned a non-success outcome) — drop the claim so a retry
        re-executes."""
        with self._lock:
            self._claims.pop(key, None)
        self._drop(key)

    # ---------------------------------------------------------- recovery

    def _expired(self, rec: dict, now: Optional[float] = None) -> bool:
        if self.ttl <= 0:
            return True
        return (now or time.time()) - rec.get("at", 0) > self.ttl

    def _records(self) -> list[dict]:
        out = []
        if self._client is None:
            return out
        for kv in self._client.range(RESOURCE):
            try:
                out.append(json.loads(kv.value))
            except json.JSONDecodeError:
                continue
        return out

    def sweep(self) -> int:
        """Drop expired records (store-maintenance path). Records owned
        by a live claim are never swept mid-flight."""
        n = 0
        now = time.time()
        for rec in self._records():
            key = rec.get("key", "")
            with self._lock:
                if key in self._claims:
                    continue
            if self._expired(rec, now):
                if self._drop(key):
                    n += 1
        return n

    def reconcile_boot(self, outcomes: dict[str, str]) -> dict:
        """Boot-reconciler pass: settle every record a crash left behind.
        `outcomes` maps idemKey -> "completed" | "unwound" as decided by
        the intent replay (reconcile.py). in_progress records whose intent
        rolled forward are finalized with a synthetic success envelope;
        everything else in_progress is dropped (module doc)."""
        rep = {"finalized": 0, "dropped": 0, "expired": 0}
        now = time.time()
        for rec in self._records():
            key = rec.get("key", "")
            with self._lock:
                if key in self._claims:
                    # a LIVE request in this process owns the key (the
                    # runtime ?run=1 reconcile path) — its record is not
                    # crash debris; leave it to finish()/abandon()
                    continue
            if self._expired(rec, now):
                self._drop(key)
                rep["expired"] += 1
                continue
            if rec.get("status") == DONE:
                continue
            # EXECUTED is the commit marker itself (written before the
            # intent cleared): finalize even with no intent outcome —
            # that is exactly the done()-to-finish() crash window
            if (outcomes.get(key) == "completed"
                    or rec.get("status") == EXECUTED):
                body = json.dumps({"code": 200, "msg": _RECOVERED_MSG,
                                   "data": None}).encode()
                self.finish(key, 200, 200, body)
                rep["finalized"] += 1
            else:
                self._drop(key)
                rep["dropped"] += 1
        return rep

    # ------------------------------------------------------------- stats

    @property
    def replays(self) -> int:
        with self._lock:
            return self._replays

    def record_count(self) -> int:
        """Approximate live-record gauge, O(1) — /metrics is scraped far
        too often to pay a range() scan per scrape."""
        with self._lock:
            return max(0, self._count)
