"""Async write-behind queue for state persistence.

Reference parity: internal/workQueue/workQueue.go — a buffered channel (cap
110) drained by SyncLoop, each message dispatched to a goroutine, with
*infinite re-enqueue* on etcd failure (:29-33) and close-at-Stop.

Differences by design:
- bounded retries with exponential backoff instead of an unbounded hot loop;
- a single drainer thread applying ops in order (the reference's
  goroutine-per-message loses write ordering — SURVEY §2 bug 8);
- write-behind coalescing: the drainer pops every immediately-available
  message and collapses consecutive PutKeyValue for the same
  (resource, name) to the latest snapshot — a burst of status-map updates
  costs one store write. DelKey and Call act as BARRIERS (no coalescing
  across them), so apply order is preserved exactly;
- deferred payloads: PutKeyValue.value may be a zero-arg callable — the
  producer snapshots cheap state under its lock and the DRAINER pays the
  JSON serialization (schedulers/base.py uses this to get json.dumps off
  the grant path);
- join() for deterministic tests and graceful shutdown;
- dead-letter visibility: messages that exhaust retries land in `dropped`
  (counted in /metrics, one event each) instead of vanishing, and
  replay_dropped() re-queues them — the boot-time reconciler calls it so a
  transient store outage can't become permanent state loss.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Union

from .faults import crashpoint
from .obs import trace

log = logging.getLogger(__name__)

DEFAULT_CAPACITY = 1024  # reference: 110 (workQueue.go:12)

# max messages the drainer coalesces per sweep (env-tunable; a sweep never
# blocks — it only takes what is already queued)
BATCH_MAX_ENV = "TDAPI_WQ_BATCH_MAX"
DEFAULT_BATCH_MAX = 128


@dataclass
class PutKeyValue:
    resource: str
    name: str
    # str, or a zero-arg callable resolved on the drainer (deferred
    # serialization); coalescing keeps only the LATEST value per key
    value: Union[str, Callable[[], str]]

    def resolve(self) -> str:
        return self.value() if callable(self.value) else self.value


@dataclass
class DelKey:
    resource: str
    name: str


@dataclass
class Call:
    """Escape hatch: run an arbitrary persistence closure on the drainer."""
    fn: Callable[[], None]
    describe: str = "call"


def describe(msg) -> str:
    """Stable human-readable identity of a queue message (drop events)."""
    if isinstance(msg, PutKeyValue):
        return f"put {msg.resource}/{msg.name}"
    if isinstance(msg, DelKey):
        return f"del {msg.resource}/{msg.name}"
    if isinstance(msg, Call):
        return msg.describe
    return repr(msg)


@dataclass
class _Envelope:
    msg: object
    attempts: int = 0
    enqueued_at: float = field(default_factory=time.monotonic)
    # trace context captured at submit(): the drainer resumes it, so a
    # write-behind persist appears on the MUTATION's trace even though it
    # runs seconds later on another thread (async span follow-through)
    span: object = None


class WorkQueue:
    def __init__(self, client, capacity: int = DEFAULT_CAPACITY,
                 max_retries: int = 8, base_backoff: float = 0.05,
                 events=None, batch_max: Optional[int] = None):
        self._client = client
        self._q: queue.Queue = queue.Queue(maxsize=capacity)
        self._max_retries = max_retries
        self._base_backoff = base_backoff
        self._closed = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._events = events      # EventLog: one record per dropped message
        self._dropped_lock = threading.Lock()
        self.dropped: list[object] = []  # messages that exhausted retries
        if batch_max is None:
            try:
                batch_max = int(os.environ.get(BATCH_MAX_ENV,
                                               str(DEFAULT_BATCH_MAX)))
            except ValueError:
                batch_max = DEFAULT_BATCH_MAX
        self._batch_max = max(1, batch_max)
        self.coalesced = 0  # puts superseded by a later one (drainer-only)

    # ---- producer side ----

    def submit(self, msg) -> None:
        crashpoint("workqueue.before_submit")
        if self._closed.is_set():
            raise RuntimeError("work queue closed")
        self._q.put(_Envelope(msg, span=trace.capture()))

    def pending(self) -> int:
        """Messages enqueued but not yet fully persisted (for /metrics)."""
        return self._q.unfinished_tasks

    # ---- consumer side ----

    def start(self) -> None:
        """Spawn the drainer (reference SyncLoop, workQueue.go:20-54)."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, name="workqueue-sync", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            try:
                env = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._closed.is_set():
                    return
                continue
            # sweep everything already queued (never blocks) and coalesce
            batch = [env]
            while len(batch) < self._batch_max:
                try:
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    break
            # runs of consecutive surviving puts dispatch as ONE batched
            # store commit (client.put_many -> store.put_many: one lock,
            # one flush, one optional fsync) instead of N round trips;
            # barriers (DelKey/Call) still apply individually in order
            run: list[tuple] = []
            for env, superseded in self._coalesce(batch):
                if isinstance(env.msg, PutKeyValue):
                    run.append((env, superseded))
                    continue
                self._apply_put_run(run)
                run = []
                self._apply_one(env, superseded)
            self._apply_put_run(run)

    def _apply_put_run(self, entries: list[tuple]) -> None:
        """Persist a run of coalesce-surviving puts as one batched store
        commit. Retries the whole batch (ordering within the run is the
        store's ordering); exhausted retries dead-letter every message
        individually so replay_dropped() re-queues each."""
        if not entries:
            return
        put_many = getattr(self._client, "put_many", None)
        if len(entries) == 1 or put_many is None:
            for env, superseded in entries:
                self._apply_one(env, superseded)
            return
        attempts = 0
        try:
            while True:
                try:
                    with trace.resume(entries[0][0].span,
                                      "workqueue.apply_batch",
                                      target=f"put_many x{len(entries)}",
                                      coalesced=sum(len(s) for _, s
                                                    in entries)):
                        put_many([(e.msg.resource, e.msg.name,
                                   e.msg.resolve()) for e, _ in entries])
                    # every OTHER mutation in the batch still gets its
                    # persistence span (end-to-end mutation tracing must
                    # not end at enqueue just because the write was
                    # batched); the batch's cost is carried by the
                    # apply_batch span above, these mark completion
                    for env, superseded in entries[1:]:
                        with trace.resume(env.span, "workqueue.apply",
                                          target=describe(env.msg),
                                          coalesced=len(superseded),
                                          batched=True):
                            pass
                    break
                except Exception as e:  # noqa: BLE001 — persistence must not kill the drainer
                    attempts += 1
                    if attempts > self._max_retries:
                        log.error("workqueue: dropping %d-put batch after "
                                  "%d attempts: %s", len(entries), attempts,
                                  e)
                        for env, _ in entries:
                            self._record_drop(env.msg, attempts, e)
                        break
                    delay = min(self._base_backoff * (2 ** (attempts - 1)),
                                2.0)
                    log.warning("workqueue: retry %d for %d-put batch in "
                                "%.2fs: %s", attempts, len(entries), delay,
                                e)
                    time.sleep(delay)
        finally:
            for _, superseded in entries:
                self._q.task_done()
                for _ in superseded:
                    self._q.task_done()

    def _apply_one(self, env, superseded: list) -> None:
        # Retry inline, blocking the drainer: later writes to the same
        # key must not overtake a failed earlier one, and join()/
        # close() must see in-flight retries as unfinished work.
        try:
            while True:
                try:
                    with trace.resume(env.span, "workqueue.apply",
                                      target=describe(env.msg),
                                      coalesced=len(superseded)):
                        self._dispatch(env.msg)
                    break
                except Exception as e:  # noqa: BLE001 — persistence must not kill the drainer
                    env.attempts += 1
                    if env.attempts > self._max_retries:
                        log.error("workqueue: dropping %r after %d attempts: %s",
                                  env.msg, env.attempts, e)
                        self._record_drop(env.msg, env.attempts, e)
                        break
                    delay = min(self._base_backoff * (2 ** (env.attempts - 1)), 2.0)
                    log.warning("workqueue: retry %d for %r in %.2fs: %s",
                                env.attempts, env.msg, delay, e)
                    time.sleep(delay)
        finally:
            # superseded envelopes complete WITH their survivor:
            # join() must not report done while the key's latest
            # value is still un-persisted
            self._q.task_done()
            for _ in superseded:
                self._q.task_done()

    def _coalesce(self, batch: list) -> list[tuple]:
        """[(survivor_envelope, [superseded_envelopes])], order-preserving.

        Consecutive PutKeyValue for the same (resource, name) collapse to
        the LATEST envelope at the FIRST one's position — between two
        barriers only the newest snapshot of a key can matter. DelKey and
        Call are barriers: coalescing never crosses them, so put→del→put
        still applies as three ops in order (collapsing around the del
        would resurrect or lose the key)."""
        out: list[tuple] = []
        index: dict[tuple[str, str], int] = {}  # key -> slot in current segment
        for env in batch:
            msg = env.msg
            if isinstance(msg, PutKeyValue):
                slot = index.get((msg.resource, msg.name))
                if slot is not None:
                    keep, superseded = out[slot]
                    superseded.append(keep)
                    out[slot] = (env, superseded)
                    self.coalesced += 1
                else:
                    index[(msg.resource, msg.name)] = len(out)
                    out.append((env, []))
            else:
                index.clear()   # barrier: a new segment starts after it
                out.append((env, []))
        return out

    def coalesced_count(self) -> int:
        """Puts superseded by a newer same-key put (for /metrics)."""
        return self.coalesced

    def _record_drop(self, msg, attempts: int, exc: Exception) -> None:
        """Dead-letter a message visibly: keep it for replay_dropped(),
        emit one event (the silent-loss fix — a dropped write used to be
        observable only in the process log)."""
        with self._dropped_lock:
            self.dropped.append(msg)
        if self._events is not None:
            try:
                self._events.record("workqueue.drop", target=describe(msg),
                                    code=500, attempts=attempts,
                                    error=str(exc))
            except Exception:  # noqa: BLE001 — never kill the drainer
                log.exception("recording workqueue drop event")

    def replay_dropped(self) -> int:
        """Re-queue every dead-lettered message with a fresh retry budget.
        Called by the boot-time reconciler; safe to call any time. Returns
        the number of messages re-queued."""
        with self._dropped_lock:
            msgs, self.dropped = self.dropped, []
        for m in msgs:
            self._q.put(_Envelope(m))
        return len(msgs)

    def dropped_count(self) -> int:
        with self._dropped_lock:
            return len(self.dropped)

    def _dispatch(self, msg) -> None:
        if isinstance(msg, PutKeyValue):
            self._client.put(msg.resource, msg.name, msg.resolve())
        elif isinstance(msg, DelKey):
            self._client.delete(msg.resource, msg.name)
        elif isinstance(msg, Call):
            msg.fn()
        else:
            raise TypeError(f"unknown workqueue message {type(msg)!r}")

    # ---- lifecycle ----

    def join(self, timeout: float = 5.0) -> bool:
        """Block until all currently-queued work is applied. Event-driven on
        the queue's all_tasks_done condition — the old 5ms poll put a hard
        latency floor under every mutation that drains before a read
        (delete, history, rollback)."""
        deadline = time.monotonic() + timeout
        q = self._q
        with q.all_tasks_done:
            while q.unfinished_tasks:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                q.all_tasks_done.wait(remaining)
        return True

    def close(self, timeout: float = 5.0) -> None:
        self.join(timeout)
        self._closed.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
