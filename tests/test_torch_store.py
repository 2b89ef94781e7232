"""PyTorch port, the node layer's state store (gpu_docker_api_tpu_torch/
store/) and write-behind queue (workqueue.py):

- the Python-engine cases of tests/test_store.py and the workqueue cases
  of tests/test_version_workqueue.py, on the port (each waits on joins,
  flushes and acks with its own timeout, never on a wall-clock poll);
- the state carried across: a WAL and a snapshot written by JAX's
  MVCCStore reopen in the port's with equal range, history and revisions,
  and the reverse; the same operations write the same bytes.
"""

import os
import subprocess
import sys
import threading

import pytest
import torch

from gpu_docker_api_tpu.store import MVCCStore as JStore
from gpu_docker_api_tpu.store import walio as jwalio
from gpu_docker_api_tpu_torch import faults, xerrors
from gpu_docker_api_tpu_torch.obs import metrics as obs_metrics
from gpu_docker_api_tpu_torch.obs import trace
from gpu_docker_api_tpu_torch.store import MVCCStore, StateClient, walio
from gpu_docker_api_tpu_torch.store.client import KEEP_HISTORY_PREFIXES
from gpu_docker_api_tpu_torch.workqueue import (Call, DelKey, PutKeyValue,
                                                WorkQueue)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def store(tmp_path):
    s = MVCCStore(wal_path=str(tmp_path / "wal.jsonl"))
    yield s
    s.close()


@pytest.fixture()
def client(store):
    return StateClient(store)


# ---- the engine (tests/test_store.py, Python engine) -----------------------

def test_put_get_revisions(store):
    r1 = store.put("a", "1")
    r2 = store.put("a", "2")
    r3 = store.put("b", "x")
    assert (r1, r2, r3) == (1, 2, 3)
    kv = store.get("a")
    assert (kv.value, kv.create_revision, kv.mod_revision, kv.version) == \
        ("2", 1, 2, 2)
    assert store.get("b").version == 1
    assert store.get("missing") is None


def test_delete_resets_version(store):
    store.put("k", "v1")
    store.put("k", "v2")
    assert store.delete("k")
    assert store.get("k") is None
    assert not store.delete("k")
    store.put("k", "v3")
    kv = store.get("k")
    assert kv.version == 1 and kv.create_revision == kv.mod_revision


def test_get_at_revision(store):
    store.put("k", "v1")  # rev 1
    store.put("x", "q")   # rev 2
    store.put("k", "v2")  # rev 3
    store.delete("k")     # rev 4
    store.put("k", "v3")  # rev 5
    assert [getattr(store.get_at_revision("k", r), "value", None)
            for r in range(1, 6)] == ["v1", "v1", "v2", None, "v3"]


def test_history_current_lifetime(store):
    store.put("k", "old1")
    store.delete("k")
    store.put("k", "a")
    store.put("k", "b")
    hist = store.history("k")
    assert [kv.value for kv in hist] == ["a", "b"]
    assert [kv.version for kv in hist] == [1, 2]
    full = store.history("k", since_create=False)
    assert [kv.value for kv in full] == ["old1", "a", "b"]


def test_range_sorted(store):
    store.put("/p/b", "2")
    store.put("/p/a", "1")
    store.put("/q/c", "3")
    store.delete("/p/b")
    assert [(kv.key, kv.value) for kv in store.range("/p/")] == [("/p/a", "1")]


def test_wal_persistence_roundtrip(tmp_path):
    wal = str(tmp_path / "w.jsonl")
    s = MVCCStore(wal_path=wal)
    s.put("k", "v1")
    s.put("k", "v2")
    s.delete("k")
    s.put("k", "v3")
    rev = s.revision
    s.close()
    s2 = MVCCStore(wal_path=wal)
    assert s2.revision == rev
    kv = s2.get("k")
    assert kv.value == "v3" and kv.version == 1
    assert s2.put("k", "v4") == rev + 1
    s2.close()


def test_compaction_preserves_kept_prefixes(store):
    for i in range(5):
        store.put("/hist/a", f"h{i}")
        store.put("/scratch/b", f"s{i}")
    assert store.compact(store.revision, keep_history_prefixes=("/hist/",)) == 4
    assert len(store.history("/hist/a")) == 5
    assert store.get("/scratch/b").value == "s4"
    with pytest.raises(ValueError):
        store.get_at_revision("/scratch/b", 1)


def test_snapshot_replayable(tmp_path, store):
    store.put("a", "1")
    store.put("a", "2")
    store.put("b", "x")
    snap = str(tmp_path / "snap.jsonl")
    store.snapshot(snap)
    s2 = MVCCStore(wal_path=snap)
    assert s2.get("a").value == "2"
    assert [kv.value for kv in s2.history("a")] == ["1", "2"]
    s2.close()


def test_group_commit_ack_is_durable(tmp_path):
    """put() returning means the record is in the WAL: a reader opening the
    file right after the ack sees the key, however writes are batched."""
    wal = str(tmp_path / "gc.wal")
    s = MVCCStore(wal_path=wal)
    errs = []

    def worker(i):
        for j in range(25):
            key = f"/gc/k{i}-{j}"
            s.put(key, f"v{j}")
            with open(wal, encoding="utf-8") as f:
                if f'"k":"{key}"' not in f.read():
                    errs.append(f"{key} acked but not in WAL")
                    return

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs[:3]
    assert s.wal_flushed_records >= 200
    assert 1 <= s.wal_flushes <= s.wal_flushed_records
    s.close()


def test_group_commit_replay_after_kill(tmp_path):
    """Every put a child acked before dying hard (os._exit) replays."""
    wal = str(tmp_path / "kill.wal")
    child = (
        "import sys, os, threading\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "sys.modules['jax'] = None\n"
        "from gpu_docker_api_tpu_torch.store.mvcc import MVCCStore\n"
        f"s = MVCCStore(wal_path={wal!r})\n"
        "def w(i):\n"
        "    for j in range(30):\n"
        "        s.put(f'/kill/k{i}-{j}', str(j))\n"
        "ts = [threading.Thread(target=w, args=(i,)) for i in range(4)]\n"
        "[t.start() for t in ts]\n"
        "[t.join() for t in ts]\n"
        "print('ACKED', flush=True)\n"
        "os._exit(1)\n"
    )
    out = subprocess.run([sys.executable, "-c", child],
                         capture_output=True, text=True, timeout=60)
    assert "ACKED" in out.stdout, out.stderr
    s2 = MVCCStore(wal_path=wal)
    for i in range(4):
        for j in range(30):
            kv = s2.get(f"/kill/k{i}-{j}")
            assert kv is not None and kv.value == str(j)
    s2.close()


def test_group_commit_durability_ordering(store):
    def worker(i):
        for j in range(40):
            store.put("/ordered/shared", f"{i}-{j}")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    hist = store.history("/ordered/shared")
    assert len(hist) == 240
    revs = [kv.mod_revision for kv in hist]
    assert revs == sorted(revs)
    assert store.get("/ordered/shared").mod_revision == revs[-1]


def test_concurrent_puts_unique_revisions(store):
    revs = []
    lock = threading.Lock()

    def worker(i):
        for j in range(50):
            r = store.put(f"k{i}", str(j))
            with lock:
                revs.append(r)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert len(revs) == len(set(revs)) == 400


def test_client_basic_and_missing(client):
    client.put("containers", "foo", "{}")
    assert client.get_value("containers", "foo") == "{}"
    with pytest.raises(xerrors.NotExistInStoreError):
        client.get_value("containers", "nope")


def test_client_revision_range_newest_first(client):
    for v in ("v1", "v2", "v3"):
        client.put("containers", "foo", v)
    combos = client.get_revision_range("containers", "foo")
    assert [c.value for c in combos] == ["v3", "v2", "v1"]
    assert [c.version for c in combos] == [3, 2, 1]
    assert client.get_revision("containers", "foo", 2).value == "v2"
    with pytest.raises(xerrors.VersionNotFoundError):
        client.get_revision("containers", "foo", 9)


def test_entity_version_keys(client):
    for v in (1, 2, 3):
        client.put_entity_version("containers", "rs", v, f"cfg{v}")
    assert client.get_entity_version("containers", "rs", 2) == "cfg2"
    assert client.entity_versions("containers", "rs") == \
        [(1, "cfg1"), (2, "cfg2"), (3, "cfg3")]
    assert client.delete_entity_versions("containers", "rs") == 3
    assert client.entity_versions("containers", "rs") == []


def test_compaction_keeps_floor_revision(store):
    for k in ("a", "_", "b", "_", "c"):
        store.put("k" if k != "_" else "x", k)
    store.compact(4)
    assert store.get_at_revision("k", 4).value == "b"
    assert store.get_at_revision("k", 5).value == "c"


def test_compaction_reclaims_tombstoned_keys(store):
    store.put("dead", "v")
    store.delete("dead")
    store.put("alive", "v")
    store.compact(store.revision)
    assert "dead" not in list(store.keys())
    assert store.get("dead") is None and store.get("alive").value == "v"


def test_snapshot_preserves_revision_counter(tmp_path, store):
    store.put("a", "1")
    store.put("b", "2")
    store.delete("b")
    snap = str(tmp_path / "s.jsonl")
    store.snapshot(snap)
    s2 = MVCCStore(wal_path=snap)
    assert s2.revision == 3
    assert s2.put("c", "x") == 4
    s2.close()


def test_compaction_durable_across_restart(tmp_path):
    wal = str(tmp_path / "c.jsonl")
    s = MVCCStore(wal_path=wal)
    for i in range(5):
        s.put("k", f"v{i}")
    s.compact(s.revision)
    s.close()
    s2 = MVCCStore(wal_path=wal)
    with pytest.raises(ValueError):
        s2.get_at_revision("k", 1)
    assert s2.get("k").value == "v4"
    s2.close()


def test_maintain_bounds_wal_and_keeps_history(tmp_path):
    wal = str(tmp_path / "maint.wal")
    s = MVCCStore(wal_path=wal)
    for i in range(500):
        s.put("/tpu-docker-api/apis/v1/tpus/tpuStatusMap", f"state-{i}")
    for v in range(1, 6):
        s.put("/tpu-docker-api/apis/v1/containers/web", f"cfg-v{v}")
        s.put(f"/tpu-docker-api/apis/v1/versions/containers/web/{v:012d}",
              f"cfg-v{v}")
    rev_before = s.revision
    stats = s.maintain(KEEP_HISTORY_PREFIXES)
    assert stats["dropped"] >= 499 and stats["wal_records"] < 30
    s.put("/tpu-docker-api/apis/v1/tpus/tpuStatusMap", "state-after")
    s.close()
    s2 = MVCCStore(wal_path=wal)
    assert s2.revision >= rev_before + 1
    assert s2.get("/tpu-docker-api/apis/v1/tpus/tpuStatusMap").value == \
        "state-after"
    assert [kv.value for kv in s2.history(
        "/tpu-docker-api/apis/v1/containers/web")] == \
        [f"cfg-v{v}" for v in range(1, 6)]
    with pytest.raises(ValueError):
        s2.get_at_revision("/tpu-docker-api/apis/v1/tpus/tpuStatusMap", 1)
    s2.close()


def test_torn_tail_truncates_and_midlog_damage_raises(tmp_path):
    """The v1 frames: a torn tail is cut off on open; a flipped bit with
    good records after it refuses to open, naming the port's scrub."""
    wal = str(tmp_path / "t.wal")
    s = MVCCStore(wal_path=wal)
    for i in range(6):
        s.put("k", f"v{i}")
    s.close()
    faults.corrupt_wal(wal, "torn_tail")
    s2 = MVCCStore(wal_path=wal)
    assert s2.get("k").value == "v4" and s2.revision == 5
    s2.close()
    faults.corrupt_wal(wal, "bitflip", line_at=0.3)
    assert not walio.scrub(wal)["ok"]
    with pytest.raises(walio.WalCorruptError, match="cli store scrub"):
        MVCCStore(wal_path=wal)


def test_enospc_latches_read_only(tmp_path):
    from gpu_docker_api_tpu_torch.store import StoreReadOnlyError
    s = MVCCStore(wal_path=str(tmp_path / "full.wal"))
    s.put("k", "v1")
    faults.arm_disk_fault("full.wal:enospc")
    try:
        with pytest.raises(StoreReadOnlyError):
            s.put("k", "v2")
        assert s.read_only and s.get("k") is not None
    finally:
        faults.disarm_disk_faults()
        s.close()


def test_the_store_writes_are_traced_and_counted(client):
    collector = trace.TraceCollector()
    before = obs_metrics.STORE_PUT_LATENCY.snapshot()["count"]
    with trace.root_span(collector, "test.root") as root:
        client.put("containers", "a", "1")
        client.delete("containers", "a")
    got = collector.get(root.trace_id)
    assert [s["op"] for s in got["spans"]] == \
        ["store.put", "store.delete", "test.root"]
    assert got["spans"][0]["parentId"] == root.span_id
    assert obs_metrics.STORE_PUT_LATENCY.snapshot()["count"] == before + 1


# ---- the write-behind queue (tests/test_version_workqueue.py) ---------------

def test_workqueue_applies_in_order(client):
    wq = WorkQueue(client)
    wq.start()
    for i in range(20):
        wq.submit(PutKeyValue("containers", "k", f"v{i}"))
    assert wq.join(30)
    assert client.get_value("containers", "k") == "v19"
    wq.submit(DelKey("containers", "k"))
    assert wq.join(30)
    assert client.get("containers", "k") is None
    wq.close()


def test_workqueue_retries_then_succeeds(client):
    fails = {"n": 3}

    def flaky():
        if fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("transient")
        client.put("containers", "done", "yes")

    wq = WorkQueue(client, base_backoff=0.01)
    wq.start()
    wq.submit(Call(flaky))
    assert wq.join(30)        # retries run inline: join covers them
    assert client.get_value("containers", "done") == "yes"
    assert wq.dropped_count() == 0
    wq.close()


def test_workqueue_drops_after_max_retries(client):
    def always_fails():
        raise OSError("permanent")

    wq = WorkQueue(client, max_retries=2, base_backoff=0.001)
    wq.start()
    wq.submit(Call(always_fails, "doomed"))
    assert wq.join(30)
    assert len(wq.dropped) == 1
    wq.close()


def test_workqueue_rejects_after_close(client):
    wq = WorkQueue(client)
    wq.start()
    wq.close()
    with pytest.raises(RuntimeError):
        wq.submit(PutKeyValue("a", "b", "c"))


def test_workqueue_retry_preserves_key_order(client):
    fails = {"n": 2}
    applied = []

    def first():
        if fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("transient")
        applied.append("old")
        client.put("containers", "ordered", "old")

    def second():
        applied.append("new")
        client.put("containers", "ordered", "new")

    wq = WorkQueue(client, base_backoff=0.01)
    wq.start()
    wq.submit(Call(first))
    wq.submit(Call(second))
    assert wq.join(30)
    assert applied == ["old", "new"]
    assert client.get_value("containers", "ordered") == "new"
    wq.close()


class _RecordingClient:
    """StateClient wrapper counting the ops that hit the store."""

    def __init__(self, inner):
        self.inner = inner
        self.ops: list[tuple] = []

    def put(self, resource, name, value):
        self.ops.append(("put", resource, name, value))
        return self.inner.put(resource, name, value)

    def delete(self, resource, name):
        self.ops.append(("del", resource, name))
        return self.inner.delete(resource, name)


def test_coalesce_consecutive_puts_same_key(client):
    rec = _RecordingClient(client)
    wq = WorkQueue(rec)
    for i in range(20):
        wq.submit(PutKeyValue("containers", "hot", f"v{i}"))
    wq.submit(PutKeyValue("containers", "other", "x"))
    wq.start()
    assert wq.join(30)
    assert [op for op in rec.ops if op[0] == "put"] == [
        ("put", "containers", "hot", "v19"),
        ("put", "containers", "other", "x")]
    assert wq.coalesced_count() == 19
    wq.close()


def test_coalesce_del_is_a_barrier(client):
    rec = _RecordingClient(client)
    wq = WorkQueue(rec)
    wq.submit(PutKeyValue("containers", "k", "v1"))
    wq.submit(DelKey("containers", "k"))
    wq.submit(PutKeyValue("containers", "k", "v2"))
    wq.start()
    assert wq.join(30)
    assert rec.ops == [("put", "containers", "k", "v1"),
                       ("del", "containers", "k"),
                       ("put", "containers", "k", "v2")]
    assert wq.coalesced_count() == 0
    wq.close()


def test_coalesce_call_is_a_barrier(client):
    wq = WorkQueue(_RecordingClient(client))
    seen = {}
    wq.submit(PutKeyValue("containers", "k", "v1"))
    wq.submit(Call(lambda: seen.update(
        at_call=client.get_value("containers", "k")), "probe"))
    wq.submit(PutKeyValue("containers", "k", "v2"))
    wq.start()
    assert wq.join(30)
    assert seen["at_call"] == "v1"
    assert client.get_value("containers", "k") == "v2"
    wq.close()


def test_coalesce_deferred_value_resolved_on_drainer(client):
    wq = WorkQueue(client)
    resolved = []

    def snap(i):
        def go():
            resolved.append(i)
            return f"snapshot-{i}"
        return go

    for i in range(5):
        wq.submit(PutKeyValue("tpus", "statusMap", snap(i)))
    wq.start()
    assert wq.join(30)
    assert client.get_value("tpus", "statusMap") == "snapshot-4"
    assert resolved == [4]
    wq.close()


def test_coalesced_drop_dead_letters_survivor(client):
    class Failing:
        def __init__(self, inner):
            self.inner = inner
            self.healthy = False

        def put(self, resource, name, value):
            if not self.healthy:
                raise OSError("store down")
            return self.inner.put(resource, name, value)

        def delete(self, resource, name):
            return self.inner.delete(resource, name)

    failing = Failing(client)
    wq = WorkQueue(failing, max_retries=1, base_backoff=0.001)
    for i in range(8):
        wq.submit(PutKeyValue("containers", "dl", f"v{i}"))
    wq.start()
    assert wq.join(30)
    assert wq.coalesced_count() == 7
    assert len(wq.dropped) == 1 and wq.dropped[0].value == "v7"
    failing.healthy = True
    assert wq.replay_dropped() == 1
    assert wq.join(30)
    assert client.get_value("containers", "dl") == "v7"
    assert wq.dropped_count() == 0
    wq.close()


def test_workqueue_crashpoint_drops_the_persist(client):
    """An armed crashpoint kills the submit before the write is queued."""
    wq = WorkQueue(client)
    wq.start()
    faults.arm("workqueue.before_submit")
    try:
        with pytest.raises(faults.InjectedCrash):
            wq.submit(PutKeyValue("containers", "never", "x"))
    finally:
        faults.disarm_all()
    assert wq.join(30)
    assert client.get("containers", "never") is None
    with pytest.raises(RuntimeError, match="not registered"):
        faults.crashpoint("workqueue.typo")
    wq.close()


# ---- the state carried across the packages ----------------------------------

def _drive(s):
    """One op sequence: puts, a batch, deletes, recreation, compaction."""
    for i in range(6):
        s.put("/tpu-docker-api/apis/v1/containers/web", f"cfg{i}")
        s.put("/tpu-docker-api/apis/v1/tpus/tpuStatusMap", f"m{i}")
    s.put_many([("/tpu-docker-api/apis/v1/ports/portStatusMap", "p0"),
                ("/tpu-docker-api/apis/v1/cpus/cpuStatusMap", "c0")])
    s.delete("/tpu-docker-api/apis/v1/containers/web")
    s.put("/tpu-docker-api/apis/v1/containers/web", "reborn")
    s.put("/x/é\"quoted\"", "v\nwith newline")
    s.compact(s.revision - 2, keep_history_prefixes=KEEP_HISTORY_PREFIXES)
    s.put("/tpu-docker-api/apis/v1/tpus/tpuStatusMap", "after")


def _view(s):
    keys = sorted(s.keys())
    return {
        "revision": s.revision,
        "range": [(kv.key, kv.value, kv.create_revision, kv.mod_revision,
                   kv.version) for kv in s.range("/")],
        "history": {k: [(kv.value, kv.mod_revision, kv.version)
                        for kv in s.history(k, since_create=False)]
                    for k in keys},
    }


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_store_opens_in_the_other_package(tmp_path, writer):
    """WAL and snapshot from one package reopen in the other with equal
    range, history and revisions; both keep counting from there."""
    W, R = (JStore, MVCCStore) if writer == "jax" else (MVCCStore, JStore)
    wal, snap = str(tmp_path / "w.wal"), str(tmp_path / "snap.wal")
    s = W(wal_path=wal)
    _drive(s)
    want = _view(s)
    s.snapshot(snap)
    s.close()
    for path in (wal, snap):
        other = R(wal_path=path)
        got = _view(other)
        if path == wal:
            assert got == want
        else:
            assert got["revision"] == want["revision"]
            assert got["range"] == want["range"]
        assert other.put("/next", "n") == want["revision"] + 1
        other.close()


def test_the_same_operations_write_the_same_bytes(tmp_path):
    jw, tw = str(tmp_path / "j.wal"), str(tmp_path / "t.wal")
    for cls, path in ((JStore, jw), (MVCCStore, tw)):
        s = cls(wal_path=path)
        _drive(s)
        s.snapshot(path + ".snap")
        s.backup(path + ".bak")
        s.close()
    for suffix in ("", ".snap", ".bak"):
        with open(jw + suffix, "rb") as f, open(tw + suffix, "rb") as g:
            assert f.read() == g.read(), suffix
    assert walio.MAGIC == jwalio.MAGIC
    assert walio.scrub(jw) == {**jwalio.scrub(jw)}
