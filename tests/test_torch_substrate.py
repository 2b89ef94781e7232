"""PyTorch port, the services' substrate against JAX's on the same calls:

- the VersionMap and MergeMap cases of tests/test_version_workqueue.py;
- the CPU and port scheduler cases of tests/test_schedulers.py;
- the MockBackend cases of tests/test_backend.py, with quiesce and the
  health injections;
- tests/test_lockwatch.py: the wrapped primitives, the lock-order graph,
  the held-across-backend findings (through the port's GuardedBackend),
  and the install seam, which watches the port's own locks;
- the event log, the intent journal, the idempotency cache and the
  rotating writer on a few calls each.

Each case is one function run once with each package's modules (`P`); it
returns a record of every result, or error class name, and of the state
it reads, and the two records must be equal. Nothing is normalised but
each run's own directory, which reads as <root>, and wall-clock stamps,
which are dropped. Lock sites that name a source file are compared by
what they say, not by their line numbers.
"""

import json
import os
import threading
import time
import types

import pytest
import torch

import gpu_docker_api_tpu as jpkg
import gpu_docker_api_tpu_torch as tpkg

torch.set_num_threads(1)


def modules(pkg):
    """The modules a case uses, as attributes of one namespace."""
    import importlib
    names = ("xerrors", "version", "workqueue", "store", "events",
             "intents", "idempotency", "obs.rotate", "schedulers",
             "backend", "backend.guard", "analysis.lockwatch", "dtos")
    ns = types.SimpleNamespace(name=pkg.__name__,
                               jax=pkg.__name__ == "gpu_docker_api_tpu")
    for n in names:
        setattr(ns, n.replace(".", "_"),
                importlib.import_module(f"{pkg.__name__}.{n}"))
    return ns


JAX, PORT = modules(jpkg), modules(tpkg)


class Rec(list):
    """A case's record: call results (or error class names) and reads."""

    def __init__(self, root):
        super().__init__()
        self.root = root

    def call(self, label, fn, *a, **kw):
        try:
            out = fn(*a, **kw)
        except Exception as e:  # noqa: BLE001 — the error is the result
            self.append((label, "error", type(e).__name__))
            return None
        self.append((label, "ok", self._norm(out)))
        return out

    def note(self, label, value):
        self.append((label, "note", self._norm(value)))

    def _norm(self, x):
        if isinstance(x, dict):
            return {k: self._norm(v) for k, v in x.items()
                    if k not in ("ts", "at", "begunAt", "durationMs")}
        if isinstance(x, (list, tuple)):
            return [self._norm(v) for v in x]
        if isinstance(x, str):
            return x.replace(self.root, "<root>")
        return x


def both(tmp_path, case):
    out = []
    for name, P in (("jax", JAX), ("port", PORT)):
        root = tmp_path / name
        root.mkdir()
        rec = Rec(str(root))
        case(P, root, rec)
        out.append(rec)
    return out


def client_of(P):
    return P.store.StateClient(P.store.MVCCStore())


# ---- tests/test_version_workqueue.py: VersionMap, MergeMap -------------------

def version_map_bump_and_persist(P, root, r):
    c = client_of(P)
    vm = P.version.VersionMap("containerVersionMap", c)
    r.call("get", vm.get, "foo")
    for name in ("foo", "foo", "bar"):
        r.call(f"bump {name}", vm.bump, name)
    r.call("rollback foo", vm.rollback_bump, "foo", 1)
    r.call("get", vm.get, "foo")
    r.call("rollback bar", vm.rollback_bump, "bar", 0)
    r.call("exist", vm.exist, "bar")
    r.call("reload", P.version.VersionMap("containerVersionMap", c).items)


def version_map_concurrent_bumps(P, root, r):
    vm = P.version.VersionMap("containerVersionMap", client_of(P))
    out, lock = [], threading.Lock()

    def w():
        for _ in range(100):
            v = vm.bump("rs")
            with lock:
                out.append(v)

    ts = [threading.Thread(target=w) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    r.note("minted", sorted(out))


def merge_map(P, root, r):
    c = client_of(P)
    mm = P.version.MergeMap(c)
    for k, v in (("rs-1", "/merges/rs/rs-1"), ("rs-2", "/merges/rs/rs-2"),
                 ("other-1", "/merges/other/other-1")):
        r.call(f"set {k}", mm.set, k, v)
    r.call("remove rs", lambda: sorted(mm.remove_replicaset("rs")))
    r.call("items", mm.items)
    r.call("reload", P.version.MergeMap(c).items)


def version_map_via_workqueue(P, root, r):
    c = client_of(P)
    wq = P.workqueue.WorkQueue(c)
    wq.start()
    vm = P.version.VersionMap("volumeVersionMap", c, wq)
    r.call("bump", vm.bump, "vol")
    r.call("bump", vm.bump, "vol")
    r.call("join", wq.join)
    r.call("reload", P.version.VersionMap("volumeVersionMap", c).get, "vol")
    wq.close()


def merge_map_prefix_no_cross_replicaset(P, root, r):
    mm = P.version.MergeMap(client_of(P))
    mm.set("app-1", "/m/app/app-1")
    mm.set("app-1-1", "/m/app-1/app-1-1")
    r.call("remove app", mm.remove_replicaset, "app")
    r.call("items", mm.items)


# ---- tests/test_schedulers.py: the CPU and port schedulers -------------------

def cpu_apply_cpuset_string(P, root, r):
    s = P.schedulers.CpuScheduler(client_of(P), core_count=8)
    r.call("apply 3", s.apply, 3)
    r.call("apply 2", s.apply, 2)
    r.call("restore", s.restore, "1,3")
    r.call("apply 2", s.apply, 2)
    r.call("status", s.get_status)


def cpu_exhaustion(P, root, r):
    s = P.schedulers.CpuScheduler(client_of(P), core_count=2)
    r.call("apply 2", s.apply, 2)
    r.call("apply 1", s.apply, 1)


def cpu_restore_empty_noop(P, root, r):
    s = P.schedulers.CpuScheduler(client_of(P), core_count=4)
    r.call("restore ''", s.restore, "")
    r.call("restore None", s.restore, None)
    r.call("status", s.get_status)


def cpu_reboot_from_store(P, root, r):
    c = client_of(P)
    s = P.schedulers.CpuScheduler(c, core_count=4)
    r.call("apply", s.apply, 2, "o")
    s.flush()
    r.call("reboot", P.schedulers.CpuScheduler(c).get_status)
    r.call("owners", P.schedulers.CpuScheduler(c).owners)


def port_apply_in_range_unique(P, root, r):
    s = P.schedulers.PortScheduler(client_of(P), port_range=(42000, 42100),
                                   seed=7)
    r.call("apply 20", s.apply, 20)
    r.call("status", s.get_status)


def port_exhaustion_and_restore(P, root, r):
    s = P.schedulers.PortScheduler(client_of(P), port_range=(42000, 42004),
                                   seed=1)
    g = r.call("apply 5", s.apply, 5)
    r.call("apply 1", s.apply, 1)
    r.call("restore", s.restore, g[:2])
    r.call("apply 2", s.apply, 2)


def port_dense_fallback_sweep(P, root, r):
    s = P.schedulers.PortScheduler(client_of(P), port_range=(42000, 42009),
                                   seed=3)
    r.call("apply 10", lambda: sorted(s.apply(10)))


def port_persists_under_own_key(P, root, r):
    c = client_of(P)
    s = P.schedulers.PortScheduler(c, port_range=(42000, 42010), seed=2)
    r.call("apply", s.apply, 3, "o")
    s.flush()
    r.call("ports key", lambda: c.get("ports", "portStatusMap") is not None)
    r.call("tpus key", lambda: c.get("tpus", "portStatusMap") is None)
    r.call("reboot", P.schedulers.PortScheduler(c).get_status)


def port_explicit_range_overrides_store(P, root, r):
    c = client_of(P)
    s = P.schedulers.PortScheduler(c, port_range=(42000, 42010), seed=2)
    s.apply(3)
    s.flush()
    s2 = P.schedulers.PortScheduler(c, port_range=(50000, 50100), seed=5)
    r.call("status", s2.get_status)
    r.call("apply", s2.apply, 5)


# ---- tests/test_backend.py: the mock backend ---------------------------------

def spec(P, **kw):
    d = dict(image="", cmd=["sleep", "30"], env=["FOO=bar"])
    d.update(kw)
    return P.dtos.ContainerSpec(**d)


def state(b, name):
    st = b.inspect(name)
    return {"exists": st.exists, "running": st.running, "paused": st.paused,
            "exit_code": st.exit_code, "upper_dir": st.upper_dir or "",
            "dir": bool(st.upper_dir) and os.path.isdir(st.upper_dir)}


def mock_create_start_inspect_stop(P, root, r):
    b = P.backend.MockBackend(str(root / "s"))
    r.call("create", lambda: bool(b.create("rs-1", spec(P))))
    r.note("created", state(b, "rs-1"))
    r.call("start", b.start, "rs-1")
    r.note("started", state(b, "rs-1"))
    r.call("stop", b.stop, "rs-1")
    r.note("stopped", state(b, "rs-1"))
    r.call("remove", b.remove, "rs-1")
    r.note("removed", state(b, "rs-1"))


def mock_duplicate_create_rejected(P, root, r):
    b = P.backend.MockBackend(str(root / "s"))
    r.call("create", lambda: bool(b.create("rs-1", spec(P))))
    r.call("create again", b.create, "rs-1", spec(P))


def mock_list_names_prefix(P, root, r):
    b = P.backend.MockBackend(str(root / "s"))
    for n in ("foo-1", "foo-2", "bar-1"):
        b.create(n, spec(P))
    r.call("list", b.list_names, "foo-")


def mock_remove_running_requires_force(P, root, r):
    b = P.backend.MockBackend(str(root / "s"))
    b.create("rs-1", spec(P))
    b.start("rs-1")
    r.call("remove", b.remove, "rs-1", force=False)
    r.call("remove force", b.remove, "rs-1", force=True)
    r.note("gone", state(b, "rs-1"))


def mock_volumes(P, root, r):
    b = P.backend.MockBackend(str(root / "s"))
    v = b.volume_create("vol", size_bytes=1024 ** 2)
    r.note("created", [v.exists, v.mountpoint, os.path.isdir(v.mountpoint)])
    with open(os.path.join(v.mountpoint, "data.bin"), "wb") as f:
        f.write(b"z" * 2048)
    r.call("used", lambda: b.volume_inspect("vol").used_bytes)
    r.call("create again", b.volume_create, "vol")
    r.call("list", b.volume_list)
    r.call("remove", b.volume_remove, "vol")
    r.call("gone", lambda: b.volume_inspect("vol").exists)


def mock_exec_canned(P, root, r):
    b = P.backend.MockBackend(str(root / "s"))
    b.create("rs-1", spec(P))
    r.call("exec stopped", b.execute, "rs-1", ["echo", "hi"])
    b.start("rs-1")
    r.call("exec", b.execute, "rs-1", ["echo", "hi"])


def mock_quiesce_and_health(P, root, r):
    """The injectable quiesce outcomes and health state the services'
    tests drive: the ack lands in the layer at the injected step."""
    import json
    b = P.backend.MockBackend(str(root / "s"))
    b.create("rs-1", spec(P))
    r.call("quiesce stopped", b.quiesce, "rs-1")
    b.start("rs-1")
    r.call("quiesce", b.quiesce, "rs-1")
    with open(os.path.join(b.inspect("rs-1").upper_dir,
                           b.QUIESCE_ACK)) as f:
        r.note("ack", json.load(f))
    for mode in ("timeout", "error", "bogus"):
        r.call(f"set {mode}", b.set_quiesce, mode, 3)
        r.call(f"quiesce {mode}", b.quiesce, "rs-1")
    r.note("log", b.quiesce_log)
    b.set_chip_health("/dev/nvidia1", False)
    r.call("chip 1", b.chip_available, "/dev/nvidia1")
    r.call("chip 0", b.chip_available, "/dev/nvidia0")
    b.set_flap_count("rs-1", 2)
    r.call("flaps", b.flap_counts)
    b.set_ping(False)
    r.call("ping", b.ping)


# ---- the event log, the intent journal, idempotency, the rotating writer ----

def event_log_ring(P, root, r):
    ev = P.events.EventLog(str(root), capacity=4)
    for i in range(6):
        ev.record("op", target=f"t{i % 2}", code=200 + i, extra=i)
    r.call("recent", ev.recent)
    r.call("recent t1", ev.recent, target="t1")
    r.call("last", ev.last_seq)
    r.call("first", ev.first_retained)
    r.call("since 3", ev.since, 3)
    r.call("since 0", ev.since, 0)
    ev.close()
    with open(root / "events.jsonl") as f:
        r.note("jsonl", [line.strip() != "" for line in f])


def intent_journal(P, root, r):
    c = client_of(P)
    j = P.intents.IntentJournal(c)
    it = j.begin("replace", "demo", via="patch")
    it.step("created", container="demo-2", version=2)
    it.step("precopied", sync=False, bytes=3)
    r.call("open", lambda: [json.loads(x.serialize())
                            for x in j.open_intents()])
    it.done(committed=True)
    r.call("after done", j.open_intents)
    vol = j.begin("volume.create", "v", kind=P.intents.KIND_VOLUME)
    r.call("key", lambda: [kv.key for kv in c.range("")])
    vol.done()


def idempotency_cache(P, root, r):
    cache = P.idempotency.IdempotencyCache(client_of(P))
    r.call("names", lambda: sorted(n for n in dir(cache)
                                   if not n.startswith("_")))


def rotating_writer(P, root, r):
    w = P.obs_rotate.RotatingWriter(str(root / "log.jsonl"), max_bytes=64)
    for i in range(20):
        w.write(f'{{"i": {i}}}\n')
    w.flush()
    w.close()
    r.note("files", sorted(os.listdir(root)))
    r.note("tail", open(root / "log.jsonl").read())


CASES = [version_map_bump_and_persist, version_map_concurrent_bumps,
         merge_map, version_map_via_workqueue,
         merge_map_prefix_no_cross_replicaset,
         cpu_apply_cpuset_string, cpu_exhaustion, cpu_restore_empty_noop,
         cpu_reboot_from_store, port_apply_in_range_unique,
         port_exhaustion_and_restore, port_dense_fallback_sweep,
         port_persists_under_own_key, port_explicit_range_overrides_store,
         mock_create_start_inspect_stop, mock_duplicate_create_rejected,
         mock_list_names_prefix, mock_remove_running_requires_force,
         mock_volumes, mock_exec_canned, mock_quiesce_and_health,
         event_log_ring, intent_journal, idempotency_cache,
         rotating_writer]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_substrate_case_equals_jax(tmp_path, case):
    jax, port = both(tmp_path, case)
    assert port == jax
    assert port


# ---- tests/test_lockwatch.py ------------------------------------------------

def lw_watched_lock_contract(P, root, r):
    w = P.analysis_lockwatch.LockWatcher()
    lk = w.make_lock(site="L")
    r.note("locked", lk.locked())
    with lk:
        r.note("held", [lk.locked(), lk.acquire(blocking=False)])
    r.note("after", [lk.locked(), w.acquires, w.report()["lockSites"]])


def lw_rlock_reentrancy(P, root, r):
    w = P.analysis_lockwatch.LockWatcher()
    rl = w.make_rlock(site="R")
    with rl:
        with rl:
            pass
    r.note("report", w.report())


def lw_out_of_lifo_release(P, root, r):
    w = P.analysis_lockwatch.LockWatcher()
    a, b = w.make_lock(site="A"), w.make_lock(site="B")
    a.acquire()
    b.acquire()
    a.release()
    w.note_backend_op("stop")
    b.release()
    r.note("found", [f["lock"] for f in w.report()["heldAcrossBackend"]])


def lw_condition_wait_notify(P, root, r):
    w = P.analysis_lockwatch.LockWatcher()
    cond = w.make_condition(site="C")
    hits = []

    def waiter():
        with cond:
            while not hits:
                cond.wait(timeout=5)
            hits.append("woke")

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        hits.append("sent")
        cond.notify_all()
    t.join(timeout=5)
    r.note("hits", [t.is_alive(), hits])


def lw_condition_over_watched_lock(P, root, r):
    w = P.analysis_lockwatch.LockWatcher()
    lk = w.make_rlock(site="L")
    cond = w.make_condition(lock=lk, site="C")
    with lk:
        grabbed = []
        t = threading.Thread(
            target=lambda: grabbed.append(cond._inner.acquire(False)))
        t.start()
        t.join()
    r.note("grabbed", grabbed)


def lw_nested_acquire_edge(P, root, r):
    w = P.analysis_lockwatch.LockWatcher()
    a, b = w.make_lock(site="A"), w.make_lock(site="B")
    with a:
        with b:
            pass
    rep = w.report()
    r.note("graph", [rep["edges"], rep["cycles"]])
    r.call("clean", w.assert_clean)


def lw_two_thread_abba(P, root, r):
    w = P.analysis_lockwatch.LockWatcher()
    a, b = w.make_lock(site="A"), w.make_lock(site="B")
    done = threading.Event()

    def t1():
        with a:
            with b:
                pass
        done.set()

    def t2():
        done.wait(5)
        with b:
            with a:
                pass

    ths = [threading.Thread(target=t1), threading.Thread(target=t2)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(5)
    rep = w.report()
    r.note("cycles", rep["cycles"])
    r.note("edges", sorted((e["from"], e["to"]) for e in rep["cycleEdges"]))
    r.call("clean", w.assert_clean)


def lw_three_site_cycle(P, root, r):
    w = P.analysis_lockwatch.LockWatcher()
    a, b, c = (w.make_lock(site=s) for s in "ABC")
    for first, second in ((a, b), (b, c), (c, a)):
        with first:
            with second:
                pass
    r.note("cycles", w.report()["cycles"])


def lw_same_site_peers(P, root, r):
    w = P.analysis_lockwatch.LockWatcher()
    a1, a2 = w.make_lock(site="base.py:65"), w.make_lock(site="base.py:65")
    with a1:
        with a2:
            pass
    r.note("edges", w.report()["edges"])


def lw_held_across_backend(P, root, r):
    w = P.analysis_lockwatch.LockWatcher()
    lk = w.make_lock(site="sched")
    with lk:
        w.note_backend_op("create")
    r.note("found", [(f["lock"], f["op"])
                     for f in w.report()["heldAcrossBackend"]])
    r.call("clean", w.assert_clean)


def lw_nothing_held(P, root, r):
    w = P.analysis_lockwatch.LockWatcher()
    lk = w.make_lock(site="sched")
    with lk:
        pass
    w.note_backend_op("create")
    r.note("found", w.report()["heldAcrossBackend"])
    r.call("clean", w.assert_clean)


def lw_name_lock_exemptions(P, root, r):
    w = P.analysis_lockwatch.LockWatcher()
    name_lock = w.make_lock(site="replicaset.py:173", exempt=True)
    with name_lock:
        w.note_backend_op("stop")
    r.note("exempt", w.report()["heldAcrossBackend"])
    other = w.make_lock(site="special")
    w.exempt_io("special")
    with other:
        w.note_backend_op("stop")
    r.note("allowlisted", [w.report()["heldAcrossBackend"],
                           w.report()["exemptSites"]])


def lw_guard_seam(P, root, r):
    """GuardedBackend notes every guarded op on the caller's thread, so a
    watched lock held over one is flagged; the health hooks are not."""
    lw = P.analysis_lockwatch
    w = lw.LockWatcher()
    saved = lw._watcher
    lw._watcher = w
    try:
        gb = P.backend.GuardedBackend(P.backend.MockBackend(str(root / "s")))
        lk = w.make_lock(site="monitor._lock")
        with lk:
            gb.ping()
            gb.list_names()
        r.note("found", sorted((f["lock"], f["op"])
                               for f in w.report()["heldAcrossBackend"]))
    finally:
        lw._watcher = saved


def lw_reset_in_place(P, root, r):
    lw = P.analysis_lockwatch
    w = lw.LockWatcher()
    saved = lw._watcher
    lw._watcher = w
    try:
        a, b = w.make_lock(site="A"), w.make_lock(site="B")
        with a:
            with b:
                pass
        r.note("edges", len(w.report()["edges"]))
        lw.reset()
        r.note("reset", [w.report()["edges"], w.report()["acquires"]])
        with b:
            with a:
                pass
        with a:
            with b:
                pass
        r.note("cycles", lw.report()["cycles"])
    finally:
        lw._watcher = saved


def lw_install_seam(P, root, r):
    """install() watches locks created inside the package (the card or TPU
    scheduler's, by their creation site) and not the caller's; uninstall
    restores threading and orphaned wrappers keep working."""
    lw = P.analysis_lockwatch
    was = lw.installed()
    w = lw.install()
    try:
        r.note("ours", isinstance(threading.Lock(), lw._WatchedLock))
        cpu = P.schedulers.CpuScheduler(core_count=4)
        r.note("theirs", [isinstance(cpu._lock, lw._WatchedLock),
                          cpu._lock._site.split(":")[0].split("/", 1)[1],
                          w.report()["lockSites"][cpu._lock._site] >= 1])
    finally:
        if not was:
            lw.uninstall()
    r.note("uninstalled", [lw.installed(), threading.Lock is lw._REAL_LOCK])
    grant = cpu.apply(2, "o")
    cpu.restore(grant, "o")
    r.note("orphan works", [grant, lw.report()])
    r.call("clean", lw.assert_clean)
    r.call("fast path", lw.note_backend_op, "stop")


LOCKWATCH = [lw_watched_lock_contract, lw_rlock_reentrancy,
             lw_out_of_lifo_release, lw_condition_wait_notify,
             lw_condition_over_watched_lock, lw_nested_acquire_edge,
             lw_two_thread_abba, lw_three_site_cycle, lw_same_site_peers,
             lw_held_across_backend, lw_nothing_held,
             lw_name_lock_exemptions, lw_guard_seam, lw_reset_in_place,
             lw_install_seam]


@pytest.mark.parametrize("case", LOCKWATCH, ids=lambda c: c.__name__)
def test_lockwatch_case_equals_jax(tmp_path, case):
    jax, port = both(tmp_path, case)
    assert port == jax
    assert port


def test_lockwatch_flags_a_lock_held_across_a_service_backend_op(tmp_path):
    """The port's own locks under install(): a service mutation taken
    while a watched lock is held is flagged at the guarded backend op,
    and the per-name mutation mutex (created in `_mutex`) is exempt."""
    lw = PORT.analysis_lockwatch
    if lw.installed():
        pytest.skip("a session-armed lockwatch is installed")
    lw.install()
    try:
        lw.reset()
        from test_torch_services import World
        b = PORT.backend.GuardedBackend(
            PORT.backend.MockBackend(str(tmp_path / "s")))
        w = World("port", tmp_path, backend=b)
        try:
            w.run("clean", tpus=1)
            assert lw.report()["heldAcrossBackend"] == []
            held = threading.Lock()      # a test-made lock is not watched
            assert not isinstance(held, lw._WatchedLock)
            guard = lw._watcher.make_lock(site="caller._lock")
            with guard:
                w.run("dirty", tpus=1)
            found = {(f["lock"], f["op"])
                     for f in lw.report()["heldAcrossBackend"]}
            assert ("caller._lock", "create") in found
            assert ("caller._lock", "start") in found
            assert not any("replicaset" in site for site, _ in found)
        finally:
            w.close()
    finally:
        lw.reset()
        lw.uninstall()
