"""PyTorch port, the card scheduler (gpu_docker_api_tpu_torch/schedulers/
gpu.py) against JAX's TpuScheduler on the `(n, 1, 1)` line of chips.

Every case of tests/test_schedulers.py that applies to a line runs, with
the same request sequence, on both packages: apply, exhaustion and
restore, reuse on patch and shrink, the fallbacks, cordon, the share
ledger, plan grants, worker-spanning grants, claim, and the reboot from
the store (through the write-behind queue, drained before the read). Each
call's grant, or its error by code, and the scheduler's serialize() after
every call must be equal. One parametrised test, so each case counts.
"""

import pytest
import torch

from gpu_docker_api_tpu import xerrors as jx
from gpu_docker_api_tpu import topology as jtopo
from gpu_docker_api_tpu.meshplan import PlanSpec as JPlan
from gpu_docker_api_tpu.schedulers.tpu import TpuScheduler
from gpu_docker_api_tpu.server.codes import ResCode
from gpu_docker_api_tpu.store import MVCCStore as JStore
from gpu_docker_api_tpu.store import StateClient as JClient
from gpu_docker_api_tpu.workqueue import WorkQueue as JQueue
from gpu_docker_api_tpu_torch import topology as ttopo
from gpu_docker_api_tpu_torch import xerrors as tx
from gpu_docker_api_tpu_torch.meshplan import PlanSpec as TPlan
from gpu_docker_api_tpu_torch.schedulers import GpuScheduler, parse_gpu_count
from gpu_docker_api_tpu_torch.server.codes import ResCode as TResCode
from gpu_docker_api_tpu_torch.store import MVCCStore as TStore
from gpu_docker_api_tpu_torch.store import StateClient as TClient
from gpu_docker_api_tpu_torch.workqueue import WorkQueue as TQueue

torch.set_num_threads(1)

#: JAX's error -> the envelope code its routes answer with (server/app.py)
JAX_CODES = [(jx.TpuOversubscribedError, ResCode.ContainerTpuOversubscribed),
             (jx.TpuNotEnoughError, ResCode.ContainerTpuNotEnough)]


class Side:
    """One package's scheduler, topology, store and plan types."""

    def __init__(self, name, tmp_path):
        self.name = name
        self.jax = name == "jax"
        self.dir = tmp_path / name
        self.dir.mkdir()
        self.trace = []

    def topology(self, n, per=None):
        per = per or n
        workers = -(-n // per)
        if self.jax:
            return jtopo.TpuTopology(f"h100-{n}", "h100", (n, 1, 1),
                                     chips_per_host=per, num_workers=workers)
        return ttopo.GpuTopology(f"h100-{n}", "h100", (n, 1, 1),
                                 chips_per_host=per, num_workers=workers)

    def client(self, wal="state.wal"):
        path = str(self.dir / wal)
        return (JClient(JStore(wal_path=path)) if self.jax
                else TClient(TStore(wal_path=path)))

    def queue(self, client):
        q = (JQueue if self.jax else TQueue)(client)
        q.start()
        return q

    def sched(self, client=None, wq=None, **kw):
        return (TpuScheduler if self.jax else GpuScheduler)(client, wq, **kw)

    def plan(self, **axes):
        return (JPlan if self.jax else TPlan)(**axes)

    def code(self, e):
        if isinstance(e, ValueError):
            return "ValueError"
        if self.jax:
            return int(next(c for cls, c in JAX_CODES if isinstance(e, cls)))
        return int(e.code)

    def call(self, s, method, *a, **kw):
        """Record one call's result (or its error's code) and the state
        right after it."""
        try:
            out = getattr(s, method)(*a, **kw)
        except (ValueError, jx.XError, tx.XError) as e:
            out = ("error", self.code(e))
        self.trace.append((method, out, s.serialize()))
        return out


# ---- the cases: each drives one Side ----------------------------------------

def exhaustion_and_restore(x):
    s = x.sched(topology=x.topology(4))
    g = x.call(s, "apply", 4)
    x.call(s, "apply", 1)
    x.call(s, "restore", g)
    x.call(s, "apply", 2)


def restore_idempotent(x):
    s = x.sched(topology=x.topology(4))
    g = x.call(s, "apply", 2)
    x.call(s, "restore", g)
    x.call(s, "restore", g)
    x.trace.append(s.get_status()["freeCount"])


def grants_disjoint_and_connected(x):
    s = x.sched(topology=x.topology(8))
    for owner in "abcd":
        g = x.call(s, "apply", 2, owner)
        x.trace.append(s.topology.is_connected(g))
    x.call(s, "apply", 1, "e")


def owner_checked_restore(x):
    s = x.sched(topology=x.topology(8))
    ga = x.call(s, "apply", 3, "a")
    x.call(s, "restore", ga, "b")          # a stale restore frees nothing
    x.call(s, "restore", ga, "a")
    x.call(s, "mark_used", ga, "a")
    x.call(s, "apply", 2, "c")
    x.call(s, "mark_used", [3, 4, 5], "d")  # c's chips are left alone


def fragmented_fallback(x):
    for frag in (False, True):
        s = x.sched(topology=x.topology(8), allow_fragmented=frag)
        for i in (2, 5):
            s.status[i] = "held"
        x.call(s, "apply", 3, "x")          # runs of 2: no box, no line
        x.call(s, "apply", 2, "y")


def connected_picks_big_component(x):
    s = x.sched(topology=x.topology(8), allow_fragmented=False)
    for i in (1, 2, 7):
        s.status[i] = "held"
    x.call(s, "apply", 3, "x")              # from {3..6}, not {0}
    x.call(s, "apply", 2, "y")


def cordon(x):
    s = x.sched(topology=x.topology(4))
    x.call(s, "cordon", [0, 1])
    x.call(s, "apply", 2)
    x.call(s, "apply", 1)
    x.call(s, "uncordon", [0])
    x.call(s, "apply", 1)
    x.call(s, "cordon", [99])


def cordoned_chip_not_reusable(x):
    s = x.sched(topology=x.topology(4))
    g = x.call(s, "apply", 2, "rs")
    x.call(s, "cordon", [g[0]])
    x.call(s, "apply", 2, "rs", reuse=g)


def patch_grant_contains_reused(x):
    s = x.sched(topology=x.topology(8))
    old = x.call(s, "apply", 1, "rs")
    x.call(s, "apply", 4, "rs", reuse=old)
    s2 = x.sched(topology=x.topology(8))
    s2.status[7] = "rs2"
    x.call(s2, "apply", 4, "rs2", reuse=[7])


def shrink_keeps_subset(x):
    s = x.sched(topology=x.topology(8))
    old = x.call(s, "apply", 4, "rs")
    x.call(s, "apply", 2, "rs", reuse=old)
    x.call(s, "restore", old, "rs")


def avoid_is_hard(x):
    s = x.sched(topology=x.topology(8))
    x.call(s, "apply", 4, "a", avoid={0, 1, 2, 3})
    x.call(s, "apply", 4, "b", avoid={4})
    x.call(s, "apply", 0, "c")


def prefers_single_worker(x):
    s = x.sched(topology=x.topology(16, per=8))
    a = x.call(s, "apply", 4, "a")
    x.trace.append(s.topology.workers_spanned(a))
    x.call(s, "apply", 8, "b")
    x.call(s, "apply", 4, "c")
    x.call(s, "restore", a, "a")
    x.call(s, "apply", 6, "d")              # spans the nodes only now


def spans_workers_when_needed(x):
    s = x.sched(topology=x.topology(16, per=8))
    g = x.call(s, "apply", 12, "big")
    x.trace.append(s.topology.workers_spanned(g))


def plan_grants(x):
    s = x.sched(topology=x.topology(8))
    x.call(s, "apply", 4, "a", plan=x.plan(tp=2, sp=2))
    x.call(s, "apply", 2, "b", plan=x.plan(dp=2))
    x.call(s, "apply", 3, "c", plan=x.plan(dp=2))       # size mismatch
    x.call(s, "apply", 1, "d", plan=x.plan())            # trivial: no plan
    x.trace.append(s.plan_feasible(x.plan(pp=2, tp=4)))
    x.trace.append(s.plan_feasible(x.plan(dp=16)))
    x.call(s, "enumerate_candidates", 1)
    x.call(s, "enumerate_candidates", 2, plan=x.plan(tp=2))


def plan_needs_a_box(x):
    s = x.sched(topology=x.topology(8))
    for i in (3, 6):
        s.status[i] = "held"
    x.call(s, "apply", 3, "g", plan=x.plan(tp=3))       # no run of 3 ...
    x.call(s, "apply", 2, "g", plan=x.plan(tp=2))       # ... a run of 2


def worker_spanning_plan(x):
    s = x.sched(topology=x.topology(16, per=8))
    x.call(s, "apply", 16, "gang", plan=x.plan(dp=2, tp=8))
    x.call(s, "restore", list(range(16)), "gang")
    x.call(s, "apply", 8, "g2", plan=x.plan(fsdp=2, tp=4))
    x.call(s, "apply", 8, "g3", plan=x.plan(pp=8))
    x.call(s, "enumerate_candidates", 4, plan=x.plan(tp=4))


def claim(x):
    s = x.sched(topology=x.topology(8))
    x.call(s, "claim", [2, 3], "a")
    x.call(s, "claim", [3, 4], "b")          # lost a chip: whole claim fails
    x.call(s, "claim", [4, 5, 6, 7], "c", plan=x.plan(tp=4))
    x.call(s, "claim", [0, 1], "d", plan=x.plan(tp=4))   # size mismatch
    x.call(s, "capacity_view")


def shares(x):
    s = x.sched(topology=x.topology(4))
    x.call(s, "apply_shares", 2, "a")
    x.call(s, "apply_shares", 1, "b")         # packs onto a's card
    x.call(s, "apply_shares", 3, "c")         # a fresh card
    x.call(s, "apply_shares", 1, "d", prefer=2)
    x.call(s, "apply_shares", 2, "e", avoid={0})
    x.call(s, "apply", 2, "w")                # share-split cards are out
    x.call(s, "apply", 1, "w2")
    x.call(s, "apply_shares", 3, "f")
    x.call(s, "apply_shares", 1, "g", avoid={0, 1, 2}, strict_avoid=True)
    x.call(s, "apply_shares", 4, "h")
    x.call(s, "capacity_view")
    x.trace.append(s.get_status()["freeShares"])
    x.call(s, "restore_shares", 0, 1, "a")
    x.call(s, "restore_shares", 0, 5, "a")
    x.call(s, "restore_shares", 0, 1, "nobody")
    x.call(s, "set_shares", 1, "c", 9)
    x.call(s, "release_owner_shares", "e")
    x.call(s, "cordon", [1])
    x.call(s, "apply_shares", 1, "i")


def reboot_from_store(x):
    c = x.client()
    s = x.sched(c, topology=x.topology(4))
    g = x.call(s, "apply", 2, "rs")
    x.call(s, "cordon", [3])
    x.call(s, "apply_shares", 1, "tiny")
    s.flush()
    s2 = x.sched(c)                            # no topology: from the store
    x.trace.append(s2.serialize())
    x.call(s2, "restore", g, "rs")
    x.call(s2, "apply", 1, "again")


def reboot_through_the_queue(x):
    """Persistence rides the write-behind queue: a restart drains it
    before reading the store back."""
    c = x.client()
    q = x.queue(c)
    s = x.sched(c, q, topology=x.topology(8, per=4))
    for owner, n in (("a", 3), ("b", 2), ("c", 1)):
        x.call(s, "apply", n, owner)
    x.call(s, "restore", [0, 1, 2], "a")
    assert q.join(timeout=30)
    q.close()
    s2 = x.sched(x.client())                   # a fresh store on the same WAL
    x.trace.append(s2.serialize())
    x.call(s2, "apply", 4, "d")


CASES = [exhaustion_and_restore, restore_idempotent,
         grants_disjoint_and_connected, owner_checked_restore,
         fragmented_fallback, connected_picks_big_component, cordon,
         cordoned_chip_not_reusable, patch_grant_contains_reused,
         shrink_keeps_subset, avoid_is_hard, prefers_single_worker,
         spans_workers_when_needed, plan_grants, plan_needs_a_box,
         worker_spanning_plan, claim, shares, reboot_from_store,
         reboot_through_the_queue]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_card_scheduler_equals_the_tpu_scheduler(case, tmp_path):
    jax_side, port_side = Side("jax", tmp_path), Side("torch", tmp_path)
    case(jax_side)
    case(port_side)
    assert len(port_side.trace) == len(jax_side.trace) > 0
    for got, want in zip(port_side.trace, jax_side.trace):
        assert got == want


def test_error_codes_are_the_jax_routes_codes():
    """The card errors carry the codes JAX's routes give the TPU ones, and
    every app code keeps its number."""
    assert tx.GpuNotEnoughError.code == ResCode.ContainerTpuNotEnough == 1013
    assert tx.GpuOversubscribedError.code == \
        ResCode.ContainerTpuOversubscribed == 1026
    assert issubclass(tx.GpuOversubscribedError, tx.GpuNotEnoughError)
    assert {m.name: int(m) for m in ResCode} == {
        name: int(m) for name, m in TResCode.__members__.items()
        if name in ResCode.__members__}
    assert TResCode.ContainerGpuNotEnough is TResCode.ContainerTpuNotEnough


def test_sentinel_errors_match_by_name_and_code():
    """Every JAX sentinel error has its port twin (the scheduler's under a
    card name), with the code the JAX routes map it to."""
    routes = {jx.CpuNotEnoughError: 1023, jx.PortNotEnoughError: 1014,
              jx.ContainerExistedError: 1008,
              jx.NoRollbackRequiredError: 1022, jx.GatewayExistedError: 1030,
              jx.GatewayShedError: 429, jx.GatewayDeadlineError: 504,
              jx.GatewayRetryBudgetError: 503,
              jx.BackendUnavailableError: 503, jx.VolumeExistedError: 1103,
              jx.VolumeSizeUsedGreaterThanReducedError: 1107,
              jx.PreconditionFailedError: 412, jx.NoPatchRequiredError: None,
              jx.NotExistInStoreError: None, jx.VersionNotFoundError: None,
              jx.BackendTimeoutError: None,
              jx.TpuNotEnoughError: 1013, jx.TpuOversubscribedError: 1026}
    for jcls, code in routes.items():
        tcls = getattr(tx, jcls.__name__.replace("Tpu", "Gpu"))
        assert tcls.code == code, jcls.__name__
        assert (tcls.sentinel == jcls.sentinel
                or jcls.sentinel.replace("tpu", "gpu") == tcls.sentinel)


@pytest.mark.parametrize("count, want", [
    (0, (0, 0)), (1, (1, 0)), (4.0, (4, 0)), (0.25, (0, 1)), (0.5, (0, 2)),
    (0.75, (0, 3)), (-1, ValueError), (1.5, ValueError), (0.3, ValueError),
])
def test_parse_gpu_count_is_parse_tpu_count(count, want):
    from gpu_docker_api_tpu.schedulers.tpu import parse_tpu_count
    if want is ValueError:
        for fn in (parse_gpu_count, parse_tpu_count):
            with pytest.raises(ValueError):
                fn(count)
        return
    assert parse_gpu_count(count) == parse_tpu_count(count) == want


def test_either_package_reboots_from_the_others_state(tmp_path):
    """The scheduler state is shared: a card scheduler boots from a
    TpuScheduler's store and the reverse, with equal state."""
    jside = Side("jax", tmp_path)
    js = jside.sched(jside.client(), topology=jside.topology(8))
    js.apply(3, "a")
    js.apply_shares(2, "b")
    js.cordon([7])
    js.flush()
    ported = GpuScheduler(TClient(TStore(wal_path=str(jside.dir / "state.wal"))))
    assert ported.serialize() == js.serialize()
    ported.apply(2, "c")
    ported.flush()
    back = TpuScheduler(JClient(JStore(wal_path=str(jside.dir / "state.wal"))))
    assert back.serialize() == ported.serialize()


def test_the_native_finder_grants_as_jax_does():
    """GpuScheduler(native_finder=True) takes JAX's _native_find_box path
    (the C++ search of native/topology_alloc.cc, each package's own build)
    on the line of 16 cards: a seeded run of grants and releases gives
    JAX's TpuScheduler's grants, errors and serialize() at every call."""
    import random

    from unittest import mock
    rng = random.Random(11)
    shape = ("h100-16", "h100", (16, 1, 1))
    js = TpuScheduler(topology=jtopo.TpuTopology(*shape, chips_per_host=16))
    ts = GpuScheduler(topology=ttopo.GpuTopology(*shape, chips_per_host=16),
                      native_finder=True)
    native = ts._native_find_box
    calls = []
    with mock.patch.object(ts, "_native_find_box",
                           side_effect=lambda *a: calls.append(a)
                           or native(*a)):
        held = {}
        for i in range(60):
            if held and rng.random() < 0.4:
                owner = rng.choice(sorted(held))
                chips = held.pop(owner)
                js.restore(chips, owner)
                ts.restore(chips, owner)
            else:
                n, owner = rng.choice([1, 2, 4, 8]), f"w{i}"
                got = []
                for sched, err in ((js, jx.TpuNotEnoughError),
                                   (ts, tx.GpuNotEnoughError)):
                    try:
                        got.append(sched.apply(n, owner))
                    except err:
                        got.append("not enough")
                assert got[1] == got[0], (i, n)
                if got[0] != "not enough":
                    held[owner] = got[0]
            assert ts.serialize() == js.serialize(), i
    assert calls, "the native search never ran"


def test_device_paths_follow_the_minor_numbers():
    """device_paths lists each card's own node; a reboot from the store
    keeps the node numbering."""
    chips = [ttopo.Chip(i, (i, 0, 0), f"/dev/nvidia{m}")
             for i, m in enumerate((3, 0))]
    topo = ttopo.GpuTopology("h100-2", "h100", (2, 1, 1), chips=chips,
                             chips_per_host=2)
    client = TClient(TStore())
    s = GpuScheduler(client, topology=topo)
    g = s.apply(1, "rs")
    assert g == [0] and s.device_paths(g) == ["/dev/nvidia3"]
    env = s.env_for(g, plan=TPlan())
    assert (env["CUDA_VISIBLE_DEVICES"], env["CUDA_DEVICE_ORDER"]) == \
        ("0", "PCI_BUS_ID")
    assert env["TDAPI_MESH_PLAN"] == TPlan().to_env()
    s.flush()
    again = GpuScheduler(client)
    assert again.device_paths([0, 1]) == ["/dev/nvidia3", "/dev/nvidia0"]
    assert again.status[0] == "rs"


def test_node_layer_instruments_are_the_jax_ones():
    """The grant, WAL-flush and store-put histograms and the span counter
    keep the JAX daemon's names, labels and buckets; a grant observes its
    latency under the card kinds."""
    from gpu_docker_api_tpu.obs import metrics as jm
    from gpu_docker_api_tpu_torch.obs import metrics as tm
    for name in ("GRANT_LATENCY", "WAL_FLUSH_LATENCY", "STORE_PUT_LATENCY",
                 "SPANS_TOTAL"):
        t, j = getattr(tm, name), getattr(jm, name)
        assert (t.name, t.labels, t.typ) == (j.name, j.labels, j.typ)
        assert getattr(t, "buckets", None) == getattr(j, "buckets", None)
    before = {k: tm.GRANT_LATENCY.snapshot(kind=k)["count"]
              for k in ("gpu", "gpu_shares")}
    s = GpuScheduler(topology=ttopo.make_topology("h100-4"))
    s.apply(2, "a")
    s.apply_shares(1, "b")
    assert {k: tm.GRANT_LATENCY.snapshot(kind=k)["count"] - before[k]
            for k in before} == {"gpu": 1, "gpu_shares": 1}
    text = tm.REGISTRY.render()
    assert 'tdapi_sched_grant_duration_ms_bucket{kind="gpu",le="0.05"}' in text
