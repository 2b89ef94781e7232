"""PyTorch port, the co-tenancy regulator (gpu_docker_api_tpu_torch/
regulator.py, the port's own copy of gpu_docker_api_tpu/regulator.py) and
its batcher hooks:

- one register / acquire / release sequence (stride scheduling over
  virtual time, the latency class admitted first and its preemption
  counted) on a fake clock gives the port's regulator and JAX's the same
  admission order and the same describe() fields, the seconds aside;
- the preempt events set_events routes onto a daemon's event log, and
  the /metrics walk (snapshot), equal JAX's on the same scenario;
- tenant_from_env on the same envs as JAX's;
- the chunk histogram keeps JAX's name and buckets;
- a tiny _Batcher with a tenant gives the streams of one without, each
  device chunk in a slice; while a latency co-tenant waits
  (should_yield), a decode-chunk batcher takes single steps.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from gpu_docker_api_tpu import regulator as jreg
from gpu_docker_api_tpu.events import EventLog as JEvents
from gpu_docker_api_tpu.models import llama as jllama
from gpu_docker_api_tpu.obs import metrics as jmetrics
from gpu_docker_api_tpu_torch import convert
from gpu_docker_api_tpu_torch import metrics as tmetrics
from gpu_docker_api_tpu_torch import regulator as treg
from gpu_docker_api_tpu_torch.events import EventLog as TEvents
from gpu_docker_api_tpu_torch.models import llama as tllama
from gpu_docker_api_tpu_torch.workloads import serve as tserve

torch.set_num_threads(1)

SECONDS = ("busySeconds", "waitSeconds")


def _wait(cond, what, timeout=30.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, what
        time.sleep(0.001)


def _scenario(mod, clock):
    """On chip 7 of `mod`'s registry: a (weight 1) runs two solo chunks and
    b (weight 3) one, each 1 s of the clock; c (weight 2) and l (latency)
    join; a gate tenant takes the chip, then a, b, c and l queue behind it
    one by one (l's arrival preempts the gate) and are admitted one chunk
    at a time. -> (admission order, describe())."""
    mod.reset()
    reg = mod.for_chip(7)
    gate = reg.register("gate", 1)
    a, b = reg.register("a", 1), reg.register("b", 3)
    for t in (a, b, a):
        t.acquire()
        clock[0] += 1.0
        t.release(tokens=4)
    c = reg.register("c", 2)
    lat = reg.register("l", 1, priority=mod.LATENCY)
    gate.acquire()
    order, go = [], {t.name: threading.Event() for t in (a, b, c, lat)}

    def run(t):
        t.acquire()
        order.append(t.name)
        go[t.name].wait(30)
        clock[0] += 0.5
        t.release(tokens=2)

    threads = []
    for t in (a, b, c, lat):
        threads.append(threading.Thread(target=run, args=(t,)))
        threads[-1].start()
        _wait(lambda: t.waiting, f"{t.name} never waited")
    yielded = gate.should_yield()
    clock[0] += 0.25
    gate.release()
    for k in range(4):
        _wait(lambda: len(order) == k + 1, f"admission {k + 1}")
        go[order[-1]].set()
    for t in threads:
        t.join(30)
    gate.unregister()
    return order, yielded, reg.describe()


def _strip(d):
    d = {k: v for k, v in d.items() if k not in SECONDS}
    d["tenants"] = [{k: v for k, v in t.items() if k not in SECONDS}
                    for t in d["tenants"]]
    return d


def test_admission_order_and_describe_equal_the_jax_regulators(monkeypatch):
    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    got = _scenario(treg, clock)
    clock[0] = 100.0
    want = _scenario(jreg, clock)
    assert got[0] == want[0] == ["l", "b", "c", "a"]
    assert got[1] and want[1]            # the gate was asked to yield
    assert _strip(got[2]) == _strip(want[2])
    assert got[2]["preemptTotal"] == 1   # l preempted the best-effort gate
    assert got[2]["chunksTotal"] == 8    # 3 solo, the gate, 4 queued
    assert [t["busySeconds"] for t in got[2]["tenants"]] == [
        t["busySeconds"] for t in want[2]["tenants"]]


def _preempt_events(mod, events_cls, clock):
    """_scenario with the registry's events routed to an EventLog (set
    before a regulator exists, and onto one that already does) ->
    (event rows without their clock and sequence, snapshot())."""
    mod.reset()
    early = mod.for_chip(3)
    log = events_cls()
    mod.set_events(log)
    try:
        assert early.events is log
        order, _, _ = _scenario(mod, clock)
        with early.register("x", 1).slice():
            pass
        rows = [{k: v for k, v in e.items() if k not in ("ts", "seq")}
                for e in log.recent()]
        return order, rows, mod.snapshot()
    finally:
        mod.set_events(None)
        log.close()


def test_preempt_events_and_snapshot_equal_the_jax_regulators(monkeypatch):
    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    got = _preempt_events(treg, TEvents, clock)
    clock[0] = 100.0
    want = _preempt_events(jreg, JEvents, clock)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert [(e["op"], e["target"], e["tenant"], e["holder"])
            for e in got[1]] == [("regulator.preempt", "chip7", "l", "gate")]
    assert [_strip(r) for r in got[2]] == [_strip(r) for r in want[2]]
    assert [r["chip"] for r in got[2]] == [7]
    treg.reset()
    assert treg.for_chip(1).events is None    # unset again


def test_latency_preemption_is_counted_once_per_held_chunk():
    treg.reset()
    reg = treg.for_chip(0)
    be = reg.register("be", 3)
    lat = reg.register("lat", 1, priority=treg.LATENCY)
    be.acquire()
    assert not be.should_yield()
    t = threading.Thread(target=lambda: (lat.acquire(), lat.release()))
    t.start()
    _wait(lambda: lat.waiting, "the latency tenant never waited")
    assert be.should_yield() and not lat.should_yield()
    assert (be.preempted, reg.preempt_total) == (1, 1)
    be.release()
    t.join(10)
    d = reg.describe()
    assert d["preemptTotal"] == 1 and d["queueDepth"] == 0
    assert [x["preempted"] for x in d["tenants"]] == [1, 0]


@pytest.mark.parametrize("env", [
    {},
    {"TDAPI_TPU_SHARES": "3"},
    {"TDAPI_PRIORITY": "latency", "TPU_VISIBLE_CHIPS": "2,3"},
    {"TDAPI_TPU_SHARES": "x", "TPU_VISIBLE_CHIPS": "1"},
    {"TDAPI_TPU_SHARES": "0", "TDAPI_PRIORITY": "best_effort"},
    {"TDAPI_TPU_SHARES": "2", "TPU_VISIBLE_CHIPS": "a",
     "CONTAINER_VERSION": "4"},
    {"TDAPI_PRIORITY": "weird"},
])
def test_tenant_from_env_equals_the_jax_one(monkeypatch, env):
    for k in ("TDAPI_TPU_SHARES", "TDAPI_PRIORITY", "TPU_VISIBLE_CHIPS",
              "CUDA_VISIBLE_DEVICES", "CONTAINER_VERSION"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    treg.reset()
    jreg.reset()
    got, want = treg.tenant_from_env(), jreg.tenant_from_env()
    if want is None:
        assert got is None
        return
    assert (got.name, got.weight, got.priority, got.reg.chip) == (
        want.name, want.weight, want.priority, want.reg.chip)


@pytest.mark.parametrize("env, chip", [
    # the card scheduler's grant: the first CUDA_VISIBLE_DEVICES entry
    ({"CUDA_VISIBLE_DEVICES": "3,4"}, 3),
    # it wins over a TPU_VISIBLE_CHIPS the env also carries
    ({"CUDA_VISIBLE_DEVICES": "1", "TPU_VISIBLE_CHIPS": "6"}, 1),
    # absent: the JAX daemon's grant keys the chip, as before
    ({"TPU_VISIBLE_CHIPS": "6,7"}, 6),
    # a UUID entry is no index: chip -1, as an unparsable value is
    ({"CUDA_VISIBLE_DEVICES": "GPU-46fc04bf-19d5-a7c9-023d-1411cd925509"}, -1),
    # present but empty (a container granted no card): chip -1
    ({"CUDA_VISIBLE_DEVICES": "", "TPU_VISIBLE_CHIPS": "2"}, -1),
])
def test_tenant_chip_comes_from_the_card_grant(monkeypatch, env, chip):
    for k in ("TPU_VISIBLE_CHIPS", "CUDA_VISIBLE_DEVICES",
              "CONTAINER_VERSION", "TDAPI_PRIORITY"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TDAPI_TPU_SHARES", "2")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    treg.reset()
    tenant = treg.tenant_from_env()
    assert (tenant.reg.chip, tenant.weight) == (chip, 2)
    assert treg.for_chip(chip) is tenant.reg


def test_queue_depth_timeout_and_default_name_are_the_jax_regulators(
        monkeypatch):
    """queue_depth() counts the waiters, acquire(timeout) leaves the
    contention set and answers False when the holder keeps the chip past
    it, and tenant_from_env(default_name) labels the tenant by it: on
    both regulators, the same answers (JAX's test_multitenancy reads
    queue_depth; the port lacked all three until its twin found it)."""
    monkeypatch.setenv("TDAPI_TPU_SHARES", "2")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("TPU_VISIBLE_CHIPS", "0")
    got = {}
    for name, mod in (("jax", jreg), ("torch", treg)):
        mod.reset()
        reg = mod.ChipRegulator(0)
        holder, other = reg.register("h"), reg.register("o")
        holder.acquire()
        depth_idle = reg.queue_depth()
        waiting = threading.Thread(target=other.acquire)
        waiting.start()
        _wait(lambda: reg.queue_depth() == 1, f"{name}: o never queued")
        late = reg.register("late")
        timed_out = late.acquire(timeout=0.01)
        depth_after = reg.queue_depth()
        holder.release()
        waiting.join(30)
        other.release()
        got[name] = (depth_idle, timed_out, depth_after,
                     late.acquire(timeout=5.0), reg.queue_depth(),
                     mod.tenant_from_env("named").name)
        mod.reset()
    assert got["torch"] == got["jax"] == (0, False, 1, True, 0, "named")


def test_chunk_histogram_is_the_jax_one():
    t, j = tmetrics.REGULATOR_CHUNK, jmetrics.REGULATOR_CHUNK
    assert (t.name, t.help, t.buckets) == (j.name, j.help, j.buckets)
    treg.reset()
    t.reset()
    tenant = treg.for_chip(5).register("x", 1)
    with tenant.slice(tokens=1):
        pass
    snap = t.snapshot()
    assert snap["count"] == 1 and sum(snap["buckets"]) == 1


# ---- the batcher's hooks ----------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    tree = jax.tree.map(np.asarray, jllama.init_params(jcfg,
                                                       jax.random.key(0)))
    return tcfg, convert.params_from_numpy(tree, tcfg)


def _prompts():
    rng = np.random.default_rng(71)
    return [torch.from_numpy(rng.integers(0, 256, n)).long()
            for n in (5, 9, 7, 12)]


def _streams(b, prompts, max_new=6):
    ex = ThreadPoolExecutor(len(prompts))
    try:
        futs = [ex.submit(b.submit, p, max_new) for p in prompts]
        return [f.result(timeout=120) for f in futs]
    finally:
        b.close()
        ex.shutdown(wait=True)


@pytest.mark.parametrize("kw", [dict(), dict(decode_chunk=4),
                                dict(kv_block=8, prefill_chunk=4)])
def test_batcher_with_a_tenant_streams_as_without(tiny, kw):
    """Each device chunk runs in the tenant's slice (chunks and tokens
    counted), and the streams are the ones without a regulator."""
    cfg, params = tiny
    want = _streams(tserve._Batcher(cfg, params, slots=2, max_len=48, **kw),
                    _prompts())
    treg.reset()
    tenant = treg.for_chip(0).register("t", 2)
    got = _streams(tserve._Batcher(cfg, params, slots=2, max_len=48,
                                   regulator=tenant, **kw), _prompts())
    assert got == want
    d = treg.for_chip(0).describe()
    assert d["chunksTotal"] > 0
    # every emitted token but each stream's first (from its prefill) was
    # counted by a decode slice (a decode chunk counts its whole width)
    assert d["tenants"][0]["tokens"] >= sum(len(s) - 1 for s in got)


@pytest.mark.parametrize("contended", [False, True])
def test_should_yield_forces_single_step_chunks(tiny, contended):
    """decode_chunk 4: with nothing waiting the batcher decodes in chunks;
    while a latency co-tenant waits (should_yield) it takes single steps
    only."""
    cfg, params = tiny
    treg.reset()
    tenant = treg.for_chip(0).register("be", 3)
    if contended:
        tenant.should_yield = lambda: True
    b = tserve._Batcher(cfg, params, slots=2, max_len=48, decode_chunk=4,
                        regulator=tenant)
    calls, fn = [], b._fn

    def counting(name):
        calls.append(name)
        return fn(name)
    b._fn = counting
    out = b.submit(_prompts()[0], 9)
    b.close()
    assert len(out) == 9
    assert ("slot_decode_multi" in calls) is not contended
    assert calls.count("slot_decode") == (8 if contended else 0)
