"""The port's native store engine (store/native.py over its g++ build of
native/mvcc_store.cc) and its native box finder against the JAX package's.

- Twins (tests/torch_fleet_twins.py): every case of tests/test_native.py
  and tests/test_engine_parity.py, run on both packages. The native box
  finder's case runs on a line of 16 cards in both (the port's
  GpuScheduler(native_finder=True) on its (n, 1, 1) line, JAX's
  TpuScheduler on the same shape), its cost key held to the Python
  search's.
- Across the packages: the same operations through each of the four
  engines (JAX's Python and native, the port's Python and native) write
  the same WAL bytes, and each engine reads each one's WAL to the same
  reads and revisions: the port's native engine reads JAX's Python WAL
  and JAX's Python engine the port's native one.
- The factory and the scheduler flag: open_store(engine="native") opens
  the native engine, "auto" prefers it, and GpuScheduler(native_finder=
  True) grants through the C++ search.
"""

import random

import pytest
import torch

from gpu_docker_api_tpu import store as jstore
from gpu_docker_api_tpu_torch import store as tstore
from torch_fleet_twins import twin_tests

torch.set_num_threads(1)

#: a line of 16 cards in both variants (the native core's single-worker
#: geometry; JAX's own case runs its 3-D v4-32 box)
PATCHES = tuple(
    (f'return {cls}("h100-16", "v4", (2, 2, 4), chips_per_host=16)',
     f'return {cls}("h100-16", "h100", (16, 1, 1), chips_per_host=16)', pkg)
    for cls, pkg in (("TpuTopology", "jax"), ("GpuTopology", "torch"))) + (
    ("schedulers.tpu import", "schedulers.gpu import", "torch"),)

globals().update(twin_tests("test_native", patches=PATCHES))
globals().update(twin_tests("test_engine_parity"))


# ---- across the packages ---------------------------------------------------

ENGINES = {
    "jax-python": lambda wal: jstore.open_store(wal, engine="python"),
    "jax-native": lambda wal: jstore.open_store(wal, engine="native"),
    "port-python": lambda wal: tstore.open_store(wal, engine="python"),
    "port-native": lambda wal: tstore.open_store(wal, engine="native"),
}
KEYS = [f"/x/{c}" for c in "abcdef"] + ["/y/z"]


def _ops(seed=5, n=400):
    """A seeded run of puts, batches, deletes, compactions and maintains,
    with values that stress the WAL's escaping."""
    rng = random.Random(seed)
    out = []
    for step in range(n):
        roll = rng.random()
        if roll < 0.45:
            out.append(("put", rng.choice(KEYS),
                        f'v{step} "q" \\ \n\t é中 {rng.randint(0, 9)}'))
        elif roll < 0.6:
            out.append(("put_many", [(rng.choice(KEYS), f"b{step}-{i}")
                                     for i in range(rng.randint(0, 4))]))
        elif roll < 0.8:
            out.append(("delete", rng.choice(KEYS)))
        elif roll < 0.95:
            out.append(("compact", rng.random(),
                        rng.choice([(), ("/x/",), ("/y/",)])))
        else:
            out.append(("maintain", ("/x/a",)))
    return out


def _write(engine, wal):
    s = ENGINES[engine](wal)
    answers = []
    try:
        for op in _ops():
            if op[0] == "put":
                answers.append(s.put(op[1], op[2]))
            elif op[0] == "put_many":
                answers.append(s.put_many(op[1]))
            elif op[0] == "delete":
                answers.append(s.delete(op[1]))
            elif op[0] == "compact":
                answers.append(s.compact(int(op[1] * s.revision), op[2]))
            else:
                answers.append(s.maintain(keep_history_prefixes=op[1]))
        return answers, _observable(s)
    finally:
        s.close()


def _observable(s):
    return {"rev": s.revision,
            "range": [(kv.key, kv.value, kv.create_revision,
                       kv.mod_revision, kv.version) for kv in s.range("/")],
            "hist": {k: [(kv.value, kv.mod_revision, kv.version)
                         for kv in s.history(k)] for k in KEYS}}


def test_the_four_engines_answer_and_write_the_same(tmp_path):
    """One seeded run through each engine: the same answers, reads and
    revisions from all four, and each of the port's engines writes the WAL
    bytes its JAX counterpart writes (the two engines of one package
    escape a value's characters each its own way, which either reads)."""
    got, wals = {}, {}
    for engine in ENGINES:
        wal = str(tmp_path / f"{engine}.wal")
        got[engine] = _write(engine, wal)
        with open(wal, "rb") as f:
            wals[engine] = f.read()
    for engine in ENGINES:
        assert got[engine] == got["jax-python"], engine
    assert wals["port-python"] == wals["jax-python"]
    assert wals["port-native"] == wals["jax-native"]


@pytest.mark.parametrize("writer", sorted(ENGINES))
def test_every_engine_reads_every_engines_wal(tmp_path, writer):
    wal = str(tmp_path / "w.wal")
    _, want = _write(writer, wal)
    for reader in ENGINES:
        s = ENGINES[reader](wal)
        try:
            assert _observable(s) == want, (writer, reader)
        finally:
            s.close()


def test_open_store_opens_the_native_engine(tmp_path):
    from gpu_docker_api_tpu_torch.store.native import NativeMVCCStore
    assert tstore.native_available()
    for engine in ("native", "auto"):
        s = tstore.open_store(str(tmp_path / f"{engine}.wal"), engine=engine)
        try:
            assert isinstance(s, NativeMVCCStore)
        finally:
            s.close()
    s = tstore.open_store(str(tmp_path / "py.wal"), engine="python")
    assert isinstance(s, tstore.MVCCStore)
    s.close()
    with pytest.raises(ValueError):
        tstore.open_store(str(tmp_path / "x.wal"), engine="rocks")


def test_the_native_finder_grants_what_the_python_search_grants():
    """GpuScheduler(native_finder=True) grants through the C++ search on
    a line of cards, each grant the Python search's box under random
    occupancy (on a line every box of n cards costs its length, so the
    two searches' picks are the same contiguous run)."""
    from unittest import mock

    from gpu_docker_api_tpu_torch.schedulers import GpuScheduler
    from gpu_docker_api_tpu_torch.topology import make_topology
    rng = random.Random(3)
    calls = []
    for _ in range(20):
        nat = GpuScheduler(topology=make_topology("h100-8"),
                           native_finder=True)
        py = GpuScheduler(topology=make_topology("h100-8"))
        used = rng.sample(range(8), rng.randint(0, 5))
        for i in used:
            nat.status[i] = py.status[i] = "x"
        free = {i for i, o in nat.status.items() if o is None}
        for n in (1, 2, 4):
            orig = nat._native_find_box
            with mock.patch.object(nat, "_native_find_box",
                                   side_effect=lambda *a: calls.append(a)
                                   or orig(*a)):
                got = nat._find_box(n, free)
            assert got == py._find_box(n, free), (used, n)
    assert calls, "the native search never ran"
