"""PyTorch port, the card topology of an NVIDIA node
(gpu_docker_api_tpu_torch/topology.py) against the JAX TpuTopology:

- the probe over a tmp dir of device nodes (the glob pointed there, as
  tests/test_topology.py does), beside nvidiactl / nvidia-uvm /
  nvidia-uvm-tools / nvidia-modeset / nvidia-caps: 1, 4 and 8 cards, their
  line and their worker mapping; nvidia-smi's index, UUID, name and minor
  number where a (fake) nvidia-smi answers;
- no card node and no mock type raises;
- the env of single-node grants (1, 4 and 8 cards) and of 2 x 8 multi-node
  grants equals JAX's on the `(n, 1, 1)` TpuTopology key by key, under the
  mapping TPU_VISIBLE_CHIPS -> CUDA_VISIBLE_DEVICES, CUDA_DEVICE_ORDER
  added, and the libtpu-only variables dropped;
- serialize() equals JAX's.
"""

import itertools
import os
import stat
import sys

import pytest
import torch

from gpu_docker_api_tpu import topology as J
from gpu_docker_api_tpu_torch import topology as T
from gpu_docker_api_tpu_torch.backend.base import device_path_available

torch.set_num_threads(1)

CONTROL_NODES = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools",
                 "nvidia-modeset")
#: what only libtpu reads: the card env drops them
LIBTPU_ONLY = ("TPU_CHIPS_PER_PROCESS_BOUNDS", "TPU_PROCESS_BOUNDS",
               "TPU_SKIP_MDS_QUERY", "CLOUD_TPU_TASK_ID")


def card_env_of(jax_env: dict) -> dict:
    """JAX's grant env under the card mapping."""
    out = {k: v for k, v in jax_env.items() if k not in LIBTPU_ONLY}
    out["CUDA_VISIBLE_DEVICES"] = out.pop("TPU_VISIBLE_CHIPS")
    out["CUDA_DEVICE_ORDER"] = "PCI_BUS_ID"
    return out


def jax_line(n, per=None, workers=1):
    return J.TpuTopology(f"h100-{n}", "h100", (n, 1, 1),
                         chips_per_host=per or n, num_workers=workers)


def _nodes(tmp_path, minors):
    """Card nodes with these minors, and every control node beside them."""
    for m in minors:
        (tmp_path / f"nvidia{m}").touch()
    for name in CONTROL_NODES:
        (tmp_path / name).touch()
    (tmp_path / "nvidia-caps").mkdir()


def _fake_smi(tmp_path, cards):
    """An nvidia-smi answering --query-gpu=index,uuid,name and -q for
    `cards` [(uuid, name, minor)]."""
    rows = "".join(f"{i}, {u}, {n}\n" for i, (u, n, _) in enumerate(cards))
    q = "".join(f"GPU 00000000:{i:02x}:00.0\n    Product Name : {n}\n"
                f"    Minor Number : {m}\n"
                for i, (_, n, m) in enumerate(cards))
    path = tmp_path / "fake-nvidia-smi"
    path.write_text(
        f"#!{sys.executable}\nimport sys\n"
        f"sys.stdout.write({q!r} if '-q' in sys.argv else {rows!r})\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def _probe(tmp_path, monkeypatch, minors, cards=None, mock=None):
    _nodes(tmp_path, minors)
    monkeypatch.setattr(T, "GPU_GLOB", str(tmp_path / "nvidia[0-9]*"))
    monkeypatch.setattr(T, "NVIDIA_SMI", _fake_smi(tmp_path, cards)
                        if cards is not None
                        else str(tmp_path / "no-nvidia-smi"))
    return T.discover_topology(mock)


@pytest.mark.parametrize("n", [1, 4, 8])
def test_probe_counts_card_nodes_only(tmp_path, monkeypatch, n):
    """Without nvidia-smi every card node is a card of the generic
    generation; the control nodes are not cards."""
    topo = _probe(tmp_path, monkeypatch, range(n))
    assert topo.num_chips == n and topo.shape == (n, 1, 1)
    assert topo.generation == "gpu" and topo.accelerator_type == f"gpu-{n}"
    assert (topo.chips_per_host, topo.num_workers) == (n, 1)
    assert [topo.worker_of(i) for i in range(n)] == [0] * n
    assert [c.device_path for c in topo.chips] == [
        str(tmp_path / f"nvidia{i}") for i in range(n)]
    assert [c.coord for c in topo.chips] == [(i, 0, 0) for i in range(n)]
    assert topo.is_connected(list(range(n)))
    if n > 1:
        # a line: the ends have one neighbour, the rest two
        assert [len(topo.neighbors(c)) for c in topo.chips] == \
            [1] + [2] * (n - 2) + [1]
    if n > 2:
        assert not topo.is_connected([0, n - 1])


@pytest.mark.parametrize("n", [1, 4, 8])
def test_probe_names_cards_from_nvidia_smi(tmp_path, monkeypatch, n):
    """nvidia-smi's index, UUID and name; each card's node from its minor
    number, which need not equal its index."""
    minors = [7 - i for i in range(n)] if n == 8 else [i + 2 for i in range(n)]
    cards = [(f"GPU-{i:08x}-0000", "NVIDIA H100 80GB HBM3", m)
             for i, m in enumerate(minors)]
    topo = _probe(tmp_path, monkeypatch, minors, cards)
    assert (topo.generation, topo.accelerator_type) == ("h100", f"h100-{n}")
    assert [c.index for c in topo.chips] == list(range(n))
    assert [c.uuid for c in topo.chips] == [u for u, _, _ in cards]
    assert [c.device_path for c in topo.chips] == [
        f"/dev/nvidia{m}" for m in minors]
    # the node numbering is carried in the stored state, nowhere else
    assert topo.serialize()["devices"] == [f"/dev/nvidia{m}" for m in minors]


def test_probe_takes_the_cards_nvidia_smi_lists(tmp_path, monkeypatch):
    """A host whose node directory holds a stale nvidia0 beside its one
    card's node (minor 5): one card, at /dev/nvidia5."""
    topo = _probe(tmp_path, monkeypatch, [0, 5],
                  [("GPU-abc", "NVIDIA H100 80GB HBM3", 5)])
    assert topo.num_chips == 1
    assert topo.chip(0).device_path == "/dev/nvidia5"


def test_probe_without_a_card_node_raises(tmp_path, monkeypatch):
    with pytest.raises(RuntimeError, match="no NVIDIA card node"):
        _probe(tmp_path, monkeypatch, [])


def test_probe_mock_type_only_without_a_card(tmp_path, monkeypatch):
    """A mock type makes a virtual topology where no card exists, and
    never hides a card that does."""
    topo = _probe(tmp_path, monkeypatch, [], mock="h100-8")
    assert topo.num_chips == 8 and topo.generation == "h100"
    assert topo.chip(7).device_path == "/dev/nvidia7"
    assert "devices" not in topo.serialize()
    sub = tmp_path / "host"
    sub.mkdir()
    topo = _probe(sub, monkeypatch, [0, 1], mock="h100-8")
    assert topo.num_chips == 2


def test_bad_mock_type_raises():
    for bad in ("warp9", "h100", "h100-0", "H100-8"):
        with pytest.raises(ValueError):
            T.make_topology(bad)


@pytest.mark.parametrize("name, gen", [
    ("NVIDIA H100 80GB HBM3", "h100"), ("NVIDIA A100-SXM4-80GB", "a100"),
    ("Tesla V100-SXM2-16GB", "v100"), ("NVIDIA H200", "h200"),
    ("NVIDIA GeForce RTX 4090", "gpu"),
])
def test_generation_of_nvidia_smi_names(name, gen):
    assert T.generation_of(name) == gen


def _grants(n):
    picks = [list(range(n)), [0], [n - 1]]
    if n >= 4:
        picks += [[0, 1], [1, 2, 3], [0, 2, 3]]
    if n >= 8:
        picks += [[4, 5, 6, 7], [0, 1, 2, 3, 6, 7]]
    return picks


@pytest.mark.parametrize("n", [1, 4, 8])
def test_single_node_env_equals_jax(n):
    topo, jtopo = T.make_topology(f"h100-{n}"), jax_line(n)
    plans = [None, {"dp": 1, "fsdp": 1, "pp": 1, "ep": 1, "tp": 1, "sp": 1}]
    for grant, plan in itertools.product(_grants(n), plans):
        got = topo.visible_chips_env(grant, plan=plan)
        assert got == card_env_of(jtopo.visible_chips_env(grant, plan=plan))
    assert topo.serialize() == jtopo.serialize()


@pytest.mark.parametrize("grant", [
    list(range(16)), list(range(4, 12)), [0, 1, 2, 8, 9], [7, 8],
    [0, 1, 2, 3], [12, 13],
])
def test_two_node_env_equals_jax(grant):
    """2 x 8 cards: per-node local indices and the worker contract."""
    topo, jtopo = T.make_topology("h100-16"), jax_line(16, per=8, workers=2)
    assert (topo.num_workers, topo.chips_per_host) == (2, 8)
    assert topo.serialize() == jtopo.serialize()
    plan = {"dp": 2, "fsdp": 1, "pp": 1, "ep": 1, "tp": 1, "sp": 1}
    for kw in ({}, {"plan": plan, "host_names": ["a", "b"],
                    "base_port": 9000}):
        got = topo.multihost_env(grant, **kw)
        want = jtopo.multihost_env(grant, **kw)
        assert sorted(got) == sorted(want)
        for w in want:
            assert got[w] == card_env_of(want[w]), (grant, w)


def test_two_node_workers():
    topo = T.make_topology("h100-16")
    assert [topo.worker_of(i) for i in range(16)] == [0] * 8 + [1] * 8
    assert [c.index for c in topo.chips if topo.worker_of(c.index) == 1] \
        == list(range(8, 16))
    assert topo.chip(9).device_path == "/dev/nvidia1"   # node-local minor
    assert topo.workers_spanned([7, 8]) == [0, 1]


def test_device_path_available(tmp_path, monkeypatch):
    """A card whose node is gone is unhealthy on a host with card nodes; a
    host with none runs a virtual topology and reports every card fine."""
    monkeypatch.setattr(T, "GPU_GLOB", str(tmp_path / "nvidia[0-9]*"))
    assert device_path_available(str(tmp_path / "nvidia3"))
    _nodes(tmp_path, [0])
    assert device_path_available(str(tmp_path / "nvidia0"))
    assert not device_path_available(str(tmp_path / "nvidia3"))
    assert os.path.exists(tmp_path / "nvidiactl")
