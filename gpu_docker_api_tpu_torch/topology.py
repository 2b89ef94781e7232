"""NVIDIA node topology: cards, their links, their device nodes and env.

The port's counterpart of the JAX control plane's topology.py: where that
module models a TPU slice's ICI mesh, this one models an NVIDIA node. An
HGX H100 node links its 8 cards all to all through NVSwitch; the model is
stricter than that: the cards stand in a line `(n, 1, 1)` with links
between neighbours, and `chips_per_host = n`. Every grant the card
scheduler makes is then exactly the grant JAX's TpuScheduler makes on a
TpuTopology of shape `(n, 1, 1)`, which the tests hold it to.

Three numbers name one card, and they must agree:
- the index the scheduler grants: nvidia-smi's index;
- the device node `device_paths` lists: `/dev/nvidia<minor>`, with the
  minor number nvidia-smi reports (a node's minor is not promised to
  equal the index);
- the index `CUDA_VISIBLE_DEVICES` means: the granted env sets
  `CUDA_DEVICE_ORDER=PCI_BUS_ID`, the order nvidia-smi numbers cards in
  (CUDA's default is fastest-first).

Discovery raises on a host with no card node unless the caller asks for a
mock topology by type (`h100-8`): a control plane must not schedule cards
it does not have.
"""

from __future__ import annotations

import glob
import json
import os
import re
import subprocess
from dataclasses import dataclass, field
from typing import Iterator, Optional

Coord = tuple[int, int, int]

# card device nodes; module-level so tests can point them at fakes. The
# pattern needs a digit after "nvidia": nvidiactl, nvidia-uvm,
# nvidia-uvm-tools, nvidia-modeset and /dev/nvidia-caps are not cards
GPU_GLOB = "/dev/nvidia[0-9]*"
_NODE_RE = re.compile(r"nvidia(\d+)$")
NVIDIA_SMI = "nvidia-smi"

#: cards on one HGX node: the host granularity of a multi-node type
CARDS_PER_NODE = 8

#: the generation named when nvidia-smi is missing: no guess at a model
GENERIC_GENERATION = "gpu"

#: the env each grant stamps so CUDA numbers cards as nvidia-smi does
DEVICE_ORDER = "PCI_BUS_ID"

# ---- cross-generation geometry + baselines (placement.py fleet model) ----
# Fleet-level facts about each card generation, in the shape of JAX's
# table: mesh dimensionality (a line of cards: 1), host granularity
# (CARDS_PER_NODE) and coarse per-card baselines, which only seed placement
# scoring when a workload declares no profile and no fitted observation
# exists. rel_throughput is the card's dense BF16 tensor peak normalised to
# the H100 SXM's 989 TFLOP/s, from NVIDIA's data sheets (A100 Tensor Core
# GPU: 312 TFLOP/s; H100 Tensor Core GPU, SXM: 989; H200 Tensor Core GPU,
# SXM: 989), keyed as generation_of names them. rel_cost stays at the
# neutral 1.0: no public price list is carried. No TPU ratio is carried
# over.
GENERATION_SPECS: dict[str, dict] = {
    "a100": {"dims": 1, "chips_per_host": CARDS_PER_NODE,
             "rel_throughput": 312 / 989, "rel_cost": 1.0},
    "h100": {"dims": 1, "chips_per_host": CARDS_PER_NODE,
             "rel_throughput": 1.0, "rel_cost": 1.0},
    "h200": {"dims": 1, "chips_per_host": CARDS_PER_NODE,
             "rel_throughput": 1.0, "rel_cost": 1.0},
}


def generation_spec(generation: str) -> dict:
    """Cross-generation facts for `generation`; an unknown generation (the
    generic one included) falls back to the neutral H100 row rather than
    raising, so a fleet snapshot stays renderable when a daemon joined
    with a generation this build has never heard of."""
    return GENERATION_SPECS.get(generation, GENERATION_SPECS["h100"])


@dataclass(frozen=True)
class Chip:
    """One card: its scheduler index, line coordinate and device node."""
    index: int                  # nvidia-smi's index on its host
    coord: Coord                # (x, 0, 0) on the line of cards
    device_path: str            # /dev/nvidia<minor>
    uuid: str = ""              # nvidia-smi's GPU UUID, when probed
    name: str = ""              # nvidia-smi's product name, when probed

    @property
    def id(self) -> str:
        return f"gpu-{self.index}"


def default_device_path(index: int) -> str:
    return f"/dev/nvidia{index}"


@dataclass
class GpuTopology:
    """One or more NVIDIA nodes as a line of cards (see the module doc).
    The geometry is the JAX TpuTopology's, so a grant on `(n, 1, 1)` is
    the same on both; `ici_connected` and `wraparound` keep JAX's names
    (the stored state is shared), and mean the card links here."""

    accelerator_type: str
    generation: str
    shape: Coord                       # cards per axis: (n, 1, 1)
    chips: list[Chip] = field(default_factory=list)
    wraparound: bool = False
    chips_per_host: int = CARDS_PER_NODE
    worker_id: int = 0                 # node identity (multi-node)
    num_workers: int = 1
    ici_connected: bool = True

    def __post_init__(self) -> None:
        if not self.chips:
            self.chips = [
                Chip(i, c, default_device_path(self._local(i)))
                for i, c in enumerate(self._iter_coords())
            ]
        self._by_coord = {c.coord: c for c in self.chips}
        self._by_index = {c.index: c for c in self.chips}

    def _local(self, index: int) -> int:
        return index - self.worker_of(index) * self.chips_per_host

    def _iter_coords(self) -> Iterator[Coord]:
        sx, sy, sz = self.shape
        for z in range(sz):
            for y in range(sy):
                for x in range(sx):
                    yield (x, y, z)

    # ---- lookups ----

    @property
    def num_chips(self) -> int:
        return len(self.chips)

    def chip(self, index: int) -> Chip:
        return self._by_index[index]

    def neighbors(self, chip: Chip) -> list[Chip]:
        """Linked cards: ±1 along each axis (wrapping on a torus axis of
        size > 2). Empty when the topology makes no link claims."""
        if not self.ici_connected:
            return []
        out = []
        for axis in range(3):
            for d in (-1, 1):
                cc = list(chip.coord)
                cc[axis] += d
                size = self.shape[axis]
                if self.wraparound and size > 2:
                    cc[axis] %= size
                if 0 <= cc[axis] < size:
                    n = self._by_coord.get((cc[0], cc[1], cc[2]))
                    if n is not None and n.index != chip.index:
                        out.append(n)
        seen: set[int] = set()
        uniq = []
        for n in out:
            if n.index not in seen:
                seen.add(n.index)
                uniq.append(n)
        return uniq

    def is_connected(self, indices: list[int]) -> bool:
        """True when the card set is one linked component."""
        if not indices:
            return True
        want = set(indices)
        stack = [indices[0]]
        seen = {indices[0]}
        while stack:
            c = self.chip(stack.pop())
            for n in self.neighbors(c):
                if n.index in want and n.index not in seen:
                    seen.add(n.index)
                    stack.append(n.index)
        return seen == want

    def sub_boxes(self, volume: int) -> Iterator[tuple[Coord, Coord]]:
        """All axis-aligned boxes (origin, dims) of exactly `volume` cards,
        compact dims first (least surface)."""
        sx, sy, sz = self.shape
        dims: list[Coord] = []
        for a in range(1, sx + 1):
            if volume % a:
                continue
            for b in range(1, sy + 1):
                if (volume // a) % b:
                    continue
                c = volume // a // b
                if c <= sz:
                    dims.append((a, b, c))
        dims.sort(key=lambda d: (d[0] * d[1] + d[1] * d[2] + d[0] * d[2], d))
        for (a, b, c) in dims:
            for oz in range(sz - c + 1):
                for oy in range(sy - b + 1):
                    for ox in range(sx - a + 1):
                        yield ((ox, oy, oz), (a, b, c))

    def box_indices(self, origin: Coord, dims: Coord) -> list[int]:
        ox, oy, oz = origin
        a, b, c = dims
        out = []
        for z in range(oz, oz + c):
            for y in range(oy, oy + b):
                for x in range(ox, ox + a):
                    out.append(self._by_coord[(x, y, z)].index)
        return out

    # ---- worker (node) mapping ----

    def worker_of(self, index: int) -> int:
        """Node owning a card: nodes own index-contiguous runs."""
        return min(index // self.chips_per_host,
                   max(self.num_workers - 1, 0))

    def workers_spanned(self, indices: list[int]) -> list[int]:
        return sorted({self.worker_of(i) for i in indices})

    # ---- env plumbing for the scheduled workload ----

    def _visible(self, indices: list[int]) -> str:
        return ",".join(str(self._local(i)) for i in sorted(indices))

    def multihost_env(self, indices: list[int], base_port: int = 8476,
                      host_names: Optional[list[str]] = None,
                      plan: Optional[dict] = None
                      ) -> dict[int, dict[str, str]]:
        """Per-node env for a grant spanning nodes, {worker_id: env}: each
        node's local cards in CUDA_VISIBLE_DEVICES, and the worker contract
        the port's workloads read (distributed.py): TPU_WORKER_ID is the
        rank within the spanned nodes, TPU_WORKER_HOSTNAMES names them,
        TPU_PROCESS_ADDRESSES / TPU_PROCESS_PORT wire the rendezvous, and a
        plan rides as TDAPI_MESH_PLAN."""
        workers = self.workers_spanned(indices)
        hosts = host_names or [f"worker-{w}" for w in workers]
        addresses = ",".join(f"{h}:{base_port}" for h in hosts)
        envs: dict[int, dict[str, str]] = {}
        for rank, w in enumerate(workers):
            env = {
                "CUDA_VISIBLE_DEVICES": self._visible(
                    [i for i in indices if self.worker_of(i) == w]),
                "CUDA_DEVICE_ORDER": DEVICE_ORDER,
                "TPU_WORKER_ID": str(rank),
                "TPU_WORKER_HOSTNAMES": ",".join(hosts),
                "TPU_ACCELERATOR_TYPE": self.accelerator_type,
            }
            if len(workers) > 1:
                env["TPU_PROCESS_ADDRESSES"] = addresses
                env["TPU_PROCESS_PORT"] = str(base_port)
            if plan:
                env["TDAPI_MESH_PLAN"] = json.dumps(plan, sort_keys=True)
            envs[w] = env
        return envs

    def visible_chips_env(self, indices: list[int],
                          plan: Optional[dict] = None) -> dict[str, str]:
        """Env a process needs to see exactly these cards: their local
        indices in CUDA_VISIBLE_DEVICES under nvidia-smi's numbering, the
        worker contract, and with `plan` (a full {dp..sp} axis-factor dict)
        TDAPI_MESH_PLAN, the gang contract parallel/mesh.plan_from_env
        reads."""
        env = {
            "CUDA_VISIBLE_DEVICES": self._visible(indices),
            "CUDA_DEVICE_ORDER": DEVICE_ORDER,
            "TPU_WORKER_ID": str(self.worker_id),
            "TPU_WORKER_HOSTNAMES": "localhost",
            "TPU_ACCELERATOR_TYPE": self.accelerator_type,
        }
        if plan:
            env["TDAPI_MESH_PLAN"] = json.dumps(plan, sort_keys=True)
        return env

    def serialize(self) -> dict:
        """The JAX topology's keys, so either package's scheduler reboots
        from the other's stored state; `devices` is added only where a
        card's node is not /dev/nvidia<local index>, and `uuids` and
        `names` only where discovery read them (a daemon rebooting from
        its store keeps the cards' identities)."""
        out = {
            "acceleratorType": self.accelerator_type,
            "generation": self.generation,
            "shape": list(self.shape),
            "wraparound": self.wraparound,
            "workerId": self.worker_id,
            "numWorkers": self.num_workers,
            "chipsPerHost": self.chips_per_host,
            "iciConnected": self.ici_connected,
        }
        paths = [c.device_path for c in self.chips]
        if paths != [default_device_path(self._local(c.index))
                     for c in self.chips]:
            out["devices"] = paths
        for key, attr in (("uuids", "uuid"), ("names", "name")):
            values = [getattr(c, attr) for c in self.chips]
            if any(values):
                out[key] = values
        return out


def chunk_contiguous(dims: Coord, k: int) -> bool:
    """True when row-major chunks of size k (aligned at multiples of k)
    are each a linked sub-box of a box with extents `dims`."""
    a, b, c = dims
    if k <= 1 or k == a * b * c:
        return True
    if k <= a:
        return a % k == 0
    if k % a == 0:
        kk = k // a
        if kk <= b:
            return b % kk == 0
        if kk % b == 0:
            return c % (kk // b) == 0
    return False


def plan_fits_box(dims: Coord, factors: tuple) -> bool:
    """True when a box with extents `dims` can host a MeshPlan whose axis
    factors are `factors` (outermost first) with every mesh axis on
    linked sub-boxes under row-major card order: every suffix product
    (sp, tp*sp, ...) must be folded-contiguous."""
    n = 1
    for f in factors:
        n *= f
    if n != dims[0] * dims[1] * dims[2]:
        return False
    k = 1
    for f in reversed(factors):
        k *= f
        if not chunk_contiguous(dims, k):
            return False
    return True


def make_topology(accelerator_type: str, worker_id: int = 0) -> GpuTopology:
    """A mock (or stored) topology by type, `<generation>-<cards>`, e.g.
    "h100-8": a line of that many cards, CARDS_PER_NODE to a node."""
    m = re.fullmatch(r"([a-z][a-z0-9]*)-(\d+)", accelerator_type)
    if not m or int(m.group(2)) < 1:
        raise ValueError(f"unknown accelerator type {accelerator_type!r} "
                         f"(want <generation>-<cards>, e.g. h100-8)")
    gen, n = m.group(1), int(m.group(2))
    per = min(n, CARDS_PER_NODE)
    workers = (n + per - 1) // per
    return GpuTopology(accelerator_type, gen, (n, 1, 1), chips_per_host=per,
                       worker_id=worker_id, num_workers=workers)


def card_nodes() -> list[str]:
    """The host's card device nodes, by minor number."""
    nodes = [p for p in glob.glob(GPU_GLOB)
             if _NODE_RE.search(os.path.basename(p))]
    return sorted(nodes, key=lambda p: int(
        _NODE_RE.search(os.path.basename(p)).group(1)))


def generation_of(name: str) -> str:
    """"NVIDIA H100 80GB HBM3" -> "h100": the model token of nvidia-smi's
    product name, or the generic generation when it has none."""
    m = re.search(r"\b([A-Z]{1,2}\d{2,4})[A-Za-z]?\b", name)
    return m.group(1).lower() if m else GENERIC_GENERATION


def _smi(*args: str) -> str:
    return subprocess.run([NVIDIA_SMI, *args], capture_output=True,
                          text=True, timeout=60, check=True).stdout


def query_cards() -> Optional[list[dict]]:
    """nvidia-smi's cards as [{index, uuid, name, minor}] in index order —
    the reference Go's own probe (`--query-gpu=index,uuid`), plus the
    name and each card's minor number (`-q`). None when nvidia-smi is not
    installed; a failing nvidia-smi raises."""
    try:
        rows = _smi("--query-gpu=index,uuid,name", "--format=csv,noheader")
    except FileNotFoundError:
        return None
    cards = []
    for line in rows.splitlines():
        if not line.strip():
            continue
        index, uuid, name = (x.strip() for x in line.split(",", 2))
        cards.append({"index": int(index), "uuid": uuid, "name": name,
                      "minor": None})
    cards.sort(key=lambda c: c["index"])
    # `-q` lists the cards in index order, one "Minor Number" each
    minors = re.findall(r"^\s*Minor Number\s*:\s*(\S+)", _smi("-q"),
                        flags=re.M)
    if len(minors) == len(cards):
        for c, m in zip(cards, minors):
            c["minor"] = int(m) if m.isdigit() else None
    return cards


def discover_topology(mock_accelerator_type: Optional[str] = None
                      ) -> GpuTopology:
    """Probe this host's cards: the device nodes say whether there are any,
    nvidia-smi says which (index, UUID, name, minor number). Without
    nvidia-smi every node is a card of the generic generation. With no
    card node the probe raises, unless `mock_accelerator_type` asks for a
    virtual topology (make_topology)."""
    nodes = card_nodes()
    if not nodes:
        if mock_accelerator_type:
            return make_topology(mock_accelerator_type)
        raise RuntimeError(
            f"no NVIDIA card node ({GPU_GLOB}) on this host; pass a mock "
            f"accelerator type (e.g. h100-8) for a virtual topology")
    cards = query_cards()
    if cards is None:
        gen = GENERIC_GENERATION
        chips = [Chip(i, (i, 0, 0), path) for i, path in enumerate(nodes)]
    else:
        if not cards:
            raise RuntimeError("nvidia-smi lists no card on a host with "
                               f"card nodes {nodes}")
        gen = generation_of(cards[0]["name"])
        chips = [Chip(pos, (pos, 0, 0), default_device_path(
                          c["index"] if c["minor"] is None else c["minor"]),
                      c["uuid"], c["name"])
                 for pos, c in enumerate(cards)]
    n = len(chips)
    return GpuTopology(f"{gen}-{n}", gen, (n, 1, 1), chips=chips,
                       chips_per_host=n)
