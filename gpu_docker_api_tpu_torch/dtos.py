"""Wire + store DTOs.

The port's copy of the JAX control plane's dtos.py. Reference parity:
internal/models/{container,volume,etcd,memory}.go — the REST request
shapes (ContainerRun, PatchRequest, RollbackRequest, ContainerExecute /
Commit, VolumeCreate / Size, history items) and the persisted per-version
records (EtcdContainerInfo / EtcdVolumeInfo). Field and stored names are
JAX's, so one client drives either daemon and either package's daemon
reads the other's records: `tpuCount` stays the field (`gpuCount` is
accepted for it), and on an NVIDIA node the `tpu_*` fields and `devices`
of ContainerSpec carry the card grant.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, Optional

from .utils.file import SIZE_UNITS  # noqa: F401  (re-exported unit list)


@dataclass
class Bind:
    src: str = ""
    dest: str = ""

    def format(self) -> str:
        if not self.src or not self.dest:
            return ""
        return f"{self.src}:{self.dest}"

    @classmethod
    def parse(cls, s: str) -> "Bind":
        src, _, dest = s.partition(":")
        return cls(src, dest)

    @classmethod
    def from_json(cls, d: Optional[dict]) -> Optional["Bind"]:
        if not d:
            return None
        return cls(d.get("src", ""), d.get("dest", ""))


def _num(v) -> float:
    """Parse a tpuCount that may be whole (2) or fractional (0.5);
    integral values stay int so whole-chip arithmetic is exact."""
    f = float(v or 0)
    return int(f) if f == int(f) else f


@dataclass
class ContainerRun:
    """POST /api/v1/replicaSet body (reference models/container.go ContainerRun)."""
    imageName: str = ""
    replicaSetName: str = ""
    tpuCount: float = 0           # whole chips, or a 0.25-multiple share < 1
    cpuCount: int = 0
    memory: str = ""              # e.g. "8GB"; units KB/MB/GB/TB
    priority: str = ""            # "" | "latency" | "best_effort" (regulator class)
    # gang parallelism plan: {dp, fsdp, pp, ep, tp, sp} axis factors whose
    # product must equal tpuCount (meshplan.PlanSpec validates). None =
    # no plan (the trivial single-chip shape) — every legacy request
    # deserializes here.
    meshPlan: Optional[dict] = None
    # per-generation throughput profile: {generation: relative steps/s}
    # (e.g. {"v4": 1.0, "v5e": 0.55}) — how THIS workload scales across
    # the fleet's chip generations. {} = unprofiled: placement falls back
    # to fitted observations, then the generation baseline
    # (topology.GENERATION_SPECS). Scores placement only; never the grant
    # mechanism.
    profile: dict = field(default_factory=dict)
    binds: list[Bind] = field(default_factory=list)
    env: list[str] = field(default_factory=list)
    cmd: list[str] = field(default_factory=list)
    containerPorts: list[str] = field(default_factory=list)

    @classmethod
    def from_json(cls, d: dict) -> "ContainerRun":
        return cls(
            imageName=d.get("imageName", ""),
            replicaSetName=d.get("replicaSetName", ""),
            # tpuCount is the native field; gpuCount accepted for drop-in clients
            tpuCount=_num(d.get("tpuCount", d.get("gpuCount", 0))),
            cpuCount=int(d.get("cpuCount", 0) or 0),
            memory=d.get("memory", "") or "",
            priority=d.get("priority", "") or "",
            meshPlan=d.get("meshPlan"),
            profile={str(k): float(v)
                     for k, v in (d.get("profile") or {}).items()},
            binds=[Bind.from_json(b) for b in d.get("binds", []) if b],
            env=list(d.get("env", []) or []),
            cmd=list(d.get("cmd", []) or []),
            containerPorts=[str(p) for p in d.get("containerPorts", []) or []],
        )


@dataclass
class TpuPatch:
    tpuCount: float = 0           # whole chips, or a 0.25-multiple share < 1
    # gang reshard: new axis factors (product == tpuCount). None = no
    # explicit plan — a count change then resets a gang set to the
    # trivial plan, an unchanged count keeps the stored one.
    meshPlan: Optional[dict] = None


@dataclass
class CpuPatch:
    cpuCount: int = 0


@dataclass
class MemoryPatch:
    memory: str = ""


@dataclass
class VolumePatch:
    oldBind: Optional[Bind] = None
    newBind: Optional[Bind] = None


@dataclass
class PatchRequest:
    """PATCH /api/v1/replicaSet/{name} body (reference PatchRequest)."""
    tpuPatch: Optional[TpuPatch] = None
    cpuPatch: Optional[CpuPatch] = None
    memoryPatch: Optional[MemoryPatch] = None
    volumePatch: Optional[VolumePatch] = None

    @classmethod
    def from_json(cls, d: dict) -> "PatchRequest":
        tp = d.get("tpuPatch") or d.get("gpuPatch")
        cp = d.get("cpuPatch")
        mp = d.get("memoryPatch")
        vp = d.get("volumePatch")
        return cls(
            tpuPatch=TpuPatch(_num(tp.get("tpuCount", tp.get("gpuCount", 0))),
                              tp.get("meshPlan")) if tp else None,
            cpuPatch=CpuPatch(int(cp.get("cpuCount", 0) or 0)) if cp else None,
            memoryPatch=MemoryPatch(mp.get("memory", "") or "") if mp else None,
            volumePatch=VolumePatch(Bind.from_json(vp.get("oldBind")),
                                    Bind.from_json(vp.get("newBind"))) if vp else None,
        )

    @property
    def empty(self) -> bool:
        return not (self.tpuPatch or self.cpuPatch or self.memoryPatch or self.volumePatch)


@dataclass
class RollbackRequest:
    version: int = 0


@dataclass
class ContainerExecute:
    workDir: str = ""
    cmd: list[str] = field(default_factory=list)


@dataclass
class ContainerCommit:
    newImageName: str = ""


@dataclass
class VolumeCreate:
    name: str = ""
    size: str = ""


@dataclass
class VolumeSize:
    size: str = ""


# ---- persisted records (reference models/etcd.go) ----

@dataclass
class ContainerSpec:
    """The substrate-facing creation spec — what the reference stores as
    docker Config+HostConfig (models/etcd.go:13-22), reshaped for a
    scheduled accelerator grant."""
    image: str = ""
    env: list[str] = field(default_factory=list)
    cmd: list[str] = field(default_factory=list)
    binds: list[str] = field(default_factory=list)          # "src:dest" strings
    cpuset: str = ""
    cpu_count: int = 0
    memory_bytes: int = 0
    shm_bytes: int = 256 * 1024 ** 3                        # reference: 256GB shm
    rootfs_quota: str = "30G"                               # reference: StorageOpt size=30G
    restart_policy: str = "unless-stopped"
    port_bindings: dict[str, int] = field(default_factory=dict)  # containerPort -> hostPort
    tpu_chips: list[int] = field(default_factory=list)
    # fractional grant: quanta (of schedulers.SHARE_QUANTA) held on the
    # single chip in tpu_chips; 0 = whole-chip grant (every pre-fractional
    # stored spec deserializes to 0, keeping old records whole)
    tpu_shares: int = 0
    # regulator class for the serving-path time-slicer: "latency" streams
    # preempt "best_effort" co-tenants at chunk boundaries ("" = default
    # best-effort)
    priority: str = ""
    # the card grant's environment (CUDA_VISIBLE_DEVICES, CUDA_DEVICE_ORDER,
    # the worker contract, TDAPI_MESH_PLAN) and its device nodes
    # (/dev/nvidia<minor>): JAX's stored field names, kept so the records
    # of either package read in the other
    tpu_env: dict[str, str] = field(default_factory=dict)
    devices: list[str] = field(default_factory=list)
    # gang parallelism plan granted to this version: full axis-factor dict
    # ({dp, fsdp, pp, ep, tp, sp}); {} = trivial/no plan (every
    # pre-gang stored spec deserializes here). The scheduler granted an
    # ICI-contiguous sub-mesh shaped for these factors, and the same dict
    # rides into the container as TDAPI_MESH_PLAN (tpu_env).
    mesh_plan: dict = field(default_factory=dict)
    # declared throughput profile carried from ContainerRun.profile —
    # persisted so a migrate/patch re-placement scores with the same
    # profile the original run declared ({} = unprofiled)
    profile: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "ContainerSpec":
        out = cls()
        for k, v in d.items():
            if hasattr(out, k):
                setattr(out, k, v)
        return out


@dataclass
class StoredContainerInfo:
    """One container version as persisted (reference EtcdContainerInfo).

    resourcesReleased records whether this replicaSet's chip/core/port grants
    have been returned to the pool (set by stop) — the reference has no such
    record, which is how its stop-twice path double-frees (SURVEY §2 bug 3).
    """
    version: int = 0
    createTime: str = ""
    containerName: str = ""       # versioned name {rs}-{version}
    spec: ContainerSpec = field(default_factory=ContainerSpec)
    resourcesReleased: bool = False

    def serialize(self) -> str:
        return json.dumps({
            "version": self.version,
            "createTime": self.createTime,
            "containerName": self.containerName,
            "spec": self.spec.to_json(),
            "resourcesReleased": self.resourcesReleased,
        }, sort_keys=True)

    @classmethod
    def deserialize(cls, s: str) -> "StoredContainerInfo":
        d = json.loads(s)
        return cls(
            version=d.get("version", 0),
            createTime=d.get("createTime", ""),
            containerName=d.get("containerName", ""),
            spec=ContainerSpec.from_json(d.get("spec", {})),
            resourcesReleased=d.get("resourcesReleased", False),
        )


@dataclass
class StoredVolumeInfo:
    """One volume version as persisted (reference EtcdVolumeInfo)."""
    version: int = 0
    createTime: str = ""
    volumeName: str = ""          # versioned name {name}-{version}
    size: str = ""                # e.g. "20GB"
    tier: str = ""                # storage tier ("" = default/local)

    def serialize(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)

    @classmethod
    def deserialize(cls, s: str) -> "StoredVolumeInfo":
        d = json.loads(s)
        out = cls()
        for k, v in d.items():
            if hasattr(out, k):
                setattr(out, k, v)
        return out


@dataclass
class HistoryItem:
    version: int
    createTime: str
    status: Any

    def to_json(self) -> dict:
        status = self.status
        if isinstance(status, (StoredContainerInfo, StoredVolumeInfo)):
            status = json.loads(status.serialize())
        return {"version": self.version, "createTime": self.createTime, "status": status}
