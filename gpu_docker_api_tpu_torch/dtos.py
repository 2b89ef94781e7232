"""The substrate-facing container spec (reference internal/models/etcd.go).

The port's copy of ContainerSpec from the JAX control plane's dtos.py:
the stored field names are the same, so either package's daemon reads
the other's records. On an NVIDIA node the `tpu_*` fields and `devices`
carry the card grant. The REST request shapes and the persisted
per-version records come with the services slice.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field


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
