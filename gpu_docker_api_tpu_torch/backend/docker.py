"""Docker substrate over the dockerd Unix socket — the nvidia runtime.

The port's copy of the JAX control plane's backend/docker.py. Reference
parity: internal/docker/client.go (moby client) + the HostConfig
construction in internal/services/replicaset_nomock.go:128-140: runtime
`nvidia` and CDI DeviceRequests, `{Driver: "cdi", DeviceIDs:
["nvidia.com/gpu=<UUID>"]}`, one name a granted card. The names come from
the node's topology: each granted device node (the spec's `devices`,
/dev/nvidia<minor>) is a card whose nvidia-smi UUID discovery read (its
index on the node where a mock topology has none). The stored spec stays
JAX's. The runtime injects the cards' device nodes and driver libraries,
so no device node is passed through by hand.

Inside such a container the granted cards are numbered from 0, so the
grant's CUDA_VISIBLE_DEVICES (host indices) is rewritten to the
container's own 0..n-1; NVIDIA_VISIBLE_DEVICES=void keeps an image's own
`NVIDIA_VISIBLE_DEVICES=all` (the CUDA images set it) from exposing every
card on the host through the runtime's env path. A container granted no
card runs under the default runtime and sees none.

Implemented with stdlib http.client over the UDS (no docker SDK in the
image). Exec output is demuxed from docker's 8-byte-header stream format —
the stdcopy.StdCopy equivalent (reference services/replicaset.go:225-265).
"""

from __future__ import annotations

import http.client
import json
import socket
import struct
from typing import Optional

from ..dtos import ContainerSpec
from .base import Backend, ContainerState, VolumeState

DOCKER_SOCKET = "/var/run/docker.sock"
API = "/v1.41"

#: the runtime that serves CDI device requests for NVIDIA cards
NVIDIA_RUNTIME = "nvidia"

# lxcfs /proc virtualization: when the host runs lxcfs, bind its per-cgroup
# proc files over the container's /proc so workloads see THEIR cpu/memory
# limits, not the host's (reference replicaset.go:33-40 mounts exactly this
# set). Module-level so tests (and odd hosts) can point it elsewhere.
LXCFS_DIR = "/var/lib/lxcfs"
LXCFS_PROC_FILES = ("cpuinfo", "diskstats", "meminfo", "stat", "swaps",
                    "uptime")


def container_env(spec: ContainerSpec) -> dict[str, str]:
    """The grant's env as the container sees its cards: numbered from 0 in
    CUDA_VISIBLE_DEVICES (the runtime exposes only the granted ones), and
    the runtime's own env path closed."""
    env = dict(spec.tpu_env)
    env["CUDA_VISIBLE_DEVICES"] = ",".join(
        str(i) for i in range(len(spec.devices)))
    env["NVIDIA_VISIBLE_DEVICES"] = "void"
    return env


def cdi_names(topology, devices: list[str]) -> list[str]:
    """The CDI names of the cards behind granted device nodes:
    `nvidia.com/gpu=<UUID>`, or the card's index on its node where the
    topology has no UUID (a mock)."""
    by_node = {c.device_path: c for c in topology.chips
               if topology.worker_of(c.index) == topology.worker_id}
    out = []
    for dev in devices:
        chip = by_node.get(dev)
        if chip is None:
            raise ValueError(f"{dev} is no card of this node's topology")
        out.append(f"nvidia.com/gpu={chip.uuid or topology._local(chip.index)}")
    return out


class _UnixHTTPConnection(http.client.HTTPConnection):
    def __init__(self, socket_path: str, timeout: float = 60.0):
        super().__init__("localhost", timeout=timeout)
        self._socket_path = socket_path

    def connect(self) -> None:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self._socket_path)
        self.sock = sock


class DockerError(RuntimeError):
    def __init__(self, status: int, message: str):
        self.status = status
        super().__init__(f"docker API {status}: {message}")


class DockerBackend(Backend):
    def __init__(self, state_dir: str, socket_path: str = DOCKER_SOCKET,
                 topology=None):
        self.state_dir = state_dir
        self.socket_path = socket_path
        # the node's cards (topology.GpuTopology): the CDI names of a grant
        # come from it; discovered at the first card grant when not given
        self.topology = topology
        # fail fast like the reference's 2s blocking dial (etcd/client.go:17)
        self._request("GET", "/_ping", raw=True)

    # ---- health hooks ----

    def ping(self) -> bool:
        """dockerd reachability over the Unix socket, with a short timeout
        so the health monitor's probe loop can't wedge behind a stalled
        daemon."""
        try:
            self._request("GET", "/_ping", raw=True, timeout=2.0)
            return True
        except (DockerError, OSError):
            return False

    def chip_available(self, device_path: str) -> bool:
        from .base import device_path_available
        return device_path_available(device_path)

    # ---- HTTP plumbing ----

    def _request(self, method: str, path: str, body: Optional[dict] = None,
                 raw: bool = False, timeout: float = 120.0):
        conn = _UnixHTTPConnection(self.socket_path, timeout=timeout)
        try:
            payload = None
            headers = {}
            if body is not None:
                payload = json.dumps(body)
                headers["Content-Type"] = "application/json"
            conn.request(method, (API + path) if not raw else path, payload, headers)
            resp = conn.getresponse()
            data = resp.read()
            if resp.status >= 400:
                try:
                    msg = json.loads(data).get("message", data.decode("utf-8", "replace"))
                except (json.JSONDecodeError, UnicodeDecodeError):
                    msg = data.decode("utf-8", "replace")
                raise DockerError(resp.status, msg)
            if raw or not data:
                return data
            return json.loads(data)
        finally:
            conn.close()

    # ---- container spec rendering ----

    def _host_config(self, spec: ContainerSpec) -> dict:
        import os
        binds = list(spec.binds)
        # lxcfs cgroup-aware /proc files (reference replicaset.go:33-40)
        if os.path.isdir(LXCFS_DIR):
            binds.extend(
                f"{LXCFS_DIR}/proc/{f}:/proc/{f}:rw"
                for f in LXCFS_PROC_FILES
                if os.path.exists(f"{LXCFS_DIR}/proc/{f}"))
        hc: dict = {
            "Binds": binds,
            "ShmSize": spec.shm_bytes,
            "RestartPolicy": {"Name": spec.restart_policy},
            "PortBindings": {
                f"{cport}/tcp": [{"HostPort": str(hport)}]
                for cport, hport in spec.port_bindings.items()},
            # rootfs quota (overlay2 on xfs; reference replicaset.go:67-71)
            "StorageOpt": {"size": spec.rootfs_quota} if spec.rootfs_quota else {},
        }
        if spec.devices:
            if self.topology is None:
                from ..topology import discover_topology
                self.topology = discover_topology()
            hc["Runtime"] = NVIDIA_RUNTIME
            hc["DeviceRequests"] = [{
                "Driver": "cdi",
                "DeviceIDs": cdi_names(self.topology, spec.devices)}]
        if spec.cpuset:
            hc["CpusetCpus"] = spec.cpuset
        if spec.memory_bytes:
            hc["Memory"] = spec.memory_bytes
        return hc

    # ---- containers ----

    def create(self, name: str, spec: ContainerSpec) -> str:
        env = list(spec.env) + [f"{k}={v}"
                                for k, v in container_env(spec).items()]
        if not any(e.startswith("CONTAINER_ROOT=") for e in env):
            # the quiesce ack contract addresses the writable-layer ROOT
            # ("/" from inside the container = the overlay2 UpperDir this
            # backend polls); without this an image's WORKDIR would strand
            # the ack in a subdirectory and quiesce would always time out
            env.append("CONTAINER_ROOT=/")
        body = {
            "Image": spec.image,
            "Env": env,
            "Cmd": spec.cmd or None,
            "ExposedPorts": {f"{p}/tcp": {} for p in spec.port_bindings},
            "HostConfig": self._host_config(spec),
        }
        out = self._request("POST", f"/containers/create?name={name}", body)
        return out["Id"]

    def start(self, name: str) -> None:
        self._request("POST", f"/containers/{name}/start")

    def stop(self, name: str, timeout: float = 10.0) -> None:
        self._request("POST", f"/containers/{name}/stop?t={int(timeout)}")

    def quiesce(self, name: str, timeout: float = 30.0) -> bool:
        """Checkpoint-now over the Engine API: /containers/{name}/kill with
        SIGUSR1, then wait for the workload's ack file in the overlay2
        UpperDir (the same `.quiesced` contract every substrate shares).
        A dockerd that exposes no UpperDir (remote daemon, exotic graph
        driver) can't observe the ack — report not-quiesced and let the
        caller's plain stop converge."""
        import os
        import time
        state = self.inspect(name)
        if not state.exists or not state.running or not state.upper_dir:
            return False
        ack = os.path.join(state.upper_dir, self.QUIESCE_ACK)
        try:
            os.unlink(ack)        # a stale ack must not satisfy this wait
        except OSError:
            pass
        try:
            self._request("POST", f"/containers/{name}/kill?signal=SIGUSR1")
        except DockerError:
            return False
        deadline = time.time() + max(0.0, timeout)
        while time.time() < deadline:
            if os.path.exists(ack):
                return True
            if not self.inspect(name).running:
                return False      # died on the signal: no ack is coming
            time.sleep(0.05)
        return os.path.exists(ack)

    def pause(self, name: str) -> None:
        self._request("POST", f"/containers/{name}/pause")

    def restart_inplace(self, name: str) -> None:
        self._request("POST", f"/containers/{name}/restart")

    def remove(self, name: str, force: bool = False) -> None:
        self._request("DELETE", f"/containers/{name}?force={'true' if force else 'false'}")

    def execute(self, name: str, cmd: list[str], workdir: str = "") -> tuple[int, str]:
        body: dict = {"AttachStdout": True, "AttachStderr": True, "Cmd": cmd}
        if workdir:
            body["WorkingDir"] = workdir
        exec_id = self._request("POST", f"/containers/{name}/exec", body)["Id"]
        raw = self._request("POST", f"/exec/{exec_id}/start",
                            {"Detach": False, "Tty": False}, raw=True)
        output = _demux_stream(raw)
        code = self._request("GET", f"/exec/{exec_id}/json").get("ExitCode", 0)
        return code, output

    def inspect(self, name: str) -> ContainerState:
        try:
            d = self._request("GET", f"/containers/{name}/json")
        except DockerError as e:
            if e.status == 404:
                return ContainerState(name=name, exists=False)
            raise
        state = d.get("State", {})
        graph = d.get("GraphDriver", {}).get("Data", {}) or {}
        return ContainerState(
            name=name, exists=True,
            running=bool(state.get("Running")),
            paused=bool(state.get("Paused")),
            exit_code=state.get("ExitCode"),
            spec=None,  # services keep the authoritative spec in the store
            upper_dir=graph.get("UpperDir", ""),
            pid=state.get("Pid"))

    def commit(self, name: str, new_image: str) -> str:
        repo, _, tag = new_image.partition(":")
        out = self._request("POST",
                            f"/commit?container={name}&repo={repo}&tag={tag or 'latest'}")
        return out.get("Id", "")

    def list_names(self, prefix: str = "") -> list[str]:
        out = self._request("GET", "/containers/json?all=true")
        names = []
        for c in out:
            for n in c.get("Names", []):
                n = n.lstrip("/")
                if n.startswith(prefix):
                    names.append(n)
        return sorted(names)

    # ---- volumes ----

    def volume_create(self, name: str, size_bytes: int = 0,
                      tier: str = "") -> VolumeState:
        opts = {}
        if size_bytes:
            # overlay2/XFS project quota (reference volume.go:36-38)
            opts = {"size": str(size_bytes)}
        if tier and tier != "local":
            # tiers come from the SAME --volume-tier config as the other
            # backends: a "k=v,k=v" value is local-driver opts verbatim
            # (e.g. nfs: "type=nfs,o=addr=10.0.0.5,device=:/export"); a
            # plain path is a bind root — the managed subdir is created
            # and bind-mounted as the volume
            spec = getattr(self, "volume_tiers", {}).get(tier)
            if spec is None:
                raise ValueError(
                    f"unknown volume tier {tier!r} — configure it with "
                    f"--volume-tier {tier}=PATH (or driver opts k=v,...)")
            if "=" in spec:
                opts.update(kv.split("=", 1) for kv in spec.split(","))
            else:
                import os
                device = os.path.join(spec, "tpu-volumes", name)
                os.makedirs(device, exist_ok=True)
                opts.update({"type": "none", "o": "bind", "device": device})
        out = self._request("POST", "/volumes/create",
                            {"Name": name, "DriverOpts": opts})
        return VolumeState(name=name, exists=True,
                           mountpoint=out.get("Mountpoint", ""),
                           size_limit_bytes=size_bytes, driver_opts=opts)

    # dockerd is a shared daemon: other stacks' containers/volumes live
    # beside ours, so reconcile orphan sweeps must prove ownership first
    exclusive_substrate = False

    def volume_remove(self, name: str) -> None:
        self._request("DELETE", f"/volumes/{name}")

    def volume_list(self) -> list[str]:
        out = self._request("GET", "/volumes")
        return sorted(v.get("Name", "") for v in (out.get("Volumes") or [])
                      if v.get("Name"))

    def volume_inspect(self, name: str) -> VolumeState:
        try:
            out = self._request("GET", f"/volumes/{name}")
        except DockerError as e:
            if e.status == 404:
                return VolumeState(name=name, exists=False)
            raise
        opts = out.get("Options") or {}
        from ..utils.file import dir_size
        mp = out.get("Mountpoint", "")
        used = dir_size(mp) if mp else 0
        return VolumeState(name=name, exists=True, mountpoint=mp,
                           size_limit_bytes=int(opts.get("size", 0) or 0),
                           used_bytes=used, driver_opts=opts)


def _demux_stream(raw: bytes) -> str:
    """Demux docker's multiplexed stdout/stderr stream (8-byte frame headers:
    [stream_type, 0,0,0, len_be32]) into one string — stdcopy equivalent."""
    out = []
    i = 0
    n = len(raw)
    while i + 8 <= n:
        stype = raw[i]
        # a real frame header is {0|1|2} followed by three zero bytes; anything
        # else means TTY mode (unframed) — bail to the raw decode below
        if stype not in (0, 1, 2) or raw[i + 1:i + 4] != b"\x00\x00\x00":
            return raw.decode("utf-8", "replace")
        (length,) = struct.unpack(">I", raw[i + 4:i + 8])
        frame = raw[i + 8:i + 8 + length]
        out.append(frame.decode("utf-8", "replace"))
        i += 8 + length
    if not out and raw:  # short unframed output
        return raw.decode("utf-8", "replace")
    return "".join(out)
