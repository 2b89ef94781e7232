"""Process groups: the control plane's multi-worker contract, and the
launcher of the ranks a run holds on this host.

PyTorch port of gpu_docker_api_tpu/distributed.py (its own copy; that
module is not imported). cluster_spec_from_env reads the same contract the
same way: TPU_WORKER_HOSTNAMES (rank-ordered workers), TPU_WORKER_ID (this
worker's rank), TPU_PROCESS_PORT (+ PORT_OFFSET for the coordinator) and
the JAX_COORDINATOR_ADDRESS override. maybe_initialize_from_env forms a
torch.distributed group from it: NCCL for CUDA, gloo for the CPU.

A multi-worker run (Cluster, cluster_layout): each worker holds `local`
ranks, its visible cards on cuda (torch.cuda.device_count()), or on the
CPU the run's device count over the workers. The world is workers x local
ranks, worker-major: global rank = worker x local + i, the order of JAX's
jax.devices() that its make_mesh reshapes, so the innermost mesh axes (tp,
sp) stay inside one worker. The rendezvous is tcp:// at the contract's
coordinator, which global rank 0 hosts.

launch() starts a host's ranks: every rank of a single-host run (what
`train_llama --sp N` runs), or under a cluster this worker's (run_cluster;
one local rank runs in the worker's own process). Ranks are processes
(never threads: autograd runs a device's backward on one thread, so ranks
as threads of one process would deadlock in a collective inside the
backward), forked from multiprocessing's fork server, each given its
rank, the launcher's environment and the rendezvous. A
rank that exits non-zero stops the others and fails the launch; the
signals of the control plane's drain and stop (SIGUSR1, SIGTERM, SIGINT)
are forwarded to every rank.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import signal
import socket
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

PORT_OFFSET = 1011  # coordinator = TPU_PROCESS_PORT + this
FORWARDED = (signal.SIGUSR1, signal.SIGTERM, signal.SIGINT)
GRACE_S = 10.0      # a stopped rank's time to exit before SIGKILL


def cluster_spec_from_env(env: Optional[dict] = None) -> Optional[dict]:
    """Parse the control plane's multi-worker contract out of `env`
    (default os.environ). Returns {coordinator, num_processes, process_id}
    or None when the env describes a single-process run."""
    e = os.environ if env is None else env
    hosts = [h for h in e.get("TPU_WORKER_HOSTNAMES", "").split(",") if h]
    if len(hosts) <= 1:
        return None
    try:
        rank = int(e.get("TPU_WORKER_ID", "0"))
    except ValueError as err:
        # a malformed rank on a multi-worker contract fails loudly: going
        # single-process would leave the other workers waiting for this one
        raise ValueError(
            f"multi-worker contract ({len(hosts)} hosts) with unparsable "
            f"TPU_WORKER_ID={e.get('TPU_WORKER_ID')!r}") from err
    coordinator = e.get("JAX_COORDINATOR_ADDRESS", "")
    if not coordinator:
        try:
            base_port = int(e.get("TPU_PROCESS_PORT", "8476"))
        except ValueError:
            base_port = 8476
        coordinator = f"{hosts[0]}:{base_port + PORT_OFFSET}"
    return {
        "coordinator": coordinator,
        "num_processes": len(hosts),
        "process_id": rank,
    }


def backend_for(device) -> str:
    """NCCL for CUDA ranks, gloo for CPU ranks."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_initialize_from_env(env: Optional[dict] = None,
                              device="cuda") -> Optional[dict]:
    """Form the default torch.distributed group from the control-plane
    contract when (and only when) it spans workers, with the backend for
    `device` (backend_for). Idempotent; returns the spec used, or None for
    a single-process run."""
    spec = cluster_spec_from_env(env)
    if spec is None or dist.is_initialized():
        return spec
    dist.init_process_group(
        backend_for(device), init_method=f"tcp://{spec['coordinator']}",
        world_size=spec["num_processes"], rank=spec["process_id"])
    return spec


# ---- the ranks of a multi-worker run ----------------------------------------

@dataclass(frozen=True)
class Cluster:
    """A multi-worker run as this worker sees it: the coordinator's
    host:port, the number of workers, this worker's index and the ranks
    each worker holds (local)."""
    coordinator: str
    workers: int
    worker: int
    local: int

    @property
    def world(self) -> int:
        return self.workers * self.local

    @property
    def ranks(self) -> range:
        """This worker's global ranks, worker-major."""
        return range(self.worker * self.local,
                     (self.worker + 1) * self.local)

    @property
    def init_method(self) -> str:
        return f"tcp://{self.coordinator}"

    def device(self, rank: int, device) -> torch.device:
        """The device of global rank `rank` of this worker: cuda:<local
        index> on cuda, the CPU on the CPU."""
        if torch.device(device).type != "cuda":
            return torch.device("cpu")
        return torch.device("cuda", rank - self.ranks.start)


def cluster_layout(spec: dict, device, n_devices: Optional[int] = None
                   ) -> Cluster:
    """The Cluster of a parsed contract (cluster_spec_from_env): on cuda
    each worker holds its visible cards, torch.cuda.device_count() of
    them; on the CPU, which has no device count, n_devices (the run's
    ranks) over the workers, which must divide it. Raises ValueError for
    a worker index outside the contract's hosts and a count that does not
    divide, RuntimeError on cuda without a card."""
    workers, worker = spec["num_processes"], spec["process_id"]
    if not 0 <= worker < workers:
        raise ValueError(f"TPU_WORKER_ID={worker} outside the contract's "
                         f"{workers} workers")
    if torch.device(device).type == "cuda":
        local = torch.cuda.device_count()
        if local == 0:
            raise RuntimeError("CUDA is not available: a multi-worker grant "
                               "on cuda needs this worker's cards")
    else:
        if n_devices is None or n_devices % workers:
            raise ValueError(f"{n_devices} CPU ranks do not divide over "
                             f"{workers} workers")
        local = n_devices // workers
    return Cluster(spec["coordinator"], workers, worker, local)


def run_cluster(target: Callable, args: tuple, cluster: Cluster,
                backend: str, timeout: Optional[float] = None):
    """Run target(rank, world, *args) on this worker's ranks of `cluster`
    over a `backend` group formed at the coordinator: one local rank in
    this process (target's result returned), several as launched
    processes (launch). Raises when the group does not form or a rank
    fails: nothing falls back to one host."""
    if cluster.local == 1:
        rank = cluster.ranks.start
        if backend == "nccl":
            torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=cluster.init_method,
                                world_size=cluster.world, rank=rank,
                                timeout=datetime.timedelta(minutes=10))
        try:
            return target(rank, cluster.world, *args)
        finally:
            dist.destroy_process_group()
    return launch(target, args, cluster.world, backend, cluster.init_method,
                  timeout, ranks=cluster.ranks)


# ---- the launcher ------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(target, rank, world, backend, init_method, args, local,
                env):
    """A rank: the launcher's environment `env` (the fork server's is
    the one it started with; CUDA reads its variables at its first call,
    which comes later), one intra-op thread (the ranks share the host),
    its card (the `local`-th) under NCCL, the group formed, then
    target(rank, world, *args)."""
    os.environ.clear()
    os.environ.update(env)
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(minutes=10))
    try:
        target(rank, world, *args)
    finally:
        dist.destroy_process_group()


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    deadline = time.monotonic() + GRACE_S
    for p in procs:
        if p.pid is None:           # never started
            continue
        p.join(max(0.0, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join()


def launch(target: Callable, args: tuple, world: int, backend: str,
           init_method: Optional[str] = None,
           timeout: Optional[float] = None,
           ranks: Optional[Sequence[int]] = None) -> None:
    """Run target(rank, world, *args) in rank processes over a
    `backend` group of `world` ranks (the caller picks the backend:
    backend_for, or gloo by name) and wait for them: every rank, or only
    `ranks` (this worker's of a multi-worker run; the others' workers
    start theirs), the i-th of them on card i under NCCL. The rendezvous
    is `init_method`, by default a file in a fresh temporary directory (a
    free TCP port, chosen and then bound by rank 0, can be taken in
    between by another group's connections). Returns when every rank
    exits 0; raises RuntimeError as soon as one exits otherwise,
    TimeoutError after `timeout` seconds, stopping the others in both
    cases. target and args must pickle (a module-level function). The
    ranks fork from multiprocessing's fork server, which its first launch
    starts (a fresh interpreter, never a fork of this process, so a card
    this process holds is no rank's); what the server imported before it
    forks (set_forkserver_preload, torch with CUDA left uninitialised)
    no rank imports again."""
    if init_method is None:
        with tempfile.TemporaryDirectory() as tmp:
            return launch(target, args, world, backend,
                          f"file://{os.path.join(tmp, 'rdzv')}", timeout,
                          ranks)
    ranks = list(range(world) if ranks is None else ranks)
    ctx = mp.get_context("forkserver")
    env = dict(os.environ)
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(target, rank, world, backend, init_method,
                               args, i, env))
             for i, rank in enumerate(ranks)]
    stopping: list = []

    def forward(signum, frame):
        for p in procs:
            if p.pid is not None and p.is_alive():
                os.kill(p.pid, signum)
        if signum != signal.SIGUSR1:
            stopping.append(signum)

    old = {}
    if threading.current_thread() is threading.main_thread():
        old = {s: signal.signal(s, forward) for s in FORWARDED}
    try:
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if stopping:
                _stop(procs)
                raise SystemExit(128 + stopping[0])
            codes = [p.exitcode for p in procs]
            bad = [(r, c) for r, c in zip(ranks, codes)
                   if c is not None and c != 0]
            if bad:
                _stop(procs)
                raise RuntimeError("; ".join(
                    f"rank {r} of {world} exited with code {c}"
                    for r, c in bad))
            if all(c == 0 for c in codes):
                return
            if deadline is not None and time.monotonic() > deadline:
                _stop(procs)
                raise TimeoutError(f"{len(procs)} ranks still running "
                                   f"after {timeout} s")
            time.sleep(0.05)
    finally:
        _stop(procs)
        for s, h in old.items():
            signal.signal(s, h)
