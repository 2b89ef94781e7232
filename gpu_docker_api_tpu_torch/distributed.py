"""Process groups: the control plane's multi-worker contract, and the
single-host launcher of sequence-parallel training.

PyTorch port of gpu_docker_api_tpu/distributed.py (its own copy; that
module is not imported). cluster_spec_from_env reads the same contract the
same way: TPU_WORKER_HOSTNAMES (rank-ordered workers), TPU_WORKER_ID (this
worker's rank), TPU_PROCESS_PORT (+ PORT_OFFSET for the coordinator) and
the JAX_COORDINATOR_ADDRESS override. maybe_initialize_from_env forms a
torch.distributed group from it: NCCL for CUDA, gloo for the CPU.

launch() is what `train_llama --sp N` runs on one host: N local rank
processes (spawned, never threads: autograd runs a device's backward on one
thread, so ranks as threads of one process would deadlock in a collective
inside the backward), each given its rank and a file rendezvous. A
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
from typing import Callable, Optional

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


# ---- the single-host launcher ------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(target, rank, world, backend, init_method, args):
    """A spawned rank: one intra-op thread (the ranks share the host),
    the group formed, then target(rank, world, *args)."""
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
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
           timeout: Optional[float] = None) -> None:
    """Run target(rank, world, *args) in `world` spawned processes over a
    `backend` group (the caller picks it: backend_for, or gloo by name) and
    wait for them. The rendezvous is `init_method`, by default a file in a
    fresh temporary directory (a free TCP port, chosen and then bound by
    rank 0, can be taken in between by another group's connections).
    Returns when every rank exits 0; raises RuntimeError as soon as one
    exits otherwise, TimeoutError after `timeout` seconds, stopping the
    others in both cases. target and args must pickle (a module-level
    function)."""
    if init_method is None:
        with tempfile.TemporaryDirectory() as tmp:
            return launch(target, args, world, backend,
                          f"file://{os.path.join(tmp, 'rdzv')}", timeout)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(target, rank, world, backend, init_method,
                               args))
             for rank in range(world)]
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
            bad = [(r, c) for r, c in enumerate(codes)
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
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s")
            time.sleep(0.05)
    finally:
        _stop(procs)
        for s, h in old.items():
            signal.signal(s, h)
