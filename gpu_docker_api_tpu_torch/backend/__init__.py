"""The substrate seam (base.py) and its implementations: the in-memory
mock (mock.py), host processes (process.py, with the warm worker pool of
warmpool.py) and dockerd under the nvidia runtime (docker.py), each
wrapped by the circuit-breaking guard (guard.py)."""

from .base import Backend, ContainerState, VolumeState  # noqa: F401
from .guard import CircuitBreaker, GuardedBackend  # noqa: F401
from .mock import MockBackend  # noqa: F401
from .process import ProcessBackend  # noqa: F401


def make_backend(kind: str, state_dir: str,
                 volume_tiers: dict | None = None,
                 warm_pool: int = 0,
                 supervise: bool = False) -> Backend:
    """Runtime backend selection — the reference does this at compile time
    with Go build tags (`-tags mock` vs `-tags nvidia`, Makefile:25-47);
    a runtime seam keeps one binary and makes CI trivial. volume_tiers maps
    tier name -> storage root (process/mock) for the local-SSD/NFS
    data-disk split; the docker backend takes driver-opts templates via
    its volume_tier_opts attribute instead. warm_pool > 0 keeps that many
    pre-imported Python workers for fast workload start (process backend
    only — backend/warmpool.py)."""
    if kind == "mock":
        b = MockBackend(state_dir)
    elif kind == "process":
        b = ProcessBackend(state_dir, warm_pool=warm_pool,
                           supervise=supervise)
    elif kind == "docker":
        from .docker import DockerBackend
        b = DockerBackend(state_dir)
    else:
        raise ValueError(f"unknown backend {kind!r} (mock|process|docker)")
    b.volume_tiers = dict(volume_tiers or {})
    return b
