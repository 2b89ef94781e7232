"""Sentinel error hierarchy of the control plane, and its app codes.

The JAX control plane's twin (gpu_docker_api_tpu/xerrors.py) with the
scheduler's errors named for cards. Matching is isinstance(); every class
carries a stable sentinel message and, where the REST routes map it to one
envelope code, that code (`code`). The codes are the JAX daemon's
(server/codes.py, whose ResCode the port keeps number for number), so
the port's daemon answers with the same wire envelopes. An error whose
code depends on the route (a missing store key reads as container,
volume or gateway "not found") has `code = None`.
"""

from __future__ import annotations

from .server.codes import ResCode


class XError(Exception):
    """Base class for all sentinel errors of the port's control plane."""

    sentinel = "tpu-docker-api error"
    #: the envelope code the routes answer with; None = route-dependent
    code: "ResCode | None" = None

    def __init__(self, detail: str = ""):
        self.detail = detail
        super().__init__(f"{self.sentinel}: {detail}" if detail else self.sentinel)


# --- scheduler errors (reference internal/xerrors/scheduler.go) ---

class GpuNotEnoughError(XError):
    sentinel = "gpu not enough"
    code = ResCode.ContainerGpuNotEnough


class GpuOversubscribedError(GpuNotEnoughError):
    """A fractional-share request found no card with enough free quanta.
    Subclasses GpuNotEnoughError so share-unaware callers keep their
    handling; its own code (1026) tells 'the node is full' from 'no card
    has this much spare share capacity' (retryable after a co-tenant
    releases)."""

    sentinel = "gpu shares oversubscribed"
    code = ResCode.ContainerGpuOversubscribed


class CpuNotEnoughError(XError):
    sentinel = "cpu not enough"
    code = ResCode.ContainerCpuNotEnough


class PortNotEnoughError(XError):
    sentinel = "port not enough"
    code = ResCode.ContainerPortNotEnough


# --- container errors (reference internal/xerrors/container.go) ---

class ContainerExistedError(XError):
    sentinel = "container already existed"
    code = ResCode.ContainerAlreadyExist


class NoPatchRequiredError(XError):
    """Route-dependent: a container patch (1009) or a volume resize
    (1105)."""
    sentinel = "no patch required"


class NoRollbackRequiredError(XError):
    sentinel = "no rollback required"
    code = ResCode.ContainerNoNeedRollback


# --- gateway errors (inference gateway, no reference counterpart) ---

class GatewayExistedError(XError):
    sentinel = "gateway already existed"
    code = ResCode.GatewayExisted


class GatewayShedError(XError):
    """The gateway's bounded admission queue is full: refused before it
    waits (429 + Retry-After)."""

    sentinel = "gateway admission queue full"
    code = ResCode.TooManyRequests


class GatewayDeadlineError(XError):
    """A data-plane request overran its deadline before a replica could
    serve it (HTTP 504)."""

    sentinel = "gateway request deadline exceeded"
    code = ResCode.GatewayTimeout


class GatewayRetryBudgetError(XError):
    """The gateway's retry token bucket is empty: a replica failure is shed
    instead of retried (HTTP 503 + Retry-After)."""

    sentinel = "gateway retry budget exhausted"
    code = ResCode.BackendUnavailable

    def __init__(self, detail: str = "", retry_after: float = 1.0):
        super().__init__(detail)
        self.retry_after = retry_after


# --- volume errors (reference internal/xerrors/volume.go) ---

class VolumeExistedError(XError):
    sentinel = "volume already existed"
    code = ResCode.VolumeExisted


class VolumeSizeUsedGreaterThanReducedError(XError):
    sentinel = "volume used size greater than reduced size"
    code = ResCode.VolumeSizeUsedGreaterThanReduce


# --- substrate errors ---

class BackendUnavailableError(XError):
    """The guarded backend's circuit breaker is open: calls are refused
    fast (HTTP 503 + Retry-After) while reads degrade to the store."""

    sentinel = "backend unavailable (circuit open)"
    code = ResCode.BackendUnavailable

    def __init__(self, detail: str = "", retry_after: float = 5.0):
        super().__init__(detail)
        self.retry_after = retry_after


class PreconditionFailedError(XError):
    """An `If-Match: <version>` precondition did not hold (HTTP 412 with
    the current version in `X-Current-Version`)."""

    sentinel = "version precondition failed"
    code = ResCode.PreconditionFailed

    def __init__(self, detail: str = "", current: int = 0):
        super().__init__(detail)
        self.current = current

    @classmethod
    def check(cls, name: str, current: "int | None",
              if_match: "int | None") -> None:
        """Raise unless `if_match` is unset or equals the current version."""
        if if_match is not None and if_match != (current or 0):
            raise cls(f"{name}: If-Match {if_match} != current "
                      f"{current or 0}", current=current or 0)


class BackendTimeoutError(XError):
    """A backend call overran its per-op deadline. Transient: retried with
    backoff; exhausted retries surface as the op's own failure code."""

    sentinel = "backend op deadline exceeded"


# --- state-store errors (reference internal/xerrors/etcd.go) ---

class NotExistInStoreError(XError):
    """Route-dependent: container (1016/1017), volume (1110/1111) or
    gateway (1031) not found."""
    sentinel = "not exist in store"


class VersionNotFoundError(XError):
    sentinel = "version not found"


def is_gpu_not_enough(err: BaseException) -> bool:
    return isinstance(err, GpuNotEnoughError)


def is_cpu_not_enough(err: BaseException) -> bool:
    return isinstance(err, CpuNotEnoughError)


def is_port_not_enough(err: BaseException) -> bool:
    return isinstance(err, PortNotEnoughError)


def is_container_existed(err: BaseException) -> bool:
    return isinstance(err, ContainerExistedError)


def is_no_patch_required(err: BaseException) -> bool:
    return isinstance(err, NoPatchRequiredError)


def is_no_rollback_required(err: BaseException) -> bool:
    return isinstance(err, NoRollbackRequiredError)


def is_volume_existed(err: BaseException) -> bool:
    return isinstance(err, VolumeExistedError)


def is_volume_shrink_error(err: BaseException) -> bool:
    return isinstance(err, VolumeSizeUsedGreaterThanReducedError)


def is_not_exist_in_store(err: BaseException) -> bool:
    return isinstance(err, NotExistInStoreError)
