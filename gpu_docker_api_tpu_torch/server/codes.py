"""Application error codes + messages.

Reference parity: internal/routers/code.go — HTTP status is ALWAYS 200; the
envelope's `code` carries the app-level result (200/500/403 generic,
1000-1025 container, 1100-1112 volume). Code numbers and messages match the
reference wire format so existing clients keep working; GPU-named codes are
kept as aliases of the TPU ones.

The port's copy of the JAX control plane's server/codes.py: the same codes
and messages, so a client reads either daemon's envelopes, plus the
card-named aliases of the TPU-named codes. The sentinel errors of
xerrors.py carry these codes.
"""

from __future__ import annotations

import enum


class ResCode(enum.IntEnum):
    Success = 200
    ServerBusy = 500
    Forbidden = 403
    # envelope codes that ALSO change the HTTP status (the deliberate
    # exceptions to the reference's HTTP-200-always convention, so load
    # balancers and generic clients react without parsing the envelope):
    # 503 breaker open, 412 version precondition, 429 overload shed,
    # 409 duplicate Idempotency-Key racing its still-executing original
    BackendUnavailable = 503
    PreconditionFailed = 412
    TooManyRequests = 429
    Conflict = 409

    InvalidParams = 1000
    ImageNameCannotBeEmpty = 1001
    ContainerNameCannotBeEmpty = 1002
    ContainerNameCannotContainDash = 1003
    ContainerRunFailed = 1004
    ContainerDeleteFailed = 1005
    ContainerExecuteFailed = 1006
    ContainerPatchFailed = 1007
    ContainerAlreadyExist = 1008
    ContainerNoNeedPatch = 1009
    ContainerStopFailed = 1010
    ContainerRestartFailed = 1011
    TpuCountMustBeGreaterThanOrEqualZero = 1012
    ContainerTpuNotEnough = 1013
    ContainerPortNotEnough = 1014
    ContainerCommitFailed = 1015
    ContainerGetInfoFailed = 1016
    ContainerGetHistoryFailed = 1017
    ContainerShutDownFailed = 1018
    ContainerStartUpFailed = 1019
    ContainerVersionMustBeGreaterThanOrEqualZero = 1020
    ContainerRollbackFailed = 1021
    ContainerNoNeedRollback = 1022
    ContainerCpuNotEnough = 1023
    CpuCountMustBeGreaterThanOrEqualZero = 1024
    ContainerMemorySizeNotSupported = 1025
    ContainerTpuOversubscribed = 1026
    # the same numbers under the card's name (the port's errors use these)
    GpuCountMustBeGreaterThanOrEqualZero = 1012
    ContainerGpuNotEnough = 1013
    ContainerGpuOversubscribed = 1026

    # inference gateway (1030-1039). GatewayTimeout also changes the HTTP
    # status (504): a data-plane deadline miss must be visible to load
    # balancers without envelope parsing, like 503/412/429 above.
    GatewayTimeout = 504
    GatewayExisted = 1030
    GatewayGetInfoFailed = 1031
    GatewayCreateFailed = 1032
    GatewayScaleFailed = 1033
    GatewayDeleteFailed = 1034
    GatewayRequestFailed = 1035

    # federation / fleet control plane (1036-1049): multi-daemon
    # ownership + revision watch. WatchCompacted tells an informer its
    # resume point predates the hub's retained window (forced relist);
    # FleetNotOwner carries the owning member's address so clients can
    # re-route; FleetLeaseFailed covers acquire/renew refusals.
    WatchCompacted = 1036
    FleetNotOwner = 1037
    FleetLeaseFailed = 1038

    VolumeCreateFailed = 1100
    VolumeNameCannotBeEmpty = 1101
    VolumeDeleteFailed = 1102
    VolumeExisted = 1103
    VolumeNameMustContainVersion = 1104
    VolumeSizeNoNeedPatch = 1105
    VolumeSizeNotSupported = 1106
    VolumeSizeUsedGreaterThanReduce = 1107
    VolumeNameNotContainsDash = 1108
    VolumeNameNotBeginWithForwardSlash = 1109
    VolumeGetInfoFailed = 1110
    VolumeGetHistoryFailed = 1111
    VolumePatchFailed = 1112

    @property
    def msg(self) -> str:
        return _MESSAGES.get(self, _MESSAGES[ResCode.ServerBusy])


_MESSAGES: dict[ResCode, str] = {
    ResCode.Success: "Success",
    ResCode.ServerBusy: "Server busy",
    ResCode.Forbidden: "Forbidden",
    ResCode.BackendUnavailable:
        "Substrate unavailable (circuit open) — mutations refused; "
        "retry after the interval in the Retry-After header",
    ResCode.PreconditionFailed:
        "Version precondition failed — the If-Match version is not the "
        "current version (see X-Current-Version)",
    ResCode.TooManyRequests:
        "Too many in-flight mutations — request shed; retry after the "
        "interval in the Retry-After header",
    ResCode.Conflict:
        "A request with this Idempotency-Key is still executing — retry "
        "shortly for its stored result",

    ResCode.InvalidParams: "Failed to parse body",
    ResCode.ImageNameCannotBeEmpty: "Image name cannot be empty",
    ResCode.ContainerNameCannotBeEmpty: "Container name cannot be empty",
    ResCode.ContainerNameCannotContainDash: "Container name cannot contain dash",
    ResCode.ContainerRunFailed: "Failed to start container",
    ResCode.ContainerDeleteFailed: "Failed to delete container",
    ResCode.ContainerExecuteFailed: "Failed to execute a command",
    ResCode.ContainerPatchFailed: "Failed to patch container",
    ResCode.ContainerAlreadyExist: "Container already exists",
    ResCode.ContainerNoNeedPatch: "Container doesn't need patch",
    ResCode.ContainerStopFailed: "Failed to stop container",
    ResCode.ContainerRestartFailed: "Failed to restart container",
    ResCode.TpuCountMustBeGreaterThanOrEqualZero:
        "TPU count must be greater than or equal to 0",
    ResCode.ContainerTpuNotEnough: "Not enough TPU resources",
    ResCode.ContainerPortNotEnough: "Not enough port resources",
    ResCode.ContainerCommitFailed: "Failed to commit image",
    ResCode.ContainerGetInfoFailed:
        "Failed to get container info, container not found",
    ResCode.ContainerGetHistoryFailed:
        "Failed to get container history, container not found",
    ResCode.ContainerShutDownFailed: "Failed to shut down container",
    ResCode.ContainerStartUpFailed: "Failed to start up container",
    ResCode.ContainerVersionMustBeGreaterThanOrEqualZero:
        "Container version must be greater than or equal to 0",
    ResCode.ContainerRollbackFailed: "Failed to rollback container",
    ResCode.ContainerNoNeedRollback:
        "Container doesn't need rollback, the current version is the same "
        "as the requested version",
    ResCode.ContainerCpuNotEnough: "Not enough CPU resources",
    ResCode.CpuCountMustBeGreaterThanOrEqualZero:
        "CPU count must be greater than or equal to 0",
    ResCode.ContainerMemorySizeNotSupported:
        "Memory size units are not supported, supported units: KB, MB, GB, TB",
    ResCode.ContainerTpuOversubscribed:
        "No chip has enough free share capacity for this fractional TPU "
        "request — retry after a co-tenant releases, or request fewer shares",

    ResCode.GatewayTimeout:
        "Gateway request deadline exceeded before a replica could serve "
        "it — the autoscaler is adding capacity; retry",
    ResCode.GatewayExisted: "Gateway already exists",
    ResCode.GatewayGetInfoFailed:
        "Failed to get gateway info, gateway not found",
    ResCode.GatewayCreateFailed: "Failed to create gateway",
    ResCode.GatewayScaleFailed: "Failed to scale gateway",
    ResCode.GatewayDeleteFailed: "Failed to delete gateway",
    ResCode.GatewayRequestFailed:
        "Gateway could not serve the request (no replica answered)",

    ResCode.WatchCompacted:
        "Watch revision too old — the requested fromRevision predates the "
        "retained window; relist and resume from the snapshot revision",
    ResCode.FleetNotOwner:
        "This daemon does not own the resource — retry against the owning "
        "fleet member (see data.owner)",
    ResCode.FleetLeaseFailed:
        "Fleet lease operation failed",

    ResCode.VolumeCreateFailed: "Failed to create volume",
    ResCode.VolumeNameCannotBeEmpty: "Volume name cannot be empty",
    ResCode.VolumeDeleteFailed: "Failed to delete volume",
    ResCode.VolumeExisted: "Volume already exists",
    ResCode.VolumeNameMustContainVersion:
        "Volume name must contain the version number",
    ResCode.VolumeSizeNoNeedPatch:
        "Volume doesn't need patch, as it is the same size before and after "
        "the update",
    ResCode.VolumeSizeNotSupported:
        "Volume size units are not supported, supported units: KB, MB, GB, TB",
    ResCode.VolumeSizeUsedGreaterThanReduce:
        "Failed to patch volume size, the patch size is smaller than the used size",
    ResCode.VolumeNameNotContainsDash: "Volume name cannot contain dash",
    ResCode.VolumeNameNotBeginWithForwardSlash: "Volume name must not begin with /",
    ResCode.VolumeGetInfoFailed: "Failed to get volume info",
    ResCode.VolumeGetHistoryFailed: "Failed to get volume history",
    ResCode.VolumePatchFailed: "Failed to patch volume",
}
