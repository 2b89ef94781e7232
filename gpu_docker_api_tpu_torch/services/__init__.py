"""The control plane's services: the ReplicaSet service (versioned
containers, the rolling replace, drains and migrations) and the Volume
service, over the backend seam, the schedulers and the MVCC store."""

from .replicaset import ReplicaSetService  # noqa: F401
from .volume import VolumeService  # noqa: F401
