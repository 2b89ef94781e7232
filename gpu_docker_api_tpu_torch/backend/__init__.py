"""The substrate seam (base.py) and the process backend (process.py). The
mock and docker backends, the circuit-breaking guard and make_backend come
with a later slice of the control plane."""

from .base import Backend, ContainerState, VolumeState  # noqa: F401
from .process import ProcessBackend  # noqa: F401
