"""The node layer's schedulers: the card scheduler (gpu.py) over the
common contract (base.py). The CPU and port schedulers come with a later
slice of the control plane."""

from .base import Scheduler  # noqa: F401
from .gpu import SHARE_QUANTA, GpuScheduler, parse_gpu_count  # noqa: F401
