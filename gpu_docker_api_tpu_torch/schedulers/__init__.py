"""The node layer's schedulers: the card scheduler (gpu.py), the CPU core
scheduler (cpu.py) and the host port scheduler (port.py) over the common
contract (base.py)."""

from .base import Scheduler  # noqa: F401
from .gpu import SHARE_QUANTA, GpuScheduler, parse_gpu_count  # noqa: F401
from .cpu import CpuScheduler  # noqa: F401
from .port import PortScheduler  # noqa: F401
