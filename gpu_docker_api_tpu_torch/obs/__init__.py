"""Observability of the port's control plane: causal spans (trace.py),
the Prometheus registry (metrics.py) and the size-rotated writer under
traces.jsonl and events.jsonl (rotate.py). The workload's own counters
live in the top-level metrics.py, which this package does not replace."""

from . import metrics, trace  # noqa: F401
