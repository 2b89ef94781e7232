"""Observability of the port's control plane: causal spans (trace.py) and
the Prometheus registry (metrics.py). Only the spans and instruments the
node layer feeds are here so far; the workload's own counters live in the
top-level metrics.py, which this package does not replace."""

from . import metrics, trace  # noqa: F401
