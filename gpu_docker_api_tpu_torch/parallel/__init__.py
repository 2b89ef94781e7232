"""Parallelism plans of the port (single device for now)."""
