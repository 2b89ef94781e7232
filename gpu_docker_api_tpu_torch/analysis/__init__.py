"""Runtime concurrency analysis for the port's control plane.

`lockwatch` (the port's copy of the JAX package's analysis/lockwatch.py):
instrumented Lock/RLock/Condition wrappers that build the lock-order graph
while a test or a live daemon runs, and flag potential-deadlock cycles and
locks held across backend operations. Armed via TDAPI_LOCKWATCH=1.
"""
