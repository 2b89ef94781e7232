"""Twin runs of the JAX gang, co-tenancy and lifecycle tests: one case,
both packages.

tests/test_gang.py, test_multitenancy.py, test_e2e_training.py and
test_e2e_serving.py drive the card scheduler and the ReplicaSet service
directly as often as through an App. Each case runs on the JAX variant of
its module and then on the port's (tests/torch_fleet_twins.py: its modes,
its normalisation), and each variant's JAX assertions hold. Beyond an
App's envelopes, reconcile reports and stored records, each variant
records what the case's own thread gets from:

- the card scheduler: each grant (apply, apply_shares), release
  (restore_shares), cordon, plan_feasible answer and get_status;
- the ReplicaSet service: each run, patch, rollback, stop, restart and
  drain answer, and each get_container_info.

JAX's class names read as the port's in the torch variant (TpuScheduler
is GpuScheduler), and the port's error classes as JAX's in its record.
"""

from __future__ import annotations

import torch_fleet_twins as ft

POINTS = (
    ("schedulers", "TpuScheduler.apply", "sched.apply"),
    ("schedulers", "TpuScheduler.apply_shares", "sched.apply_shares"),
    ("schedulers", "TpuScheduler.restore_shares", "sched.restore_shares"),
    ("schedulers", "TpuScheduler.cordon", "sched.cordon"),
    ("schedulers", "TpuScheduler.plan_feasible", "sched.plan_feasible"),
    ("schedulers", "TpuScheduler.get_status", "sched.status"),
    ("services", "ReplicaSetService.run_container", "svc.run"),
    ("services", "ReplicaSetService.patch_container", "svc.patch"),
    ("services", "ReplicaSetService.rollback_container", "svc.rollback"),
    ("services", "ReplicaSetService.stop_container", "svc.stop"),
    ("services", "ReplicaSetService.restart_container", "svc.restart"),
    ("services", "ReplicaSetService.drain_cordoned", "svc.drain"),
    ("services", "ReplicaSetService.get_container_info", "svc.info"),
)


def twin_tests(name, **kw) -> dict:
    """torch_fleet_twins.twin_tests over POINTS."""
    return ft.twin_tests(name, points=POINTS, **kw)

#: what a JAX variant's case hands to its torch variant (the batcher
#: case's greedy streams), taken by the torch run that follows it
STREAMS: dict = {}
