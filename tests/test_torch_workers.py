"""The port's SO_REUSEPORT data-plane workers
(gpu_docker_api_tpu_torch/server/workers.py over the port's own build of
native/shm_atomics.cc, _native.py) against the JAX package's: every case
of tests/test_workers.py, run on both packages
(tests/torch_gateway_twins.py says what is recorded, how it is compared
and what is normalised): the router policy over the shared segment, the
seqlock roster, and the tier of worker processes."""

import torch

from torch_app_twins import UNTIL
from torch_gateway_twins import twin_tests

torch.set_num_threads(1)

CASES = (
    "test_worker_router_slot_cap_and_least_queued",
    "test_worker_router_queue_bound_sheds",
    "test_worker_router_priority_barges",
    "test_worker_router_deadline_504",
    "test_worker_router_retries_dead_replica",
    "test_slot_reassignment_resets_counters",
    "test_seqlock_readers_never_see_torn_roster",
    "test_writer_killed_mid_publish_heals_on_republish",
    "test_tier_e2e_kernel_balanced_and_shed_codes",
    "test_tier_worker_kill_mid_request_reconciles",
    "test_tier_graceful_drain_completes_inflight",
    "test_app_wires_worker_tier_and_wakes",
)

# where a JAX case sleeps for threads to reach the router, the twin waits
# for that state (torch_app_twins.UNTIL): slots taken, requests parked
PATCHES = (
    ("    time.sleep(0.3)\n    c = state.gateway_counters(0)\n",
     "    _until(lambda: state.gateway_counters(0)[\"inflight\"][:2]\n"
     "           == [2, 2])\n"
     "    c = state.gateway_counters(0)\n"),
    ("    time.sleep(0.2)\n    c = state.gateway_counters(0)\n",
     "    _until(lambda: state.gateway_counters(0)[\"queued\"] == 1)\n"
     "    c = state.gateway_counters(0)\n"),
    ("        t.start()\n    time.sleep(0.2)\n    with pytest.raises(",
     "        t.start()\n"
     "    _until(lambda: state.gateway_counters(0)[\"queued\"] == 2)\n"
     "    with pytest.raises("),
    ("    threads[0].start()\n    time.sleep(0.1)\n",
     "    threads[0].start()\n"
     "    _until(lambda: state.gateway_counters(0)[\"inflight\"][0] == 1)\n"),
    ("        threads.append(t)\n        time.sleep(0.05)\n",
     "        threads.append(t)\n"
     "        _until(lambda: state.gateway_counters(0)[\"queued\"] == i + 1)\n"),
    ("    threads.append(t)\n    time.sleep(0.15)\n    hold.set()\n",
     "    threads.append(t)\n"
     "    _until(lambda: state.gateway_counters(0)[\"queued\"] == 4)\n"
     "    hold.set()\n"),
)
MODES = {
    "test_tier_e2e_kernel_balanced_and_shed_codes": "set",
    "test_tier_worker_kill_mid_request_reconciles": "set",
    "test_tier_graceful_drain_completes_inflight": "set",
    "test_app_wires_worker_tier_and_wakes": "set",
}

globals().update(twin_tests("test_workers", CASES, patches=PATCHES,
                            modes=MODES, extra=UNTIL))
