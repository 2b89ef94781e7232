"""The port's inference gateway (gpu_docker_api_tpu_torch/gateway.py and
the App's gateway plane) against the JAX gateway: every case of
tests/test_gateway.py, run on both packages (tests/torch_gateway_twins.py
says what is recorded, how it is compared and what is normalised). The
slow e2e case keeps its `slow` mark."""

import torch

from torch_app_twins import UNTIL
from torch_gateway_twins import twin_tests

torch.set_num_threads(1)

CASES = (
    "test_router_least_queued_and_slot_cap",
    "test_router_queue_bound_sheds",
    "test_router_priority_class_barges_best_effort_queue",
    "test_router_deadline_sheds_504",
    "test_router_retries_failed_replica_then_serves",
    "test_config_validation",
    "test_autoscaler_scales_up_on_queue_and_down_on_idle",
    "test_fractional_multiplexing_placement",
    "test_crash_mid_scale_reconciles",
    "test_gateway_delete_crash_replay",
    "test_gateway_catalog_registration",
    "test_e2e_burst_shed_autoscale_zero_wake",
)

# where a JAX case sleeps for threads to reach the router, the twin waits
# for that state (torch_app_twins.UNTIL): slots taken, requests parked
PATCHES = (
    ("    time.sleep(0.3)\n    with gw._cond:\n",
     "    _until(lambda: gw.replicas[\"a\"].inflight\n"
     "           + gw.replicas[\"b\"].inflight == 4)\n"
     "    with gw._cond:\n"),
    ("    extra.start()\n    time.sleep(0.2)\n",
     "    extra.start()\n    _until(lambda: gw._queued == 1)\n"),
    ("        t.start()\n    time.sleep(0.2)\n    with pytest.raises(",
     "        t.start()\n    _until(lambda: gw._queued == 2)\n"
     "    with pytest.raises("),
    ("    time.sleep(0.1)                     # slot occupied\n",
     "    _until(lambda: gw.replicas[\"a\"].inflight == 1)   # slot occupied\n"),
    ("        time.sleep(0.05)                # deterministic best-effort order\n",
     "        _until(lambda: gw._queued == i + 1)   # best-effort order\n"),
    ("    threads.append(t)\n    time.sleep(0.15)\n    hold.set()\n",
     "    threads.append(t)\n    _until(lambda: gw._queued == 4)\n"
     "    hold.set()\n"),
    # the replicas' records are write-behind (the App's work queue): the
    # roster read right after create drains the queue first, as the
    # services do before a store scan (the JAX case reads at once and can
    # find no record yet, on either package)
    ('    gw = app.gateways.get("gw")\n'
     '    assert replica_names_for(app.client, "gw") == ["gwr0"]\n',
     '    gw = app.gateways.get("gw")\n'
     '    app.wq.join()\n'
     '    assert replica_names_for(app.client, "gw") == ["gwr0"]\n'),
)

MODES = {
    "test_autoscaler_scales_up_on_queue_and_down_on_idle": "codes",
    "test_e2e_burst_shed_autoscale_zero_wake": "codes",
}

globals().update(twin_tests("test_gateway", CASES, patches=PATCHES,
                            modes=MODES, extra=UNTIL))
