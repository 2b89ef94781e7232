"""The port's KV-aware routing in the gateway, the worker router and the
mock replica against the JAX package's: the gateway, worker and mock
cases of tests/test_kv_routing.py, run on both packages
(tests/torch_gateway_twins.py says what is recorded, how it is compared
and what is normalised). The mock replicas are real processes of each
package's workloads/mock_model.py."""

import torch

from torch_gateway_twins import twin_tests

torch.set_num_threads(1)

CASES = (
    "test_mock_kv_contract_sketch_export_ewma",
    "test_gateway_pick_prefers_warm_on_queue_tie_and_folds_meta",
    "test_gateway_affinity_never_overrides_shorter_queue",
    "test_gateway_affinity_env_disable",
    "test_pool_policy_validation_roles_and_scale_parity",
    "test_kv_cells_roundtrip_and_torn_read",
    "test_worker_scored_pick_prefers_warm_on_equal_queue",
    "test_worker_scored_pick_queue_depth_dominates",
    "test_worker_affinity_env_disable",
    "test_worker_folds_advertised_sketch_into_cells",
    "test_affinity_routes_from_shm_after_daemon_sigkill",
    "test_disagg_handoff_e2e",
    "test_crash_mid_handoff_releases_claims_and_leaks_no_kv",
)

MODES = {
    "test_crash_mid_handoff_releases_claims_and_leaks_no_kv": "set",
}

globals().update(twin_tests("test_kv_routing", CASES, modes=MODES))
