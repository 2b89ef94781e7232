"""The port's tail tolerance (gpu_docker_api_tpu_torch/tailtolerance.py,
and its use by the gateway, the worker router and the App) against the
JAX package's: every case of tests/test_tail_tolerance.py, run on both
packages (tests/torch_gateway_twins.py says what is recorded, how it is
compared and what is normalised): the ejection, probation, hedge and
retry-budget decisions, the replies and the counters."""

import torch

from torch_gateway_twins import twin_tests

torch.set_num_threads(1)

CASES = (
    "test_latency_digest_fold_and_cell_roundtrip",
    "test_eject_set_outlier_threshold_and_gates",
    "test_eject_cap_never_exceeded_under_all_slow_fleet",
    "test_probation_state_machine_on_injected_clock",
    "test_trickle_allow_deterministic_across_workers",
    "test_hedge_policy_delay_and_token_bucket",
    "test_retry_budget_spends_and_refills",
    "test_gateway_ejection_tick_penalizes_outlier_and_probes_readmit",
    "test_gateway_failed_replica_heals_without_scale_cycle",
    "test_gateway_hedge_first_wins_and_loser_slot_released",
    "test_gateway_hedge_bucket_empty_no_duplicate",
    "test_gateway_retry_budget_sheds_long_before_deadline",
    "test_gateway_describe_tail_block_and_kill_switches",
    "test_tail_catalog_registration",
    "test_budget_exhaustion_answers_503_with_retry_after",
    "test_worker_tier_eject_parity_with_shared_decision",
    "test_worker_tier_hedge_and_budget_counters_on_shm",
)

globals().update(twin_tests("test_tail_tolerance", CASES))
