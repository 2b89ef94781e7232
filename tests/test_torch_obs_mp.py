"""The port's worker-tier observability (obs/shm_metrics.py, obs/spool.py,
TraceCollector.ingest_row and the App's /metrics over both tiers) against
the JAX package's: every case of tests/test_obs_mp.py, run on both
packages (tests/torch_gateway_twins.py says what is recorded, how it is
compared and what is normalised)."""

import torch

from torch_app_twins import UNTIL
from torch_gateway_twins import twin_tests

torch.set_num_threads(1)

CASES = (
    "test_shard_aggregation_matches_python_histogram",
    "test_histogram_extern_merges_shard_cells",
    "test_counter_parity_families_present_without_workers",
    "test_scrape_during_reset_never_torn",
    "test_ring_roundtrip_truncation_and_torn_slot",
    "test_flight_recorder_ring_sink_and_flush",
    "test_span_spool_merges_into_collector",
    "test_sigkill_mid_request_yields_postmortem",
    "test_respawn_preserves_cumulative_counters",
    "test_e2e_trace_daemon_worker_replica",
    "test_metric_family_parity_and_truthful_latency",
)

# the twin waits until the worker's spans merged into the daemon before
# it reads the trace, where the JAX case polls the route (a poll's miss is
# itself a trace, which would make the two records differ by timing)
PATCHES = (
    ("    assert out.get(\"code\") == 200, out\n    t = None\n",
     "    assert out.get(\"code\") == 200, out\n"
     "    _until(lambda: len((app.traces.get(tid) or {\"spans\": ()})\n"
     "                       [\"spans\"]) >= 3)\n"
     "    t = None\n"),
)
MODES = {
    "test_sigkill_mid_request_yields_postmortem": "set",
    "test_respawn_preserves_cumulative_counters": "set",
    "test_e2e_trace_daemon_worker_replica": "set",
    "test_metric_family_parity_and_truthful_latency": "set",
}

globals().update(twin_tests("test_obs_mp", CASES, patches=PATCHES,
                            modes=MODES, extra=UNTIL))
