"""The lease model's sweeps of tests/test_federation.py over the port's
federation (tools/tdcheck's models bound to the port by
tests/torch_tdcheck.py), run on both packages: each sweep's statistics
(schedules, killed runs, the digest of every explored schedule) must
equal JAX's, and each seeded mutant (BrokenFleetArbiter,
NoExpiryFleetArbiter: the port's classes) must be caught with the same
violation; test_fed_sweeps_deterministic sweeps both models twice. The
other cases of the file are twinned in test_torch_federation.py, the
fedwatch model's in test_torch_federation_fedwatch.py."""

import torch

from torch_fleet_twins import twin_tests

torch.set_num_threads(1)

CASES = (
    "test_lease_model_swept_exhaustively",
    "test_lease_l1_checker_live_on_mutant",
    "test_lease_l2_checker_live_on_noexpiry_mutant",
    "test_fed_sweeps_deterministic",
)

PATCHES = (
    ("from tools.tdcheck import models\n",
     "from _tdcheck_port import models\n", "torch"),
)

globals().update(twin_tests("test_federation", select=CASES,
                            patches=PATCHES, sweeps=CASES))
