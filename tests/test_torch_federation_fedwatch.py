"""The fedwatch model's sweeps of tests/test_federation.py over the
port's watch hub and informer (tools/tdcheck's models bound to the port
by tests/torch_tdcheck.py), run on both packages: the sweep's statistics
(schedules, killed runs, the digest of every explored schedule) must
equal JAX's, and each seeded mutant (a duplicated and a dropped event,
the port's classes) must be caught with the same violation. The other
cases of the file are twinned in test_torch_federation.py and
test_torch_federation_lease.py."""

import torch

from torch_fleet_twins import twin_tests

torch.set_num_threads(1)

CASES = (
    "test_fedwatch_model_swept_exhaustively",
    "test_fedwatch_checker_live_on_dup_mutant",
    "test_fedwatch_checker_live_on_drop_mutant",
)

PATCHES = (
    ("from tools.tdcheck import models\n",
     "from _tdcheck_port import models\n", "torch"),
)

globals().update(twin_tests("test_federation", select=CASES,
                            patches=PATCHES, sweeps=CASES))
