"""The claim model's cases of tests/test_tdcheck.py over the port's
server/workers.py and its build of the shm-atomics core, run on both
packages (tests/torch_fleet_twins.py; tools/tdcheck's models bound to the
port by tests/torch_tdcheck.py, BrokenClaimRouter the port's class): the
sweep's statistics (schedules, killed runs, the digest of every explored
schedule) must equal JAX's, and the mutant must be caught with the same
violation. The other cases of the file are twinned in
test_torch_tdcheck.py and test_torch_tdcheck_wal.py."""

import torch

from torch_fleet_twins import twin_tests

torch.set_num_threads(1)

CASES = (
    "test_claim_model_swept_exhaustively",
    "test_claim_checker_live_on_mutant",
    "test_random_mode_failure_reports_its_seed",
)

PATCHES = (
    ("from tools.tdcheck.instrument import",
     "from _tdcheck_port.instrument import", "torch"),
    ("from tools.tdcheck.models import (",
     "from _tdcheck_port.models import (", "torch"),
)

globals().update(twin_tests("test_tdcheck", select=CASES, patches=PATCHES,
                            sweeps=CASES))
