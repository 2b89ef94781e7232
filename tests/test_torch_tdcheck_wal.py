"""The WAL model's cases of tests/test_tdcheck.py over the port's store,
run on both packages (tests/torch_fleet_twins.py): tools/tdcheck's
models and instrument bound to the port by tests/torch_tdcheck.py, the
real-core kill sweep over the port's native store, and the seeded mutant
BrokenWalTwin the port's class. Each sweep's statistics (schedules,
killed runs, the digest of every explored schedule) must equal JAX's,
and each mutant must be caught with the same violation. The other cases
of the file are twinned in test_torch_tdcheck.py and
test_torch_tdcheck_claim.py."""

import torch

from torch_fleet_twins import twin_tests

torch.set_num_threads(1)

CASES = (
    "test_wal_model_swept_exhaustively",
    "test_wal_checker_live_on_mutant",
    "test_failure_schedule_replays_identical_violation",
    "test_wal_twin_invariant_on_real_core_kill_sweep",
)

PATCHES = (
    ("from tools.tdcheck.instrument import",
     "from _tdcheck_port.instrument import", "torch"),
    ("from tools.tdcheck.models import (",
     "from _tdcheck_port.models import (", "torch"),
)

globals().update(twin_tests("test_tdcheck", select=CASES, patches=PATCHES,
                            sweeps=CASES))
