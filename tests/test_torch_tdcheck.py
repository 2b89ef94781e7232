"""The tdcheck model sweeps over the port's modules: the seqlock model's
cases of tests/test_tdcheck.py and the sweeps' determinism, run on both
packages (tests/torch_fleet_twins.py). In the torch variant
tools/tdcheck's models and instrument are the copies tests/torch_tdcheck.py
binds to the port: the seqlock model drives the port's server/workers.py
over its build of the shm-atomics core, and each seeded mutant
(BrokenSeqlockState and the test's own PreFixSeqlockState) is the port's
class. Each sweep's statistics (schedules, killed runs, the digest of
every explored schedule) must equal JAX's, and each mutant must be caught
with the same violation. The WAL model's cases are twinned in
test_torch_tdcheck_wal.py and the claim model's in
test_torch_tdcheck_claim.py (a file each, so that no one file holds the
whole suite's run back).

Left out: test_cli_sweep_and_mutant_gate, which runs `python -m
tools.tdcheck`, the JAX-bound command-line tool, and touches no module of
the port."""

import torch

from torch_fleet_twins import twin_tests

torch.set_num_threads(1)

CASES = (
    "test_seqlock_model_swept_exhaustively",
    "test_seqlock_checker_live_on_mutant",
    "test_kill_sweep_catches_prefix_publish_bug",
    "test_exhaustive_sweep_deterministic",
    "test_random_mode_deterministic_under_seed",
)

PATCHES = (
    ("from tools.tdcheck.instrument import",
     "from _tdcheck_port.instrument import", "torch"),
    ("from tools.tdcheck.models import (",
     "from _tdcheck_port.models import (", "torch"),
)

globals().update(twin_tests("test_tdcheck", select=CASES, patches=PATCHES,
                            sweeps=CASES))
