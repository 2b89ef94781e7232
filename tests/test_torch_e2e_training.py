"""The flagship lifecycle on the port's daemon against the JAX package's:
tests/test_e2e_training.py (the BASELINE's config 5) run on both packages
(tests/torch_lifecycle_twins.py says what is recorded, and
tests/torch_fleet_twins.py how it is compared). A training replicaSet of
each package's own trainer (the port's `train_llama --device cpu`) runs
under its own App on the process backend with its checkpoints on a
volume, is patched from 1 card to 4 mid-run and then rolled back to
version 1 over REST (`PATCH /replicaSet/train/rollback`, version 3 on one
card), and resumes past every step it had logged. Its outcome depends on
the trainers' pace, so the twin compares codes; every JAX assertion holds
on both. Slow, as its twin is."""

import torch

from torch_lifecycle_twins import twin_tests

torch.set_num_threads(1)

PATCHES = (
    # the port's trainer runs on the card unless it is asked for the CPU
    ('''           "--batch", "2", "--seq", "32",
           "--workdir", "root/foo-tmp"]''',
     '''           "--batch", "2", "--seq", "32",
           "--workdir", "root/foo-tmp", "--device", "cpu"]''', "torch"),
)

globals().update(twin_tests(
    "test_e2e_training", patches=PATCHES,
    modes={"test_training_replicaset_patch_and_rollback_resumes": "codes"}))
