"""Train, then serve, on the port's daemon against the JAX package's:
tests/test_e2e_serving.py run on both packages
(tests/torch_lifecycle_twins.py says what is recorded, and
tests/torch_fleet_twins.py how it is compared). Each package's own
trainer (the port's `train_llama --device cpu`) writes a checkpoint onto a
volume under its own App on the process backend; a serving replicaSet of
the same package's serve.py binds the same volume with `--checkpoint`,
answers /healthz on the host port the scheduler granted and gives the
same greedy tokens twice. The port's trainer marks an uncommitted save
`<step>.tmp-<pid>` where orbax writes `<step>.orbax-checkpoint-tmp-<t>`,
so the case's wait for a committed step reads the port's mark in the
torch variant. The processes' pace decides the record, so the twin
compares codes; every JAX assertion holds on both. Slow, as its twin
is."""

import torch

from torch_lifecycle_twins import twin_tests

torch.set_num_threads(1)

PATCHES = (
    # the port's workloads run on the card unless asked for the CPU
    ('"--batch", "2", "--seq", "32", "--workdir", "root/foo-tmp"],',
     '"--batch", "2", "--seq", "32", "--workdir", "root/foo-tmp",\n'
     '                "--device", "cpu"],', "torch"),
    ('"--checkpoint", "root/foo-tmp/checkpoints"],',
     '"--checkpoint", "root/foo-tmp/checkpoints", "--device", "cpu"],',
     "torch"),
    # the port's uncommitted-save mark (train.TMP_MARK)
    ('and ".orbax-checkpoint-tmp" not in n',
     'and ".tmp-" not in n', "torch"),
)

globals().update(twin_tests(
    "test_e2e_serving", patches=PATCHES,
    modes={"test_train_then_serve_from_checkpoint": "codes"}))
