"""The port's elastic gang replicaSets against the JAX package's: every
case of tests/test_gang.py, run on both packages
(tests/torch_lifecycle_twins.py says what is recorded, and
tests/torch_fleet_twins.py how it is compared and what is normalised):
MeshPlan parsing and its env contract, plan-shaped grants, the reshard
cycle through the service, rollback restoring a gang's shape, a crash mid-
reshard, REST and client plan validation, and the live 1 -> 4 -> 1
reshard of a real training run (slow, as JAX's).

Both variants grant on a line of cards (tests/torch_app_twins.py: v4-8 and
v5p-8 read as h100-4, v4-32 as h100-16). Two geometry cases name a TPU
shape that a line of cards does not have, and run mapped:
- `test_gang_grant_infeasible_geometry` and the last malformed body of
  `test_rest_mesh_plan_validation`: no sub-box of a 2x2 slice has volume
  3, but a line of 4 cards holds 3 in a row, so an sp=3 plan fits there.
  On a line the plan that can never be hosted is one larger than the
  line: sp=5 on h100-4 (plan_feasible False, the API's 1000).
Every other geometry case holds on the line as written: a dp=2 x tp=2
grant is a run of 4 with each tp pair adjacent, pp=2 x tp=2 stages are
adjacent pairs, the checkerboard leaves no free run of 4, and a one-node
line puts every tp pair on one host.

The live reshard launches each package's own trainer (the port's with
`--device cpu`): its dp=4 generation trains over 4 gloo ranks on the CPU
(train_llama's TDAPI_MESH_PLAN contract) and records the plan and its 4
devices as JAX's does. Its outcome depends on the processes' pace, so it
compares codes (tests/torch_fleet_twins.py); every JAX assertion holds on
both."""

import torch

from torch_lifecycle_twins import twin_tests

torch.set_num_threads(1)

#: the TPU box volume no 2x2 slice has -> the size no line of 4 holds
SP3 = "PlanSpec(sp=3)"
SP5 = "PlanSpec(sp=5)"

PATCHES = (
    (f"    assert not s.plan_feasible({SP3})",
     f"    assert not s.plan_feasible({SP5})"),
    ('run_body(tpuCount=3, meshPlan={"sp": 3})',
     'run_body(tpuCount=5, meshPlan={"sp": 5})'),
    # the port's trainer runs on the card unless it is asked for the CPU
    ('"--batch", "4", "--seq", "32", "--workdir", "root/foo-tmp"]',
     '"--batch", "4", "--seq", "32", "--workdir", "root/foo-tmp",'
     ' "--device", "cpu"]', "torch"),
)

MODES = {
    # a real trainer's steps at the host's pace, two quiesced reshards
    "test_e2e_live_reshard_1_4_1_gapless": "codes",
}

globals().update(twin_tests(
    "test_gang", patches=PATCHES, modes=MODES,
    renames=(("gpu_docker_api_tpu_torch.schedulers.tpu",
              "gpu_docker_api_tpu_torch.schedulers.gpu"),)))
