"""The port's daemon (gpu_docker_api_tpu_torch/server/app.py) against the
JAX App: every case of tests/test_api.py, run on both Apps over their mock
backends and held envelope by envelope (tests/torch_app_twins.py says
how, and what is normalised)."""

import torch

from torch_app_twins import twin_tests

torch.set_num_threads(1)

globals().update(twin_tests("test_api"))
