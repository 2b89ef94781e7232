"""The port's placement and defrag (placement.py, defrag.py, the App's
placer, GET /placement and POST /placement/defrag) against the JAX
package's: every case of tests/test_placement.py, run on both packages
(tests/torch_fleet_twins.py says what is recorded, how it is compared and
what is normalised).

Both variants build their fleets of lines of cards: JAX's v4-32 is a line
of 16 chips of generation v4 and its v5e-8 a line of 8 of v5e; the port's
are h100-16 (h100) and h200-8 (h200), named so that the pools sort as
JAX's do (first fit takes the lexically first pool). The generation-
baseline cases need JAX's ratios, so for the test only the port's table
gives h100 JAX's v4 row and h200 its v5e row (the port's own table
carries NVIDIA's dense BF16 peaks and no TPU ratio); the torch variant
names its pools and profiles by the port's generations, and its records
read them back as JAX's."""

import torch

from gpu_docker_api_tpu import topology as jtopo
from gpu_docker_api_tpu_torch import topology as ttopo
from torch_fleet_twins import twin_tests

torch.set_num_threads(1)

#: (the test's type) -> (JAX's line, the port's line): type, generation,
#: cards
LINES = {"h100-16": (("v4-32", "v4", 16), ("h100-16", "h100", 16)),
         "v5e-8": (("v5e-8", "v5e", 8), ("h200-8", "h200", 8))}
#: the port's names read as JAX's in the torch variant's records
NAMES = {"h100": "v4", "h200": "v5e", "h100-16": "v4-32", "h200-8": "v5e-8"}


def _make_topology(pkg):
    def make_topology(accelerator_type: str, worker_id: int = 0):
        typ, gen, n = LINES[accelerator_type][pkg == "torch"]
        cls = jtopo.TpuTopology if pkg == "jax" else ttopo.GpuTopology
        return cls(typ, gen, (n, 1, 1), chips_per_host=n, num_workers=1)
    return make_topology


def setup(pkg, mod, mp):
    make = _make_topology(pkg)
    mp.setattr(mod, "make_topology", make)
    mp.setattr(jtopo if pkg == "jax" else ttopo, "make_topology", make)
    if pkg == "torch":
        for port, jax in (("h100", "v4"), ("h200", "v5e")):
            mp.setitem(ttopo.GENERATION_SPECS, port,
                       dict(jtopo.GENERATION_SPECS[jax]))


RENAMES = (('"v4"', '"h100"'), ('"v5e"', '"h200"'))

globals().update(twin_tests("test_placement", names=NAMES, setup=setup,
                            renames=RENAMES))
