"""The port's daemon against the JAX App on the exactly-once sweep: every
case of tests/test_exactly_once.py (duplicate keys, dropped responses,
overload shedding, crash between attempts, If-Match races, drain, TTL
sweeping and the client's retries), run on both Apps over their mock
backends and held envelope by envelope (tests/torch_app_twins.py says how,
and what is normalised)."""

import torch

from torch_app_twins import UNTIL, twin_tests

torch.set_num_threads(1)

# where the JAX cases sleep for a thread to park in the gate or for stop()
# to start draining, the twins wait for that state (torch_app_twins.UNTIL)
PATCHES = (
    ("    t1.start()\n    time.sleep(0.05)\n",
     "    t1.start()\n    _until(lambda: gate.describe()[\"waiting\"] == 1)\n"),
    ("    t2.start()\n    time.sleep(0.05)\n",
     "    t2.start()\n    _until(lambda: gate.describe()[\"waiting\"] == 2)\n"),
    ("    time.sleep(0.05)            # stop() is now draining\n",
     "    _until(lambda: app.server._draining)   # stop() is now draining\n"),
)

# two PATCHes race for one version: which one wins is the threads' pick
globals().update(twin_tests("test_exactly_once", patches=PATCHES,
                            extra=UNTIL,
                            races=("test_racing_patches_one_winner",)))
