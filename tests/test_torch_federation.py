"""The port's federation (gpu_docker_api_tpu_torch/federation.py, both
halves, and server/fleet.py in the App) against the JAX package's: every
case of tests/test_federation.py, run on both packages
(tests/torch_fleet_twins.py says what is recorded, how it is compared
and what is normalised). The lease and fedwatch model sweeps and their
mutants, which run over the port's modules (tests/torch_tdcheck.py), are
twinned in test_torch_federation_lease.py and
test_torch_federation_fedwatch.py (a file each, so that no one file
holds the whole suite's run back). The two-daemon SIGKILL takeover
starts the other daemon from each package's own cli (the JAX one on its
own `v4-32`); its outcome depends on a lease expiring on the wall clock,
so it compares codes, and every JAX assertion holds on both. Where a JAX
case waits a fixed time for a state of another thread or process, the
twin waits for the state itself; where it reads the revisions of records
it created, each write-behind write lands before the request that queued
it goes on, so the revisions do not depend on how the queue's thread
interleaves with the request's."""

import torch

from torch_fleet_twins import twin_tests

torch.set_num_threads(1)

#: twinned in test_torch_federation_lease.py and _fedwatch.py
SWEEPS = (
    "test_lease_model_swept_exhaustively",
    "test_fedwatch_model_swept_exhaustively",
    "test_lease_l1_checker_live_on_mutant",
    "test_lease_l2_checker_live_on_noexpiry_mutant",
    "test_fedwatch_checker_live_on_dup_mutant",
    "test_fedwatch_checker_live_on_drop_mutant",
    "test_fed_sweeps_deterministic",
)

TAKEOVER_WAIT = """        wait_for(lambda: all(g["holder"] == "a"
                             for g in a.fleet.arbiter.grants()),
                 timeout=10 * ttl, msg="takeover")"""
TAKEOVER_STATE = """        wait_for(lambda: all(g["holder"] == "a"
                             for g in a.fleet.arbiter.grants())
                 and a.fleet.member.takeovers_total == len(names_b),
                 timeout=300, msg="takeover")"""

PATCHES = (
    ("from tools.tdcheck import models\n",
     "from _tdcheck_port import models\n", "torch"),
    # the JAX daemon's cli knows no line of cards: its own v4-32
    ('"-b", "mock", "-t", "h100-16", "-p", "43400-43500",',
     '"-b", "mock", "-t", "v4-32", "-p", "43400-43500",', "jax"),
    # where the JAX case waits on the clock for a state of another thread
    # or process, the twin waits for the state itself (a generous bound
    # only ends a hang); the takeover's wait also takes the member's
    # takeover count, which it raises after the arbiter's steal
    ('                 msg="informer caught both creates")',
     '                 timeout=300, msg="informer caught both creates")'),
    ('                 msg="informer applied the delete")',
     '                 timeout=300, msg="informer applied the delete")'),
    ('wait_for(ping_b, timeout=60, msg="daemon b serving")',
     'wait_for(ping_b, timeout=300, msg="daemon b serving")'),
    ('timeout=15, msg="b joined the fleet")',
     'timeout=300, msg="b joined the fleet")'),
    ('                 == set(names_b), timeout=10,',
     '                 == set(names_b), timeout=300,'),
    (TAKEOVER_WAIT, TAKEOVER_STATE),
    # a create's records are write-behind: the queue's thread writes them
    # while the request's thread goes on with its own writes, so the
    # listed records' modRevision is the two threads' interleaving; the
    # twin lets each queued write land before the request goes on
    ('''    c = watch_client(app)
    rev0, items0 = c.list_resource("containers")''',
     '''    c = watch_client(app)
    _submit = app.wq.submit

    def _landed(msg):
        _submit(msg)
        app.wq.join()
    app.wq.submit = _landed
    rev0, items0 = c.list_resource("containers")'''),
    ('timeout=10, msg="informer converged on the takeover")',
     'timeout=300, msg="informer converged on the takeover")'),
)

MODES = {
    # an SSE follower polls until the state holds
    "test_watch_list_then_stream_is_gapless": "set",
    # the informer's thread lists and watches at the host's pace
    "test_informer_converges_and_applies_in_order": "codes",
    "test_follow_events_raises_typed_gap_on_ring_overrun": "set",
    # a daemon SIGKILLed, its lease left to expire on the wall clock
    "test_two_daemon_sigkill_takeover": "codes",
}

globals().update(twin_tests("test_federation", patches=PATCHES, modes=MODES,
                            exclude=SWEEPS))
