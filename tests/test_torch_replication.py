"""The port's durable state plane against the JAX package's: every case of
tests/test_durability.py, run on both packages
(tests/torch_fleet_twins.py says what is recorded, how it is compared and
what is normalised). The WAL's frames, scans and scrubs, the kill-at-any-
append replay and the offline damage of either engine, backup and
restore (the `store` cli of each package), the ENOSPC latch, and warm-
standby replication: the StandbyReplicator tailing a live daemon, its
full resync after a WatchCompacted, the promote model's R2 mutant (over
the port's modules, tests/torch_tdcheck.py) and a SIGKILLed primary's
standby promoting behind the fencing epoch. Every case that the JAX file
runs on both engines (`BOTH`) runs on both of the port's: its Python
engine and its native one (store/native.py over its g++ build of
native/mvcc_store.cc).

Where a JAX case waits a fixed time for a state of another thread or
process (the daemon serving, the member joining, the replica catching up,
the takeover), the twin waits for the state itself under a bound that only
ends a hang; the takeover's wait also takes its promote and takeover
events, which the standby records after it records the ownership the JAX
case waits for. Where a JAX case reads a record right after the request
that creates it, the twin first drains the write-behind queue that
writes it."""

import torch

from torch_fleet_twins import twin_tests

torch.set_num_threads(1)

TAKEOVER_WAIT = '''        wait_for(lambda: ("containers", name) in b.fleet.member.owned,
                 timeout=15 * ttl, msg="standby takeover")'''
TAKEOVER_STATE = '''        wait_for(lambda: ("containers", name) in b.fleet.member.owned
                 and {"fed.promote", "fed.takeover"} <= {
                     e["op"] for e in b.events.recent(200)},
                 timeout=300, msg="standby takeover")'''

PATCHES = (
    ("from tools.tdcheck import models\n",
     "from _tdcheck_port import models\n", "torch"),
    # the JAX daemon's cli knows no line of cards: its own v4-32
    ('"-b", "mock", "-t", "h100-16", "-p", "43600-43700",',
     '"-b", "mock", "-t", "v4-32", "-p", "43600-43700",', "jax"),
    ('wait_for(ping_a, timeout=60, msg="daemon a serving")',
     'wait_for(ping_a, timeout=300, msg="daemon a serving")'),
    ('timeout=15, msg="a joined the fleet")',
     'timeout=300, msg="a joined the fleet")'),
    ('timeout=20, msg="replica caught the acked record")',
     'timeout=300, msg="replica caught the acked record")'),
    (TAKEOVER_WAIT, TAKEOVER_STATE),
    # the volume's record is write-behind: the POST answers before the
    # queue lands it, so the case's read right after can find no record
    ('''        pk = a.store.get(resource_key("volumes", "vol"))
        r.start()''',
     '''        a.wq.join()
        pk = a.store.get(resource_key("volumes", "vol"))
        r.start()'''),
    ('''            wait_for(lambda: r.horizon >= pk.mod_revision,
                     msg="replica caught up")''',
     '''            wait_for(lambda: r.horizon >= pk.mod_revision,
                     timeout=300, msg="replica caught up")'''),
)

MODES = {
    # the replicator's tail runs on its own thread at the host's pace
    "test_replicator_tails_live_daemon": "codes",
    # the App's boot records land through its write-behind queue, so the
    # resync's snapshot numbers its records in the queue's order
    "test_replicator_gap_forces_full_resync": "codes",
    # the read-only latch heals on a timer: whether a refused mutation's
    # intent record landed before it is the queue's pace
    "test_enospc_latches_read_only_503_then_heals": "codes",
    # a daemon SIGKILLed, its lease left to expire on the wall clock
    "test_sigkill_primary_standby_promotes": "codes",
}

globals().update(twin_tests("test_durability", patches=PATCHES, modes=MODES,
                            sweeps=("test_promote_model_r2_mutant_is_caught",)))
