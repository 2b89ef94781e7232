"""The port's daemon against the JAX App on the crash-safety sweep of
tests/test_crash_recovery.py: the daemon dies at a crashpoint (an armed
crashpoint raises InjectedCrash out of the mutation), the App is abandoned
without a graceful stop and rebuilt on the same state dir, and the boot
reconciler must restore the invariants. Each case runs on both Apps over
their mock backends, and the two records (every envelope, every reconcile
report with the store's records after it) must be equal
(tests/torch_app_twins.py says how, and what is normalised).

- The sweep covers every crashpoint the port registers, the gateway's
  (gwscale.after_clone, kvhandoff.after_prefill, hedge.in_flight), the
  fleet's (fed.after_acquire, fed.after_takeover, fed.after_promote),
  replication's (repl.after_snapshot) and the defragmenter's
  (defrag.after_plan, defrag.after_migrate) included; a test pins that
  none is skipped.
- The targeted recovery cases are those of tests/test_crash_recovery.py
  from test_clean_reboot_is_noop on.
- One case is new: a patch that dies at replace.after_quiesce on a node
  that loses its substrate with the daemon (the process backend adopts no
  child of a killed daemon, so a daemon crash on the card is a node-level
  crash). The boot reconciler finds the open replace intent and an empty
  substrate: it rolls the replace forward and recreates version 2.
"""

import pytest
import torch

from gpu_docker_api_tpu import faults as jfaults
from gpu_docker_api_tpu_torch import faults as tfaults
from torch_app_twins import load_variant, twin, twin_tests

torch.set_num_threads(1)

pytestmark = pytest.mark.crash

#: every crashpoint the port registers
SWEPT = tuple(tfaults.all_crashpoints())

WIPE_AFTER_QUIESCE = '''

def test_substrate_wipe_with_open_replace_after_quiesce(tmp_path):
    app = make_app(tmp_path)
    setup_replace(app)
    faults.arm("replace.after_quiesce")
    with pytest.raises(InjectedCrash):
        scenario_replace(app)
    app.wq.join()
    assert [r.op for r in app.intents.open_intents()] == ["replace"]
    crash(app)
    fresh = MockBackend(os.path.join(str(tmp_path / "state"), "backend2"))
    app2 = make_app(tmp_path, backend=fresh)
    rep = app2.last_reconcile
    assert "container:demo:replace" in rep["intentsReplayed"]
    assert "replace-completed:demo" in rep["opsCompleted"]
    assert rep["containersRecreated"] == ["demo-2"]
    stored = assert_invariants(app2)
    assert stored["demo"].version == 2
    assert len(stored["demo"].spec.tpu_chips) == 4
    assert app2.backend.list_names() == ["demo-2"]
    assert app2.backend.inspect("demo-2").running
'''


def test_the_sweep_skips_exactly_the_gateway_crashpoint():
    """Since the gateway, the fleet, replication and the defragmenter are
    ported, the sweep skips no crashpoint: theirs are swept like the
    rest, and the port registers every crashpoint JAX's does."""
    assert {"gwscale.after_clone", "kvhandoff.after_prefill",
            "hedge.in_flight", "fed.after_acquire", "fed.after_takeover",
            "fed.after_promote", "repl.after_snapshot", "defrag.after_plan",
            "defrag.after_migrate"} <= set(SWEPT)
    assert set(SWEPT) == set(jfaults.all_crashpoints())
    # every swept crashpoint is JAX's too, and JAX's sweep has its scenario
    assert set(SWEPT) <= set(jfaults.all_crashpoints())
    prefixes = [p for p, _ in load_variant("test_crash_recovery",
                                           "torch").SCENARIOS]
    for cp in SWEPT:
        assert any(cp.startswith(p) for p in prefixes), cp


@pytest.mark.parametrize("cp", SWEPT)
def test_crashpoint_sweep(cp, tmp_path):
    twin("test_crash_recovery", "test_crashpoint_sweep", tmp_path,
         {"cp": cp})


def test_substrate_wipe_with_open_replace_after_quiesce(tmp_path):
    twin("test_crash_recovery",
         "test_substrate_wipe_with_open_replace_after_quiesce", tmp_path,
         extra=WIPE_AFTER_QUIESCE)


globals().update(twin_tests("test_crash_recovery", select=(
    "test_clean_reboot_is_noop",
    "test_substrate_wipe_recreates_containers",
    "test_orphan_backend_container_removed",
    "test_orphan_grant_freed_and_lost_grant_remarked",
    "test_replace_unwound_when_new_version_never_persisted",
    "test_orphan_sweep_spares_foreign_names",
    "test_purge_spares_prefix_sharing_sibling",
    "test_volume_scale_crash_before_create_never_self_migrates",
    "test_runtime_reconcile_refused_while_mutation_in_flight",
    "test_reconcile_endpoint_and_metrics",
    "test_intent_journal_lifecycle",
    "test_workqueue_drop_event_and_replay",
)))
