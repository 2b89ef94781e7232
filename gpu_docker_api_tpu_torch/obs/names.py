"""Telemetry name catalog — the single source of truth for event op
strings and Prometheus metric family names.

Every `events.record("<op>", ...)` literal in the control plane and every
instrument name handed to the metrics registry must appear below; tdlint's
`untraced-op` rule (tools/tdlint/rules.py) parses THIS module's set
literals and fails the build on an ad-hoc literal. That is what keeps a
dashboard's `sum(rate(tdapi_...))` and an operator's
`grep '"op": "replace.copied"'` stable across refactors: telemetry names
are API, and APIs live in a registry, not scattered string literals.

Two deliberate gaps the lexical rule cannot close (documented here so the
next reader doesn't re-derive them):

- HTTP request events use the computed op `f"{method} {path}"`
  (server/http.py) — one name per route would be unbounded; the rule
  skips non-literal ops by design.
- breaker transition events are `f"breaker.{state}"` (backend/guard.py);
  all three expansions are registered below so consumers can still rely
  on the catalog.

The port's copy of the JAX control plane's obs/names.py. The catalog is
the whole control plane's, the planes the port does not serve yet
included: a name keeps its meaning whichever daemon records it.
"""

from __future__ import annotations

#: every event-log op string the control plane records (events.record's
#: first argument). Grep anchor: docs/observability.md catalogs these.
EVENT_OPS = frozenset({
    # admission / exactly-once middleware (server/app.py)
    "admission.shed",
    "idempotency.replay",
    # chip lifecycle + health (server/app.py, health.py)
    "tpu.cordon",
    "tpu.uncordon",
    "health.cordon",
    # rolling replace data movement (services/replicaset.py)
    "replace.copied",
    # gang reshard: a committed mesh-shape change (services/replicaset.py)
    "reshard",
    # boot/runtime reconciler (reconcile.py)
    "reconcile",
    "reconcile.unknown_op",
    "reconcile.unknown_step",
    # substrate guard (backend/guard.py: f"breaker.{state}" expansions)
    "breaker.closed",
    "breaker.half_open",
    "breaker.open",
    # substrate tooling (backend/process.py)
    "backend.tool_timeout",
    "backend.stop_killed",
    # write-behind persistence (workqueue.py)
    "workqueue.drop",
    # co-tenancy regulator (regulator.py)
    "regulator.preempt",
    # inference gateway: router + autoscaler control loop (gateway.py)
    "gateway.create",
    "gateway.delete",
    "gateway.scale_up",
    "gateway.scale_down",
    "gateway.replica_ready",
    "gateway.replica_down",
    "gateway.shed",
    "gateway.wake",
    # KV-aware serving data plane: one event per disaggregated
    # prefill->decode handoff; rate-limited note that the affinity
    # scorer steered a request onto a prefix-warm replica
    "gateway.kv_handoff",
    "router.affinity_hit",
    # tail-tolerant serving: gray-failure ejection into
    # probation, trickle-probe re-admission, and a dispatched hedge
    # (duplicate request racing a slow primary)
    "gateway.ejected",
    "gateway.probation_pass",
    "gateway.hedged",
    # multi-process data-plane worker tier (server/workers.py)
    "gateway.worker_respawn",
    # watchdog-reaped dead worker: flight-recorder segment + claim-
    # reconcile delta bundle (server/workers.py _capture_postmortem)
    "gateway.worker_postmortem",
    # federation: leased multi-daemon fleet (federation.py). join/leave
    # are membership transitions; expire is a lease the arbiter lazily
    # reaped; grant/steal/takeover trace resource ownership moving
    # between members (steal = live acquire of an expired holder's
    # grant, takeover = the heartbeat sweep adopting orphans).
    "fed.join",
    "fed.leave",
    "fed.expire",
    "fed.grant",
    "fed.steal",
    "fed.takeover",
    # promote-on-loss: a takeover installed the dead daemon's records
    # from the warm-standby replica before adopting (replication.py +
    # federation.FleetMember promote hook)
    "fed.promote",
    # revision watch plane: an SSE watcher resumed past the hub's
    # retained window and was told to relist (server/app.py)
    "watch.gap",
    # durable state plane (store/mvcc.py + replication.py): the store
    # latched read-only after a WAL append failure (ENOSPC et al. —
    # mutations answer 503 + Retry-After until a probe heals it); the
    # standby replicator fell past the peer's watch retention and
    # rebuilt its replica from a full snapshot
    "store.read_only",
    "repl.resync",
    # heterogeneity-aware placement + defragmenter: a scored
    # placement committed (placement.py FleetModel.place); a defrag run
    # journaled its eviction plan, migrated one tenant, opened the box
    # for a gang (admit), or refused (deny: not blocked / over budget /
    # eviction failed) — defrag.py Defragmenter.run_for
    "placement.place",
    "defrag.plan",
    "defrag.migrate",
    "defrag.admit",
    "defrag.deny",
})

#: every Prometheus metric family name the /metrics exposition may emit.
#: Histograms register their FAMILY name (the _bucket/_sum/_count suffixes
#: are the render's job, not the catalog's).
METRIC_NAMES = frozenset({
    # resource inventories (server/app.py collect callback)
    "tdapi_tpu_chips",
    "tdapi_cpu_cores",
    "tdapi_ports",
    "tdapi_replicasets",
    "tdapi_volumes",
    # write-behind queue
    "tdapi_workqueue_pending",
    "tdapi_workqueue_dropped",
    "tdapi_workqueue_coalesced",
    # reconciler / store
    "tdapi_reconcile_actions",
    "tdapi_store_wal_records",
    "tdapi_store_wal_flushes",
    "tdapi_store_wal_flushed_records",
    "tdapi_store_wal_flush_batch_max",
    # health / substrate
    "tdapi_chip_health_failures",
    "tdapi_backend_stop_kills",
    "tdapi_breaker_state",
    "tdapi_breaker_consecutive_failures",
    # gang resharding (services/replicaset.py reshards_total)
    "tdapi_reshards_total",
    # replace fast path (utils/copyfast.py METRICS)
    "tdapi_replace_copy_bytes",
    "tdapi_replace_copy_seconds",
    "tdapi_replace_copy_mode",
    "tdapi_replace_downtime_ms",
    "tdapi_copy_delta_files",
    # fractional multi-tenancy
    "tdapi_tpu_shares_allocated",
    "tdapi_tpu_shares_allocated_total",
    "tdapi_tpu_shares_allocatable",
    "tdapi_tpu_shares_utilization",
    "tdapi_regulator_queue_depth",
    "tdapi_regulator_preemptions_total",
    "tdapi_regulator_chunks_total",
    "tdapi_regulator_tenants",
    # admission gate + idempotency cache
    "tdapi_mutations_inflight",
    "tdapi_mutations_waiting",
    "tdapi_mutations_admitted_total",
    "tdapi_mutations_shed_total",
    "tdapi_idempotency_records",
    "tdapi_idempotency_replays_total",
    # latency distributions (obs/metrics.py module instruments)
    "tdapi_http_request_duration_ms",
    "tdapi_backend_op_duration_ms",
    "tdapi_sched_grant_duration_ms",
    "tdapi_wal_flush_duration_ms",
    "tdapi_store_put_duration_ms",
    "tdapi_replace_downtime_window_ms",
    "tdapi_regulator_chunk_duration_ms",
    # tracing + streaming self-observation
    "tdapi_traces_retained",
    "tdapi_trace_spans_total",
    "tdapi_events_stream_clients",
    # inference gateway (gateway.py + server/app.py collect callback)
    "tdapi_gateway_request_duration_ms",
    "tdapi_gateway_scale_ready_ms",
    "tdapi_gateway_replicas",
    "tdapi_gateway_queue_depth",
    "tdapi_gateway_inflight",
    "tdapi_gateway_requests_total",
    "tdapi_gateway_shed_total",
    "tdapi_gateway_scale_events_total",
    # KV-aware routing: affinity pick totals (in-process router
    # + worker-tier shm counters, summed at scrape), replica prefix-
    # cache occupancy, and disaggregated handoffs completed
    "tdapi_gw_affinity_hits_total",
    "tdapi_gw_affinity_tokens_total",
    "tdapi_kv_prefix_blocks",
    "tdapi_kv_prefix_handoffs_total",
    # tail tolerance: gray-failure ejections, dispatched hedges
    # and hedge wins, and retry-budget shed totals — in-process router +
    # worker-tier shm counters, summed at scrape
    "tdapi_gateway_ejections_total",
    "tdapi_gateway_hedges_total",
    "tdapi_gateway_hedge_wins_total",
    "tdapi_gateway_retry_budget_exhausted_total",
    # cross-process telemetry plane: shared-memory metric shards of the
    # multi-process worker tier (obs/shm_metrics.py, summed at scrape by
    # the server/app.py collect callback). Declared in BOTH serving
    # modes (family parity); per-worker attribution of the data plane.
    "tdapi_gw_workers_alive",
    "tdapi_gw_worker_respawns_total",
    "tdapi_gw_worker_requests_total",
    "tdapi_gw_worker_shed_total",
    "tdapi_gw_worker_deadline_total",
    "tdapi_gw_worker_retries_total",
    "tdapi_gw_worker_queue_wait_ms",
    # federation: fleet membership + grant table + revision watch hub
    # (server/app.py collect callback over federation.FleetArbiter /
    # WatchHub counters)
    "tdapi_fed_members",
    "tdapi_fed_grants",
    "tdapi_fed_owned",
    "tdapi_fed_renewals_total",
    "tdapi_fed_steals_total",
    "tdapi_fed_expiries_total",
    "tdapi_fed_watch_events_total",
    "tdapi_fed_watch_head_revision",
    # warm-standby replication (replication.py StandbyReplicator.status,
    # refreshed by the server/app.py collect callback; zero-valued when
    # no --repl-peer is configured — family parity)
    "tdapi_repl_horizon",
    "tdapi_repl_lag_revisions",
    "tdapi_repl_events_applied_total",
    "tdapi_repl_resyncs_total",
    "tdapi_repl_connected",
    # heterogeneity-aware placement: active policy (value 1,
    # labeled), per-pool capacity/fragmentation views, and the
    # score/commit counters (server/app.py collect callback over
    # placement.FleetModel; zero-valued single-pool families when no
    # policy is configured — family parity)
    "tdapi_placement_policy",
    "tdapi_placement_pools",
    "tdapi_placement_free_chips",
    "tdapi_placement_largest_free_box",
    "tdapi_placement_fragmentation",
    "tdapi_placement_scored_total",
    "tdapi_placement_placements_total",
    # defragmenter (defrag.py Defragmenter counters)
    "tdapi_defrag_runs_total",
    "tdapi_defrag_migrations_total",
    "tdapi_defrag_moved_chips_total",
    "tdapi_defrag_steps_lost_total",
    "tdapi_defrag_denied_total",
    "tdapi_defrag_last_run_ms",
})
