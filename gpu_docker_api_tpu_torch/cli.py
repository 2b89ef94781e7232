"""Process bootstrap.

Reference parity: cmd/gpu-docker-api/main.go — flags --addr/-a, --etcd/-e
(here --state-dir: the store is embedded, no external etcd), --portRange/-p,
--logLevel/-l (:33-38), banner of chip/port inventory (:107-112), SIGINT/
SIGTERM graceful stop with full state flush (:139-154).

The port's copy of the JAX control plane's cli.py. Discovery of the
node's cards raises without one, so the CPU is asked for with a mock
topology:

    python -m gpu_docker_api_tpu_torch.cli --backend mock --topology h100-8

and the card's node with none (`-b process` discovers the cards through
nvidia-smi and the device nodes; the daemon itself never initialises
CUDA). `store scrub|backup|restore` is the offline durability tooling, on
either store engine (`--engine auto|native|python`). Two daemons make a
fleet with a warm standby: the standby hosts the fleet's arbiter and tails
the primary's revisions (`--repl-peer PRIMARY:PORT`); the primary is a
member of that fleet (`--fleet-member a --fleet-host STANDBY:PORT`).
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading

# arm the lock-order watcher BEFORE the App import pulls in every
# control-plane module, so module-level locks (faults, regulator registry)
# are watched too — a live daemon then doubles as a race sweep, reporting
# at exit (docs/correctness.md). Off by default: zero wrappers, zero cost.
if os.environ.get("TDAPI_LOCKWATCH") == "1":
    from .analysis import lockwatch as _lockwatch
    _lockwatch.install(report_at_exit=True)

from .server.app import App                                    # noqa: E402
from .topology import make_topology                            # noqa: E402

log = logging.getLogger("tpu-docker-api")


def parse_port_range(s: str) -> tuple[int, int]:
    lo, _, hi = s.partition("-")
    return int(lo), int(hi)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-docker-api",
        description="container-orchestration REST service for NVIDIA "
                    "cards (the PyTorch port's daemon)")
    p.add_argument("-a", "--addr", default="0.0.0.0:2378",
                   help="listen address (default 0.0.0.0:2378)")
    p.add_argument("-s", "--state-dir", default="./tpu-docker-api-state",
                   help="embedded state store + backend working dir")
    p.add_argument("-p", "--portRange", default="40000-65535",
                   help="host port pool, e.g. 40000-65535")
    p.add_argument("-l", "--logLevel", default="info",
                   choices=["debug", "info", "warning", "error"])
    p.add_argument("-b", "--backend", default="process",
                   choices=["mock", "process", "docker"],
                   help="substrate (default: process; mock needs no hardware)")
    p.add_argument("-t", "--topology", default=None,
                   help="a mock line of cards, <generation>-<cards> (e.g. "
                        "h100-8); default: probe the host's cards")
    p.add_argument("--volume-tier", action="append", default=[],
                   metavar="NAME=PATH",
                   help="extra volume storage tier (repeatable), e.g. "
                        "nfs=/mnt/nfs — the local-SSD/NFS data-disk split")
    p.add_argument("--warm-pool", type=int, default=1, metavar="N",
                   help="pre-imported Python workers for fast workload "
                        "start (process backend; 0 disables; default 1)")
    p.add_argument("--no-supervise", action="store_true",
                   help="disable the process-backend supervisor (restart "
                        "policy enforcement + rootfs storage-quota "
                        "watchdog; on by default for the daemon)")
    p.add_argument("--no-guard", action="store_true",
                   help="disable the guarded backend (per-op deadlines, "
                        "transient-error retries, circuit breaker; on by "
                        "default for the daemon)")
    p.add_argument("--health-interval", type=float, default=5.0,
                   metavar="SEC",
                   help="substrate health probe period (chip presence, "
                        "reachability, flap detection; 0 disables the "
                        "background prober — /healthz still probes on "
                        "demand; default 5)")
    p.add_argument("--no-auto-cordon", action="store_true",
                   help="report unhealthy chips on /healthz but never "
                        "cordon them automatically")
    p.add_argument("--gw-workers", type=int, default=None, metavar="N",
                   help="multi-process serving data plane: N worker "
                        "processes share the gateway generate port via "
                        "SO_REUSEPORT with router state in shared memory "
                        "(default: TDAPI_GW_WORKERS env, else 0 = "
                        "in-process)")
    p.add_argument("--gw-data-port", type=int, default=None, metavar="PORT",
                   help="explicit data-plane port for --gw-workers "
                        "(default: TDAPI_GW_DATA_PORT env, else pick a "
                        "free one; see /api/v1/healthz workers.port)")
    p.add_argument("--fleet-member", default=None, metavar="ID",
                   help="join a multi-daemon fleet under this member id: "
                        "lease heartbeats, hash-ring resource ownership, "
                        "takeover of dead members' slices (default: "
                        "TDAPI_FLEET_MEMBER env, else single-daemon)")
    p.add_argument("--fleet-host", default=None, metavar="HOST:PORT",
                   help="the daemon hosting the fleet arbiter (default: "
                        "TDAPI_FLEET_HOST env, else this daemon hosts "
                        "its own — the fleet's one shared point, like "
                        "the reference's etcd endpoint)")
    p.add_argument("--fleet-ttl", type=float, default=None, metavar="SEC",
                   help="fleet lease TTL; heartbeat runs at TTL/3 "
                        "(default: TDAPI_FLEET_TTL env, else 5)")
    p.add_argument("--repl-peer", default=None, metavar="HOST:PORT",
                   help="warm-standby replication: tail this peer "
                        "daemon's revision watch into a local replica "
                        "store, so a fleet takeover of the dead peer "
                        "promotes its records instead of losing them "
                        "(default: TDAPI_REPL_PEER env, else off)")
    p.add_argument("--cpu-cores", type=int, default=None, metavar="N",
                   help="override the schedulable core count (default: "
                        "probe /proc/cpuinfo; mock-backend fleets on "
                        "small hosts need more cores than exist)")
    p.add_argument("--placement-policy", default=None, metavar="POLICY",
                   help="score whole-card grants with this placement "
                        "objective (max_throughput | "
                        "finish_time_fairness | cost | first_fit) "
                        "instead of mechanism-layer first-fit (default: "
                        "TDAPI_PLACEMENT_POLICY env, else off)")
    p.add_argument("--defrag-interval", type=float, default=None,
                   metavar="SEC",
                   help="run the background defragmenter every SEC "
                        "seconds over gang shapes the admission path "
                        "refused on capacity (default: "
                        "TDAPI_DEFRAG_INTERVAL env, else 0 = on-demand "
                        "only via POST /api/v1/placement/defrag)")
    return p


def store_engine(store) -> str:
    """"native" or "python": the engine under the App's (watched) store."""
    from .store.native import NativeMVCCStore
    inner = getattr(store, "_inner", store)
    return "native" if isinstance(inner, NativeMVCCStore) else "python"


def build_store_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-docker-api store",
        description="offline durability tooling for the embedded MVCC "
                    "store (docs/durability.md)")
    sub = p.add_subparsers(dest="cmd", required=True)

    sc = sub.add_parser("scrub", help="verify WAL frame integrity "
                        "(CRC + framing) and report where it breaks")
    sc.add_argument("wal", help="path to the WAL file (state.wal, "
                    "replica.wal, or a backup file)")

    bk = sub.add_parser("backup", help="write a consistent point-in-time "
                        "snapshot of the store to a portable WAL file")
    bk.add_argument("-s", "--state-dir", default="./tpu-docker-api-state",
                    help="daemon state dir holding state.wal")
    bk.add_argument("-o", "--out", required=True,
                    help="backup file to write (atomic: tmp + rename)")
    bk.add_argument("-r", "--revision", type=int, default=None,
                    help="snapshot at this revision (default: current "
                         "head; must be >= the compaction floor)")
    bk.add_argument("--engine", default="auto",
                    choices=["auto", "python", "native"])

    rs = sub.add_parser("restore", help="install a backup file as a "
                        "state dir's WAL (the backup replays to the "
                        "exact revision history it captured)")
    rs.add_argument("-s", "--state-dir", default="./tpu-docker-api-state",
                    help="daemon state dir to restore into")
    rs.add_argument("-f", "--from", dest="src", required=True,
                    help="backup file written by `store backup`")
    rs.add_argument("--force", action="store_true",
                    help="overwrite an existing state.wal")
    return p


def store_main(argv) -> int:
    import json as _json
    import shutil

    from .store import walio

    args = build_store_parser().parse_args(argv)
    if args.cmd == "scrub":
        report = walio.scrub(args.wal)
        print(_json.dumps(report, indent=2, sort_keys=True))
        return 0 if report["ok"] else 1
    if args.cmd == "backup":
        from .store import open_store
        wal = os.path.join(args.state_dir, "state.wal")
        if not os.path.exists(wal):
            print(f"no WAL at {wal}", file=sys.stderr)
            return 1
        store = open_store(wal_path=wal, engine=args.engine)
        try:
            info = store.backup(args.out, revision=args.revision)
        finally:
            store.close()
        print(_json.dumps({"backup": args.out, **info}, sort_keys=True))
        return 0
    # restore: scrub-verify the backup, then file placement — the backup
    # IS a valid WAL, so installing it and letting the next boot replay
    # is the whole restore (no store object needed, either engine reads it)
    report = walio.scrub(args.src)
    if not report["ok"]:
        print(_json.dumps(report, indent=2, sort_keys=True),
              file=sys.stderr)
        print(f"refusing to restore from corrupt backup {args.src}",
              file=sys.stderr)
        return 1
    os.makedirs(args.state_dir, exist_ok=True)
    wal = os.path.join(args.state_dir, "state.wal")
    if os.path.exists(wal) and not args.force:
        print(f"{wal} exists; pass --force to overwrite", file=sys.stderr)
        return 1
    tmp = wal + ".restore-tmp"
    shutil.copyfile(args.src, tmp)
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    os.replace(tmp, wal)
    print(_json.dumps({"restored": wal, "records": report["records"],
                       "format": report["format"]}, sort_keys=True))
    return 0


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "store":
        return store_main(argv[1:])
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.logLevel.upper()),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")

    from .analysis import lockwatch
    if lockwatch.installed():
        log.info("lockwatch armed: lock-order + held-across-backend "
                 "report at exit")

    topology = make_topology(args.topology) if args.topology else None
    tiers = {}
    for spec in args.volume_tier:
        tname, sep, path = spec.partition("=")
        if not sep or not tname or not path:
            raise SystemExit(f"--volume-tier expects NAME=PATH, got {spec!r}")
        if tname == "local":
            raise SystemExit(
                "--volume-tier local=... is not configurable: 'local' is "
                "the state-dir default tier")
        if tname in tiers:
            raise SystemExit(f"duplicate --volume-tier {tname!r}")
        tiers[tname] = path
    app = App(state_dir=args.state_dir, backend=args.backend, addr=args.addr,
              port_range=parse_port_range(args.portRange), topology=topology,
              volume_tiers=tiers, warm_pool=args.warm_pool,
              supervise=not args.no_supervise,
              guard_backend=not args.no_guard,
              health_interval=args.health_interval,
              auto_cordon=not args.no_auto_cordon,
              gw_workers=args.gw_workers,
              gw_data_port=args.gw_data_port,
              fleet_member=args.fleet_member,
              fleet_host=args.fleet_host,
              fleet_ttl=args.fleet_ttl,
              repl_peer=args.repl_peer,
              cpu_cores=args.cpu_cores,
              placement_policy=args.placement_policy,
              defrag_interval=args.defrag_interval)
    app.start()

    status = app.tpu.get_status()
    log.info("topology: %s (%d cards, %d free)",
             status["topology"]["acceleratorType"], len(status["chips"]),
             status["freeCount"])
    log.info("port pool: %s", app.ports.get_status()["range"])
    log.info("state store: %s engine", store_engine(app.store))
    log.info("listening on %s — Ctrl-C to stop", app.address)

    stop = threading.Event()

    def on_signal(signum, frame):
        log.info("signal %d: shutting down", signum)
        stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    stop.wait()
    app.stop()
    log.info("state flushed; bye")
    return 0


if __name__ == "__main__":
    sys.exit(main())
