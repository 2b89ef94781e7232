"""The flagship scheduled workload, PyTorch port: resumable Llama (or,
with --family moe, MoE) training.

What runs inside a replicaSet container, with the JAX workload's contract
(gpu_docker_api_tpu/workloads/train_llama.py): the same flags, all durable
state (checkpoints, metrics.jsonl) under --workdir, resume-first from the
newest checkpoint, the same metrics.jsonl schema and the quiesce park on
SIGUSR1. It trains on the CUDA card the container was given; --device cpu
runs on the CPU instead (tests).

A TDAPI_MESH_PLAN (the control plane's gang contract) is honoured
exactly. Without one the plan is the JAX workload's: --tp (or best_tp_for
over the devices left by --sp, --pp and --ep), --sp, --pp, --ep, and the
rest of the visible devices on fsdp (unplanned_plan), for either family.
Under pp the trunk is pipelined (parallel/pipeline.py) over
--microbatches, interleaved when --virtual-stages is above 1.
A plan over more than one rank trains over plan.size ranks on this host
(distributed.launch): processes on cuda:0..N-1 over NCCL, or with --device
cpu on the CPU over gloo. Rank 0 alone writes metrics, the checkpoints
(the gathered state: a run resumes under another plan, as a tpuCount
patch asks; under the interleaved schedule the layers stay grouped, so
such a run resumes only under the same pp and v) and the quiesce marker
and ack; every rank resumes from the same checkpoint and keeps its shards.
Multi-worker contracts are not yet ported and are refused.

Run: python -m gpu_docker_api_tpu_torch.workloads.train_llama \
        --config tiny --steps 100 --workdir /path/to/run1
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _refuse_multi_worker(env=None) -> None:
    """The control plane's multi-worker contract (TPU_WORKER_HOSTNAMES over
    more than one host) needs a distributed runtime the port lacks."""
    e = os.environ if env is None else env
    hosts = [h for h in e.get("TPU_WORKER_HOSTNAMES", "").split(",") if h]
    if len(hosts) > 1:
        raise NotImplementedError(
            f"a {len(hosts)}-worker grant: multi-worker training is not yet "
            f"ported to PyTorch")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--family", default="llama", choices=["llama", "moe"])
    p.add_argument("--config", default="tiny",
                   help="named config for the family (models.NAMED_CONFIGS)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--workdir", default=os.environ.get("CONTAINER_ROOT", "."))
    p.add_argument("--checkpoint-every", type=int, default=10)
    p.add_argument("--tp", type=int, default=0, help="0 = auto from devices")
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline stages (llama family)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel width (moe family)")
    p.add_argument("--microbatches", type=int, default=4,
                   help="pipeline microbatches when --pp > 1")
    p.add_argument("--virtual-stages", type=int, default=1,
                   help="interleaved pipeline schedule: layer chunks per "
                        "stage")
    p.add_argument("--data", default="",
                   help="flat binary token file (uint16, or uint32 with a "
                        ".u32 suffix — the nanoGPT/llm.c format); empty = "
                        "synthetic random tokens")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="linear LR warmup (0 = constant)")
    p.add_argument("--decay-steps", type=int, default=0,
                   help="cosine decay horizon after warmup (0 = none)")
    p.add_argument("--min-lr-ratio", type=float, default=0.1,
                   help="cosine decay floor as a fraction of peak LR")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation micro-slices per step")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to train: the CUDA card (default; raises "
                        "without one) or, when asked, the CPU")
    return p


def main(argv=None) -> int:
    p = _parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)

    _refuse_multi_worker()

    from ..models import named_config
    from ..parallel.mesh import plan_from_env

    # gang contract: a plan the control plane stamped is honoured exactly
    # (the CLI's axis flags apply to un-planned launches only)
    plan = plan_from_env() or _unplanned(args)
    try:
        config = named_config(args.family, args.config)
    except KeyError as e:
        p.error(str(e))
    if plan.size > 1:
        return _launch(args, argv, plan)

    from ..device import resolve_device
    device = resolve_device(args.device)   # no card and no --device cpu: raise
    return _run(args, config, plan, device)


def unplanned_plan(n_dev: int, tp: int, sp: int, pp: int = 1, ep: int = 1):
    """The JAX workload's plan without TDAPI_MESH_PLAN, over n_dev
    devices: tp as asked (0: best_tp_for over the devices the other fixed
    axes leave), sp, pp and ep as asked, the rest on fsdp
    (MeshPlan.auto; raises ValueError when they do not divide n_dev)."""
    from ..parallel.mesh import MeshPlan, best_tp_for
    fixed = sp * pp * ep
    tp = tp or best_tp_for(n_dev // fixed if n_dev % fixed == 0 else 1)
    return MeshPlan.auto(n_dev, tp=tp, sp=sp, pp=pp, ep=ep)


def _unplanned(args):
    """unplanned_plan over the visible devices: on cuda every card
    (torch.cuda.device_count(), after refusing flags that ask for more
    cards than there are, and a machine with none); on --device cpu, which
    has no device count to fill, what the flags ask, (--tp or 1) * --sp *
    --pp * --ep."""
    asked = (args.tp or 1) * args.sp * args.pp * args.ep
    if args.device == "cpu":
        return unplanned_plan(asked, args.tp, args.sp, args.pp, args.ep)
    import torch

    from ..device import resolve_device
    n_dev = torch.cuda.device_count()
    if asked > 1 and asked > n_dev:
        flags = " ".join(f"--{a} {getattr(args, a)}"
                         for a in ("tp", "sp", "pp", "ep")
                         if getattr(args, a) > 1)
        raise RuntimeError(f"{flags} needs {asked} CUDA devices, sees "
                           f"{n_dev}")
    resolve_device(args.device)            # no card: raise
    return unplanned_plan(n_dev, args.tp, args.sp, args.pp, args.ep)


def _launch(args, argv, plan) -> int:
    """plan.size rank processes on this host, each running _rank_main."""
    import torch

    from .. import distributed
    if args.device == "cuda" and torch.cuda.device_count() < plan.size:
        raise RuntimeError(f"TDAPI_MESH_PLAN {plan} needs {plan.size} CUDA "
                           f"devices, sees {torch.cuda.device_count()}")
    distributed.launch(_rank_main, (argv, plan), plan.size,
                       distributed.backend_for(args.device))
    return 0


def _rank_main(rank: int, world: int, argv: list, plan) -> None:
    """One rank of a run over ranks (distributed.launch formed the world's
    group; this forms the plan's)."""
    from ..device import resolve_device
    from ..models import named_config
    from ..parallel.mesh import MeshGroups

    args = _parser().parse_args(argv)
    groups = MeshGroups.build(plan)
    device = resolve_device(f"cuda:{rank}" if args.device == "cuda"
                            else "cpu")
    _run(args, named_config(args.family, args.config), plan, device, groups)


def _run(args, config, plan, device, groups=None) -> int:
    """Train on `device` (this rank's, over the plan's groups) to
    --steps."""
    from ..data import Prefetcher, make_dataset
    from ..train import (
        QuiesceSignal, Trainer, TrainConfig, clear_quiesce_marker,
        read_quiesce_marker, restore_checkpoint,
    )

    # checkpoint-on-drain: install the SIGUSR1 handler before the loop, so
    # a drain arriving any time after startup is honoured at the next step
    # boundary (train.py QuiesceSignal)
    quiesce = QuiesceSignal()
    writer = groups is None or groups.rank == 0

    os.makedirs(args.workdir, exist_ok=True)
    ckpt_dir = os.path.abspath(os.path.join(args.workdir, "checkpoints"))
    metrics_path = os.path.join(args.workdir, "metrics.jsonl")

    trainer = Trainer.create(
        config, plan, tc=TrainConfig(n_microbatches=args.microbatches,
                                     virtual_stages=args.virtual_stages,
                                     learning_rate=args.lr,
                                     warmup_steps=args.warmup_steps,
                                     decay_steps=args.decay_steps,
                                     min_lr_ratio=args.min_lr_ratio,
                                     accum_steps=args.accum_steps),
        device=device, groups=groups)

    # resume-first: a fresh init only when there is no checkpoint at all;
    # every rank restores the same one (rank 0 wrote it, whole, under
    # whatever plan) and keeps its shards
    start_step = 0
    try:
        state, start_step = restore_checkpoint(
            ckpt_dir, trainer.abstract_state())
        state = trainer.shard_state(state)
        q_step = read_quiesce_marker(ckpt_dir) if writer else None
        if q_step is not None:
            # a prior generation parked here via quiesce; consume the marker
            print(f"resuming quiesced run: marker step {q_step}, "
                  f"checkpoint step {start_step}", flush=True)
            clear_quiesce_marker(ckpt_dir)
        if writer:
            print(f"resumed from checkpoint step {start_step}", flush=True)
    except FileNotFoundError:
        # no checkpoint yet. Anything else (a shape mismatch from a changed
        # --config or, grouped, --pp / --virtual-stages; a corrupt payload)
        # fails loudly: silently starting over would discard real progress
        # on the same workdir (pipeline.ungroup_layers converts layouts
        # when a schedule change across a resume is intended).
        state = trainer.init(seed=0)

    # deterministic (seed, step) batches — resume replays the exact stream —
    # staged onto the device while the step runs. Every rank draws the same
    # global batch (process_id 0) and trains on its shard.
    dataset = make_dataset(
        args.data, config.vocab_size, args.batch, args.seq, seed=args.seed)
    prefetch = Prefetcher(dataset.iter_from(start_step),
                          place=trainer.shard_batch)

    metrics_f = open(metrics_path, "a", encoding="utf-8") if writer else None
    try:
        _train_loop(args, trainer, state, start_step, prefetch, metrics_f,
                    ckpt_dir, plan, quiesce)
    finally:
        if metrics_f is not None:
            metrics_f.close()
        prefetch.close()
    if writer:
        print(f"done: {args.steps} steps", flush=True)
    return 0


def _ckpt_record(metrics_f, rec: dict) -> None:
    """Checkpoint-marker jsonl append, flushed and fsync'd: a durable
    checkpoint never lacks its marker line."""
    metrics_f.write(json.dumps(rec) + "\n")
    metrics_f.flush()
    os.fsync(metrics_f.fileno())


def _quiesce_agreed(quiesce, trainer) -> bool:
    """Whether any rank got the drain signal: over ranks they agree (MAX)
    at every step boundary, so all stop after the same step."""
    if trainer.groups is None:
        return quiesce.requested
    import torch

    from ..parallel.comm import all_reduce_max
    flag = torch.tensor([int(quiesce.requested)], device=trainer.device)
    all_reduce_max([flag], trainer.groups.world)
    return bool(flag.item())


def _train_loop(args, trainer, state, start_step, prefetch, metrics_f,
                ckpt_dir, plan, quiesce):
    """The steps; metrics_f is None on every rank but the world's 0th,
    which alone writes metrics, checkpoints and the quiesce files. Every
    rank gathers the state it saves (Trainer.full_state)."""
    from ..train import (
        save_checkpoint, write_quiesce_ack, write_quiesce_marker,
    )
    writer = metrics_f is not None
    for step in range(start_step, args.steps):
        tokens = next(prefetch)
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, tokens)
        loss = float(metrics["loss"])       # waits for the step to finish
        rec = {"step": step + 1, "loss": round(loss, 5),
               "step_time_s": round(time.perf_counter() - t0, 4),
               "devices": plan.size, "plan": str(plan), "time": time.time()}
        if writer:
            metrics_f.write(json.dumps(rec) + "\n")
            metrics_f.flush()
        if _quiesce_agreed(quiesce, trainer):
            full = trainer.full_state(state)
            if not writer:
                quiesce.park()
            # park at exactly step+1: checkpoint, durable marker, then the
            # ack, strictly in that order so ack implies durable checkpoint
            save_checkpoint(ckpt_dir, full, step + 1)
            write_quiesce_marker(ckpt_dir, step + 1)
            _ckpt_record(metrics_f, {"checkpoint": step + 1,
                                     "quiesced": True, "time": time.time()})
            write_quiesce_ack(step + 1)
            print(f"quiesced at step {step + 1}; parking", flush=True)
            quiesce.park()      # until the control plane's stop (SIGTERM)
        if ((step + 1) % args.checkpoint_every == 0
                or step + 1 == args.steps):
            full = trainer.full_state(state)
            if writer:
                save_checkpoint(ckpt_dir, full, step + 1)
                _ckpt_record(metrics_f, {"checkpoint": step + 1,
                                         "time": time.time()})
            del full


if __name__ == "__main__":
    raise SystemExit(main())
