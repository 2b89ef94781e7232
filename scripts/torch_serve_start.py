#!/usr/bin/env python3
"""Where a serve process's start goes, on the card.

For each start asked for (`dense`: `serve --config 1b`, as phase 4 starts
it; `moe`: `serve --family moe --config 1b`, as phase 7c starts it), two
readings:

- the split: a child process runs serve.main's start step by step and
  stamps each step against the moment its parent spawned it: the
  interpreter up, `import torch`, CUDA's init (the first tensor on the
  card), the port's modules imported, `Trainer.create`, the weights
  (`_load_params`: a seed-0 init on the card), the `_Server`, and a first
  forward (one greedy token of a one-row prompt, synchronised), which the
  server itself runs only on its first request;
- the real start: `python -m gpu_docker_api_tpu_torch.workloads.serve` on
  a free port, timed from the spawn to the first answer of /healthz.

Prints one JSON line: {"card": nvidia-smi's name and power limit,
"starts": {name: {"split_s": {step: seconds since the spawn},
"healthz_s": seconds}}}.

    python3 scripts/torch_serve_start.py [--starts dense moe]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FLAGS = {"dense": ("--config", "1b"),
         "moe": ("--family", "moe", "--config", "1b")}


def child(kind: str, spawned: float) -> None:
    """serve.main's start, step by step; prints the stamps as JSON."""
    stamps = {"python_up": time.time() - spawned}
    import torch
    stamps["import_torch"] = time.time() - spawned
    torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    stamps["cuda_init"] = time.time() - spawned
    sys.path.insert(0, REPO)
    from gpu_docker_api_tpu_torch import infer
    from gpu_docker_api_tpu_torch.models import named_config
    from gpu_docker_api_tpu_torch.train import Trainer
    from gpu_docker_api_tpu_torch.workloads import serve
    stamps["import_port"] = time.time() - spawned
    config = named_config("moe" if kind == "moe" else "llama", "1b")
    trainer = Trainer.create(config, device="cuda")
    stamps["trainer_create"] = time.time() - spawned
    params = serve._load_params(trainer, "")
    torch.cuda.synchronize()
    stamps["weights"] = time.time() - spawned
    srv = serve._Server(config, params)
    stamps["server"] = time.time() - spawned
    with torch.no_grad():
        out = infer.generate(params, torch.zeros((1, 8), dtype=torch.long,
                                                 device="cuda"), config, 1)
    torch.cuda.synchronize()
    stamps["first_forward"] = time.time() - spawned
    assert out.shape == (1, 1) and srv.n_params > 0
    print(json.dumps(stamps), flush=True)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def healthz_s(kind: str, deadline_s: float = 300.0) -> float:
    from http.client import HTTPConnection
    port = free_port()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpu_docker_api_tpu_torch.workloads.serve",
         *FLAGS[kind], "--host", "127.0.0.1", "--port", str(port)],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        while time.perf_counter() - t0 < deadline_s:
            if proc.poll() is not None:
                raise SystemExit(f"{kind}: the serve process exited")
            try:
                conn = HTTPConnection("127.0.0.1", port, timeout=5)
                conn.request("GET", "/healthz")
                if conn.getresponse().status == 200:
                    return time.perf_counter() - t0
            except OSError:
                time.sleep(0.05)
            finally:
                conn.close()
        raise SystemExit(f"{kind}: no /healthz within {deadline_s} s")
    finally:
        proc.kill()
        proc.wait(timeout=60)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--starts", nargs="+", default=["dense", "moe"],
                   choices=sorted(FLAGS))
    p.add_argument("--child", default="")
    p.add_argument("--spawned", type=float, default=0.0)
    args = p.parse_args(argv)
    if args.child:
        child(args.child, args.spawned)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: the starts run on the card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out = {"card": card, "starts": {}}
    for kind in args.starts:
        spawned = time.time()
        got = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", kind,
             "--spawned", repr(spawned)], cwd=REPO, capture_output=True,
            text=True, check=True)
        split = json.loads(got.stdout.strip().splitlines()[-1])
        out["starts"][kind] = {"split_s": split,
                               "healthz_s": healthz_s(kind)}
        print(json.dumps({kind: out["starts"][kind]}), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
