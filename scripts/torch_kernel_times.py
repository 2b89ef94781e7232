#!/usr/bin/env python3
"""Time the port's three flash kernels at the main path's shape on one card.

Builds the kernels of the checkout given by --repo (default: this one), runs
each at chip_smoke.py's MAIN_SHAPE (llama 1b's attention: bf16, causal,
B=4, S=2048, 16 q / 8 kv heads, D=128) on seeded inputs, and prints one
JSON line: the card, and each kernel's mean ms per launch (chip_smoke's
time_ms: CUDA events over 20 launches after a warm-up), taken ROUNDS times.
To compare two checkouts, run it on each in one call, in turns:

    python3 scripts/torch_kernel_times.py --repo OLD
    python3 scripts/torch_kernel_times.py
    python3 scripts/torch_kernel_times.py
    python3 scripts/torch_kernel_times.py --repo OLD
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

ROUNDS = 3
ITERS = 20


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--repo", default=REPO,
                   help="checkout whose gpu_docker_api_tpu_torch is timed")
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: kernel times cannot be measured here")
    sys.path.insert(0, os.path.abspath(args.repo))
    from gpu_docker_api_tpu_torch.ops import attention as att

    shape = chip_smoke.MAIN_SHAPE
    b, s, h, hkv, d = (shape[k] for k in ("b", "s", "h", "hkv", "d"))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*dims):
        return torch.randn(*dims, generator=gen, device="cuda").bfloat16()

    q, do = randn(b, s, h, d), randn(b, s, h, d)
    k, v = randn(b, s, hkv, d), randn(b, s, hkv, d)
    o, lse = att.flash_fwd(q, k, v)
    kernels = {
        "flash_fwd": lambda: att.flash_fwd(q, k, v),
        "flash_bwd_dq": lambda: att.flash_bwd_dq(q, k, v, o, do, lse),
        "flash_bwd_dkv": lambda: att.flash_bwd_dkv(q, k, v, o, do, lse),
    }
    ms = {name: [chip_smoke.time_ms(torch, fn, ITERS) for _ in range(ROUNDS)]
          for name, fn in kernels.items()}
    print(json.dumps({"repo": os.path.abspath(args.repo),
                      "card": chip_smoke.nvidia_smi(), "shape": shape,
                      "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
