"""Where the port runs: the card, unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None or "cuda" -> the current CUDA device, raising when there is no
    card (a run never continues on the CPU by itself); "cpu" -> the CPU.

    On the card, f32 matrix products are pinned to full f32: TF32 keeps
    about three decimal digits, and the f32 configs are the parity path
    against the JAX reference."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (--device cpu) "
                "to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device {dev}: the port runs on cuda or cpu")
    return dev
