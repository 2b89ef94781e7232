"""train_mfu: model FLOPs of the traced steps (flops.train_step_flops:
active experts, kept attention pairs, no recompute) over the traced
window, as a share of the card's bf16 peak, in %."""

import flops


def read(summary):
    if summary.get("kind") != "train" or not summary["busy_s"]:
        return None
    rate = summary["steps"] * summary["step_flops"] / summary["window_s"]
    return 100.0 * rate / flops.PEAK_BF16_FLOPS
