"""flash_roofline.train: the three flash kernels' least possible time (per
launch the larger of FLOPs over the bf16 peak and bytes over HBM
bandwidth, flops.flash_launch, times the launches the program counted)
over their device time in the trace, in %."""

import flops


def read(summary):
    if summary.get("kind") != "train":
        return None
    device = sum(summary["family_s"].get(k, 0.0)
                 for k in flops.FLASH_KERNELS)
    if device <= 0:
        return None
    a = summary["attention"]
    bound = sum(n * flops.roofline_seconds(*flops.flash_launch(
        k, a["batch"], a["seq"], a["heads"], a["kv_heads"], a["head_dim"],
        a["window"])) for k, n in summary["launches"].items())
    return 100.0 * bound / device
