"""other_ms_per_step.train: device time of every kernel that is neither a
flash kernel, a library matrix product, a sort nor an index kernel (norms,
RoPE, activations, the loss, AdamW) per traced training step, in ms."""


def read(summary):
    if summary.get("kind") != "train" or not summary["busy_s"]:
        return None
    return 1e3 * summary["family_s"].get("other", 0.0) / summary["steps"]
