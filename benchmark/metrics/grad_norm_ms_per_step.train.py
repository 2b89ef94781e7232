"""grad_norm_ms_per_step.train: device time of the operations launched
inside the program's train.grad_norm span (the global norm of the
gradients the clip takes) per traced training step, in ms
(spantrace.span_device_s)."""


def read(summary):
    spans = summary.get("span_device_s") if summary.get("kind") == "train" \
        else None
    if not spans or "train.grad_norm" not in spans:
        return None
    return 1e3 * spans["train.grad_norm"] / summary["steps"]
