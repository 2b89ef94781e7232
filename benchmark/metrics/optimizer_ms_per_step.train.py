"""optimizer_ms_per_step.train: device time of the operations launched
inside the program's train.optimizer span (AdamW.update, its clip sync
included) per traced training step, in ms (spantrace.span_device_s)."""


def read(summary):
    spans = summary.get("span_device_s") if summary.get("kind") == "train" \
        else None
    if not spans or "train.optimizer" not in spans:
        return None
    return 1e3 * spans["train.optimizer"] / summary["steps"]
