"""device_idle.train: the share of the traced training window in which no
operation ran on the card (1 - the union of device intervals over the
window), in %."""


def read(summary):
    if summary.get("kind") != "train" or not summary["busy_s"]:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
