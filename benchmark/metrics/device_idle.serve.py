"""device_idle.serve: the share of the traced serving window in which no
operation ran on the card, in the server process, in %."""


def read(summary):
    if summary.get("kind") != "serve" or not summary["busy_s"]:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
