"""device_ms_per_request.serve: device-busy time per finished request: the
busy share of the traced part of the window, times the window, over the
requests finished in the window, in ms."""


def read(summary):
    if (summary.get("kind") != "serve" or not summary["busy_s"]
            or not summary.get("completed_in_window")):
        return None
    busy_share = summary["busy_s"] / summary["window_s"]
    return 1e3 * busy_share * summary["run_window_s"] \
        / summary["completed_in_window"]
