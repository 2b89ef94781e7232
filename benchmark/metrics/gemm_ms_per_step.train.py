"""gemm_ms_per_step.train: device time of library matrix-product kernels
(devtrace.family "gemm") per traced training step, in ms."""


def read(summary):
    if summary.get("kind") != "train" or not summary["busy_s"]:
        return None
    return 1e3 * summary["family_s"].get("gemm", 0.0) / summary["steps"]
