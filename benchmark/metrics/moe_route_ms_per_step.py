"""moe_route_ms_per_step: device time of sort, scatter, gather and index
kernels (the MoE block's routing and dispatch) per traced training step,
in ms. Only where the model routes."""


def read(summary):
    if (summary.get("kind") != "train" or not summary.get("moe")
            or not summary["busy_s"]):
        return None
    fam = summary["family_s"]
    return 1e3 * (fam.get("sort", 0.0) + fam.get("index", 0.0)) \
        / summary["steps"]
