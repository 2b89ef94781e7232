"""moe_drop_pct.train: the share of the top-k routing choices that the
expert capacity dropped over the traced steps' forwards, from the
program's MoE drop counter (models/moe.DROPS), in %."""


def read(summary):
    if (summary.get("kind") != "train" or not summary.get("moe")
            or not summary.get("moe_choices")):
        return None
    return 100.0 * summary["moe_dropped"] / summary["moe_choices"]
