"""queue_wait_p90_ms.serve: the 90th percentile of the batcher's queue
wait (submit to slot admission) over the window's answered requests, as
each response's X-TDAPI-Queue-Wait-Ms header gives it, in ms."""

import stats


def read(summary):
    waits = summary.get("queue_waits_ms") if summary.get("kind") == "serve" \
        else None
    if not waits:
        return None
    return stats.percentile(waits, 90)
