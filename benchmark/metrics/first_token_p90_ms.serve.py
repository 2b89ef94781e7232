"""first_token_p90_ms.serve: the 90th percentile of the time from enqueue
to a request's first token over the window's answered requests, as each
response's X-TDAPI-First-Token-Ms header gives it, in ms."""

import stats


def read(summary):
    times = summary.get("first_token_ms") \
        if summary.get("kind") == "serve" else None
    if not times:
        return None
    return stats.percentile(times, 90)
