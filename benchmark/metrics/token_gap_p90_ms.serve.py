"""token_gap_p90_ms.serve: the 90th percentile of the mean gap between a
request's tokens after its first (X-TDAPI-Token-Gap-Ms: first token to
last over the tokens after the first) over the window's answered requests
of more than one token, in ms."""

import stats


def read(summary):
    gaps = summary.get("token_gap_ms") \
        if summary.get("kind") == "serve" else None
    if not gaps:
        return None
    return stats.percentile(gaps, 90)
