"""tick_idle.serve: the share of the traced serving window in which the
card was idle while the batcher's serve.tick span, or a span inside it,
was the innermost on the scheduler thread (spantrace.span_idle_s): the
idle the host's work on a tick causes, apart from the idle loop's
serve.sleep, in %."""

TICK = ("serve.tick", "serve.admit", "serve.prefill_piece",
        "serve.first_token", "serve.decode_step", "serve.emit")


def read(summary):
    idle = summary.get("span_idle_s") if summary.get("kind") == "serve" \
        else None
    if not idle:
        return None
    return 100.0 * sum(idle.get(n, 0.0) for n in TICK) / summary["window_s"]
