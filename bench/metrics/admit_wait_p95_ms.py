"""admit_wait_p95_ms: the 95th percentile, over the requests admitted in
the traced part of the window, of the time each waited between its
``submit`` and the start of its prefill (the ``queued_s`` of the engine's
``engine.prefill`` spans, on the host clock), in ms."""

from bench import spans, window


def read(ctx):
    p = window.percentile(spans.admit_waits(ctx.events), 95)
    return None if p is None else 1e3 * p
