"""ttft_p95_ms as a per-layer metric: the 95th percentile, over every
request whose first token is stamped in the traced part of the window, of
that stamp minus the request's ``submit`` call, in ms (``bench/window.py``).
The seed's order of sizes decides which long prompts share an admission
step, so it spreads too far between seeds to be bounded (``PERF.md``)."""


def read(ctx):
    return ctx.e2e["ttft_p95_ms"]
