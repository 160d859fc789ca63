"""hybrid_decode_hbm_roofline: the decode steps of a ``hybrid_moe`` model
against the card's memory bandwidth: the least bytes of each logged
``model.decode`` call (``roofline_hybrid_moe.decode_bytes``: weights once,
the Mamba state and conv context read and written, the valid K/V read and
the new written) over 3.35 TB/s, summed, over the summed device time of
the operations those calls queued (the profiler's trace), in %."""

from bench import devtrace, roofline, roofline_hybrid_moe as rh


def read(ctx):
    if ctx.trace is None or ctx.config["family"] != "hybrid_moe":
        return None
    calls = [c for c in ctx.calls if c["kind"] == "decode"]
    if len(ctx.trace.ranges.get(devtrace.DECODE, [])) != len(calls):
        return None
    ops = devtrace.ops_of(ctx.trace, devtrace.DECODE)
    least = spent = 0.0
    for i, c in enumerate(calls):
        mine = ops.get(i, [])
        if not mine:
            continue
        least += rh.decode_bytes(ctx.config, c["lengths"]) / \
            roofline.PEAK_BYTES
        spent += sum(o.end - o.start for o in mine) / 1e9
    if spent <= 0:
        return None
    return 100.0 * least / spent
