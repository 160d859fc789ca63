"""kernels_per_decode_step: device kernels queued inside the window's
``model.decode`` ranges (the profiler's trace) over the number of those
ranges: the launches one decode step costs the host."""

from bench import devtrace


def read(ctx):
    if ctx.trace is None:
        return None
    n = len(ctx.trace.ranges.get(devtrace.DECODE, []))
    if n == 0:
        return None
    ops = devtrace.ops_of(ctx.trace, devtrace.DECODE)
    kernels = sum(1 for v in ops.values() for o in v if o.kind == "kernel")
    return kernels / n
