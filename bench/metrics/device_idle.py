"""device_idle: the share of the traced window in which no kernel, copy or
fill ran on the device (one minus the union of their intervals over the
window), in %."""

from bench import devtrace


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - devtrace.busy_s(ctx.trace) / ctx.trace.window_s)
