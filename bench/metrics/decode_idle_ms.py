"""decode_idle_ms: the median, over the engine's ``engine.decode`` spans in
the traced window, of the span's length minus the union of the device
ops' intervals inside it (the profiler's trace, on the spans' clock): the
time the device waits on the host within one decode step, in ms."""

import statistics

from bench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    idle = spans.decode_idle(ctx.trace, spans.program_spans(ctx.events))
    return 1e3 * statistics.median(idle) if idle else None
