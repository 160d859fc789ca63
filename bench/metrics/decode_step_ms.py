"""decode_step_ms: the median wall time of the engine's decode steps in the
window (``ServingEngine.decode_seconds``, each ended by a device
synchronisation), in ms."""

import statistics


def read(ctx):
    if not ctx.decode_seconds:
        return None
    return 1e3 * statistics.median(ctx.decode_seconds)
