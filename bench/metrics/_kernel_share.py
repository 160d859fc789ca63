"""The share of its roofline that one kernel reaches over the window:
the sum of each launch's least time (``bench/roofline.py``, from the call's
shapes) over the sum of the launches' device times in the profiler's
trace, in %.  Launches are tied to the model call that queued them, whose
sizes the pass-through model logged over the traced part of the
window."""

from bench import devtrace


def share(ctx, range_name: str, kinds: tuple, count_kind: str, bound):
    """``kinds``: name fragments of the kernel's launches; ``count_kind``
    the fragment of the launch that counts one call; ``bound(call)`` a
    call's least seconds, or None where the call is not the kernel's."""
    if ctx.trace is None:
        return None
    calls = [c for c in ctx.calls
             if c["kind"] == range_name.split(".")[1]]
    ops = devtrace.ops_of(ctx.trace, range_name)
    if len(ctx.trace.ranges.get(range_name, [])) != len(calls):
        return None
    least = spent = 0.0
    for i, c in enumerate(calls):
        mine = [o for o in ops.get(i, [])
                if o.kind == "kernel" and any(k in o.name for k in kinds)]
        n = sum(1 for o in mine if count_kind in o.name)
        b = bound(c)
        if n == 0 or b is None:
            continue
        least += n * b
        spent += sum(o.end - o.start for o in mine) / 1e9
    if spent <= 0:
        return None
    return 100.0 * least / spent
