"""mfu: the useful model FLOPs of the prefills and decode steps in the
traced part of the window (``bench/roofline.py``: the routed top-k experts only,
attention over the attended keys, the head where logits are computed) over
that part's seconds times the bf16 peak, in %."""

from bench import roofline


def read(ctx):
    if ctx.trace is None:
        return None
    flops = 0.0
    for c in ctx.calls:
        if c["kind"] == "prefill":
            flops += roofline.prefill_flops(ctx.config, c["tokens"])
        else:
            flops += roofline.decode_flops(ctx.config, c["lengths"])
    if flops <= 0:
        return None
    return 100.0 * flops / (ctx.window_s * roofline.PEAK_BF16)
