"""hybrid_moe_mfu: the useful model FLOPs of the prefills and decode steps
in the traced part of the window (``bench/roofline_hybrid_moe.py``: each
layer by its mixer, the routed top-k and the shared expert, the SSD
recurrence, attention over the attended keys on the attention layers, the
head where logits are computed) over that part's seconds times the bf16
peak, in %: the whole step's share of the card's peak."""

from bench import roofline, roofline_hybrid_moe as rh


def read(ctx):
    if ctx.trace is None or ctx.config["family"] != "hybrid_moe":
        return None
    flops = 0.0
    for c in ctx.calls:
        if c["kind"] == "prefill":
            flops += rh.prefill_flops(ctx.config, c["tokens"])
        else:
            flops += rh.decode_flops(ctx.config, c["lengths"])
    if flops <= 0:
        return None
    return 100.0 * flops / (ctx.window_s * roofline.PEAK_BF16)
