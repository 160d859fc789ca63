"""decode_attn_roofline: the decode attention kernels (``decode_split`` and
``decode_combine``, one call each a layer and step) over the window's
decode steps, against their roofline (each row's query against its valid
keys, those keys read once), in %."""

from bench import devtrace, roofline
from bench.metrics._kernel_share import share


def read(ctx):
    c = ctx.config
    if c["family"] != "moe":
        return None

    def bound(call):
        return roofline.least_seconds(*roofline.decode_attention(
            [max(n, 1) for n in call["lengths"]], c["n_heads"],
            c["n_kv_heads"], c["head_dim"], c.get("sliding_window")))

    return share(ctx, devtrace.DECODE, ("decode_split", "decode_combine"),
                 "decode_split", bound)
