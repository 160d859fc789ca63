"""flash_roofline: the bf16 flash attention kernel (``flash_bf16``) over the
window's prefills, against its roofline (one prompt a call: QK^T and PV over
the causal pairs, q, k, v and o once), in %."""

from bench import devtrace, roofline
from bench.metrics._kernel_share import share


def read(ctx):
    c = ctx.config
    if c["family"] != "moe":
        return None

    def bound(call):
        return roofline.least_seconds(*roofline.flash_prefill(
            call["tokens"], c["n_heads"], c["n_kv_heads"], c["head_dim"],
            c.get("sliding_window")))

    return share(ctx, devtrace.PREFILL, ("flash_bf16",), "flash_bf16",
                 bound)
