"""ssd_roofline: the SSD intra-chunk kernel (``ssd_intra_chunk_kernel``, one
call a layer and prompt) over the window's prefills, against its roofline
(3xTF32 products at the TF32 peak, fp32 operands once), in %."""

from bench import devtrace, roofline
from bench.metrics._kernel_share import share


def read(ctx):
    c = ctx.config
    if c["family"] != "ssm":
        return None
    s = c["ssm"]
    nh = s["expand"] * c["d_model"] // s["head_dim"]

    def bound(call):
        return roofline.least_seconds(
            *roofline.ssd_intra_chunk(call["tokens"], nh, s["head_dim"],
                                      s["d_state"], s["chunk"]),
            roofline.PEAK_TF32)

    return share(ctx, devtrace.PREFILL, ("ssd_intra_chunk_kernel",),
                 "ssd_intra_chunk_kernel", bound)
