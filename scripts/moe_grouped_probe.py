#!/usr/bin/env python3
"""The routed MoE step's grouped products at mixtral-8x7b's widths, beside
their bound and beside the dense lowering's batched matmuls, on one NVIDIA
GPU:

    python3 scripts/moe_grouped_probe.py

Run from the root of a checkout on a machine with the card.  One
full-width layer (d 4096, 8 experts of 14336, top-2; N(0, 1/fan_in) bf16
weights) at prompts of T = 256, 1024 and 4096 tokens (2·T rows) and a
decode step of 256 rows (512 rows).  For each: one ``torch._grouped_mm``
gate product (rows, 4096) x (8, 4096, 14336) and down product
(rows, 14336) x (8, 14336, 4096) over balanced groups, and the dense
lowering's batched matmul of the same product over every token and expert
(``moe_dense``'s ``torch.matmul`` of (1, T, d) against the stack); then
the whole layer both ways (``moe_ep.moe_routed``, ``layers.moe_dense``) on
its router's routing.  Device ms by the profiler (``chip_smoke._profile``,
20 calls in a row; a stack is 0.94 GB, far past L2), each beside its bound:
the larger of its operations at 989 TFLOP/s and its bytes (the weights,
the rows in and out, each once) at 3.35 TB/s.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as c  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe_ep  # noqa: E402

REPS = 20
# (tag, B, T)
CASES = (("prefill T=256", 1, 256), ("prefill T=1024", 1, 1024),
         ("prefill T=4096", 1, 4096), ("decode B=256", 256, 1))


def timed(tag: str, what: str, fn, flops: float, nbytes: float,
          smi: str) -> float:
    fn()                                      # warm: handles, heuristics
    r = c._profile(fn, REPS)
    bound, by = c._bound(flops, nbytes)
    ms = float("nan") if r is None else r["device_ms"]
    c.log(f"moe probe {tag} {what}: {ms:.4f} ms on the device, bound "
          f"{bound:.4f} ms ({by}: {flops / 1e9:.1f} GFLOP, "
          f"{nbytes / 1e9:.3f} GB), {ms / bound:.2f}x; host "
          f"{float('nan') if r is None else r['wall_ms']:.3f} ms a call "
          f"under the profiler [{smi}]")
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        c.log("the probe needs an NVIDIA GPU")
        return 2
    smi = c.card()
    cfg = get_config("mixtral-8x7b")
    m = cfg.moe
    d, e, f, k = cfg.d_model, m.num_experts, m.d_ff_expert, m.top_k
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).bfloat16()
    p = {"router": randn(d, e, scale=d ** -0.5),
         "w_gate": randn(e, d, f, scale=d ** -0.5),
         "w_up": randn(e, d, f, scale=d ** -0.5),
         "w_down": randn(e, f, d, scale=f ** -0.5)}
    w_bytes = e * d * f * 2                   # one stack in bf16
    for tag, b, t in CASES:
        tokens = b * t
        rows = tokens * k
        offs = (torch.arange(1, e + 1, device="cuda", dtype=torch.int32)
                * (rows // e))
        xs, hs = randn(rows, d), randn(rows, f)
        xd, hd = randn(1, tokens, d), randn(e, tokens, f)
        timed(tag, f"grouped gate ({rows} rows)",
              lambda: torch._grouped_mm(xs, p["w_gate"], offs=offs),
              2.0 * rows * d * f, w_bytes + 2.0 * rows * (d + f), smi)
        timed(tag, f"grouped down ({rows} rows)",
              lambda: torch._grouped_mm(hs, p["w_down"], offs=offs),
              2.0 * rows * d * f, w_bytes + 2.0 * rows * (d + f), smi)
        timed(tag, f"dense gate ({e} x {tokens} rows)",
              lambda: torch.matmul(xd, p["w_gate"]),
              2.0 * e * tokens * d * f,
              w_bytes + 2.0 * tokens * d + 2.0 * e * tokens * f, smi)
        timed(tag, f"dense down ({e} x {tokens} rows)",
              lambda: torch.matmul(hd, p["w_down"]),
              2.0 * e * tokens * d * f,
              w_bytes + 2.0 * e * tokens * (d + f), smi)
        del xs, hs, xd, hd
        x = randn(b, t, d)
        layer_bytes = 3 * w_bytes + 2 * 2.0 * tokens * d
        timed(tag, "routed layer (moe_routed)",
              lambda: moe_ep.moe_routed(cfg, p, x),
              3 * 2.0 * rows * d * f, layer_bytes, smi)
        timed(tag, "dense layer (moe_dense)",
              lambda: L.moe_dense(cfg, p, x),
              3 * 2.0 * e * tokens * d * f, layer_bytes, smi)
        del x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
