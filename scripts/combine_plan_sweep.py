#!/usr/bin/env python3
"""Every grid of the decode combine kernel beside the one ``combine_plan``
picks, on one NVIDIA GPU.

    python3 scripts/combine_plan_sweep.py

Run from the root of a checkout on a machine with the card and the CUDA
toolkit.  At the merge of 8, 4 and 2 shares (B=128 x Hq=8 rows, D=256,
bf16), gemma-2b's serving decode (B=4, S=1024, 32 splits) and one share of
``decode_32k`` (B=128, 4096 rows, 2 splits), each (chunk, warps) the
kernel takes is run in place of the plan: its output held to the plain
version at the bf16 tolerance, then the combine launch's device time by
kernel name (``torch.profiler``, 50 calls, inputs warm in L2).  One line a
shape: the plan, the six fastest grids and the two slowest.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as c  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

da = c.da
PLAN = da.combine_plan


def combine_ms(fn) -> float:
    r = c._profile(fn, 50)
    return sum(v for k, v in r["by_name"].items() if "decode_combine" in k)


def sweep(tag, rows, n, d, itemsize, fn, want, smi) -> None:
    nv = d * itemsize // da.VEC_BYTES
    res = []
    try:
        for chunk in (32, 16, 8, 4, 2, 1):
            if nv % chunk:
                continue
            for warps in (4, 2, 1):
                grid = dict(chunk=chunk, warps=warps,
                            blocks=-(-rows * (nv // chunk) // warps))
                da.combine_plan = lambda *a, **k: grid
                c._check(f"{tag} {grid}", fn(), want,
                         c.TOL[torch.bfloat16])
                res.append((combine_ms(fn), chunk, warps, grid["blocks"]))
    finally:
        da.combine_plan = PLAN
    res.sort()
    c.log(f"combine grids, {tag}: plan {PLAN(rows, n, d, itemsize)}; "
          "fastest " + "; ".join(f"chunk {ch} warps {w} ({b} blocks) "
                                 f"{ms:.5f} ms" for ms, ch, w, b in res[:6])
          + "; slowest " + "; ".join(f"chunk {ch} warps {w} {ms:.5f} ms"
                                     for ms, ch, w, _ in res[-2:])
          + f" [{smi}]")


def main() -> int:
    c._build.build_all(("decode_attention",))
    smi = c.card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, hq, d = c.TP_DECODE[0], c.HQ, c.HD
    for r in (8, 4, 2):
        outs = c._randn((b, hq, r, d), torch.bfloat16, gen)
        lses = torch.randn((b, hq, r), generator=gen, device="cuda")
        sweep(f"merge of {r} shares B={b} Hq={hq} D={d}", b * hq, r, d, 2,
              lambda: da.merge(outs, lses), ref.decode_merge(outs, lses),
              smi)
    lens = c.DECODE_LENS[0][0]
    args, lt = c.decode_case(c.MAX_BATCH, c.MAX_LEN, hq, c.HKV, d,
                             torch.bfloat16, lens, 500)
    ns = da.split_plan(c.MAX_BATCH, c.HKV, c.MAX_LEN, None)
    sweep(f"gemma-2b serving decode lens={lens} ({ns} splits)",
          c.MAX_BATCH * hq, ns, d, 4, lambda: da.decode_attention(*args, lt),
          ref.decode_attention_naive(*args, lt), smi)
    s = c.TP_DECODE[1]
    m = s // c.TP_SHARES
    q = c._randn((b, 1, hq, d), torch.bfloat16, gen)
    ks = c._randn((b, m, c.HKV, d), torch.bfloat16, gen)
    vs = c._randn((b, m, c.HKV, d), torch.bfloat16, gen)
    full = torch.full((b,), s, dtype=torch.int32, device="cuda")
    ns = da.split_plan(b, c.HKV, m, None)
    sweep(f"one share of decode_32k ({ns} splits)", b * hq, ns, d, 4,
          lambda: da.decode_attention(q, ks, vs, full, k_offset=s - m),
          ref.decode_attention_naive(q, ks, vs, full, k_offset=s - m), smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
