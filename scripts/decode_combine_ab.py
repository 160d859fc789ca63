#!/usr/bin/env python3
"""Decode's two launches and the merge on one NVIDIA GPU, this checkout's
kernels set beside another checkout's.

    python3 scripts/decode_combine_ab.py OTHER_CHECKOUT

Run from the root of a checkout on a machine with the card and the CUDA
toolkit.  Four processes, one after another, each building the decode
kernels of its own checkout: OTHER_CHECKOUT, this checkout twice, then
OTHER_CHECKOUT again, so that drift between runs falls on both alike.
Each runs the source of this checkout's ``chip_smoke.decode_launch_times``
inside its own checkout's ``chip_smoke`` (so the measurement is the same
code on both sides, and only the kernels differ): the split and combine
launches by kernel name and the whole decode call's device time at
gemma-2b's serving decode shape and at one share of ``decode_32k``, and
the merge's at 2, 4 and 8 ranks beside its bound.  Each also saves the
decode call's output and LSE, in bf16 and fp32, at the split counts 2, 9,
32 and 128, and the merge of 1, 2, 4 and 8 ranks with empty ones; the
four runs' outputs must be equal bit for bit.  The exit code is the worst
of the four, and 1 where any output differs.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# the decode call at (B, S, Hkv, D, lengths), Hq = 8, whose split_plan gives
# 2, 9, 32 and 128 splits, and the merge of 1, 2, 4 and 8 ranks of B=128 x
# Hq=8 rows, a quarter of the ranks empty; outputs saved to the given path
OUTPUTS = """
import numpy as np
import torch


def outputs(c, path):
    da, out = c.da, {}
    lens128 = np.random.default_rng(2900).integers(0, 257, 128).tolist()
    for tag, (b, s, hkv, d, lens) in {
            "2 splits": (128, 256, 1, 256, lens128),
            "9 splits": (4, 1024, 4, 128, [0, 197, 572, 873]),
            "32 splits": (4, 1024, 1, 256, [544, 400, 256, 96]),
            "128 splits": (1, 4096, 1, 64, [1000])}.items():
        for dt in (torch.float32, torch.bfloat16):
            args, lt = c.decode_case(b, s, 8, hkv, d, dt, lens, 2901)
            o, lse = da.decode_attention(*args, lt, return_lse=True)
            out[f"decode {tag} {dt}"] = (o.cpu(), lse.cpu())
    gen = torch.Generator(device="cuda").manual_seed(2902)
    for r in (1, 2, 4, 8):
        for dt in (torch.float32, torch.bfloat16):
            outs = c._randn((128, 8, r, 256), dt, gen)
            lses = 3 * torch.randn((128, 8, r), generator=gen, device="cuda")
            empty = torch.rand((128, 8, r), generator=gen,
                               device="cuda") < 0.25
            lses[empty] = -1e30
            outs[empty] = 0
            out[f"merge {r} {dt}"] = da.merge(outs, lses).cpu()
    torch.save(out, path)
"""


def measurement() -> str:
    """The source of this checkout's ``chip_smoke.decode_launch_times``."""
    text = (HERE / "chip_smoke.py").read_text()
    for node in ast.parse(text).body:
        if isinstance(node, ast.FunctionDef) and \
                node.name == "decode_launch_times":
            return ast.get_source_segment(text, node)
    raise SystemExit("chip_smoke.py has no decode_launch_times")


def run(tag: str, tree: Path, source: str, path: Path) -> int:
    code = ("import chip_smoke as c\n"
            "c._build.build_all(('decode_attention',))\n"
            f"exec({source!r}, vars(c))\n"
            "c.decode_launch_times(c.card())\n"
            f"exec({OUTPUTS!r})\n"
            f"outputs(c, {str(path)!r})\n")
    env = dict(os.environ, PYTHONPATH=f"{tree}/src:{tree}")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], cwd=tree, env=env,
                       capture_output=True, text=True, timeout=600)
    print(f"=== {tag} ({tree}): exit {r.returncode}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(r.stdout[-5000:], flush=True)
    if r.returncode:
        print(r.stderr[-4000:], flush=True)
    return r.returncode


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    other = Path(sys.argv[1]).resolve()
    source = measurement()
    with tempfile.TemporaryDirectory() as tmp:
        runs = [("other", other), ("this", HERE), ("this", HERE),
                ("other", other)]
        paths = [Path(tmp) / f"{i}.pt" for i in range(len(runs))]
        rc = max(run(tag, tree, source, path)
                 for (tag, tree), path in zip(runs, paths))
        if rc:
            return rc
        def bits(v):
            return [x.view(torch.uint8) for x in
                    (v if isinstance(v, tuple) else (v,))]

        first = torch.load(paths[0])
        for (tag, _), path in zip(runs[1:], paths[1:]):
            got = torch.load(path)
            differ = [k for k in first if not all(
                torch.equal(x, y) for x, y in zip(bits(first[k]),
                                                  bits(got[k])))]
            if differ:
                print(f"outputs of {tag} differ from the first run's: "
                      f"{differ}", flush=True)
                return 1
        print(f"outputs: {len(first)} cases equal bit for bit in all four "
              "runs", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
