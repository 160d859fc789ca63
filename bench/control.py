#!/usr/bin/env python3
"""The lower precision control of a cell, on the chip at the cell's own
size:

    python3 bench/control.py --workload <cell> --seed <n> --seconds <s> [--trace 0]

runs the cell as ``bench/run.py`` does (``--trace 0``) and, after the
window, judges in the program's place the control's tokens: at the
prompts and served tokens of the same sample, the token that the plain
reference computed with every product in fp8 (one step below the
configuration's bf16) puts first.  The same numbers are compared against
the same limits, so the result line has to read ``"correct": false``; the
program's own readings are printed on standard error beside the
control's.  The limits in ``bench/limits/`` are set between the program's
readings over a dozen seeds and the control's over three or more
(``PERF.md``).  The benchmark's own runs never run the control."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0,), default=0,
                    help="the control runs untraced")
    args = ap.parse_args(argv)
    from bench import spec
    import torch
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        bench_run.log("the control runs on the GPU")
        return 2
    bench_run.report(bench_run.run(cell, args.seed, args.seconds, False,
                                   control=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
