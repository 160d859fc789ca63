#!/usr/bin/env python3
"""The tensor-parallel serving phase of ``chip_smoke.py`` on one NVIDIA GPU,
and its world-1 decode step set beside another checkout's.

    python3 scripts/tp_serving_ab.py OTHER_CHECKOUT

Run from the root of a checkout on a machine with the card and the CUDA
toolkit.  Four processes, one after another, each building the kernels of
its own checkout: ``chip_smoke.tp_world_one`` of OTHER_CHECKOUT, this
checkout's whole ``chip_smoke.tp_serving_phase``, ``tp_world_one`` of this
checkout, then of OTHER_CHECKOUT again, so that the host's drift between
runs falls on both alike.  Each prints its lines (the sharded decode
step's median ms beside the unsharded one's); the exit code is the worst
of the four.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

WORLD_ONE = ("import chip_smoke as c; c._build.build_all(); smi = c.card()\n"
             "with c.world_one() as mesh:\n    c.tp_world_one(mesh, smi)\n")
PHASE = ("import chip_smoke as c; c._build.build_all(); smi = c.card()\n"
         "c.tp_serving_phase(smi)\n")


def run(tag: str, tree: str, code: str) -> int:
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
    other, here = os.path.abspath(sys.argv[1]), os.getcwd()
    return max(run("other, world 1", other, WORLD_ONE),
               run("this, the phase", here, PHASE),
               run("this, world 1", here, WORLD_ONE),
               run("other, world 1", other, WORLD_ONE))


if __name__ == "__main__":
    sys.exit(main())
