#!/usr/bin/env python3
"""A benchmark run of a cell with the MoE lowering's calls counted:

    python3 scripts/moe_routed_check.py --workload <cell> --seed <n> --seconds <s> --trace <0|1> [--out FILE]

from the root of a checkout, on a machine with the card.  ``--trace 0`` is
``bench/run.py``'s run, ``--trace 1`` ``bench/program_spans.py``'s (the
traced run and the program-span table; ``--out`` as there).  Around it,
every ``Model.apply_prefill`` and ``apply_decode`` call is counted: the
step at an EP axis of width 1 (``moe_ep.calls``) must have run once per MoE
layer of each, and every ``layer.moe`` span a recorder received must name
the "routed" lowering.  Prints the run's output, then one ``moe routed
check`` JSON line on standard error; exits 1 where a check fails."""

from __future__ import annotations

import json
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def counted(fn) -> tuple[object, dict]:
    """``fn()``'s result, and the check of the MoE layers' calls made
    under it."""
    from repro_torch.models import moe_ep
    from repro_torch.models.model import Model
    calls: Counter = Counter()
    recorders: dict[int, object] = {}
    real = {n: getattr(Model, n) for n in ("apply_prefill", "apply_decode")}

    def counting(name):
        def call(self, *args, **kw):
            calls[name] += 1
            calls["moe_layers"] += self.cfg.n_layers if self.cfg.moe else 0
            rec = kw.get("telemetry")
            if rec is not None:
                recorders[id(rec)] = rec
            return real[name](self, *args, **kw)
        return call

    c0 = moe_ep.calls
    for name in real:
        setattr(Model, name, counting(name))
    try:
        out = fn()
    finally:
        for name, f in real.items():
            setattr(Model, name, f)
    impls = Counter(e.attrs.get("impl") for r in recorders.values()
                    for e in r.events
                    if e.kind == "span" and e.name == "layer.moe")
    check = {"prefill_calls": calls["apply_prefill"],
             "decode_calls": calls["apply_decode"],
             "moe_layer_calls": calls["moe_layers"],
             "width_one_calls": moe_ep.calls - c0,
             "layer_moe_spans": dict(impls)}
    check["ok"] = (check["width_one_calls"] == check["moe_layer_calls"] > 0
                   and set(impls) <= {"routed"})
    return out, check


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    from bench import program_spans
    from bench import run as bench_run
    common = ["--workload", args.workload, "--seed", str(args.seed),
              "--seconds", str(args.seconds)]
    if args.trace:
        out = common + ([] if args.out is None else ["--out", str(args.out)])
        rc, check = counted(lambda: program_spans.main(out))
    else:
        rc, check = counted(lambda: bench_run.main(common + ["--trace", "0"]))
    bench_run.log("moe routed check " + json.dumps(check))
    return rc or (0 if check["ok"] else 1)


if __name__ == "__main__":
    sys.exit(main())
