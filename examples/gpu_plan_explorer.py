"""GPU-tier HiDP planning on the PyTorch port: the tier-2 DSE (the P1–P9
analogue) for any (arch × shape) cell on one 8-GPU H100 host, or two of them
over the network (``--multi-node``): which layouts were considered, their
predicted three-term roofline costs on the H100, and what the planner
picked.

    PYTHONPATH=src python examples/gpu_plan_explorer.py --arch qwen3-moe-30b-a3b --shape train_4k [--multi-node]

It runs on the host and needs no GPU; it imports neither jax nor the JAX
package.  The candidates are those of the global mode the planner chose
(data or model across hosts).
"""

import argparse

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import SHAPES, build_model
from repro_torch.sharding.plan import (GPU_MULTI_NODE, GPU_NODE, H100,
                                       _candidate_cost, _enumerate_candidates,
                                       plan_gpu)

SHOWN = 12
HEADER = (f"{'layout':22s}{'micro':>6s}{'rg':>4s}{'opt':>5s}{'par':>5s}"
          f"{'compute':>9s}{'memory':>9s}{'coll':>9s}{'resident':>10s}"
          f"{'fits':>6s}")


def candidate_rows(model, shape, mesh, global_mode) -> list:
    """Every candidate with its predicted cost on the H100, cheapest first
    (a candidate that does not fit costs infinity)."""
    rows = [(c, _candidate_cost(model, shape, c, mesh, H100))
            for c in _enumerate_candidates(model.cfg, shape, mesh,
                                           global_mode)]
    rows.sort(key=lambda rc: rc[1]["total"])
    return rows


def shown_rows(rows) -> list:
    """The first ``SHOWN`` rows, one per (layout, MoE lowering)."""
    seen, out = set(), []
    for c, cost in rows:
        key = (c["name"], c["moe_impl"])
        if key in seen or len(out) >= SHOWN:
            continue
        seen.add(key)
        out.append((c, cost))
    return out


def row_line(c, cost) -> str:
    return (f"{c['name']:22s}{c['microbatches']:6d}"
            f"{c.get('remat_group', 1):4d}"
            f"{c.get('opt_dtype', 'f32')[:4]:>5s}"
            f"{c.get('param_dtype', 'f32')[:4]:>5s}"
            f"{cost['compute']:9.3g}{cost['memory']:9.3g}"
            f"{cost['collective']:9.3g}{cost['resident'] / 1e9:9.1f}G"
            f"{'  ✓' if cost['fits'] else '  ✗'}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b", choices=ARCH_IDS)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--multi-node", action="store_true")
    args = ap.parse_args(argv)

    mesh = GPU_MULTI_NODE if args.multi_node else GPU_NODE
    model = build_model(get_config(args.arch))
    shape = SHAPES[args.shape]
    plan = plan_gpu(model, shape, mesh)
    rows = candidate_rows(model, shape, mesh, plan.global_mode)

    print(f"{args.arch} × {args.shape} on H100 {mesh.shape} — tier-2 DSE "
          f"({len(rows)} candidates in global {plan.global_mode} mode, top "
          f"{SHOWN} by predicted step time):\n")
    print(HEADER)
    for c, cost in shown_rows(rows):
        print(row_line(c, cost))
    fits = sum(cost["fits"] for _, cost in rows)
    print(f"\n{fits} of {len(rows)} candidates fit "
          f"{H100.hbm_per_chip * 0.92 / 1e9:.1f} GB a GPU"
          + ("" if fits else "; none does, so the least resident is "
             "picked"))
    print(f"HiDP picked: {plan.local_layout} (global {plan.global_mode} "
          f"mode, micro={plan.microbatches}, "
          f"remat_group={plan.remat_group}, opt={plan.opt_dtype}, "
          f"params={plan.param_dtype}, moe={plan.moe_impl})")
    print(f"planning took {plan.planning_seconds * 1e3:.1f} ms")


if __name__ == "__main__":
    main()
