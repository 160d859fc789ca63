"""``examples/gpu_plan_explorer.py``, the port's counterpart of
``examples/tpu_plan_explorer.py``, run as a user runs it (a subprocess) for
qwen3-moe-30b-a3b x ``train_4k`` on one 8-GPU H100 host and on two: it
prints the plan that ``plan_gpu`` picks, and its candidate table is the one
the port's ``sharding/plan.py`` gives (``_enumerate_candidates`` in the
picked global mode, ``_candidate_cost`` on the H100, cheapest first, one row
per layout and MoE lowering, at most twelve), to the digits it prints."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import SHAPES, build_model  # noqa: E402
from repro_torch.sharding.plan import (GPU_MULTI_NODE, GPU_NODE,  # noqa: E402
                                       H100, _candidate_cost,
                                       _enumerate_candidates, plan_gpu)

ROOT = Path(__file__).resolve().parents[1]
ARCH, SHAPE = "qwen3-moe-30b-a3b", "train_4k"
ROWS = 12


def _run(*args) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "gpu_plan_explorer.py"),
         "--arch", ARCH, "--shape", SHAPE, *args], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


def _expected(mesh):
    """(the picked plan, the table's rows) from the port's functions."""
    model = build_model(get_config(ARCH))
    shape = SHAPES[SHAPE]
    plan = plan_gpu(model, shape, mesh)
    rows = sorted(((c, _candidate_cost(model, shape, c, mesh, H100))
                   for c in _enumerate_candidates(model.cfg, shape, mesh,
                                                  plan.global_mode)),
                  key=lambda rc: rc[1]["total"])
    table, seen = [], set()
    for c, cost in rows:
        if (c["name"], c["moe_impl"]) not in seen and len(table) < ROWS:
            seen.add((c["name"], c["moe_impl"]))
            table.append((c, cost))
    return plan, table, len(rows), sum(cost["fits"] for _, cost in rows)


def _g3(x: float) -> float:
    return float(f"{x:.3g}")


@pytest.mark.parametrize("mesh,args", [(GPU_NODE, ()),
                                       (GPU_MULTI_NODE, ("--multi-node",))],
                         ids=["one-host", "two-hosts"])
def test_explorer_prints_the_ports_candidates_and_plan(mesh, args):
    out = _run(*args).splitlines()
    plan, table, n, fits = _expected(mesh)
    assert out[0].startswith(f"{ARCH} × {SHAPE} on H100 {mesh.shape} ")
    assert f"({n} candidates in global {plan.global_mode} mode" in out[0]
    start = next(i for i, line in enumerate(out)
                 if line.startswith("layout")) + 1
    printed = out[start:out.index("", start)]
    assert len(printed) == len(table) > 0
    for line, (c, cost) in zip(printed, table):
        name, micro, rg, opt, par, comp, mem, coll, res, mark = line.split()
        assert (name, int(micro), int(rg), opt, par) == (
            c["name"], c["microbatches"], c["remat_group"],
            c["opt_dtype"][:4], c["param_dtype"][:4])
        assert (float(comp), float(mem), float(coll)) == (
            _g3(cost["compute"]), _g3(cost["memory"]),
            _g3(cost["collective"]))
        assert res == f"{cost['resident'] / 1e9:.1f}G"
        assert mark == ("✓" if cost["fits"] else "✗")
    assert any(line.startswith(f"{fits} of {n} candidates fit")
               for line in out)
    picked = next(line for line in out if line.startswith("HiDP picked: "))
    assert picked == (
        f"HiDP picked: {plan.local_layout} (global {plan.global_mode} mode, "
        f"micro={plan.microbatches}, remat_group={plan.remat_group}, "
        f"opt={plan.opt_dtype}, params={plan.param_dtype}, "
        f"moe={plan.moe_impl})")
