"""The lower precision control at a size a test run holds: the plain
reference computed with every product in fp8, its first choices read at
the positions of a tiny run's served tokens and judged in the program's
place, comes out not correct, where the program's own tokens, judged by
the same limits, come out correct (the mean gap over the served tokens
separates the two at this size).  On
the chip, at the cells' own sizes, the same reading is ``python3
bench/control.py --workload <cell> --seed <n> --seconds <s>``; PERF.md
gives the readings each cell's limit was set from."""

import pytest

from bench import spec
from bench.tests import _tiny


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]]
                         + [_tiny.SSM_CELL])
def test_control_is_not_correct(cell):
    """The harness itself judges the control's tokens in the program's
    place, by the limits the program's own tokens keep."""
    assert _tiny.run(cell, seed=11)["correct"]
    r = _tiny.run(cell, seed=11, control=True)
    assert not r["correct"], r["compared"]
    assert any(c["value"] > c["limit"] for c in r["compared"].values())
