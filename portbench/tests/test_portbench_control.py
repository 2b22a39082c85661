"""On the card, at each cell's own size: the control (the reference in
the precision below the configuration's, put in the program's place)
comes out not correct on three seeds, and the program correct.

    python -m pytest portbench/tests -q -m card
"""

import pytest

from portbench import calibrate, harness, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, cuda):
    lim = spec.limits(cell)
    rows = calibrate.calibrate(cell, [7001, 7002, 7003], 1,
                               [lim["control"]], 3, "cuda",
                               emit=lambda s: None)
    for r in rows:
        ok, checks = harness.judge(r["program"], lim)
        assert ok, (r["seed"], checks)
        bad, checks = harness.judge(r[lim["control"]], lim)
        assert not bad, (r["seed"], checks)
