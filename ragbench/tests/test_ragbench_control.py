"""The control: the reference computed in float8, put in the program's
place, fails a cell's limits, while the program passes them.  At a size a
CPU test run holds (the published depth, a small corpus); on the card the
same readings come from ``python3 -m ragbench.calibrate`` at the cell's
own size (PERF.md gives them)."""

import pytest

from ragbench.tests._small import run_small, small_cell


@pytest.mark.parametrize("cell", ["trec-covid.hybrid", "trec-covid.ingest"])
def test_control_fails_the_limits(cell):
    c = small_cell(cell, layers=None)
    res = run_small(c, seconds=1.0, control=True)
    prog, ctrl = res["readings"]["program"], res["readings"]["control"]
    assert all(prog[n] <= lim for n, lim in c.limits.items()), prog
    assert any(ctrl[n] > lim for n, lim in c.limits.items()), ctrl
