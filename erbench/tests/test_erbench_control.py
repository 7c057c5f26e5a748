"""The control of ``correct`` (the reference in bfloat16, put in the
program's place) comes out not correct under each cell's limits, at a
size a test run holds: 200,000 records, where it reads about a seventh
of what it reads at the cells' 1.4M.  The runs on the card at full size
are ``erbench/control.py``'s (PERF.md gives their readings)."""
import pytest

from erbench import harness
from erbench.control import control

CELLS = [w["name"] for w in harness.spec()["workloads"]]


@pytest.mark.parametrize("seed", [1, 2**31 + 3, 2**40 + 5])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, seed):
    checks = control(cell, seed, n=200_000)
    assert any(v > lim for v, lim in checks.values()), checks
