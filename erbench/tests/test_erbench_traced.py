"""Both cells traced on the CPU at a small size: the run is correct and
its line holds every per-layer metric read from the program's spans."""
import pytest

torch = pytest.importorskip("torch")

from erbench import harness  # noqa: E402

SEED = 2**31 + 99
SIZES = {"pubs-1.4m.resolve": 3000, "pubs-350k.serve": 2000}


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_traced_cell_reports_every_span_metric(cell):
    bench = harness.spec()
    out = harness.run(cell, SEED, 0.5, True, device="cpu", n=SIZES[cell])
    assert out["correct"], out["checks"]
    for m in harness.metrics_of(cell, "per_layer", bench):
        if m["source"] == "program_span":
            assert m["name"] in out["metrics"], m["name"]
