"""Each cell end to end on the card, at a reduced size and a short window:
the run is correct and reports every metric its cell lists.  Marked
``gpu``; skips where there is no CUDA card:

    python -m pytest -q -m gpu erbench/tests/test_erbench_gpu.py
"""
import pytest

torch = pytest.importorskip("torch")

from erbench import harness  # noqa: E402

CELLS = [w["name"] for w in harness.spec()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell, trace):
    bench = harness.spec()
    out = harness.run(cell, 2**31 + 17, 1.0, trace, n=60_000)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    group = "per_layer" if trace else "end_to_end"
    for m in harness.metrics_of(cell, group, bench):
        assert m["name"] in out["metrics"], m["name"]
    if trace:
        assert 0 < out["device"]["busy_s"] < out["device"]["window_s"]
