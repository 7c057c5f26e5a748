"""Port parity for the LM's train step at the two recurrent archs'
``smoke_variant``: recurrentgemma (a 19-block pattern of RG-LRU and
local-attention blocks) and xLSTM (mLSTM / sLSTM).  Their reference
gradients take the longest compiles of the ten archs, so they have a
file of their own (``tests/test_torch_train_step.py`` holds the other
eight)."""
import pytest

pytest.importorskip("torch")

from _torch_train import RECURRENT, check_train_step  # noqa: E402


@pytest.mark.parametrize("name", RECURRENT)
def test_train_step_matches_reference(name):
    check_train_step(name)
