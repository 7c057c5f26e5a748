"""Port parity for the LM's train step (``train.steps.make_train_step``)
at every arch's ``smoke_variant`` in f32 (the two recurrent archs in
``test_torch_train_recurrent.py``): the loss and its parts, the
gradients of every param leaf (the port's autograd against
``jax.value_and_grad(repro.models.lm.lm_loss)``), the grad norm, the
learning rate and the updated state, from one train state
(``models.convert.train_state_from_reference``) and one seeded batch;
tolerances in ``tests/_torch_train.py``."""
import pytest

pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402

from _torch_train import RECURRENT, check_train_step  # noqa: E402


@pytest.mark.parametrize("name", sorted(set(ARCHS) - set(RECURRENT)))
def test_train_step_matches_reference(name):
    check_train_step(name)
