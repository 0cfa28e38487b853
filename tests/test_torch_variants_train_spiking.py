"""One train step of the small detector with a spiking neck ('full'; a
spiking head too, 'full_v2', in ``test_torch_variants_train_spiking_v2.py``)
x embedding {count, arsnn}, norm on for one embedding and off for the
other, port against the JAX package on the CPU in f32. Weights, events
and the tolerances: ``tests/test_torch_variants_model.py``."""

import pytest
import torch

from test_torch_variants_train import check_train_case

CASES = [("full", "count", "bn"), ("full", "arsnn", None)]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("mode,embedding,norm", CASES)
def test_spiking_neck_train_step_matches_jax(mode, embedding, norm):
    """Loss terms and every gradient of one train step
    (``check_train_case``): the neck's (and with 'full_v2' the head's)
    PLIF decays get their gradient through the spike trains."""
    check_train_case(mode, embedding, norm)
