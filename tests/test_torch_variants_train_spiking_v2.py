"""One train step of the fully spiking small detector ('full_v2': spiking
backbone, neck and head) x embedding {count, arsnn}, norm on for arsnn,
port against the JAX package on the CPU in f32 (``check_train_case``;
weights, events and the tolerances: ``tests/test_torch_variants_model.py``)."""

import pytest
import torch

from test_torch_variants_train import check_train_case


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("embedding,norm", [("count", None),
                                            ("arsnn", "bn")])
def test_full_v2_train_step_matches_jax(embedding, norm):
    check_train_case("full_v2", embedding, norm)
