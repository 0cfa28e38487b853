"""The eval forward of the small detector with a spiking neck ('full')
and head ('full_v2') x embedding {count, arsnn} x norm, port against the
JAX package on the CPU in f32. Weights, events and the tolerance:
``tests/test_torch_variants_model.py``."""

import pytest
import torch

from test_torch_variants_model import check_eval_case


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("norm", [None, "bn"], ids=["plain", "norm"])
@pytest.mark.parametrize("embedding", ["count", "arsnn"])
@pytest.mark.parametrize("mode", ["full", "full_v2"])
def test_spiking_neck_eval_matches_jax(mode, embedding, norm):
    """A spiking neck's and head's spike trains reach the decoded
    outputs (``check_eval_case``)."""
    check_eval_case(mode, embedding, norm)
