"""One train step of the small detector, port against the JAX package on
the CPU in f32, for the analog mode ('none') x embedding {count, arsnn},
norm on for one embedding and off for the other, and a patan (ASGL)
step; 'backbone' is ``tests/test_torch_variants_train_backbone.py``, the
spiking-neck modes ``tests/test_torch_variants_train_spiking*.py``.
Weights, events and the tolerances: ``tests/test_torch_variants_model.py``."""

import pytest
import torch

from eas_snn_tpu_torch.models.blocks import PLIF

from test_torch_variants_model import case_seed, check_train, pair

# each mode with norm on and off, each embedding with norm on and off
# ('backbone' in test_torch_variants_train_backbone.py)
CASES = [("none", "count", "bn"), ("none", "arsnn", None)]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def check_train_case(mode, embedding, norm):
    """Loss terms and every gradient of one train step
    (``check_train``); the post-embedding BN gets its gradient."""
    jm, pm, v, ev, lab = pair(mode, embedding,
                              case_seed(mode, embedding, norm), norm=norm)
    params = check_train(mode, jm, pm, v, ev, lab)
    if norm:
        assert float(params["emb_bn.weight"].grad.abs().max()) > 0


@pytest.mark.parametrize("mode,embedding,norm", CASES)
def test_detector_train_step_matches_jax(mode, embedding, norm):
    check_train_case(mode, embedding, norm)


def test_patan_train_step_matches_jax():
    """patan (ASGL) at granularity 'channel', p = 0, in the fully spiking
    detector with the count embedding: every spiking site trains through
    the plain scan with its learnable (C,) alpha, on both sides, and
    every alpha gets its gradient (``check_train``'s tolerances)."""
    jm, pm, v, ev, lab = pair("full_v2", "count", 40, spike_fn="patan",
                              alpha_granularity="channel")
    sites = [m for m in pm.modules() if isinstance(m, PLIF)]
    assert sites and all(m.asgl_alpha.shape == (m.w.new_empty(0).shape[0]
                                                or m.asgl_alpha.shape[0],)
                         for m in sites)
    params = check_train("full_v2", jm, pm, v, ev, lab)
    alphas = [n for n in params if n.endswith("asgl_alpha")]
    assert len(alphas) == len(sites)
    assert all(float(params[n].grad.abs().max()) > 0 for n in alphas)
