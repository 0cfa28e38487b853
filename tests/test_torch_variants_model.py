"""The whole detector of every ``use_spike`` mode x embedding {count,
arsnn} x post-embedding norm {off, on}, port against the JAX package on
the CPU in f32: the eval outputs from the same drawn weights (the
'full' modes in ``tests/test_torch_variants_model_spiking.py``). One
train step of each mode x embedding (norm on for one embedding, off for
the other) and patan training are ``tests/test_torch_variants_train*.py``.
They share this file's helpers; each file holds a few cases, so that
the test runner spreads them.

The weights are drawn with numpy into the JAX model's variable shapes
(``tests/test_torch_model.py:_random_variables``): the spiking sites' BN
scales (1.5-2.5) make the backbone, the neck and the head fire; the
post-embedding BN, the snn decay and the patan alphas are drawn here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eas_snn_tpu.models import EASYOLOX as JEASYOLOX

from eas_snn_tpu_torch.models import EASYOLOX
from eas_snn_tpu_torch.utils import state_dict_from_jax

from test_torch_model import SMALL, _random_variables
from test_torch_train_step import _labels

MODES = ("none", "backbone", "full", "full_v2")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _variables(jm, ev, rng):
    """Firing variables of ``jm``, with the post-embedding BN near the
    identity, the snn decay at a logit of 0.3 and each patan alpha drawn
    in [1, 3] (the draw of ``_random_variables`` leaves them 0)."""
    v = _random_variables(jm, ev, rng)

    def walk(p):
        for k, t in p.items():
            if isinstance(t, dict):
                walk(t)
            elif k == "alpha":
                p[k] = rng.uniform(1, 3, t.shape).astype(np.float32)
            elif k == "decay":
                p[k] = np.float32(0.3)

    walk(v["params"])
    if "emb_bn" in v["params"]:
        v["params"]["emb_bn"] = dict(
            scale=rng.uniform(0.8, 1.2, 2).astype(np.float32),
            bias=rng.uniform(-0.1, 0.1, 2).astype(np.float32))
        v["batch_stats"]["emb_bn"] = dict(
            mean=rng.uniform(0.0, 0.4, 2).astype(np.float32),
            var=rng.uniform(0.5, 1.5, 2).astype(np.float32))
    # obj and cls biases at 0 so that the decoded scores are not all ~0
    for k in range(3):
        for name in ("obj_pred", "cls_pred"):
            pred = v["params"]["head"][f"{name}{k}"]
            pred["bias"] = np.zeros_like(pred["bias"])
    return v


def pair(mode, embedding, seed, **kw):
    """(JAX model, port model, variables, events, labels) of one case."""
    rng = np.random.default_rng(seed)
    ev = rng.poisson(0.2, (2, 1, 4, 64, 64, 2)).astype(np.float32)
    cfg = dict(SMALL, **kw)
    jm = JEASYOLOX(use_spike=mode, embedding=embedding, **cfg)
    v = _variables(jm, ev, rng)
    pm = EASYOLOX(use_spike=mode, embedding=embedding, **cfg)
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return jm, pm, v, ev, _labels()


def _check_eval(jm, pm, v, ev):
    """Eval outputs, with the tolerance of
    ``test_torch_model.py::test_whole_slice_matches_jax_f32`` (rtol 1e-5,
    atol 1e-4: the spikes agree, the analog sums differ in order)."""
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(ev)))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(ev)).numpy()
    assert got.shape == want.shape == (2, 84, 7)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert (want[..., 4] > 0.05).mean() > 0.1


def _grad_tol(name: str, g: torch.Tensor) -> float:
    """The gradient tolerance: 1e-3 of the tensor's largest magnitude, 3e-3
    for a PLIF decay's scalar. The JAX package against itself, jitted and
    op by op (other fusions, other summation orders), differs by up to
    4e-4 of the largest magnitude in these cases (the deep analog 'none'
    detector with one foreground anchor among them), and the port by as
    much; a decay's scalar gradient is a sum over its whole site that
    cancels to ~1e-2 of its terms' magnitude."""
    return (3e-3 if name.endswith("act.w") else 1e-3) * float(g.abs().max())


def check_train(mode, jm, pm, v, ev, lab):
    """One train step's loss terms (1e-5 relative) and every gradient
    (:func:`_grad_tol`), port against JAX from the same weights. Returns
    the port's parameters by name."""
    def loss_fn(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]}, ev, lab,
                          train=True, mutable=["batch_stats"])
        return out["total_loss"], out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    want = state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    pm.train()
    out = pm(torch.from_numpy(ev), torch.from_numpy(lab))
    out["total_loss"].backward()
    for k, x in jout.items():
        np.testing.assert_allclose(float(out[k].detach()), float(x),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(out["num_fg"]) > 0
    params = dict(pm.named_parameters())
    assert set(params) == set(want)
    for name, g in want.items():
        p = params[name]
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), rtol=0,
                                   atol=_grad_tol(name, g) + 1e-12,
                                   err_msg=name)
    spiking = [n for n in params if n.endswith("act.w")]
    necks = [n for n in spiking if n.startswith("backbone.")
             and not n.startswith("backbone.backbone.")]
    heads = [n for n in spiking if n.startswith("head.")]
    assert (len(necks) > 0) == (mode in ("full", "full_v2"))
    assert (len(heads) > 0) == (mode == "full_v2")
    # the gradient reaches the spiking neck's and head's decays (a site
    # that never fires here has none, on both sides)
    for group in (necks, heads):
        assert not group or any(float(params[n].grad.abs()) > 0
                                for n in group)
    return params


def case_seed(mode: str, embedding: str, norm) -> int:
    return MODES.index(mode) * 4 + (embedding == "arsnn") * 2 + bool(norm)


def check_eval_case(mode, embedding, norm):
    """The eval forward of the small detector, port against JAX, for one
    mode x embedding x norm (tolerance of :func:`_check_eval`)."""
    jm, pm, v, ev, _ = pair(mode, embedding, case_seed(mode, embedding,
                                                       norm), norm=norm)
    _check_eval(jm, pm, v, ev)


@pytest.mark.parametrize("norm", [None, "bn"], ids=["plain", "norm"])
@pytest.mark.parametrize("embedding", ["count", "arsnn"])
@pytest.mark.parametrize("mode", ["none", "backbone"])
def test_detector_eval_matches_jax(mode, embedding, norm):
    """The analog-neck modes (the spiking-neck ones:
    ``tests/test_torch_variants_model_spiking.py``)."""
    check_eval_case(mode, embedding, norm)
