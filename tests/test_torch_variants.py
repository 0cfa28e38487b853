"""The rest of the event model surface against the JAX package, on the CPU
in f32: the LIF functions, the ASGL ('patan') spike, the count / snn /
rsnn embeddings and the split arsnn sampler, the optimizer groups, the
weights bridge and the SOP counts of the fully spiking detectors, the
routing of their sites at the flagship geometry, the ``e_yolox_*``
presets and both command lines on the new variants.

Inputs are made with numpy from a seed; the port receives the JAX
package's weights through ``state_dict_from_jax``. The whole-detector
grid (every ``use_spike`` mode x {count, arsnn} x norm) is
``tests/test_torch_variants_model.py``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eas_snn_tpu.core import optim as joptim
from eas_snn_tpu.evaluators import count_ops as j_count_ops
from eas_snn_tpu.models import EASYOLOX as JEASYOLOX
from eas_snn_tpu.models.embedding import build_embedding as j_build_embedding
from eas_snn_tpu.ops.arsnn import gated_lif_update as j_gated_lif_update
from eas_snn_tpu.ops.lif import lif_scan as j_lif_scan
from eas_snn_tpu.ops.lif import lif_step as j_lif_step
from eas_snn_tpu.ops.surrogate import asgl_spike as j_asgl_spike
from eas_snn_tpu.ops.surrogate import get_spike_fn as j_spike_fn
from eas_snn_tpu.utils.torch_import import translate_torch_checkpoint

from eas_snn_tpu_torch.core import optim as poptim
from eas_snn_tpu_torch.core.train_state import CapturedStep
from eas_snn_tpu_torch.evaluators import count_ops
from eas_snn_tpu_torch.exp import get_exp
from eas_snn_tpu_torch.models import EASYOLOX
from eas_snn_tpu_torch.models import blocks as pblocks
from eas_snn_tpu_torch.models.embedding import build_embedding
from eas_snn_tpu_torch.ops.lif import gated_lif_update, lif_scan, lif_step
from eas_snn_tpu_torch.ops.surrogate import (asgl_spike, get_spike_fn,
                                             surrogate_deriv)
from eas_snn_tpu_torch.utils import state_dict_from_jax
from eas_snn_tpu_torch.utils.weights import _module_tokens

from test_torch_model import SMALL, _jax_preset, _np_tree, _random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


# --------------------------------------------------------------- LIF ops

@pytest.mark.parametrize("vreset", [None, 0.0], ids=["soft", "hard"])
def test_lif_functions_match_jax(vreset):
    """lif_step, lif_scan and gated_lif_update, values and gradients (in
    the currents, the membrane, the decay logit and the gate), with the
    rect surrogate, at both resets. The same elementwise formulas in the
    same order, but XLA's sigmoid of the decay differs from torch's by an
    ulp: spikes exact, membranes and gradients 1e-6 relative."""
    rng = np.random.default_rng(0)
    T, shape = 4, (2, 3, 5, 6)
    psp = rng.normal(0.4, 0.8, (T,) + shape).astype(np.float32)
    v0 = rng.normal(0.2, 0.5, shape).astype(np.float32)
    gate = rng.uniform(0.1, 0.9, shape).astype(np.float32)
    g = rng.normal(0, 1, (3,) + shape).astype(np.float32)
    decay = np.float32(0.3)
    jfn, fn = j_spike_fn("rect"), get_spike_fn("rect")

    def j_all(psp, v0, gate, decay):
        st = j_lif_step(v0, psp[0], decay, 1.0, vreset, jfn)
        gl = j_gated_lif_update(v0, gate, psp[1], 1.0, vreset, jfn)
        sc = j_lif_scan(psp, decay, 1.0, vreset, jfn)
        return st, gl, sc

    def j_loss(*a):
        st, gl, sc = j_all(*a)
        return sum((o * g[0]).sum() for o in st) + sum(
            (o * g[1]).sum() for o in gl) + (sc[0] * g[2]).sum() + (
            (sc[1] + sc[2]) * g[2][0]).sum()

    args = tuple(jnp.asarray(a) for a in (psp, v0, gate, decay))
    want = jax.tree_util.tree_map(np.asarray, j_all(*args))
    want_g = [np.asarray(x) for x in jax.grad(j_loss, (0, 1, 2, 3))(*args)]

    p = [_t(a).requires_grad_() for a in (psp, v0, gate, decay)]
    st = lif_step(p[1], p[0][0], p[3], 1.0, vreset, fn)
    gl = gated_lif_update(p[1], p[2], p[0][1], 1.0, vreset, fn)
    sc = lif_scan(p[0], p[3], 1.0, vreset, fn)
    gt = [_t(x) for x in g]
    loss = sum((o * gt[0]).sum() for o in st) + sum(
        (o * gt[1]).sum() for o in gl) + (sc[0] * gt[2]).sum() + (
        (sc[1] + sc[2]) * gt[2][0]).sum()
    loss.backward()
    for got, w in zip(st + gl + sc, want[0] + want[1] + want[2]):
        np.testing.assert_allclose(got.detach().numpy(), w, rtol=1e-6,
                                   atol=1e-6)
    for i in (2, 5, 6):  # the spikes
        np.testing.assert_array_equal((st + gl + sc)[i].detach().numpy(),
                                      (want[0] + want[1] + want[2])[i])
    for t, w in zip(p, want_g):
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-6, atol=1e-6)
        assert np.abs(w).max() > 0
    assert 0.05 < float(sc[0].detach().mean()) < 0.95  # it really spikes


# ------------------------------------------------------------ ASGL spike

def _asgl_case(seed=0, shape=(4, 5, 6, 3)):
    rng = np.random.default_rng(seed)
    x = np.concatenate([np.array([-1.0, -1e-7, 0.0, 1e-7, 0.5, -0.5],
                                 np.float32),
                        rng.normal(0, 1, int(np.prod(shape)) - 6
                                   ).astype(np.float32)]).reshape(shape)
    g = rng.normal(0, 1, shape).astype(np.float32)
    mask = (rng.uniform(size=shape) < 0.5).astype(np.float32)
    return x, g, mask


@pytest.mark.parametrize("p,inject", [(0.0, False), (0.5, True)],
                         ids=["p0", "p0.5_mask"])
def test_asgl_spike_matches_jax(p, inject):
    """Forward, dx and dalpha of the straight-through ASGL spike with a
    learnable scalar alpha; at p = 0.5 both sides take the same injected
    mask. The hard spikes exact, the smooth values (where the mask is 0)
    and the gradients 1e-6 relative (XLA's and torch's atan differ by an
    ulp)."""
    x, g, mask = _asgl_case()
    m = mask if inject else None

    def j_loss(xx, a):
        return (j_asgl_spike(xx, a, p=p, mask=None if m is None
                             else jnp.asarray(m)) * g).sum()

    a0 = np.array([1.7], np.float32)
    want = np.asarray(j_asgl_spike(jnp.asarray(x), jnp.asarray(a0), p=p,
                                   mask=None if m is None else jnp.asarray(m)))
    wdx, wda = jax.grad(j_loss, (0, 1))(jnp.asarray(x), jnp.asarray(a0))
    xt, at = _t(x).requires_grad_(), _t(a0).requires_grad_()
    got = asgl_spike(xt, at, p=p, mask=None if m is None else _t(m))
    (got * _t(g)).sum().backward()
    hard = np.ones_like(x, bool) if m is None else m == 1
    np.testing.assert_array_equal(got.detach().numpy()[hard], want[hard])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(wdx), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(wda), rtol=1e-5,
                               atol=1e-6)
    if not inject:  # p = 0: the hard spike, atan's gradient at |alpha|
        np.testing.assert_array_equal(want, (x >= 0).astype(np.float32))
        d = surrogate_deriv("patan", 1.7, _t(x)) * _t(g)
        np.testing.assert_allclose(xt.grad.numpy(), d.numpy(), rtol=1e-6,
                                   atol=1e-7)
    else:  # the smooth value where the mask is 0
        assert (want != (x >= 0)).sum() > 0


def test_asgl_spike_eval_and_registry_match_jax():
    """At eval the hard spike ``x >= 0`` whatever p; ``get_spike_fn('patan')``
    is the p = 0 spike at a fixed alpha (forward exact, dx 1e-6)."""
    x, g, _ = _asgl_case(1)
    want = np.asarray(j_asgl_spike(jnp.asarray(x), jnp.asarray([2.0]),
                                   p=0.5, training=False))
    got = asgl_spike(_t(x), _t([2.0]), p=0.5, training=False)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, (x >= 0).astype(np.float32))
    jfn = j_spike_fn("patan", 1.5)
    wdx = jax.grad(lambda v: (jfn(v) * g).sum())(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    y = get_spike_fn("patan", 1.5)(xt)
    (y * _t(g)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jfn(x)))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(wdx), rtol=1e-6,
                               atol=1e-7)


def test_asgl_spike_draws_no_random_numbers_at_p0():
    """p = 0 (the reference's value) draws nothing from the generator;
    p > 0 draws its Bernoulli mask from it, reproducibly."""
    x = torch.randn(64, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    asgl_spike(x, 2.0, p=0.0, generator=gen)
    assert torch.equal(gen.get_state(), state)
    a = asgl_spike(x, 2.0, p=0.5, generator=torch.Generator().manual_seed(1))
    b = asgl_spike(x, 2.0, p=0.5, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and (a != (x >= 0).float()).any()


@pytest.mark.parametrize("gran", ["layer", "channel", "neuron"])
def test_asgl_alpha_granularities_match_jax(gran):
    """alpha of shape (1,), (C,) or (H, W, C) in the JAX package's NHWC,
    (1,), (C, 1, 1) or (C, H, W) on the port's NCHW: the same forward
    (exact) and gradients (1e-5: dalpha sums over the batch, and over
    H and W for 'channel')."""
    x, g, _ = _asgl_case(2, (4, 5, 6, 3))  # NHWC
    rng = np.random.default_rng(3)
    shape = {"layer": (1,), "channel": (3,), "neuron": (5, 6, 3)}[gran]
    a0 = rng.uniform(0.5, 3.0, shape).astype(np.float32)
    wy = np.asarray(j_asgl_spike(jnp.asarray(x), jnp.asarray(a0)))
    wdx, wda = jax.grad(lambda xx, a: (j_asgl_spike(xx, a) * g).sum(),
                        (0, 1))(jnp.asarray(x), jnp.asarray(a0))
    pa = (a0.reshape(3, 1, 1) if gran == "channel"
          else a0.transpose(2, 0, 1) if gran == "neuron" else a0)
    xt = _t(x.transpose(0, 3, 1, 2)).requires_grad_()
    at = _t(pa).requires_grad_()
    y = asgl_spike(xt, at)
    (y * _t(g.transpose(0, 3, 1, 2))).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy().transpose(0, 2, 3, 1),
                                  wy)
    np.testing.assert_array_equal(wy, (x >= 0).astype(np.float32))
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(wdx), rtol=1e-6, atol=1e-7)
    da = at.grad.numpy()
    da = (da.reshape(3) if gran == "channel"
          else da.transpose(1, 2, 0) if gran == "neuron" else da)
    np.testing.assert_allclose(da, np.asarray(wda), rtol=1e-5, atol=1e-6)


def test_patan_train_plif_matches_jax_scan():
    """A patan PLIF site in training (the port's ``PLIF._asgl_scan``,
    granularity 'channel', with its BN terms) against the JAX package's
    fallback path: the BN normalize, then ``plif_scan`` with
    ``asgl_spike``. Spikes exact; dx, dw, dalpha and the BN terms'
    gradients 1e-5 relative to their largest magnitude."""
    from eas_snn_tpu.ops.lif import plif_scan as j_plif_scan

    rng = np.random.default_rng(4)
    T, B, C, H, W = 3, 4, 8, 5, 6
    x = rng.normal(0.3, 1.0, (T * B, H, W, C)).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    mean, mul = (rng.normal(0, .2, C).astype(np.float32),
                 rng.uniform(1, 2, C).astype(np.float32))
    bias, w = rng.normal(0, .2, C).astype(np.float32), np.float32(-0.4)
    alpha = rng.uniform(1, 3, C).astype(np.float32)

    def j_loss(x, w, alpha, mean, mul, bias):
        y = (x - mean) * mul + bias
        s, _ = j_plif_scan(y.reshape((T, B, H, W, C)), w,
                           lambda v: j_asgl_spike(v, alpha), 1.0)
        return (s.reshape(x.shape) * g).sum(), s.reshape(x.shape)

    args = [jnp.asarray(a) for a in (x, w, alpha, mean, mul, bias)]
    (_, want), grads = jax.value_and_grad(j_loss, range(6), has_aux=True)(
        *args)
    site = pblocks.PLIF(T, "patan", alpha=2.0, alpha_granularity="channel",
                        channels=C).train()
    with torch.no_grad():
        site.w.fill_(float(w))
        site.asgl_alpha.copy_(_t(alpha))
    xt = _t(x.transpose(0, 3, 1, 2)).requires_grad_()
    bn = [_t(a).requires_grad_() for a in (mean, mul, bias)]
    y = site(xt, bn=tuple(bn))
    (y * _t(g.transpose(0, 3, 1, 2))).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy().transpose(0, 2, 3, 1),
                                  np.asarray(want))
    assert 0.05 < float(y.mean()) < 0.95
    got = [xt.grad.numpy().transpose(0, 2, 3, 1), site.w.grad.numpy(),
           site.asgl_alpha.grad.numpy()] + [t.grad.numpy() for t in bn]
    for name, a, b in zip(("x", "w", "alpha", "mean", "mul", "bias"), got,
                          grads):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)
        assert np.abs(b).max() > 0, name


# ------------------------------------------------------------ embeddings

_EMB_CASES = [
    ("count", {}),
    ("snn", dict(readout="sum")),
    ("snn", dict(readout="last")),
    ("rsnn", dict(use_abs=False)),
    ("rsnn", dict(use_abs=True)),
]


@pytest.mark.parametrize("name,kw", _EMB_CASES,
                         ids=[f"{n}-{'-'.join(map(str, k.values()))}"
                              for n, k in _EMB_CASES])
def test_embedding_matches_jax(name, kw):
    """Each embedding against the JAX package's ``build_embedding`` on the
    same weights: the output (1e-5 absolute: the conv stacks sum in
    another order; the spikes agree, no membrane sits that close to its
    threshold) and the gradient of every parameter (1e-4 of its largest
    magnitude)."""
    rng = np.random.default_rng(0)
    ev = rng.poisson(0.6, (2, 1, 4, 24, 32, 2)).astype(np.float32)
    kw = dict(kw, ksize=5, depth=2, vreset=0.0)
    je = j_build_embedding(name, **kw)
    v = _np_tree(je.init(jax.random.PRNGKey(1), jnp.asarray(ev)))
    out = np.asarray(je.apply(v, jnp.asarray(ev)))  # (N, H, W, C)
    g = rng.normal(0, 1, out.shape).astype(np.float32)
    jg = _np_tree(jax.grad(lambda p: (je.apply({"params": p},
                                               jnp.asarray(ev)) * g).sum())(
        v["params"])) if v else {}
    pe = build_embedding(name, **kw)
    sd = state_dict_from_jax({"params": {"embedding": v.get("params", {})}})
    pe.load_state_dict({k[len("embedding."):]: t for k, t in sd.items()},
                       strict=True)
    got = pe(torch.from_numpy(ev))
    (got * _t(g.transpose(0, 3, 1, 2))).sum().backward() if v else None
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               out, rtol=0, atol=1e-5)
    assert np.abs(out).max() > 0.5
    grads = state_dict_from_jax({"params": {"embedding": jg}}) if v else {}
    params = dict(pe.named_parameters())
    assert set(params) == {k[len("embedding."):] for k in grads}
    for k, want in grads.items():
        p = params[k[len("embedding."):]]
        np.testing.assert_allclose(
            p.grad.numpy(), want.numpy(), rtol=0,
            atol=1e-4 * float(want.abs().max()) + 1e-12, err_msg=k)
        assert float(want.abs().max()) > 0, k
    if name == "snn":
        assert set(params) == {"decay", "embedding_conv.layer.0.weight",
                               "embedding_conv.layer.0.bias",
                               "embedding_conv.layer.2.weight",
                               "embedding_conv.layer.2.bias"}


def test_split_arsnn_declares_agg_convs_and_keeps_its_output():
    """``split`` declares input_conv_agg / gate_conv_agg with the swapped
    inits, loaded from the JAX tree; the output equals the unsplit
    sampler's on the same weights, and the JAX package's (1e-5)."""
    rng = np.random.default_rng(1)
    ev = rng.poisson(1.0, (2, 1, 4, 24, 32, 2)).astype(np.float32)
    kw = dict(ksize=5, depth=2, Ts=3, write_zero=True, vreset=None)
    je = j_build_embedding("arsnn", split=True, **kw)
    v = _np_tree(je.init(jax.random.PRNGKey(0), jnp.asarray(ev)))
    want = np.asarray(je.apply(v, jnp.asarray(ev)))
    sd = {k[len("embedding."):]: t for k, t in state_dict_from_jax(
        {"params": {"embedding": v["params"]}}).items()}
    split = build_embedding("arsnn", split=True, **kw).eval()
    split.load_state_dict(sd, strict=True)
    plain = build_embedding("arsnn", **kw).eval()
    plain.load_state_dict({k: t for k, t in sd.items() if "_agg" not in k},
                          strict=True)
    assert split.input_conv_agg.weight.shape == (4, 2, 5, 5)
    assert split.gate_conv_agg.weight.shape == (4, 2, 5, 5)
    with torch.no_grad():
        a, b = split(torch.from_numpy(ev)), plain(torch.from_numpy(ev))
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.numpy().transpose(0, 1, 3, 4, 2), want,
                               rtol=0, atol=1e-5)
    # the init: fan-in uniform input agg, orthogonal gate agg
    split.reset_parameters(torch.Generator().manual_seed(0))
    lim = (3.0 / 50) ** 0.5
    assert float(split.input_conv_agg.weight.abs().max()) <= lim
    w = split.gate_conv_agg.weight.reshape(4, -1)
    torch.testing.assert_close(w @ w.T, 2.0 * torch.eye(4), rtol=0,
                               atol=1e-5)


# ------------------------------------------- routing at the flagship size

def _fake_kernels(monkeypatch):
    """Replace the eval kernel wrappers by counters (meta tensors)."""
    calls = {"plif": 0, "c1": 0, "c3": 0, "c3s2": 0}

    def fake(name, out):
        def f(x, *a, **k):
            calls[name] += 1
            return out(x, *a)
        return f

    def first(x):
        return x[0] if isinstance(x, (tuple, list)) else x

    monkeypatch.setattr(pblocks, "plif_forward", fake(
        "plif", lambda x, *a: torch.empty(x.shape, dtype=torch.int8,
                                          device=x.device)))
    monkeypatch.setattr(pblocks, "conv1x1_plif", fake(
        "c1", lambda x, w, *a: torch.empty(
            (first(x).shape[0], w.shape[0]) + tuple(first(x).shape[2:]),
            dtype=torch.int8, device=first(x).device)))
    for name, s in (("conv3x3_plif", 1), ("conv3x3s2_plif", 2)):
        monkeypatch.setattr(pblocks, name, fake(
            "c3" if s == 1 else "c3s2", lambda x, w, *a, s=s: torch.empty(
                (x.shape[0], w.shape[1], x.shape[2] // s, x.shape[3] // s),
                dtype=torch.int8, device=x.device)))
    return calls


# launches a deploy forward of gen1_syolox_m (256x320) sends to rows 1-4
FLAGSHIP_ROUTING = {
    "full_spike_v2": {"plif": 74, "c1": 14, "c3": 8, "c3s2": 1},
    "full_spike": {"plif": 60, "c1": 13, "c3": 8, "c3s2": 1},
}


@pytest.mark.parametrize("mode", sorted(FLAGSHIP_ROUTING))
def test_fully_spiking_flagship_site_routing(monkeypatch, mode):
    """At the flagship geometry one deploy forward of the fully spiking
    detector sends its sites to rows 1-4 as the JAX package's policy
    (``eas_snn_tpu/ops/conv_plif_policy.py:should_fuse`` on the NHWC
    shapes, with ``BaseConv._conv_plif_eligible``'s kernel rules: 1x1 or
    3x3, a tuple only into a 1x1) sends the same sites; the counts are
    pinned (``chip_smoke.py`` phase 11 checks them on the card). Shapes
    only: the model runs on the meta device, the kernels replaced by
    counters."""
    from eas_snn_tpu.ops.conv_plif_policy import should_fuse as j_should_fuse

    calls = _fake_kernels(monkeypatch)
    jax_calls = {"plif": 0, "c1": 0, "c3": 0, "c3s2": 0}

    def hook(mod, args):
        x = args[0]
        pieces = tuple(x) if isinstance(x, (tuple, list)) else (x,)
        nhwc = tuple((p.shape[0], p.shape[2], p.shape[3], p.shape[1])
                     for p in pieces)
        ok = (mod.ksize in (1, 3) and (mod.ksize, mod.stride) != (1, 2)
              and (len(pieces) == 1 or mod.ksize == 1)
              and j_should_fuse(mod.ksize, mod.stride,
                                nhwc if len(nhwc) > 1 else nhwc[0],
                                mod.weight.shape[0]))
        key = ("plif" if not ok else "c1" if mod.ksize == 1 else
               "c3" if mod.stride == 1 else "c3s2")
        jax_calls[key] += 1

    exp = get_exp("gen1_syolox_m").deploy().merge(["use_spike", mode])
    model = exp.get_model(device="cpu").to("meta")
    for m in model.modules():
        if isinstance(m, pblocks.BaseConv) and m.neuron.spiking:
            m.register_forward_pre_hook(hook)
    out = model(torch.empty((1, 1, 4, 256, 320, 2), device="meta"))
    assert out.shape == (1, 1680, 7)
    assert calls == jax_calls == FLAGSHIP_ROUTING[mode]


@pytest.mark.parametrize("mode,sites", [("full_spike_v2", 97),
                                        ("full_spike", 82)])
def test_fully_spiking_flagship_train_step_sites(monkeypatch, mode, sites):
    """One train step of the fully spiking flagship (bf16, meta tensors):
    every spiking site (backbone, neck and with full_spike_v2 the head)
    passes the train kernels' layout checks and launches each once; no
    eval kernel. The library is replaced by stubs."""
    from eas_snn_tpu_torch.ops import _build, launch_counts, reset_launches

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(_build, "require_cuda", lambda t, what: None)
    monkeypatch.setattr(_build, "get_lib", lambda name: Lib())
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    model = get_exp("gen1_syolox_m").merge(["use_spike", mode]).get_model(
        device="cpu", train=True).to("meta")
    reset_launches()
    losses = model(torch.empty((1, 1, 4, 256, 320, 2), device="meta"),
                   torch.zeros((1, 50, 5), device="meta"))
    losses["total_loss"].backward()
    counts = launch_counts()
    reset_launches()
    assert counts == {k: {"plif_train_fwd": sites,
                          "plif_train_bwd": sites}.get(k, 0) for k in counts}
    assert all(p.grad is not None for p in model.parameters())


# ------------------------------------------- optimizer groups and weights

VARIANTS = {
    "full_v2-snn-norm-patan_neuron": dict(
        use_spike="full_v2", embedding="snn", norm="bn", spike_fn="patan",
        alpha_granularity="neuron", Ts=1),
    "full-rsnn": dict(use_spike="full", embedding="rsnn", Ts=1),
    "backbone-arsnn_split-patan_channel": dict(
        use_spike="backbone", embedding="arsnn", split=True,
        spike_fn="patan", alpha_granularity="channel"),
    "none-count-norm": dict(use_spike="none", embedding="count", norm="bn",
                            Ts=1),
}


def _variant(name, seed=0):
    """(JAX model, its firing variables, the port's model loaded strictly
    from them, events) of a VARIANTS entry at the small size."""
    rng = np.random.default_rng(seed)
    ev = rng.poisson(0.3, (2, 1, 4, 64, 64, 2)).astype(np.float32)
    kw = dict(SMALL, **VARIANTS[name])
    jm = JEASYOLOX(**kw)
    v = _random_variables(jm, ev, rng)
    pm = EASYOLOX(**kw)
    pm.materialize_alpha(ev.shape)
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return jm, v, pm.eval(), ev


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_optimizer_groups_of_new_parameters_equal_jax(name):
    """Every parameter lands in the JAX package's group: the embedding's
    (the snn decay, the rsnn and split convs) with ``emb_lr``; ASGL alpha
    and the post-embedding BN without weight decay; conv kernels outside
    BN and the embedding with it (``_label_params``, ``_decay_mask``)."""
    jm, v, pm, _ = _variant(name)
    code = jax.tree_util.tree_map(
        lambda lab, dec: np.float32(2 * (lab == "emb") + bool(dec)),
        joptim._label_params(v["params"]), joptim._decay_mask(v["params"]))
    shaped = jax.tree_util.tree_map(lambda c, p: np.full(p.shape, c,
                                                         np.float32),
                                    code, v["params"])
    want = {k: int(t.flatten()[0]) for k, t in state_dict_from_jax(
        {"params": shaped}).items()}
    decay, no_decay, emb = poptim._groups(pm)
    got = {}
    for group, c in ((decay, 1), (no_decay, 0), (emb, 2)):
        for p in group:
            got[id(p)] = c
    named = dict(pm.named_parameters())
    assert {n: got[id(p)] for n, p in named.items()} == want
    new = [n for n in named if n.startswith("emb_bn") or "asgl_alpha" in n
           or n in ("embedding.decay",) or "_agg" in n]
    assert new or name == "full-rsnn"


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_state_dict_from_jax_round_trips_every_variant(name):
    """``state_dict_from_jax`` loads strictly (``_variant``); the port's
    state dict goes back through the JAX package's importer
    (``translate_torch_checkpoint``) with every leaf whose name the
    importer knows restored exactly and nothing unmapped but the
    post-embedding BN's scale and bias, for which it knows no name
    (``eas_snn_tpu/utils/torch_import.py:_map_name``): its ``emb_bn.bias``
    lands on the JAX leaf, its ``emb_bn.weight`` is taken for a kernel
    and left unmapped. It skips the leaves it has no kind for: the snn
    decay, the ASGL alphas, the post-embedding BN's statistics and the BN
    step counters."""
    _, v, pm, _ = _variant(name)
    sd = {k: t.numpy() for k, t in pm.state_dict().items()}
    zeros = jax.tree_util.tree_map(np.zeros_like, v)
    back, report = translate_torch_checkpoint(sd, zeros)
    norm = "emb_bn" in v["params"]
    assert report["unmapped"] == (1 if norm else 0), report
    assert report["shape_miss"] == 0, report
    skipped = [k for k in sd if k.endswith("num_batches_tracked")
               or k.endswith(("asgl_alpha", "embedding.decay"))
               or k.startswith("emb_bn.running")]
    assert report["skipped"] == len(skipped)
    n_leaves = len(jax.tree_util.tree_leaves(v))
    unmapped_leaves = (3 if norm else 0) + sum(
        k.endswith(("asgl_alpha", "embedding.decay")) for k in sd)
    assert report["mapped"] == n_leaves - unmapped_leaves
    flat_v = dict(jax.tree_util.tree_leaves_with_path(v))
    for path, leaf in jax.tree_util.tree_leaves_with_path(back):
        keys = [getattr(k, "key", "") for k in path]
        if ("emb_bn" in keys and keys[-1] != "bias") or keys[-1] in (
                "alpha", "decay"):
            continue
        np.testing.assert_array_equal(leaf, flat_v[path], err_msg=str(keys))


@pytest.mark.parametrize("mode", ["full", "full_v2"])
def test_count_ops_of_spiking_neck_and_head_equal_jax(mode):
    """SOPs and MACs per module of the fully spiking detectors against
    the JAX package's ``count_ops``: MACs and the spiking flag equal, SOPs
    within 1e-4 relative (the spikes agree; the JAX package sums the
    ~2.5e5 window sums of a dark2 site in f32, the port in f64: seen
    1.4e-5). The neck's (and with full_v2 the head's) sites count as
    spiking and see int8 spikes at eval."""
    rng = np.random.default_rng(2)
    ev = rng.poisson(0.2, (2, 1, 4, 64, 64, 2)).astype(np.float32)
    kw = dict(SMALL, use_spike=mode, embedding="arsnn")
    jm = JEASYOLOX(**kw)
    v = _random_variables(jm, ev, rng)
    pm = EASYOLOX(**kw).eval()
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    want = {".".join(_module_tokens(tuple(k.split("/")))): a
            for k, a in j_count_ops(jm, v, jnp.asarray(ev)).items()}
    got = count_ops(pm, torch.from_numpy(ev))
    assert set(got) == set(want)
    for name, a in got.items():
        b = np.asarray(want[name], np.float64)
        assert a[1] == b[1] and a[2] == b[2], name
        assert abs(a[0] - b[0]) <= 1e-4 * max(abs(b[0]), 1.0), name
    neck = [a for n, a in got.items() if n.startswith("backbone.")
            and not n.startswith("backbone.backbone.")]
    head = [a for n, a in got.items() if n.startswith("head.")]
    assert neck and all(a[2] == 1 and a[0] > 0 for a in neck)
    assert all(a[2] == (mode == "full_v2") for a in head)


def test_captured_step_refuses_random_asgl_masks():
    """patan at asgl_p > 0 draws a fresh mask a step, which a CUDA graph
    would replay: ``CapturedStep`` refuses it (p = 0 draws nothing)."""
    m = EASYOLOX(use_spike="backbone", **dict(SMALL, spike_fn="patan"),
                 asgl_p=0.25)
    with pytest.raises(NotImplementedError, match="asgl_p"):
        CapturedStep(m, None, None)
    assert m.draws_random_numbers
    assert not EASYOLOX(use_spike="backbone", **dict(
        SMALL, spike_fn="patan")).draws_random_numbers


def test_neuron_alpha_is_created_when_the_model_is_built():
    """A 'neuron' patan alpha is created once, when ``get_model`` builds
    the model, at each site's (C, H, W) for the exp's input size; a train
    forward of a site without one raises instead of adding a parameter
    that the optimizer and the EMA would never see."""
    exp = get_exp("gen1_syolox_s").merge([
        "spike_fn", "patan", "alpha_granularity", "neuron", "width",
        "0.125", "depth", "0.33", "input_size", "(64, 96)", "compute_dtype",
        "float32"])
    m = exp.get_model(device="cpu", train=True)
    sites = [x.act for x in m.modules()
             if isinstance(x, pblocks.BaseConv) and x.neuron.spiking]
    sizes = {(64 >> k, 96 >> k) for k in range(1, 6)}
    assert sites and all(s.asgl_alpha.shape[1:] in sizes for s in sites)
    names = {n for n, _ in m.named_parameters()}
    m(torch.zeros((1, exp.Tl, exp.Tm, 64, 96, exp.in_dim)),
      torch.zeros((1, 50, 5)))
    assert {n for n, _ in m.named_parameters()} == names
    site = pblocks.PLIF(3, "patan", alpha_granularity="neuron").train()
    with pytest.raises(RuntimeError, match="materialize_alpha"):
        site(torch.zeros((6, 4, 5, 6)))
    assert site.eval()(torch.zeros((6, 4, 5, 6))).dtype == torch.int8


@pytest.mark.parametrize("name, fp16, tf32", [
    ("e_yolox_s", False, False), ("e_yolox_s", True, True),
    ("gen1_syolox_m", False, True)])
@pytest.mark.parametrize("cli", ["train_event", "eval_event"])
def test_command_lines_run_f32_presets_without_tf32(monkeypatch, cli, name,
                                                    fp16, tf32):
    """Both CLIs run an f32 exp (``e_yolox_*``) in IEEE f32: cuDNN's and
    cuBLAS's TF32 off, whatever they were; a bf16 one (``--fp16``, the
    Gen1 presets) leaves torch's settings as they were."""
    import importlib

    build = importlib.import_module(f"eas_snn_tpu_torch.tools.{cli}").build
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    exp, _ = build(["-n", name] + ["--fp16"] * fp16)
    assert (exp.compute_dtype == "float32") == (not tf32)
    assert torch.backends.cudnn.allow_tf32 is tf32
    assert torch.backends.cuda.matmul.allow_tf32 is tf32


# ---------------------------------------------------------------- presets

@pytest.mark.parametrize("size", ["s", "m", "l"])
def test_e_yolox_presets_equal_the_jax_exps(size):
    """``get_exp('e_yolox_*')`` holds every field of
    ``exps/default/e_yolox_*.py``'s Exp at the same value, less the fields
    that only the JAX package has; the model it builds is the count
    embedding before an analog YOLOX (no spiking site)."""
    name = f"e_yolox_{size}"
    jexp, pexp = _jax_preset(name), get_exp(name)
    only_jax = set(vars(jexp)) - set(vars(pexp))
    assert only_jax == {"data_worker_mode", "use_pallas"}
    for f in sorted(set(vars(jexp)) & set(vars(pexp))):
        assert getattr(pexp, f) == getattr(jexp, f), f
    assert (pexp.depth, pexp.width) == {"s": (0.33, 0.5), "m": (0.67, 0.75),
                                        "l": (1.0, 1.0)}[size]
    assert (pexp.embedding, pexp.use_spike_mode, pexp.num_classes,
            pexp.input_size) == ("count", "none", 100, (640, 640))
    pexp.width, pexp.depth = 0.125, 0.33
    m = pexp.get_model(device="cpu")
    assert not any(isinstance(x, pblocks.PLIF) for x in m.modules())


def test_new_fields_take_command_line_overrides():
    """The CLIs' ``key value`` overrides reach the new fields with the
    JAX package's coercion: ``split True`` a bool, ``decay 0.3`` and
    ``asgl_p 0.25`` floats, ``norm bn`` a string (the field is None), and
    the model takes them."""
    exp = get_exp("gen1_syolox_m").merge([
        "use_spike", "full_spike_v2", "embedding", "rsnn", "split", "True",
        "norm", "bn", "decay", "0.3", "spike_fn", "patan", "asgl_p", "0.25",
        "alpha_granularity", "channel", "width", "0.125", "depth", "0.33",
        "compute_dtype", "float32"])
    assert (exp.split, exp.norm, exp.decay, exp.asgl_p) == (True, "bn", 0.3,
                                                            0.25)
    m = exp.get_model(device="cpu")
    assert m.use_spike == "full_v2" and m.emb_bn is not None
    assert type(m.embedding).__name__ == "RSNNEmbedding"
    sites = [x for x in m.modules()
             if isinstance(x, pblocks.BaseConv) and x.neuron.spiking]
    assert sites and all(x.act.asgl_p == 0.25 and x.act.asgl_alpha.shape
                         == (x.weight.shape[0],) for x in sites)
    snn = get_exp("gen1_syolox_m").merge(["embedding", "snn", "decay", "0.3",
                                          "width", "0.125", "depth", "0.33"])
    d = snn.get_model(device="cpu").embedding.decay
    assert abs(float(torch.sigmoid(d)) - 0.3) < 1e-6


# ---------------------------------------------------------- command lines

def _tiny_opts(out):
    return ["output_dir", out, "width", "0.125", "depth", "0.33",
            "compute_dtype", "float32", "data_num_workers", "0",
            "print_interval", "1", "max_epoch", "1", "seed", "1",
            "eval_interval", "1"]


@pytest.mark.parametrize("case", ["e_yolox_s", "full_spike_v2"])
def test_command_lines_run_the_new_variants_on_the_cpu(tmp_path, case):
    """The train CLI takes two steps (and the epoch-end evaluation) and
    the eval CLI evaluates the checkpoint, with ``e_yolox_s`` on an
    N-Caltech tree and with ``gen1_syolox_s`` overridden to
    ``use_spike full_spike_v2 embedding snn norm bn spike_fn patan`` on a
    Gen1 tree; ``--energy`` reports the spiking neck and head."""
    from eas_snn_tpu_torch.tools import eval_event
    from eas_snn_tpu_torch.tools.train_event import build

    from test_torch_data import write_tree
    from test_torch_datasets import write_ncaltech_tree

    if case == "e_yolox_s":
        data = write_ncaltech_tree(str(tmp_path / "nc"))
        name, opts = "e_yolox_s", ["input_size", "(64, 64)", "test_size",
                                   "(64, 64)", "data_dir", data]
    else:
        data = write_tree(str(tmp_path / "gen1"), groups=3)
        name = "gen1_syolox_s"
        opts = ["input_size", "(32, 32)", "test_size", "(32, 32)",
                "max_events_per_slice", "4096", "data_dir", data,
                "use_spike", "full_spike_v2", "embedding", "snn", "Ts", "1",
                "norm", "bn", "spike_fn", "patan"]
    out = str(tmp_path / "out")
    exp, args = build(["-n", name, "-b", "2", "-l", "jsonl"]
                      + _tiny_opts(out) + opts)
    assert exp.exp_name == name and exp.norm in (None, "bn")
    exp.iters_per_epoch = 2
    tr = exp.get_trainer(args, device="cpu")
    tr.train()
    assert all(np.isfinite(v) for v in tr.last_losses.values())
    run = os.path.join(out, exp.exp_name)
    ckpt = os.path.join(run, "ckpt", "ckpt_2.pth")
    assert os.path.exists(ckpt)
    flags = ["-n", name, "-b", "2", "--device", "cpu", "-c", ckpt]
    res = eval_event.main(flags + _tiny_opts(out) + opts)
    assert np.isfinite(res["ap"]) and res["timing"]["samples"] > 0
    energy = eval_event.main(flags[:-2] + ["--energy"] + flags[-2:]
                             + _tiny_opts(out) + opts)["energy"]
    if case == "e_yolox_s":
        assert energy["sops"] == 0 and energy["dense_macs"] > 0
    else:
        assert energy["sops"] > 0 and energy["snn_equivalent_macs"] > 0
        assert isinstance(tr.model.emb_bn, pblocks.BatchNorm)
