"""Train memory of the port on the CPU: block remat (the JAX package's
``remat``) and the int8 store of saved spike trains. Neither may change a
bit of a train step; remat must move the BN running statistics once a
step, recompute each spiking site's train PLIF forward once (a fixed
count of launches), and hold to the JAX package's ``remat=True`` step.
"""

import numpy as np
import pytest
import torch

import jax

from eas_snn_tpu.models import EASYOLOX as JEASYOLOX

from eas_snn_tpu_torch.core import (build_lr_schedule, build_optimizer,
                                    init_ema, train_step)
from eas_snn_tpu_torch.exp import get_exp
from eas_snn_tpu_torch.models import EASYOLOX
from eas_snn_tpu_torch.models import blocks as pblocks
from eas_snn_tpu_torch.models import yolox as pyolox
from eas_snn_tpu_torch.ops import arsnn as parsnn
from eas_snn_tpu_torch.ops import plif as pplif
from eas_snn_tpu_torch.ops.surrogate import get_spike_fn

from test_torch_model import SMALL, _random_variables
from test_torch_train_step import _labels, _torch_tree

# the flagship's depth: 50 spiking sites, as gen1_syolox_m and
# ncaltech_syolox_m have
FLAGSHIP_DEPTH = dict(SMALL, depth=0.67)
SITES = 50


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _batch(seed=1, B=2):
    g = torch.Generator().manual_seed(seed)
    ev = torch.poisson(torch.full((B, 1, 4, 64, 64, 2), 0.2), generator=g)
    return ev, torch.from_numpy(_labels(B))


def _model(kw=FLAGSHIP_DEPTH, **extra):
    m = EASYOLOX(use_spike="backbone", **kw, **extra)
    m.reset_parameters(torch.Generator().manual_seed(0))
    return m.train()


def _steps(model, ev, lab, n=2):
    """``n`` Adam steps with EMA; the losses, last gradients and the end
    state (parameters, BN buffers, Adam's state, EMA)."""
    opt = build_optimizer(model, build_lr_schedule("fixed", 1e-3, 1, 1))
    ema = init_ema(model)
    losses = [train_step(model, opt, ema, ev, lab, to_host=True)
              for _ in range(n)]
    grads = {k: p.grad.clone() for k, p in model.named_parameters()
             if p.grad is not None}
    state = dict(model.state_dict())
    state.update({f"ema.{k}": v for k, v in ema.items()})
    for i, st in enumerate(opt.state.values()):
        state.update({f"opt.{i}.{k}": v for k, v in st.items()})
    return losses, grads, state


@pytest.fixture(scope="module")
def runs():
    ev, lab = _batch()
    return {(remat, store): _steps(_model(remat=remat, train_store=store),
                                   ev, lab)
            for remat in (False, True) for store in ("float", "int8")}


@pytest.mark.parametrize("remat,store", [(False, "int8"), (True, "float"),
                                         (True, "int8")])
def test_remat_and_int8_store_give_the_bits_of_the_plain_step(runs, remat,
                                                              store):
    """Two Adam steps with remat and / or the int8 store against two
    plain steps from the same weights: every loss, gradient, parameter,
    BN running statistic (moved once a step: ``num_batches_tracked`` is
    2), Adam state and EMA bit for bit."""
    base, got = runs[(False, "float")], runs[(remat, store)]
    assert got[0] == base[0]
    for what in (1, 2):
        assert got[what].keys() == base[what].keys()
        for k, v in base[what].items():
            assert torch.equal(got[what][k], v), k
    tracked = [v for k, v in got[2].items() if k.endswith("tracked")]
    assert tracked and all(int(t) == 2 for t in tracked)


def test_remat_recomputes_each_train_plif_forward_once(monkeypatch):
    """The launches of a remat step, by the train PLIF op's two calls: 50
    sites at the flagship's depth give 50 + 50 a plain step and 100 + 50
    with remat (the recompute runs each site's forward again, its
    backward once). ``chip_smoke.py`` phase 14a pins the same counts on
    the card by the wrappers and by kernel name."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = pplif.plif_train_forward, pplif.plif_train_backward

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(pplif, "plif_train_forward", counted("fwd", fwd))
    monkeypatch.setattr(pplif, "plif_train_backward", counted("bwd", bwd))
    ev, lab = _batch()
    for remat, want in ((False, (SITES, SITES)), (True, (2 * SITES, SITES))):
        calls.update(fwd=0, bwd=0)
        m = _model(remat=remat)
        m(ev, lab)["total_loss"].backward()
        assert (calls["fwd"], calls["bwd"]) == want, remat


def test_saved_spike_trains_are_held_as_int8(monkeypatch):
    """A train step's saved tensors through a saved-tensor hook: with the
    float store every spike train a conv saves is saved in the compute
    dtype; with the int8 store (the default) the model's hook takes each
    of them (one int8 copy a train, whatever the count of its savers),
    and the gradients are bit-equal."""
    made = []

    class Counting(pblocks.int8_saved_spikes):
        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(pyolox, "int8_saved_spikes", Counting)
    ev, lab = _batch()
    seen = []

    def pack(t):
        if pblocks.is_spike_train(t):
            seen.append((id(t), t.dtype))
        return t

    grads = {}
    for store in ("float", "int8"):
        m = _model(train_store=store)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            m(ev, lab)["total_loss"].backward()
        grads[store] = {k: p.grad for k, p in m.named_parameters()}
    assert len(made) == 1 and made[0].saves == len(seen) > SITES // 2
    assert made[0].trains == len({i for i, _ in seen})
    assert {d for _, d in seen} == {torch.float32}
    for k, g in grads["float"].items():
        assert torch.equal(grads["int8"][k], g), k
    assert EASYOLOX(use_spike="backbone", **SMALL).train_store == "int8"


def test_sampler_scan_remat_gives_the_same_bits():
    """The arsnn scan with a checkpoint a micro-step (JAX
    ``jax.checkpoint(step)``): the aggregation and every gradient bit for
    bit."""
    g = torch.Generator().manual_seed(3)
    ev = torch.rand((4, 2, 2, 17, 19), generator=g) * 3.0
    convs = [torch.nn.Conv2d(2, 4, 3, padding=1) for _ in range(2)]
    out = {}
    for remat in (False, True):
        for c in convs:
            c.zero_grad()
        x = ev.clone().requires_grad_()
        agg = parsnn.arsnn_scan(x, convs[0], convs[1], Ts=3, thresh=1.0,
                                vreset=None, spike_fn=get_spike_fn("rect"),
                                remat=remat)
        (agg * torch.linspace(-1, 1, agg.numel()).reshape(agg.shape)
         ).sum().backward()
        out[remat] = [agg.detach(), x.grad] + [p.grad for c in convs
                                               for p in c.parameters()]
    assert out[False][0].abs().sum() > 0
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)


def test_remat_step_holds_to_jax_remat_step():
    """The port's remat step against the JAX package's ``remat=True`` loss
    and gradient from the same weights (tests/test_models.py:243's pattern,
    across the packages): the loss within 1e-5 relative, every gradient
    within 1e-3 of its tensor's largest magnitude."""
    rng = np.random.default_rng(0)
    ev = rng.poisson(0.2, (2, 1, 4, 64, 64, 2)).astype(np.float32)
    lab = _labels()
    jm = JEASYOLOX(use_spike="backbone", embedding="arsnn", remat=True,
                   **SMALL)
    v = _random_variables(jm, ev, rng)

    def loss_fn(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]}, ev, lab,
                          train=True, mutable=["batch_stats"])
        return out["total_loss"]

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    jg = _torch_tree({"params": jg})
    pm = EASYOLOX(use_spike="backbone", remat=True, **SMALL)
    pm.load_state_dict(_torch_tree(v), strict=True)
    pm.train()
    loss = pm(torch.from_numpy(ev), torch.from_numpy(lab))["total_loss"]
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k, p in pm.named_parameters():
        g = jg[k]
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), rtol=0,
                                   atol=1e-3 * float(g.abs().max()) + 1e-12,
                                   err_msg=k)


def test_exp_remat_reaches_the_model():
    exp = get_exp("gen1_syolox_s").merge(["remat", "True", "width", "0.125",
                                          "depth", "0.33"])
    m = exp.get_model(device="cpu", train=True)
    assert m.backbone.backbone.remat and m.embedding.remat
    m.set_remat(False)
    assert not m.backbone.backbone.remat and not m.embedding.remat
