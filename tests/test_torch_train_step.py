"""The port's train step against the JAX package's, and its checkpoints and
trainer, on the CPU in f32.

The whole-slice weights are drawn with numpy into the JAX model's variable
shapes and handed to the port through ``state_dict_from_jax``, as the
eval slice's tests do (``tests/test_torch_model.py``); their BN scales
(1.5-2.5 at the spiking sites) make every spiking stage fire on the batch
statistics. Both sides take the same events and labels and the same
optimizer (Adam, fixed lr 1e-3, EMA).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eas_snn_tpu.core import optim as joptim
from eas_snn_tpu.core.train_state import create_train_state
from eas_snn_tpu.core.train_state import train_step as j_train_step
from eas_snn_tpu.models import EASYOLOX as JEASYOLOX

from eas_snn_tpu_torch.core import (CheckpointManager, build_lr_schedule,
                                    build_optimizer, eval_step, init_ema,
                                    load_partial_params, train_step)
from eas_snn_tpu_torch.exp import get_exp
from eas_snn_tpu_torch.models import EASYOLOX
from eas_snn_tpu_torch.models.blocks import PLIF
from eas_snn_tpu_torch.utils import state_dict_from_jax

from test_torch_model import SMALL, _random_variables


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _labels(B=2, M=50):
    """[cls, cx, cy, w, h] rows in 64x64 images, zero rows after."""
    lab = np.zeros((B, M, 5), np.float32)
    lab[0, 0] = [1, 20, 24, 18, 14]
    lab[0, 1] = [0, 44, 40, 24, 30]
    lab[1, 0] = [0, 30, 34, 40, 20]
    return lab


def _torch_tree(tree):
    """A JAX {"params": ..., "batch_stats": ...} tree as port names."""
    return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def jax_two_steps():
    """The JAX train step twice from the drawn variables, with each step's
    gradients and batch statistics from ``jax.value_and_grad`` of the same
    loss at the same parameters."""
    rng = np.random.default_rng(0)
    ev = rng.poisson(0.2, (2, 1, 4, 64, 64, 2)).astype(np.float32)
    jm = JEASYOLOX(use_spike="backbone", embedding="arsnn", **SMALL)
    v = _random_variables(jm, ev, rng)
    lab = _labels()

    def loss_fn(params):
        out, mut = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, ev, lab,
                            train=True, mutable=["batch_stats"])
        return out["total_loss"], (out, mut["batch_stats"])

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    tx = joptim.build_optimizer(v["params"], joptim.build_lr_schedule(
        "fixed", 1e-3, 1, 1))
    state = create_train_state(jm, None, None, None, tx, variables=v)
    steps = []
    for _ in range(2):
        (_, (metrics, stats)), grads = grad_fn(state.params)
        step = dict(
            grad_metrics={k: float(x) for k, x in metrics.items()},
            grads=_torch_tree({"params": grads}),
            stats=_torch_tree({"params": v["params"], "batch_stats": stats}))
        state, m = j_train_step(state, ev, lab)
        steps.append(dict(
            step, metrics={k: float(x) for k, x in m.items()},
            model=_torch_tree({"params": state.params,
                               "batch_stats": state.batch_stats}),
            ema=_torch_tree({"params": state.ema_params})))
    return dict(ev=ev, lab=lab, v=v, steps=steps)


def _close(got: torch.Tensor, want: torch.Tensor, rtol, atol, what):
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), rtol=rtol,
                               atol=atol, err_msg=what)


def _grad_noise(name: str, g: torch.Tensor) -> float:
    """The gradient tolerance: 1e-4 of the tensor's largest magnitude, 1e-3
    for a PLIF decay's scalar."""
    return (1e-3 if name.endswith("act.w") else 1e-4) * float(g.abs().max())


def _grads_f64(pm, ev, lab):
    """The gradients of the port's loss at ``pm``'s parameters and BN
    statistics, computed in float64 (a float64 copy of the model, its
    sites computing in f64), by name."""
    m64 = EASYOLOX(use_spike="backbone", compute_dtype=torch.float64,
                   **SMALL)
    m64.load_state_dict(pm.state_dict(), strict=True)
    m64 = m64.double().train()
    m64(ev.double(), lab.double())["total_loss"].backward()
    return {n: p.grad for n, p in m64.named_parameters()}


def test_train_steps_match_jax(jax_two_steps):
    """One and then two train steps, port vs JAX. The spikes of the two
    sides agree (the f32 preactivations differ by summation order only, and
    no spike sits that close to its threshold here), so the tolerances are
    those of f32 arithmetic in another order:

    * loss terms 1e-5 relative;
    * every gradient 1e-4 of the largest magnitude of its tensor (backward
      sums over ~1e5 terms); a PLIF decay's scalar gradient, a sum over
      all of its site's elements that cancels to ~1e-2 of their
      magnitude, is held in float64: the JAX package's and the port's
      f32 values each within 1e-3 relative of the port's float64
      gradient at the same parameters. In f32 that sum swings by ~1e-3
      on either side (dark2.1.conv3's at step 2 on an AMD EPYC host:
      port f32 0.0816725, JAX jitted 0.0815798 and op by op 0.0815452,
      port f64 0.0816089), so the two f32 values cannot be held to each
      other at 1e-3 on every host. The JAX event model computes in f32
      at fixed sites and its SimOTA does not trace under x64, so the
      float64 side is the port's;
    * BN running statistics 1e-5;
    * parameters and EMA after each step 2e-6 absolute, except where a
      gradient lies within 10x its tolerance of zero: Adam's update there,
      lr * m / (sqrt(v) + eps), takes its sign from rounding noise, so up
      to 2 lr a step is allowed (and happens: ~20% of the elements of some
      spiking conv kernels have such tiny gradients).

    Those +-lr moves are enough to flip spikes in the next forward (the
    spiking backbone is chaotic in its weights), so before the second
    step the port's parameters take the JAX package's step-1 values; its
    optimizer state, update count and EMA stay its own.
    """
    r = jax_two_steps
    pm = EASYOLOX(use_spike="backbone", **SMALL)
    pm.load_state_dict(_torch_tree(r["v"]), strict=True)
    pm.train()
    lr = 1e-3
    opt = build_optimizer(pm, build_lr_schedule("fixed", lr, 1, 1))
    ema = init_ema(pm)
    ev, lab = torch.from_numpy(r["ev"]), torch.from_numpy(r["lab"])
    feats = {}
    pm.backbone.backbone.register_forward_hook(
        lambda m, i, o: feats.update({k: v.detach() for k, v in o.items()}))
    noisy = {n: torch.zeros_like(p, dtype=torch.bool)
             for n, p in pm.named_parameters()}

    for i, want in enumerate(r["steps"]):
        g64 = _grads_f64(pm, ev, lab)
        got = train_step(pm, opt, ema, ev, lab, to_host=True)
        for k, x in want["metrics"].items():
            np.testing.assert_allclose(got[k], x, rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i + 1} {k}")
        for k, x in want["grad_metrics"].items():
            np.testing.assert_allclose(got[k], x, rtol=1e-5, atol=1e-6)
        assert got["num_fg"] > 0 and got["iou_loss"] > 0
        for stage in ("dark3", "dark4", "dark5"):
            assert 0.05 < float(feats[stage].mean()) < 0.6, stage
        for name, p in pm.named_parameters():
            g = want["grads"][name]
            assert p.grad is not None, name
            tol = _grad_noise(name, g)
            if name.endswith("act.w"):  # held in float64
                truth = g64[name].float()
                for side, v in (("port", p.grad), ("JAX", g)):
                    _close(v, truth, 0, _grad_noise(name, truth) + 1e-12,
                           f"step {i + 1} {side} f32 grad {name} vs the "
                           "port's f64")
            else:
                _close(p.grad, g, 0, tol + 1e-12,
                       f"step {i + 1} grad {name}")
            noisy[name] |= g.abs() < 10 * tol
        assert float(pm.backbone.backbone.dark2[0].act.w.grad) != 0
        assert float(pm.embedding.input_conv[0].weight.grad.abs().max()) > 0
        for name, b in pm.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                _close(b, want["model"][name], 1e-5, 1e-6,
                       f"step {i + 1} {name}")
        for name, p in pm.named_parameters():
            for mine, theirs, what in ((p, want["model"][name], "param"),
                                       (ema[name], want["ema"][name], "ema")):
                d = (mine.detach() - theirs).abs()
                allowed = torch.where(noisy[name], 2 * lr * (i + 1) + 2e-6,
                                      2e-6)
                assert (d <= allowed).all(), (
                    f"step {i + 1} {what} {name}: max excess "
                    f"{float((d - allowed).max()):.3e}")
        with torch.no_grad():
            for name, p in pm.named_parameters():
                p.copy_(want["model"][name])


def test_train_step_at_alpha_1_5_matches_jax():
    """The surrogate's alpha reaches every spiking site: one train step of
    the small spiking model at alpha 1.5 (the N-Caltech preset's), JAX
    against the port from the same weights, with the tolerances of
    ``test_train_steps_match_jax`` (loss terms 1e-5 relative, each
    gradient 1e-4 of its tensor's largest magnitude, a PLIF decay's 1e-3).
    The port at alpha 2.0 (what every site ran before alpha was carried
    through) misses the JAX gradients at 1.5 at the spiking convs, and the
    exp's override reaches the model."""
    rng = np.random.default_rng(3)
    ev = rng.poisson(0.2, (2, 1, 4, 64, 64, 2)).astype(np.float32)
    jm = JEASYOLOX(use_spike="backbone", embedding="arsnn", alpha=1.5,
                   **SMALL)
    v = _random_variables(jm, ev, rng)
    lab = _labels()

    def loss_fn(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]}, ev, lab,
                          train=True, mutable=["batch_stats"])
        return out["total_loss"], out

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    want = _torch_tree({"params": grads})
    ev_t, lab_t = torch.from_numpy(ev), torch.from_numpy(lab)

    def port_grads(alpha):
        pm = EASYOLOX(use_spike="backbone", alpha=alpha, **SMALL)
        pm.load_state_dict(_torch_tree(v), strict=True)
        pm.train()
        losses = pm(ev_t, lab_t)
        losses["total_loss"].backward()
        return losses, {n: p.grad for n, p in pm.named_parameters()}

    losses, got = port_grads(1.5)
    for k in ("total_loss", "iou_loss", "conf_loss", "cls_loss"):
        np.testing.assert_allclose(float(losses[k].detach()), float(metrics[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for name, g in want.items():
        _close(got[name], g, 0, _grad_noise(name, g) + 1e-12,
               f"alpha 1.5 grad {name}")
    _, at_2 = port_grads(2.0)
    spiking = [n for n in want if n.startswith("backbone.backbone.")
               and n.endswith("conv.0.weight")]
    assert spiking
    missed = [n for n in spiking if float((at_2[n] - want[n]).abs().max())
              > _grad_noise(n, want[n])]
    assert len(missed) == len(spiking), missed
    exp = get_exp("ncaltech_syolox_m").merge(["alpha", "1.75"])
    exp.width, exp.depth, exp.compute_dtype = 0.125, 0.33, "float32"
    model = exp.get_model(device="cpu", train=True)
    alphas = {m.alpha for m in model.modules() if isinstance(m, PLIF)}
    assert alphas == {1.75} and get_exp("ncaltech_syolox_m").alpha == 1.5


# ------------------------------------------------------------ checkpoints

def _small_train_setup(seed):
    torch.manual_seed(seed)
    m = EASYOLOX(use_spike="backbone", **SMALL)
    m.reset_parameters(torch.Generator().manual_seed(seed))
    m.train()
    opt = build_optimizer(m, build_lr_schedule("fixed", 1e-3, 1, 1))
    return m, opt, init_ema(m)


def _batch(seed=0, B=2):
    g = torch.Generator().manual_seed(seed)
    ev = torch.poisson(torch.full((B, 1, 4, 64, 64, 2), 0.2), generator=g)
    return ev, torch.from_numpy(_labels(B))


def test_checkpoint_save_restore_round_trip(tmp_path):
    m, opt, ema = _small_train_setup(0)
    ev, lab = _batch()
    train_step(m, opt, ema, ev, lab)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    for step in range(1, 6):
        mgr.save(step, m, opt, ema, best_ap=0.25)
    assert mgr.steps() == [3, 4, 5]

    m2, opt2, ema2 = _small_train_setup(1)
    assert not torch.equal(m2.head.stems[0].conv.weight,
                           m.head.stems[0].conv.weight)
    step, best = mgr.restore(m2, opt2, ema2)
    assert (step, best) == (5, 0.25)
    for (k, a), (k2, b) in zip(m.state_dict().items(),
                               m2.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    for k in ema:
        assert torch.equal(ema[k], ema2[k]), k
    s1, s2 = opt.state_dict(), opt2.state_dict()
    assert s1["param_groups"] == s2["param_groups"]
    for i, st in s1["state"].items():
        for key, val in st.items():
            assert torch.equal(val, s2["state"][i][key]), (i, key)
    # the restored state trains on exactly as the saved one does
    a = train_step(m, opt, ema, ev, lab, to_host=True)
    b = train_step(m2, opt2, ema2, ev, lab, to_host=True)
    assert a == b


def test_eval_step_runs_the_ema_with_the_models_buffers():
    """eval_step is the eval forward of a model holding the EMA parameters
    and the trained BN statistics; the model stays in train mode."""
    m, opt, ema = _small_train_setup(0)
    ev, lab = _batch()
    for _ in range(2):
        train_step(m, opt, ema, ev, lab)
    got = eval_step(m, ema, ev)
    assert m.training and got.shape == (2, 84, 7)
    ref = EASYOLOX(use_spike="backbone", **SMALL)
    ref.load_state_dict({**m.state_dict(), **ema}, strict=True)
    with torch.no_grad():
        want = ref.eval()(ev)
    assert torch.equal(got, want)
    with torch.no_grad():
        assert not torch.equal(got, m.eval()(ev))


def test_load_partial_params_skips_mismatched_shapes():
    m, _, _ = _small_train_setup(0)
    src, _, _ = _small_train_setup(1)
    sd = dict(src.state_dict())
    key = "head.cls_preds.0.weight"
    sd[key] = torch.zeros((3,) + tuple(sd[key].shape[1:]))
    del sd["head.cls_preds.0.bias"]
    sd["not.in.model"] = torch.zeros(2)
    before = m.head.cls_preds[0].weight.clone()
    report = load_partial_params(m, sd)
    assert report["shape_mismatch"] == [key]
    assert report["missing"] == ["head.cls_preds.0.bias"]
    assert report["unexpected"] == ["not.in.model"]
    assert report["loaded"] == len(sd) - 2
    assert torch.equal(m.head.cls_preds[0].weight, before)
    assert torch.equal(m.head.stems[0].conv.weight,
                       src.head.stems[0].conv.weight)


# ---------------------------------------------------------------- trainer

def test_trainer_runs_epochs_and_writes_checkpoints(tmp_path):
    """Three steps on a synthetic list of batches: one epoch, which is the
    no-aug tail (the L1 loss on), finite losses, one checkpoint."""
    exp = get_exp("gen1_syolox_s")
    exp.width, exp.depth, exp.compute_dtype = 0.125, 0.33, "float32"
    exp.max_epoch, exp.no_aug_epochs, exp.print_interval = 1, 1, 1
    exp.output_dir, exp.seed = str(tmp_path), 0
    batches = [_batch(i) for i in range(3)]
    trainer = exp.get_trainer(device="cpu", iters_per_epoch=3)
    trainer.train(batches)
    losses = trainer.last_losses
    assert all(np.isfinite(v) for v in losses.values())
    assert losses["l1_loss"] > 0 and trainer.use_l1
    assert trainer.meter["total_loss"].count == 3
    ckpt = os.path.join(str(tmp_path), "gen1_syolox_s", "ckpt")
    assert os.listdir(ckpt) == ["ckpt_3.pth"]
