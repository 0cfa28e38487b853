"""The analog detector's train trajectory on one repeated batch, port
against the JAX package, and the non-finite gradients of a box whose size
overflows ``exp``.

``e_yolox_m`` (f32, 640x640, B=32, Adam at the preset's lr 5e-4, no
warm-up) on one repeated random batch first gave a non-finite gradient at
step 35 on the card (``chip_smoke.nan_trace``): one decoded box size of
the head, ``exp`` of its regression output, overflowed to inf while the
loss stayed finite, and the IoU loss's area product sent 0 * inf = NaN
back. These tests hold both packages to the same arithmetic there: from
the same weights, the same batch and the same optimizer the losses of the
first steps agree, and a box size that overflows gives the same finite
loss and non-finite gradients in the same parameters on both sides.

``python tests/test_torch_divergence.py --name e_yolox_s --size 256 256
--batch 8 --steps 40 --lr 5e-4`` prints both trajectories on the CPU.
"""

import argparse
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:  # run as a script: chip_smoke and the packages
    sys.path.append(_REPO)

from eas_snn_tpu.core.train_state import create_train_state
from eas_snn_tpu.core.train_state import train_step as j_train_step
from eas_snn_tpu.exp import get_exp as jget_exp

from chip_smoke import random_labels
from eas_snn_tpu_torch.core import init_ema, train_step
from eas_snn_tpu_torch.exp import get_exp
from eas_snn_tpu_torch.utils import state_dict_from_jax

TERMS = ("total_loss", "iou_loss", "conf_loss", "cls_loss")
TINY = ["width", "0.125", "depth", "0.33"]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(name, size, B, overrides=(), lr=None, seed=0):
    """Both packages' exp of ``name`` at ``size`` with ``overrides``, the
    JAX model's init (seed ``seed``) in both, one Poisson(0.2) batch and
    its random labels (numpy, seeded)."""
    opts = list(overrides) + ["input_size", str(tuple(size)), "test_size",
                              str(tuple(size))]
    jexp = jget_exp(exp_name=name).merge(opts)
    pexp = get_exp(name).merge(opts)
    if lr is not None:  # the per-image lr that gives ``lr`` at batch B
        jexp.basic_lr_per_img = pexp.basic_lr_per_img = lr / B
    rng = np.random.default_rng(seed)
    ev = rng.poisson(0.2, (B, pexp.Tl, pexp.Tm, *size, pexp.in_dim)
                     ).astype(np.float32)
    lab = random_labels(B, *size, rng).numpy()
    jm = jexp.get_model()
    v = jax.tree_util.tree_map(np.array, dict(jm.init(
        jax.random.PRNGKey(seed), jnp.asarray(ev), train=False)))
    pm = pexp.get_model(device="cpu", train=True)
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return jexp, jm, v, pexp, pm, ev, lab


def trajectories(name, size, B, steps, overrides=(), lr=None):
    """Each step's loss terms of the JAX and the port's train step, from
    the same weights on one repeated batch: (jax rows, port rows)."""
    jexp, jm, v, pexp, pm, ev, lab = _pair(name, size, B, overrides, lr)
    tx = jexp.get_optimizer(v["params"], B)
    state = create_train_state(jm, None, None, None, tx, variables=v)
    opt = pexp.get_optimizer(pm, B)
    ema = init_ema(pm)
    pev, plab = torch.from_numpy(ev), torch.from_numpy(lab)
    jrows, prows = [], []
    for _ in range(steps):
        state, m = j_train_step(state, jnp.asarray(ev), jnp.asarray(lab))
        jrows.append({k: float(m[k]) for k in TERMS})
        out = train_step(pm, opt, ema, pev, plab, to_host=True)
        prows.append({k: out[k] for k in TERMS})
    return jrows, prows


def test_first_steps_on_one_batch_match_jax():
    """Three Adam steps at lr 5e-4 with no warm-up (the ``e_yolox_m`` NaN
    run's optimizer) of ``e_yolox_s`` at a tiny size, free-running on
    both sides from the same weights. The first update runs at lr 0
    (``yoloxwarmcos`` at update 0): steps 1 and 2 see the same weights,
    and their loss terms agree within 1e-4 relative (f32 sums in another
    order; 9e-6 seen). The second update moves every weight by about the
    lr whatever its gradient's size, so the two packages' rounding
    differences become lr-sized weight differences: step 3's terms agree
    within 2e-3 relative (7e-4 seen), and later steps drift apart (8% at
    step 4 here): a trajectory on one batch is compared step by step only
    this far."""
    jrows, prows = trajectories("e_yolox_s", (64, 64), 2, 3, TINY, lr=5e-4)
    assert jrows[2]["total_loss"] != jrows[1]["total_loss"]
    for i, (j, p) in enumerate(zip(jrows, prows)):
        for k in TERMS:
            np.testing.assert_allclose(p[k], j[k],
                                       rtol=1e-4 if i < 2 else 2e-3,
                                       err_msg=f"step {i + 1} {k}")


def _grads_with_overflow(level_bias: float):
    """Loss and gradients of both packages' ``e_yolox_s`` at a tiny size
    on one batch, with the box-width logit of the stride-8 level's
    regression biased to ``level_bias`` (exp overflows f32 above ~88.7)."""
    jexp, jm, v, pexp, pm, ev, lab = _pair("e_yolox_s", (64, 64), 2, TINY)
    v["params"]["head"]["reg_pred0"]["bias"][2] = level_bias
    pm.load_state_dict(state_dict_from_jax(v), strict=True)

    def loss_fn(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]}, ev, lab,
                          train=True, mutable=["batch_stats"])
        return out["total_loss"]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    jg = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": jgrads}))
    out = pm(torch.from_numpy(ev), torch.from_numpy(lab))
    out["total_loss"].backward()
    pg = {n: p.grad for n, p in pm.named_parameters()}
    return float(jloss), jg, float(out["total_loss"].detach()), pg


def test_overflowing_box_size_gives_the_same_nonfinite_gradients():
    """A regression logit past exp's f32 range (the card's step 35): both
    packages give the same finite loss, and the same parameters get
    non-finite gradients (the head's stride-8 regression and everything
    upstream of it); below the range every gradient is finite on both
    sides."""
    jl, jg, pl, pg = _grads_with_overflow(100.0)
    assert np.isfinite(jl) and np.isfinite(pl)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    jbad = {n for n, g in jg.items() if not np.isfinite(g.numpy()).all()}
    pbad = {n for n, g in pg.items() if not torch.isfinite(g).all()}
    assert "head.reg_preds.0.weight" in pbad
    assert "head.reg_preds.1.weight" not in pbad
    assert pbad == jbad
    jl, jg, pl, pg = _grads_with_overflow(10.0)
    assert all(np.isfinite(g.numpy()).all() for g in jg.values())
    assert all(torch.isfinite(g).all() for g in pg.values())


def main() -> None:
    ap = argparse.ArgumentParser(description="both packages' train "
                                 "trajectories on one batch, on the CPU")
    ap.add_argument("--name", default="e_yolox_s")
    ap.add_argument("--size", type=int, nargs=2, default=(256, 256))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("opts", nargs="*", help="exp 'key value' overrides")
    a = ap.parse_args()
    jrows, prows = trajectories(a.name, tuple(a.size), a.batch, a.steps,
                                a.opts, a.lr)
    for i, (j, p) in enumerate(zip(jrows, prows)):
        print(f"step {i + 1}: jax " + " ".join(
            f"{k} {j[k]:.6g}" for k in TERMS) + " | port " + " ".join(
            f"{k} {p[k]:.6g}" for k in TERMS), flush=True)
    first = {who: next((i + 1 for i, r in enumerate(rows)
                        if not np.isfinite(list(r.values())).all()), None)
             for who, rows in (("jax", jrows), ("port", prows))}
    print(f"first non-finite step: {first}")


if __name__ == "__main__":
    main()
