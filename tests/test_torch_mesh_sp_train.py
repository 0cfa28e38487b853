"""The port's train step on row shards (spatial parallelism, SP) on the
CPU: real processes in gloo groups (``tests/torch_mesh_worker.py``, modes
``sp_step*`` and ``sp_none``) against JAX's ``train_step`` under
``spatial_sharding`` on its 8-device virtual mesh, and against the port
unsharded.

The model is ``tests/test_parallel.py:_setup``'s (width 0.125, depth
0.33, T = 2, Ts = 2, a 3 x 3 sampler), its variables drawn with numpy
into JAX's tree (``_random_variables``: every spiking site fires) and
carried across. A row shard holds whole rows at stride 32, so the 1 x 2
and 2 x 2 steps run at 64 x 64 (B = 2 and 4) and the 1 x 4 step at
128 x 64 (B = 2: one row a shard at stride 32, under a 3 x 3 halo of
one row). Held here:

* the 1 x 2 step against JAX's step under ``spatial_sharding(
  make_mesh_2d(1, 2))``: the loss within 1e-5 relative, ``num_fg``
  equal, parameters and EMA within rtol / atol 2e-3, BN running
  statistics within atol 1e-4 (JAX's own tolerances,
  ``tests/test_parallel.py:170-190``);
* the reduced gradients of the 1 x 2, 2 x 2 and 1 x 4 steps and of the
  packed sampler's 1 x 2 step against the unsharded steps', within 1e-4
  of each tensor's largest magnitude (Adam's first update moves a
  parameter by about lr whatever its gradient, so the parameters alone
  would not show a sum over the wrong group). A PLIF decay logit's
  gradient, one scalar a site, is a sum over its whole site that
  cancels, which another order moves by up to ~1e-3 of itself in f32:
  it is held in float64, the SP step's against the unsharded step's,
  both computed by a float64 copy of the model (as
  ``tests/test_torch_train_step.py`` holds it against JAX's);
* the halo's backward (k = 3, 5 and a 3 x 3 of stride 2) and the BN
  statistics of row shards with their gradient, against the whole
  image (f64 / f32);
* remat on and off, with either spike store, the backward run outside
  the sharding's context: the SP step's bits;
* the SP checkpoint: it loads into an unsharded model, and a restored
  SP run steps on with the live run's bits;
* the refusals: channel sharding with a spatial sharding, and
  ``CapturedStep`` inside one.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from eas_snn_tpu.core import optim as joptim
from eas_snn_tpu.core.train_state import create_train_state
from eas_snn_tpu.core.train_state import train_step as j_train_step
from eas_snn_tpu.models import EASYOLOX as JEASYOLOX
from eas_snn_tpu.parallel import (make_mesh_2d as j_mesh_2d,
                                  spatial_sharding as j_spatial)

from eas_snn_tpu_torch import parallel
from eas_snn_tpu_torch.core import (CapturedStep, build_lr_schedule,
                                    build_optimizer, init_ema)
from eas_snn_tpu_torch.models import EASYOLOX
from eas_snn_tpu_torch.parallel import mesh as pmesh

from test_torch_mesh import KW, LR, _start, _wait
from test_torch_model import _random_variables
from test_torch_train_step import _torch_tree

GRAD_TOL = 1e-4  # of each gradient tensor's largest magnitude
CASES = ("sp12", "sp22", "sp14", "packed12")
VARIANTS = ((False, "int8"), (True, "int8"), (True, "float"),
            (False, "float"))


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _labels(B, H):
    """[cls, cx, cy, w, h] rows in B images of H x 64, boxes in every
    shard's rows and across the shards' edges."""
    lab = np.zeros((B, 6, 5), np.float32)
    for b in range(B):
        lab[b, 0] = [b % 2, 20 + 4 * b, H * 0.3, 18, H * 0.25]
        lab[b, 1] = [(b + 1) % 2, 44, H * 0.55, 24, H * 0.4]
    return lab


def _inputs(tmp):
    """The cases' batches and the JAX train state (Adam, lr 1e-3 fixed,
    weight decay 5e-4, EMA) on drawn variables; writes the workers'
    input and returns (its path, the JAX model, state and 1 x 2 batch)."""
    rng = np.random.default_rng(0)
    ev64 = rng.normal(size=(4, 1, 2, 64, 64, 2)).astype(np.float32)
    ev128 = rng.normal(size=(2, 1, 2, 128, 64, 2)).astype(np.float32)
    lab64, lab128 = _labels(4, 64), _labels(2, 128)
    jm = JEASYOLOX(**KW)
    v = _random_variables(jm, ev64[:1], np.random.default_rng(1))
    tx = joptim.build_optimizer(v["params"], joptim.build_lr_schedule(
        "fixed", LR, 10, 10), weight_decay=5e-4)
    state = create_train_state(jm, None, None, None, tx, variables=v)
    host = jax.tree_util.tree_map(np.asarray, state)
    t = torch.from_numpy
    cases = dict(
        sp12=dict(mesh=(1, 2), events=t(ev64[:2]), labels=t(lab64[:2])),
        sp22=dict(mesh=(2, 2), events=t(ev64), labels=t(lab64)),
        sp14=dict(mesh=(1, 4), events=t(ev128), labels=t(lab128)),
        packed12=dict(mesh=(1, 2), events=t(ev64[:2]), labels=t(lab64[:2]),
                      kwargs=dict(packed_embedding="auto")))
    inp = os.path.join(tmp, "in.pt")
    torch.save(dict(kwargs=KW, lr=LR, cases=cases, step_state=_torch_tree(
        {"params": host.params, "batch_stats": host.batch_stats})), inp)
    return inp, host, ev64[:2], lab64[:2]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workers (started first, they run beside JAX) and JAX's 1 x 2
    SP step."""
    tmp = str(tmp_path_factory.mktemp("mesh_sp"))
    inp, host, ev, lab = _inputs(tmp)
    groups = (("sp_step", 2), ("sp_step22", 4), ("sp_step14", 4),
              ("sp_none", 1))
    outs = {m: os.path.join(tmp, m, "out.pt") for m, _ in groups}
    for o in outs.values():
        os.makedirs(os.path.dirname(o))
    procs = {m: _start(m, n, inp, outs[m]) for m, n in groups}

    mesh = j_mesh_2d(1, 2, jax.devices()[:2])
    s = jax.device_put(jax.tree_util.tree_map(jnp.asarray, host),
                       NamedSharding(mesh, P()))
    s2, m2 = j_train_step(
        s, jax.device_put(jnp.asarray(ev), j_spatial(mesh)),
        jax.device_put(jnp.asarray(lab), NamedSharding(mesh, P("data"))))
    j = dict(metrics={k: float(x) for k, x in m2.items()},
             state=_torch_tree({"params": s2.params,
                                "batch_stats": s2.batch_stats}),
             ema=_torch_tree({"params": s2.ema_params}))

    for ps in procs.values():
        _wait(ps)
    got = {}
    for m, o in outs.items():
        if m != "sp_none":
            got.update(torch.load(o, weights_only=False))
    return dict(jax=j, got=got,
                ref=torch.load(outs["sp_none"], weights_only=False))


def _hold_state(state, want, ema=None, want_ema=None):
    for k, x in want.items():
        if k.endswith("num_batches_tracked"):  # no JAX counterpart
            continue
        stat = k.endswith(("running_mean", "running_var"))
        np.testing.assert_allclose(state[k].numpy(), x.numpy(), rtol=2e-3,
                                   atol=1e-4 if stat else 2e-3, err_msg=k)
    for k, x in (want_ema or {}).items():
        np.testing.assert_allclose(ema[k].numpy(), x.numpy(), rtol=2e-3,
                                   atol=2e-3, err_msg=k)


def test_sp_step_holds_to_jax(runs):
    """The port's 1 x 2 SP step against JAX's ``train_step`` with the
    events under ``spatial_sharding(make_mesh_2d(1, 2))``."""
    j, got = runs["jax"], runs["got"]["sp12"]
    losses = got["losses"]
    np.testing.assert_allclose(losses["total_loss"],
                               j["metrics"]["total_loss"], rtol=1e-5)
    assert losses["num_fg"] == j["metrics"]["num_fg"] > 0
    _hold_state(got["state"], j["state"], got["ema"], j["ema"])


@pytest.mark.parametrize("case", CASES)
def test_sp_gradients_equal_the_unsharded_steps(runs, case):
    """Each SP step's reduced gradients (every parameter replicated, each
    process's share summed over the whole mesh) against the unsharded
    step's on the same batch, within GRAD_TOL of each tensor's largest
    magnitude; the loss within 1e-5 relative, ``num_fg`` equal, the
    parameters and BN statistics after the update as JAX's test holds
    them. The PLIF decay logits' gradients are held in float64 (the
    module docstring), each within GRAD_TOL of its own magnitude."""
    got, ref = runs["got"][case], runs["ref"][case]
    np.testing.assert_allclose(got["losses"]["total_loss"],
                               ref["losses"]["total_loss"], rtol=1e-5)
    assert got["losses"]["num_fg"] == ref["losses"]["num_fg"] > 0
    assert got["grads"].keys() == ref["grads"].keys()
    decay = {k for k in ref["grads"] if k.endswith(".act.w")}
    assert decay and got["grads64"].keys() == ref["grads64"].keys() == decay
    for k, g in ref["grads"].items():
        got_k = got["grads64" if k in decay else "grads"][k]
        want = ref["grads64"][k] if k in decay else g
        np.testing.assert_allclose(
            got_k.numpy(), want.numpy(), rtol=0,
            atol=GRAD_TOL * float(want.abs().max()) + 1e-12, err_msg=k)
    _hold_state(got["state"], ref["state"])


@pytest.mark.parametrize("k,stride", [(3, 1), (5, 1), (3, 2)])
def test_halo_backward_is_the_whole_images(runs, k, stride):
    """``over_rows`` of a k x k conv on row shards of 8 rows (f64): its
    output, the input's gradient (each halo row's cotangent added by its
    owner) and the weight's gradient summed over the group equal the
    whole image's conv and autograd."""
    h = runs["got"]["halo"][(k, stride)]
    assert h["dx_scale"] > 0
    assert h["out"] < 1e-12 and h["dw"] < 1e-10, h
    assert h["dx"] < 1e-12 * max(1.0, h["dx_scale"]), h


def test_batch_stats_of_row_shards_are_the_whole_images(runs):
    """``_BatchStats`` on a row shard (its forward inside the sharding,
    its backward outside) gives the whole batch's mean and variance, and
    the whole batch's gradient on its rows."""
    bn = runs["got"]["bn"]
    assert bn["mean"] < 1e-6 and bn["var"] < 1e-5, bn
    assert bn["dx"] < 1e-5 * bn["dx_scale"], bn


@pytest.mark.parametrize("remat,store", VARIANTS)
def test_remat_and_spike_store_give_the_sp_steps_bits(runs, remat, store):
    """An SP forward and backward with ``remat`` on or off and either
    spike store, the backward run outside the sharding's context (the
    recompute brings the forward's sharding: its halos, the gathered SPP
    map and head levels): the SP step's reduced gradients and BN
    statistics bit for bit, the statistics moved once."""
    got, step = runs["got"]["remat"][(remat, store)], runs["got"]["sp12"]
    for k, g in step["grads"].items():
        assert torch.equal(got["grads"][k], g), k
    for k, b in got["buffers"].items():
        assert torch.equal(b, step["state"][k]), k


def test_sp_checkpoint_round_trip(runs):
    """The SP run's checkpoint holds whole tensors: it loads into an
    unsharded model as the live state, and a restored SP run's next step
    gives the live run's bits."""
    got = runs["got"]
    assert got["restored_equal"]
    ckpt = torch.load(got["ckpt"], weights_only=True)
    m = EASYOLOX(**KW)
    m.load_state_dict(ckpt["model"], strict=True)
    for k, x in got["sp12"]["state"].items():
        assert torch.equal(m.state_dict()[k], x), k
    for k, x in got["sp12"]["ema"].items():
        assert torch.equal(ckpt["ema"][k], x), k


def _train_model():
    model = EASYOLOX(**KW).train()
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


def test_tp_with_sp_is_refused():
    """A channel-sharded model inside a spatial sharding: both split the
    model axis, which JAX has no placement for."""
    mesh = pmesh.Mesh2D(1, 2)
    model = _train_model()
    parallel.channel_shard_params(mesh, model)
    ev = torch.zeros(1, 1, 2, 32, 64, 2)
    with parallel.spatial_sharding(mesh), \
            pytest.raises(NotImplementedError, match=r"\(TP\).*\(SP\)"):
        model(ev)


def test_captured_step_refuses_sp():
    """``CapturedStep`` built or called inside a spatial sharding."""
    model = _train_model()
    opt = build_optimizer(model, build_lr_schedule("fixed", LR, 10, 10))
    with parallel.spatial_sharding(pmesh.Mesh2D(1, 2)), \
            pytest.raises(NotImplementedError, match="spatially sharded"):
        CapturedStep(model, opt, init_ema(model))
