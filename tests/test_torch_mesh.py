"""The port's 2-D mesh on the CPU (``eas_snn_tpu_torch/parallel/mesh.py``):
real processes in gloo groups (``tests/torch_mesh_worker.py``) against
the JAX package's sharded runs on its 8-device virtual mesh and against
the port unsharded.

The model and batch are ``tests/test_parallel.py:_setup``'s (width
0.125, depth 0.33, T = 2, Ts = 2, a 3 x 3 sampler, 32 x 32, B = 8), its
variables drawn with numpy into JAX's tree and carried across (with
every BN redrawn for the eval forwards, so that each stage fires:
``_firing_bn``). The row
shards need H to divide by tp x 32, so the spatial forward runs at 64 x 64
(B = 2). Held here:

* the channel-sharded (TP) eval forward at 1 x 2 and the spatial (SP)
  eval forward at 1 x 2 against JAX's forwards under
  ``channel_shard_params`` / ``spatial_sharding`` and against the port
  unsharded, within 1e-5 relative / 1e-4 absolute (f32); the sampler's
  whole-scan route on row shards (the kernel's plain version, the
  spikes' halo exchanged between micro-steps) bit-equal to its
  unsharded run; a fused site whose kernel refuses its row shard warns
  and gathers;
* the 2 x 2 DP x TP train step against JAX's ``make_mesh_2d(2, 2)`` step:
  the loss within 1e-5 relative, ``num_fg`` equal, parameters and EMA
  within rtol / atol 2e-3 and BN running statistics within atol 1e-4
  (JAX's own test of that step, ``tests/test_parallel.py:170-190``);
* the 2 x 2 step's gradients against the unsharded step's;
* that the port shards a tensor iff JAX's rule shards it;
* that a 1 x 1 mesh in a group of one gives the bits of no group (both
  steps in worker processes of one thread);
* that the gathered 2-D checkpoint loads into an unsharded model and
  holds the unsharded step's state, and restores into a sharded run bit
  for bit;
* that the fusion route is the global site's under TP and SP, at every
  fused flagship site, and one process's flagship forward sends 35 / 8
  / 6 / 1 sites to the four eval kernels (meta tensors).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eas_snn_tpu.core import optim as joptim
from eas_snn_tpu.core.train_state import create_train_state
from eas_snn_tpu.core.train_state import train_step as j_train_step
from eas_snn_tpu.models import EASYOLOX as JEASYOLOX
from eas_snn_tpu.parallel import (channel_shard_params as j_shard,
                                  dp_tp_shardings as j_dp_tp,
                                  make_mesh_2d as j_mesh_2d,
                                  spatial_sharding as j_spatial)

from eas_snn_tpu_torch import parallel
from eas_snn_tpu_torch.exp import get_exp
from eas_snn_tpu_torch.models import EASYOLOX
from eas_snn_tpu_torch.models import blocks as pblocks
from eas_snn_tpu_torch.models.blocks import BaseConv, Neuron
from eas_snn_tpu_torch.ops.conv_plif_policy import _MEASURED_WINS
from eas_snn_tpu_torch.parallel import mesh as pmesh

from test_torch_model import _firing_bn, _random_variables
from test_torch_train_step import _torch_tree

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_mesh_worker.py")
KW = dict(num_classes=2, depth=0.33, width=0.125, use_spike="backbone", T=2,
          Ts=2, embedding="arsnn", embedding_ksize=3)
LR = 1e-3
TIMEOUT = 240  # seconds, each group of worker processes


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _start(mode, nproc, inp, out):
    """A group of ``nproc`` workers. They meet at a file in the group's
    directory (a TCP port picked here could be taken by another process
    before the group binds it) and write their output to files there."""
    run = os.path.dirname(out)
    rdzv = f"file://{run}/rdzv"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = []
    for r in range(nproc):
        with open(os.path.join(run, f"log{r}.txt"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, mode, str(r), str(nproc), rdzv, inp,
                 out], stdout=log, stderr=subprocess.STDOUT, env=env,
                cwd=REPO))
    return procs


def _wait(procs):
    """Wait for a group; the first process that fails stops the others
    (they would wait for it in a collective), and every process that did
    not exit 0 is reported with the end of its log."""
    deadline = time.monotonic() + TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    run = os.path.dirname(procs[0].args[-1])
    logs = {r: open(os.path.join(run, f"log{r}.txt")).read()[-4000:]
            for r, _ in bad}
    assert not bad, "\n".join(f"worker {r} failed (rc={rc}):\n{logs[r]}"
                               for r, rc in bad)


def _state(jm):
    """``tests/test_parallel.py:_setup``'s batch (B = 8 normal events at
    32 x 32, one box a sample) and a JAX train state of ``jm`` (Adam, lr
    1e-3 fixed, weight decay 5e-4, EMA) on variables drawn with numpy at
    JAX's shapes (``_random_variables``: JAX's own init of this model
    takes ~40 s on the CPU, op by op)."""
    rng = np.random.default_rng(0)
    ev = rng.normal(size=(8, 1, 2, 32, 32, 2)).astype(np.float32)
    lab = np.zeros((8, 6, 5), np.float32)
    lab[:, 0] = [0, 16, 16, 10, 10]
    v = _random_variables(jm, ev[:1], np.random.default_rng(1))
    tx = joptim.build_optimizer(v["params"], joptim.build_lr_schedule(
        "fixed", LR, 10, 10), weight_decay=5e-4)
    return create_train_state(jm, None, None, None, tx, variables=v), ev, lab


def _np(x):
    return np.asarray(x.outputs if hasattr(x, "outputs") else x)


def _flags(tree):
    """1.0 where JAX placed a leaf over "model", as port names."""
    def flag(x):
        spec = getattr(x.sharding, "spec", ())
        return np.full(x.shape, float(any(s == "model" for s in spec)),
                       np.float32)
    return {k: bool(v.reshape(-1)[0]) if v.numel() else False
            for k, v in _torch_tree(jax.tree_util.tree_map(flag, tree))
            .items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workers (started first, they run beside JAX) and JAX's sharded
    and unsharded forwards and its 2 x 2 step."""
    tmp = tmp_path_factory.mktemp("mesh")
    jm = JEASYOLOX(**KW)
    state, ev, lab = _state(jm)
    host = jax.tree_util.tree_map(np.asarray, state)
    rng = np.random.default_rng(3)
    ev_var = _firing_bn({"params": host.params,
                         "batch_stats": host.batch_stats}, rng)
    ev64 = rng.normal(size=(2, 1, 2, 64, 64, 2)).astype(np.float32)
    step_state = _torch_tree({"params": host.params,
                              "batch_stats": host.batch_stats})
    inp = str(tmp / "in.pt")
    torch.save(dict(kwargs=KW, eval_state=_torch_tree(ev_var),
                    step_state=step_state, events=torch.from_numpy(ev),
                    events_sp=torch.from_numpy(ev64),
                    labels=torch.from_numpy(lab), lr=LR), inp)
    outs = {m: str(tmp / m / "out.pt")
            for m in ("tp", "sp", "step", "one", "none")}
    for o in outs.values():
        os.makedirs(os.path.dirname(o))
    procs = {m: _start(m, n, inp, outs[m])
             for m, n in (("tp", 2), ("sp", 2), ("step", 4), ("one", 1),
                          ("none", 1))}

    fwd = jax.jit(lambda v, e: jm.apply(v, e, train=False))
    mesh12 = j_mesh_2d(1, 2, jax.devices()[:2])
    j = {}
    tp_var = {k: j_shard(mesh12, v) for k, v in ev_var.items()}
    j["tp"] = _np(fwd(tp_var, ev))
    j["flags"] = _flags(tp_var)
    j["sp"] = _np(fwd(ev_var, jax.device_put(jnp.asarray(ev64),
                                             j_spatial(mesh12))))
    mesh22 = j_mesh_2d(2, 2, jax.devices()[:4])
    batch_sh, repl_sh = j_dp_tp(mesh22)
    f = jax.tree_util.tree_map(jnp.asarray, host)
    s_tp = f.replace(
        params=j_shard(mesh22, f.params),
        batch_stats=j_shard(mesh22, f.batch_stats),
        opt_state=jax.device_put(f.opt_state, repl_sh),
        ema_params=j_shard(mesh22, f.ema_params),
        step=jax.device_put(f.step, repl_sh))
    s2, m2 = j_train_step(s_tp, jax.device_put(jnp.asarray(ev), batch_sh),
                          jax.device_put(jnp.asarray(lab), batch_sh))
    j["metrics"] = {k: float(x) for k, x in m2.items()}
    j["state"] = _torch_tree({"params": s2.params,
                              "batch_stats": s2.batch_stats})
    j["ema"] = _torch_tree({"params": s2.ema_params})

    # the port's unsharded eval forward, in this process
    pm = EASYOLOX(**KW).eval()
    pm.load_state_dict(_torch_tree(ev_var), strict=True)
    with torch.no_grad():
        port = dict(ref=pm(torch.from_numpy(ev)).numpy(),
                    ref64=pm(torch.from_numpy(ev64)).numpy())
        pm.embedding.fused_sampler = "always"
        port["v2"] = pm.embedding(torch.from_numpy(ev64))

    for ps in procs.values():
        _wait(ps)
    got = {m: torch.load(o, weights_only=False) for m, o in outs.items()}
    port.update(got.pop("none"))  # the unsharded step, in a worker
    return dict(jax=j, port=port, got=got)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-4, err_msg=what)


def test_tp_eval_forward_holds_to_jax_and_to_the_unsharded_port(runs):
    j, p, got = runs["jax"], runs["port"], runs["got"]["tp"]["out"].numpy()
    assert np.isfinite(got).all() and got.shape == j["tp"].shape
    _close(got, j["tp"], "port TP vs JAX TP")
    _close(got, p["ref"], "port TP vs port")
    assert float(np.abs(got[..., 4:]).max()) > 0


def test_sp_eval_forward_holds_to_jax_and_to_the_unsharded_port(runs):
    j, p, got = runs["jax"], runs["port"], runs["got"]["sp"]["out"].numpy()
    assert np.isfinite(got).all() and got.shape == j["sp"].shape
    _close(got, j["sp"], "port SP vs JAX SP")
    _close(got, p["ref64"], "port SP vs port")
    # the whole-scan route on row shards: the unsharded route's bits
    v2 = runs["got"]["sp"]["v2"]
    assert v2.shape == p["v2"].shape and torch.equal(v2, p["v2"])
    # a fused site whose kernel refuses its row shard warns, gathers and
    # gives the whole map's rows
    ref = runs["got"]["sp"]["refused"]
    assert ref["warned"] == 1
    _close(ref["gathered"].numpy(), ref["whole"].numpy(), "refused shard")


def test_the_port_shards_what_jax_shards(runs):
    """A tensor is a slice in the port iff JAX's rule places it over
    "model"; each slice holds half of its whole tensor's rows."""
    flags, sharded = runs["jax"]["flags"], runs["got"]["tp"]["sharded"]
    assert set(sharded) == {k for k, f in flags.items() if f}
    whole = EASYOLOX(**KW).state_dict()
    for k, shape in sharded.items():
        assert shape[0] * 2 == whole[k].shape[0], k
        assert shape[1:] == tuple(whole[k].shape[1:]), k
    assert any(k.startswith("embedding.") for k in sharded)
    assert any("cls_preds" in k for k in sharded)
    assert not any("obj_preds" in k for k in sharded)
    assert runs["got"]["step"]["sharded"] == sorted(sharded)


def test_dp_tp_step_holds_to_jax(runs):
    """The 2 x 2 step's gathered checkpoint, loaded into an unsharded
    model, against JAX's 2 x 2 step, at JAX's own tolerances for that
    step (``tests/test_parallel.py:170-190``)."""
    j, got = runs["jax"], runs["got"]["step"]
    losses = got["losses"]
    np.testing.assert_allclose(losses["total_loss"],
                               j["metrics"]["total_loss"], rtol=1e-5)
    assert losses["num_fg"] == j["metrics"]["num_fg"] > 0
    ckpt = torch.load(got["ckpt"], weights_only=True)
    m = EASYOLOX(**KW)
    m.load_state_dict(ckpt["model"], strict=True)  # whole tensors
    sd = m.state_dict()
    for k, x in j["state"].items():
        if k.endswith("num_batches_tracked"):  # no JAX counterpart
            continue
        stat = k.endswith(("running_mean", "running_var"))
        np.testing.assert_allclose(sd[k].numpy(), x.numpy(), rtol=2e-3,
                                   atol=1e-4 if stat else 2e-3, err_msg=k)
    for k, x in j["ema"].items():
        np.testing.assert_allclose(ckpt["ema"][k].numpy(), x.numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=k)


def test_dp_tp_gradients_equal_the_unsharded_steps(runs):
    """The 2 x 2 step's reduced gradients, gathered whole, against the
    unsharded step's, within 1e-3 of each tensor's largest magnitude (as
    ``tests/test_torch_parallel.py`` holds DP's): Adam's first update
    moves by about lr whatever the gradient's scale, so the parameters
    alone would not show a gradient summed over the wrong group, or a
    share not summed at all."""
    got, p = runs["got"]["step"]["grads"], runs["port"]["grads"]
    assert got.keys() == p.keys()
    for k, g in p.items():
        assert got[k].shape == g.shape, k
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=0,
                                   atol=1e-3 * float(g.abs().max()) + 1e-12,
                                   err_msg=k)


def test_gathered_checkpoint_holds_the_unsharded_step(runs):
    """The 2 x 2 run's checkpoint against the port's step with no group on
    the whole batch (same tolerances), and its restore into a fresh 2 x 2
    run equal to the live sharded state, optimizer and EMA bit for bit."""
    got, p = runs["got"]["step"], runs["port"]
    assert got["restored_equal"]
    ckpt = torch.load(got["ckpt"], weights_only=True)
    assert ckpt["model"].keys() == p["state"].keys()
    for k, x in p["state"].items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(ckpt["model"][k], x), k
            continue
        stat = k.endswith(("running_mean", "running_var"))
        np.testing.assert_allclose(ckpt["model"][k].numpy(), x.numpy(),
                                   rtol=2e-3, atol=1e-4 if stat else 2e-3,
                                   err_msg=k)
    np.testing.assert_allclose(got["losses"]["total_loss"],
                               p["losses"]["total_loss"], rtol=1e-5)
    assert got["losses"]["num_fg"] == p["losses"]["num_fg"]


def test_one_by_one_mesh_gives_the_bits_of_no_group(runs):
    """A 1 x 1 mesh in a gloo group of one (every collective of the step
    runs over its groups of one) against the same step with no group."""
    one, p = runs["got"]["one"], runs["port"]
    assert one["losses"] == p["losses"]
    assert one["sharded"] == []
    for k, x in p["state"].items():
        assert torch.equal(one["state"][k], x), k


@pytest.mark.parametrize("tp", [2, 4])
def test_fusion_route_is_the_global_sites(tp):
    """Every fused flagship site still routes to its kernel with its Cout
    sharded over tp, and on a row shard of H / tp rows: the policy sees
    the global site. A mesh with no groups is enough to ask."""
    mesh = pmesh.Mesh2D(1, tp)
    for k, s, H, W, n, cin, cout in sorted(_MEASURED_WINS):
        whole = BaseConv(cin, cout, k, s, neuron=Neuron(True, 3)).eval()
        pieces = [torch.zeros(3, cin // n, H, W)] * n
        assert whole.fused(pieces)
        sharded = BaseConv(cin, cout, k, s, neuron=Neuron(True, 3)).eval()
        parallel.channel_shard_params(mesh, sharded)
        assert sharded.weight.shape[0] == cout // tp
        assert sharded.fused(pieces), (k, s, H, W, cout, tp)
        with parallel.spatial_sharding(mesh):
            assert whole.fused([p[..., :H // tp, :] for p in pieces])
        assert not whole.fused([p[..., :H // tp, :] for p in pieces])


@pytest.mark.parametrize("mode,tp", [("tp", 2), ("tp", 4), ("sp", 2),
                                     ("sp", 4)])
def test_flagship_launches_per_process_on_the_mesh(monkeypatch, mode, tp):
    """One process's flagship deploy forward (gen1_syolox_m, 256x320)
    channel-sharded over tp, or on its H / tp rows, sends 35 sites to the
    PLIF kernel, 8 to conv1x1, 6 to conv3x3 and 1 to conv3x3s2, as the
    unsharded forward does (``tests/test_torch_model.py``). Shapes only:
    the model runs on the meta device, the kernel wrappers are counters
    and the model group's all-gather hands back tp copies."""
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
                (x.shape[0], w.shape[1], (x.shape[2] - 1) // s + 1,
                 (x.shape[3] - 1) // s + 1), dtype=torch.int8,
                device=x.device)))
    monkeypatch.setattr(pmesh, "all_gather", lambda t, group=None: [t] * tp)
    mesh = pmesh.Mesh2D(1, tp)
    model = get_exp("gen1_syolox_m").deploy().get_model(device="cpu")
    model = model.to("meta")
    if mode == "tp":
        parallel.channel_shard_params(mesh, model)
        out = model(torch.empty((1, 1, 4, 256, 320, 2), device="meta"))
    else:
        with parallel.spatial_sharding(mesh):
            out = model(torch.empty((1, 1, 4, 256 // tp, 320, 2),
                                    device="meta"))
    assert out.shape == (1, 1680, 7)
    assert calls == {"plif": 35, "c1": 8, "c3": 6, "c3s2": 1}
