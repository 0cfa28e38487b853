"""The port's train entry point on the CPU: the multiscale resize and the
EMA against the JAX package, checkpoints written with device-tensor
learning rates, the trainer end to end from a synthetic Gen1 directory
(the exp's loader, multiscale, JSONL rows, checkpoints, resume, fine-tune)
and the command line. The captured step (CUDA graphs) runs only on the
card: ``chip_smoke.py`` phase 6b holds it to the eager step there.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eas_snn_tpu.core.train_state import ema_update as j_ema_update
from eas_snn_tpu.core.trainer import _multiscale_resize as j_ms_resize
from eas_snn_tpu.exp.event_exp import EventExp as JEventExp

from eas_snn_tpu_torch.core import optim as poptim
from eas_snn_tpu_torch.core.checkpoint import CheckpointManager
from eas_snn_tpu_torch.core.train_state import (CapturedStep, ema_apply,
                                                ema_terms, init_ema)
from eas_snn_tpu_torch.core.trainer import multiscale_resize
from eas_snn_tpu_torch.exp import get_exp
from eas_snn_tpu_torch.ops import plif as pplif
from eas_snn_tpu_torch.tools.train_event import build

from test_torch_data import write_tree


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ----------------------------------------------------------- multiscale

@pytest.mark.parametrize("src,dst", [((64, 64), (96, 96)),
                                     ((64, 64), (32, 32)),
                                     ((256, 320), (288, 352)),
                                     ((256, 320), (224, 288))])
def test_multiscale_resize_equals_jax_bitwise(src, dst):
    rng = np.random.default_rng(0)
    ev = rng.poisson(0.5, (2, 1, 4) + src + (2,)).astype(np.float32)
    ev += rng.uniform(size=ev.shape).astype(np.float32)  # distinct values
    lab = np.zeros((2, 50, 5), np.float32)
    lab[:, :7] = rng.uniform(1, 60, (2, 7, 5)).astype(np.float32)
    je, jt = j_ms_resize(jnp.asarray(ev), jnp.asarray(lab), dst)
    pe, pt = multiscale_resize(torch.from_numpy(ev), torch.from_numpy(lab),
                               dst)
    assert tuple(pe.shape) == (2, 1, 4) + dst + (2,)
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    t_ev, t_lab = torch.from_numpy(ev), torch.from_numpy(lab)
    assert multiscale_resize(t_ev, t_lab, src) == (t_ev, t_lab)


# ---------------------------------------------------------- EMA, optim

class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.embedding = torch.nn.Conv2d(2, 3, 3)
        self.conv = torch.nn.Conv2d(3, 4, 1)
        self.bn = torch.nn.BatchNorm2d(4)

    def forward(self, x):
        return self.bn(self.conv(self.embedding(x))).square().mean()


def test_ema_with_device_scalar_decay_matches_jax():
    """The decay and 1 - d as 0-d tensors, filled by the host as a
    captured step does; the tolerance of
    test_torch_train.py::test_ema_update_matches_jax."""
    torch.manual_seed(1)
    m = _Tiny()
    ema = init_ema(m)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(torch.randn_like(p))
    je = {n: e.numpy().copy() for n, e in ema.items()}
    d, omd = torch.zeros(()), torch.zeros(())
    for step in (1, 7, 2000, 100000):
        je = j_ema_update(je, {n: p.detach().numpy()
                               for n, p in m.named_parameters()},
                          jnp.asarray(step))
        dv, omdv = ema_terms(step)
        d.fill_(float(dv))
        omd.fill_(float(omdv))
        ema_apply(ema, m, d, omd)
        for n in ema:
            np.testing.assert_allclose(ema[n].numpy(), np.asarray(je[n]),
                                       rtol=1e-6, atol=1e-7)


def _adam(model, tensor_lr: bool):
    """The port's Adam groups; with ``tensor_lr`` each group's lr a 0-d
    tensor, as build_optimizer makes them on the card (on the CPU torch
    takes a tensor lr without foreach)."""
    opt = poptim.build_optimizer(model, poptim.build_lr_schedule(
        "yoloxwarmcos", 1e-2, 2, 3, warmup_epochs=1), emb_lr=3e-3,
        base_lr=1e-2)
    if tensor_lr:
        for g in opt.param_groups:
            g["lr"] = torch.tensor(float(g["lr"]))
            g["foreach"] = False
    return opt


def _steps(m, opt, n, seed):
    g = torch.Generator().manual_seed(seed)
    for _ in range(n):
        opt.zero_grad()
        m(torch.randn(2, 2, 6, 6, generator=g)).backward()
        t = poptim.updates(opt)
        poptim.set_learning_rate(opt, t)
        opt.step()
        for grp in opt.param_groups:
            grp["updates"] = t + 1


@pytest.mark.parametrize("saved_tensor,load_tensor", [
    (True, False), (False, True), (True, True)])
def test_checkpoint_with_tensor_lrs_round_trips(tmp_path, saved_tensor,
                                                load_tensor):
    torch.manual_seed(0)
    m = _Tiny()
    opt = _adam(m, saved_tensor)
    _steps(m, opt, 3, 0)
    sd = opt.state_dict()
    if saved_tensor:  # as written on the card: capturable, steps on device
        for grp in sd["param_groups"]:
            grp["capturable"] = True
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, m, opt)
    m2 = _Tiny()
    opt2 = _adam(m2, load_tensor)
    lr_obj = opt2.param_groups[0]["lr"]
    assert mgr.restore(m2, opt2) == (3, 0.0)
    assert poptim.updates(opt2) == 3
    for g, g0 in zip(opt2.param_groups, opt.param_groups):
        assert isinstance(g["lr"], torch.Tensor) == load_tensor
        # a tensor lr is f32: the value of the other kind, rounded
        assert float(g["lr"]) == float(np.float32(float(g0["lr"]))) \
            if load_tensor else float(g["lr"]) == float(g0["lr"])
        assert g["capturable"] is False and g["lr_scale"] == g0["lr_scale"]
    if load_tensor:
        assert opt2.param_groups[0]["lr"] is lr_obj
    for p in m2.parameters():
        assert opt2.state[p]["step"].device.type == "cpu"
    _steps(m, opt, 2, 5)
    _steps(m2, opt2, 2, 5)
    # the same updates: bit for bit with the same kind of lr, else within
    # the f32 rounding of the lr
    tol = 0 if saved_tensor == load_tensor else 1e-6
    for a, b in zip(m.parameters(), m2.parameters()):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol * 1e-3)


def test_set_learning_rate_fills_tensor_lrs_in_place():
    m = _Tiny()
    opt = _adam(m, True)
    objs = [g["lr"] for g in opt.param_groups]
    poptim.set_learning_rate(opt, 2)
    for g, o in zip(opt.param_groups, objs):
        assert g["lr"] is o
        assert float(o) == pytest.approx(opt.lr_schedule(2) * g["lr_scale"])
    assert poptim.learning_rate(opt) == opt.lr_schedule(0)


def test_captured_step_needs_a_cuda_model():
    m = _Tiny()
    with pytest.raises(ValueError, match="CUDA"):
        CapturedStep(m, _adam(m, False), None)


def test_bwd_scratch_keeps_replaced_buffers(monkeypatch):
    """A buffer that growth replaces stays alive (a graph may hold its
    address); during a capture nothing is made or grown."""
    monkeypatch.setattr(pplif, "_BWD_SCRATCH", {})
    monkeypatch.setattr(pplif, "_BWD_RETIRED", [])
    dev = torch.device("cpu")  # the bookkeeping runs on any device
    a = pplif._bwd_scratch(dev, 7, 100)
    assert pplif._bwd_scratch(dev, 7, 4096) is a
    b = pplif._bwd_scratch(dev, 7, 5000)
    assert b.numel() >= 5000 and pplif._BWD_RETIRED == [a]
    monkeypatch.setattr(pplif, "_capturing", lambda d: True)
    assert pplif._bwd_scratch(dev, 7, 10) is b
    with pytest.raises(RuntimeError, match="capture"):
        pplif._bwd_scratch(dev, 7, 1 << 20)
    with pytest.raises(RuntimeError, match="capture"):
        pplif._bwd_scratch(dev, 8, 10)


# -------------------------------------------------------------- trainer

def _argv(data, out, *extra):
    return ["-n", "gen1_syolox_s", "-b", "2", "-l", "jsonl", *extra,
            "data_dir", data, "output_dir", out, "width", "0.125", "depth",
            "0.33", "compute_dtype", "float32", "input_size", "(32, 32)",
            "multiscale_interval", "1", "multiscale_range", "1",
            "data_num_workers", "0", "print_interval", "1", "max_epoch",
            "1", "seed", "1", "max_events_per_slice", "4096"]


def _run(exp, args):
    """``Trainer.train`` with the geometry of every step recorded."""
    tr = exp.get_trainer(args, device="cpu")
    tr.before_train()
    sizes, step = [], tr.step_fn

    def recording(events, targets, use_l1=False):
        sizes.append(tuple(events.shape[3:5]))
        return step(events, targets, use_l1=use_l1)

    tr.step_fn = recording
    try:
        for tr.epoch in range(tr.start_epoch, tr.max_epoch):
            tr.before_epoch()
            assert tr.train_in_iter()
            tr.after_epoch()
    finally:
        tr.after_train()
    return tr, sizes


def test_trainer_trains_from_a_gen1_directory(tmp_path):
    data = write_tree(str(tmp_path / "gen1"), groups=3)
    out = str(tmp_path / "out")
    exp, args = build(_argv(data, out))
    exp.iters_per_epoch = 3
    tr, sizes = _run(exp, args)
    # the JAX package's seeded size choice, every step, of two sizes
    rng = np.random.default_rng(1)
    assert sizes == [[(32, 32), (64, 64)][int(rng.integers(2))]
                     for _ in range(3)]
    assert len(set(sizes)) == 2
    run = os.path.join(out, "gen1_syolox_s")
    rows = [json.loads(r) for r in open(os.path.join(run, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2, 3]
    for r in rows:
        assert r["split"] == "train" and np.isfinite(r["total_loss"])
        assert set(r) >= {"ts", "iou_loss", "conf_loss", "cls_loss",
                          "l1_loss", "num_fg"}
    assert os.listdir(os.path.join(run, "ckpt")) == ["ckpt_3.pth"]
    assert tr.meter["total_loss"].count == 3
    assert "iter: 3/3" in open(os.path.join(run, "train_log.txt")).read()

    # resume: epoch 2 of 2 starts at step 3
    exp, args = build(_argv(data, out, "--resume") + ["max_epoch", "2"])
    exp.iters_per_epoch = 3
    assert args.resume
    tr2, _ = _run(exp, args)
    assert tr2.start_epoch == 1
    assert poptim.updates(tr2.optimizer) == 6
    rows = [json.loads(r) for r in open(os.path.join(run, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5, 6]
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == [
        "ckpt_3.pth", "ckpt_6.pth"]

    # fine-tune: a new run loads the weights, shape-checked
    exp, args = build(["-expn", "ft"] + _argv(
        data, out, "-c", os.path.join(run, "ckpt", "ckpt_6.pth")))
    tr3 = exp.get_trainer(args, device="cpu")
    tr3.before_train()
    tr3.after_train()
    report = tr3.finetune_report
    assert report["loaded"] == len(tr3.model.state_dict())
    assert report["shape_mismatch"] == report["missing"] == []
    for k, v in tr2.model.state_dict().items():
        assert torch.equal(tr3.model.state_dict()[k], v), k
    for n, p in tr3.model.named_parameters():
        assert torch.equal(tr3.ema[n], p)
    assert "fine-tune init" in open(os.path.join(
        out, "ft", "train_log.txt")).read()


def test_trainer_bins_raw_events_on_the_device(tmp_path):
    data = write_tree(str(tmp_path / "gen1"), groups=2)
    exp, args = build(_argv(data, str(tmp_path / "out"))
                      + ["device_binning", "True", "multiscale_interval",
                         "0"])
    exp.iters_per_epoch = 2
    tr, sizes = _run(exp, args)
    assert sizes == [(32, 32)] * 2
    assert all(np.isfinite(v) for v in tr.last_losses.values())


# ------------------------------------------------------------------ CLI

def test_command_line_and_merge():
    exp, args = build(["-n", "gen1_syolox_m", "-b", "16", "--resume",
                       "--profile", "3", "-expn", "run1", "data_dir",
                       "/data/gen1", "max_epoch", "3", "flip_prob", "0.25",
                       "input_size", "(288, 352)", "device_binning", "True",
                       "seed", "5"])
    assert (args.batch_size, args.resume, args.profile, args.device,
            args.experiment_name, args.logger) == (16, True, 3, "cuda",
                                                   "run1", "auto")
    assert exp.data_dir == "/data/gen1" and exp.seed == 5
    assert exp.data_name == "gen1"
    # the JAX package's coercion, field for field, where the field has a
    # value to coerce to
    opts = ["max_epoch", "3", "flip_prob", "0.25", "input_size",
            "(288, 352)", "device_binning", "True", "aggregation", "sum",
            "multiscale_range", "2", "exp_name", "12"]
    pexp, jexp = get_exp("gen1_syolox_m").merge(opts), JEventExp().merge(
        opts)
    for k in opts[0::2]:
        assert getattr(pexp, k) == getattr(jexp, k), k
        assert type(getattr(pexp, k)) is type(getattr(jexp, k)), k
    with pytest.raises(KeyError, match="unknown config key"):
        pexp.merge(["no_such_key", "1"])
    with pytest.raises(ValueError, match="multiples of 32"):
        build(["-n", "gen1_syolox_m", "input_size", "(250, 320)"])
    with pytest.raises(SystemExit, match="JAX package"):
        build(["-f", "exps/default/gen1_syolox_m.py"])
    with pytest.raises(NotImplementedError, match="item 9"):
        exp.get_evaluator(8)
    fp, _ = build(["-n", "gen1_syolox_s", "--fp16", "compute_dtype",
                   "float32"])
    assert fp.compute_dtype == "float32"  # explicit overrides win


def test_trainer_refuses_a_loader_run_without_a_batch_size(tmp_path):
    exp = get_exp("gen1_syolox_s")
    exp.output_dir = str(tmp_path)
    tr = exp.get_trainer(argparse.Namespace(), device="cpu")
    with pytest.raises(ValueError, match="batch_size"):
        tr.train()
