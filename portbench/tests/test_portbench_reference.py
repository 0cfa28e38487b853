"""The frozen reference against the port's plain CPU path, at a tiny
width: the same state dict loads into both; the eval forward, the train
losses, the first gradients and three Adam + EMA steps agree."""

import numpy as np
import pytest
import torch

from harness import checks, traffic, weights
from reference import train as ref_train
from reference.model import Detector, precision, spiking_sites
from reference.nms import postprocess as ref_postprocess

TINY = dict(embedding="arsnn", embedding_depth=2, embedding_ksize=5,
            use_spike=True, T=3, Tl=1, Tm=4, Ts=3, depth=0.33, width=0.125,
            num_classes=2, input_size=[64, 96], dtype="float32",
            sampler_dtype="float32")
TINY_COUNT = dict(TINY, embedding="count", use_spike=False, T=4, Ts=1,
                  num_classes=5)
MIX = dict(sensor=[60, 76], events_per_window=4000, boxes_per_image=[1, 4])


def port_model(model: dict, preset: str, train: bool):
    from eas_snn_tpu_torch.exp.build import get_exp

    exp = get_exp(preset)
    exp.depth, exp.width = model["depth"], model["width"]
    exp.input_size = exp.test_size = tuple(model["input_size"])
    exp.num_classes = model["num_classes"]
    exp.compute_dtype = "float32"
    return exp, exp.get_model(device="cpu", seed=0, train=train)


def made(model: dict, seed: int = 3):
    cfg = {"model": model}
    ref = Detector(cfg, precision("float32"))
    gen = torch.Generator().manual_seed(seed)
    sd = weights.make_state(ref, gen, "cpu")
    ref.load_state_dict(sd)
    return cfg, ref, sd


@pytest.mark.parametrize("model,preset", [(TINY, "gen1_syolox_m"),
                                          (TINY_COUNT, "e_yolox_m")])
def test_state_dict_names_match_the_port(model, preset):
    _, port = port_model(model, preset, False)
    _, ref, sd = made(model)
    assert set(sd) == set(port.state_dict())
    for k, v in port.state_dict().items():
        assert tuple(v.shape) == tuple(sd[k].shape), k


def test_eval_forward_matches_the_port():
    _, port = port_model(TINY, "gen1_syolox_m", False)
    cfg, ref, sd = made(TINY)
    gen = torch.Generator().manual_seed(5)
    ev = traffic.event_batch(MIX, TINY, 4, gen, "cpu")
    weights.calibrate(ref, spiking_sites(ref), ev)
    sd = ref.state_dict()
    port.load_state_dict(sd)
    ref.eval()
    with torch.no_grad():
        a = port.eval()(ev).numpy()
        b = ref(ev).numpy()
    assert np.abs(a[..., 4:] - b[..., 4:]).max() < 1e-4
    assert np.abs(a[..., :4] - b[..., :4]).max() < 1e-3
    from eas_snn_tpu_torch.ops.boxes import postprocess
    for x, y in zip(postprocess(a, 2, 0.001, 0.65),
                    ref_postprocess(b, 2, 0.001, 0.65)):
        assert (x is None) == (y is None)


@pytest.mark.parametrize("model,preset", [(TINY, "gen1_syolox_m"),
                                          (TINY_COUNT, "e_yolox_m")])
def test_three_train_steps_match_the_port(model, preset):
    from eas_snn_tpu_torch.core.train_state import init_ema, train_step

    exp, port = port_model(model, preset, True)
    cfg, ref, sd = made(model)
    port.load_state_dict(sd)
    gen = torch.Generator().manual_seed(7)
    rng = np.random.default_rng(7)
    batches = [(traffic.event_batch(MIX, model, 2, gen, "cpu"),
                traffic.labels(MIX, model, 2, rng)) for _ in range(3)]
    opt = exp.get_optimizer(port, 2, iters_per_epoch=1000)
    ema = init_ema(port)
    got = []
    for t, (e, l) in enumerate(batches):
        got.append(train_step(port, opt, ema, e, l, to_host=True))
        if t == 0:
            g1 = {k: p.grad.clone() for k, p in port.named_parameters()}
    sched = {"fixed": dict(name="fixed", lr=exp.basic_lr_per_img * 2),
             "yoloxwarmcos": dict(name="yoloxwarmcos",
                                  lr=exp.basic_lr_per_img * 2,
                                  iters_per_epoch=1000,
                                  max_epoch=exp.max_epoch,
                                  warmup_epochs=exp.warmup_epochs,
                                  no_aug_epochs=exp.no_aug_epochs,
                                  min_lr_ratio=exp.min_lr_ratio)}[exp.scheduler]
    res = ref_train.steps(ref, batches, sched, 3)
    for a, b in zip(got, res["losses"]):
        assert abs(a["total_loss"] - b["total_loss"]) <= 1e-5 * abs(
            b["total_loss"])
    p0 = sd
    prog = dict(losses=got, grad=checks.leaf_norms(g1),
                update=checks.leaf_norms({k: p.detach() - p0[k]
                                          for k, p in port.named_parameters()}),
                ema=checks.leaf_norms({k: ema[k] - p0[k] for k in ema}))
    refr = dict(losses=res["losses"], grad=checks.leaf_norms(res["grad"]),
                update=checks.leaf_norms({k: v - p0[k] for k, v in
                                          res["params"].items()}),
                ema=checks.leaf_norms({k: v - p0[k] for k, v in
                                       res["ema"].items()}))
    nums = checks.train_numbers(prog, refr)
    assert nums["loss_gap"] < 1e-5
    assert nums["grad_gap"] < 1e-4
    assert nums["update_gap"] < 1e-3
    assert nums["ema_gap"] < 1e-3


@pytest.mark.parametrize("model,preset", [(TINY, "gen1_syolox_m"),
                                          (TINY_COUNT, "e_yolox_m")])
def test_a_step_from_the_ports_state_matches_the_port(model, preset):
    """The reference takes the port's fourth step from the port's state
    (parameters, buffers, Adam's moments, the EMA), as a run holds a
    replay."""
    from eas_snn_tpu_torch.core.train_state import init_ema, train_step

    exp, port = port_model(model, preset, True)
    cfg, ref, sd = made(model)
    port.load_state_dict(sd)
    gen = torch.Generator().manual_seed(11)
    rng = np.random.default_rng(11)
    batches = [(traffic.event_batch(MIX, model, 2, gen, "cpu"),
                traffic.labels(MIX, model, 2, rng)) for _ in range(4)]
    opt = exp.get_optimizer(port, 2, iters_per_epoch=1000)
    ema = init_ema(port)
    for e, l in batches[:3]:
        train_step(port, opt, ema, e, l)
    params = dict(port.named_parameters())
    snap = dict(state={k: v.clone() for k, v in port.state_dict().items()},
                m={k: opt.state[p]["exp_avg"].clone()
                   for k, p in params.items()},
                v={k: opt.state[p]["exp_avg_sq"].clone()
                   for k, p in params.items()},
                ema={k: v.clone() for k, v in ema.items()})
    got = train_step(port, opt, ema, *batches[3], to_host=True)
    p0 = {k: snap["state"][k] for k in params}
    prog = dict(losses=[got], grad=checks.leaf_norms(
                    {k: p.grad for k, p in params.items()}),
                update=checks.leaf_norms({k: p.detach() - p0[k]
                                          for k, p in params.items()}),
                ema=checks.leaf_norms({k: ema[k] - snap["ema"][k]
                                       for k in ema}))
    ref.load_state_dict(snap["state"])
    sched = dict(name=exp.scheduler, lr=exp.basic_lr_per_img * 2,
                 iters_per_epoch=1000, max_epoch=exp.max_epoch,
                 warmup_epochs=exp.warmup_epochs,
                 no_aug_epochs=exp.no_aug_epochs,
                 min_lr_ratio=exp.min_lr_ratio)
    adam = {k: {n: t.clone() for n, t in snap[k].items()}
            for k in ("m", "v", "ema")}
    res = ref_train.steps(ref, batches[3:], sched, 1, start=3, adam=adam)
    refr = dict(losses=res["losses"], grad=checks.leaf_norms(res["grad"]),
                update=checks.leaf_norms({k: v - p0[k] for k, v in
                                          res["params"].items()}),
                ema=checks.leaf_norms({k: v - snap["ema"][k] for k, v in
                                       res["ema"].items()}))
    nums = checks.replay_numbers(prog, refr)
    assert nums["replay_loss_gap"] < 1e-5
    assert nums["replay_grad_gap"] < 1e-4
    assert nums["replay_update_gap"] < 1e-3
    assert nums["replay_ema_gap"] < 1e-3
    # a step counted one update early (bias correction, rate, decay) is seen
    adam = {k: {n: t.clone() for n, t in snap[k].items()}
            for k in ("m", "v", "ema")}
    ref.load_state_dict(snap["state"])
    early = ref_train.steps(ref, batches[3:], sched, 1, start=2, adam=adam)
    off = checks.replay_numbers(prog, dict(
        refr, update=checks.leaf_norms({k: v - p0[k] for k, v in
                                        early["params"].items()})))
    assert off["replay_update_median_gap"] > 1e-2
