"""The port's eval entry point on the CPU: SOP / MAC counting against the
JAX package's on a tiny arsnn SYOLOX with the same weights, the AP-drift
data writer's bytes, each package's ``exp.eval`` over one synthetic Gen1
tree, the eval constants following new weights, the trainer's
evaluate-and-save hook (best AP, ``best.pth``, resume, the train state
untouched) and the eval command line on ``--device cpu``.
"""

import filecmp
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eas_snn_tpu.evaluators.energy import conv_macs_per_frame as j_conv_macs
from eas_snn_tpu.evaluators import count_ops as j_count_ops
from eas_snn_tpu.evaluators import event_evaluator as jev
from eas_snn_tpu.evaluators import estimate_energy as j_estimate_energy
from eas_snn_tpu.exp import get_exp as jget_exp
from eas_snn_tpu.models import EASYOLOX as JEASYOLOX

from eas_snn_tpu_torch.core import optim as poptim
from eas_snn_tpu_torch.core.checkpoint import eval_state_dict
from eas_snn_tpu_torch.evaluators import (EventEvaluator, PSEEEvaluator,
                                          conv_macs_per_frame, count_ops,
                                          estimate_energy)
from eas_snn_tpu_torch.exp import get_exp
from eas_snn_tpu_torch.models import EASYOLOX
from eas_snn_tpu_torch.tools import ap_drift, eval_event
from eas_snn_tpu_torch.tools.train_event import build
from eas_snn_tpu_torch.utils import state_dict_from_jax
from eas_snn_tpu_torch.utils.weights import _module_tokens

from test_torch_data import write_tree
from test_torch_model import SMALL, _random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(SMALL, T=2, Ts=2)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tiny():
    """The JAX model (width 0.125, T = Ts = 2) with firing variables, the
    port's with the same weights (f32), and a Poisson batch at 64x64."""
    rng = np.random.default_rng(0)
    ev = rng.poisson(0.2, (2, 1, 4, 64, 64, 2)).astype(np.float32)
    jm = JEASYOLOX(use_spike="backbone", embedding="arsnn", **TINY)
    v = _random_variables(jm, ev, rng)
    pm = EASYOLOX(use_spike="backbone", **TINY).eval()
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return jm, v, pm, ev


# ------------------------------------------------------------ SOPs, MACs

def test_count_ops_equals_jax_per_module(tiny):
    """Every BaseConv's MACs equal the JAX package's, and its SOPs agree
    within 1e-5 relative: the sites' input spikes agree exactly (held by
    test_torch_model.py::test_whole_slice_matches_jax_f32), and the
    analog sites' inputs and both packages' f32 window sums differ only
    in summation order (seen: below 1e-6)."""
    jm, v, pm, ev = tiny
    want = {".".join(_module_tokens(tuple(k.split("/")))): a
            for k, a in j_count_ops(jm, v, jnp.asarray(ev)).items()}
    got = count_ops(pm, torch.from_numpy(ev))
    assert set(got) == set(want) and len(got) > 60
    for name, a in got.items():
        b = np.asarray(want[name], np.float64)
        assert a[1] == b[1] and a[2] == b[2], name
        assert abs(a[0] - b[0]) <= 1e-5 * max(abs(b[0]), 1.0), name
    spiking = [a for a in got.values() if a[2] == 1]
    assert spiking and all(a[0] > 0 for a in spiking)
    assert not pm.training  # count_ops restores the mode

    e, je = (estimate_energy(pm, torch.from_numpy(ev)),
             j_estimate_energy(jm, v, jnp.asarray(ev)))
    assert e.keys() == je.keys()
    for k in e:
        assert abs(e[k] - je[k]) <= 1e-5 * abs(je[k]), k


def test_conv_macs_per_frame_equals_jax(tiny):
    jm, _, pm, _ = tiny
    shape = (1, 1, 4, 64, 96, 2)
    want = j_conv_macs(jm, shape)
    assert conv_macs_per_frame(pm, shape) == want
    # shape only: the weights and the compute dtype do not change it
    bf = EASYOLOX(use_spike="backbone", compute_dtype=torch.bfloat16,
                  **TINY).train()
    assert conv_macs_per_frame(bf, shape) == want
    assert bf.training


# ----------------------------------------------------------------- data

def test_ap_drift_writer_writes_the_jax_tools_bytes(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "jax_ap_drift", os.path.join(REPO, "tools", "ap_drift.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    for tag, fn in (("j", jtool._make_stream), ("p", ap_drift._make_stream)):
        fn(str(tmp_path / f"{tag}_td.dat"), str(tmp_path / f"{tag}_bbox.npy"),
           seed=101, duration_us=1_500_000)
    for suffix in ("_td.dat", "_bbox.npy"):
        assert filecmp.cmp(tmp_path / f"j{suffix}", tmp_path / f"p{suffix}",
                           shallow=False)
    assert ap_drift.CLASS_SIZES == jtool.CLASS_SIZES


@pytest.fixture(scope="module")
def val_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("drift"))
    ap_drift.make_data(root, n_train=0, n_val=2, duration_us=3_000_000)
    return root


# ------------------------------------------------------------- exp.eval

_OPTS = ["width", "0.125", "depth", "0.33", "T", "2", "Ts", "2",
         "compute_dtype", "float32", "test_size", "(64, 64)",
         "input_size", "(64, 64)", "data_num_workers", "0"]


def test_exp_eval_equals_jax(tiny, val_tree, monkeypatch):
    """One tree through each package's exp, map_val loader, evaluator and
    ``exp.eval``, the same weights (obj and cls biases at 0, so that
    detections pass the filter and the host NMS runs on them). Random
    weights score an AP near 0, which would hide a fault of the wiring
    (letterbox scale, frames, dtype), so the rows the matcher is given
    are held to JAX's: ground truth equal, detections the same in number
    and, row by row, within 1e-3 px (boxes, at the sensor's size: the
    decoded outputs agree within the whole-slice test's 1e-4 at 64x64,
    divided by the letterbox scale 64/304) and 1e-4 (scores). AP and AP50
    within 1e-3: a box moved that far rarely crosses an IoU threshold."""
    jm, v, _, _ = tiny
    v = jax.tree_util.tree_map(np.copy, v)
    for k in range(3):
        for p in ("obj_pred", "cls_pred"):
            pred = v["params"]["head"][f"{p}{k}"]
            pred["bias"] = np.zeros_like(pred["bias"])
    opts = ["data_dir", val_tree] + _OPTS
    jexp = jget_exp(exp_name="gen1_syolox_s")
    jexp.merge(opts)
    pexp = get_exp("gen1_syolox_s").merge(opts)
    jexp.eval_proph = pexp.eval_proph = False
    jmodel = jexp.get_model()
    seen = []  # JAX's det rows, then its gt rows
    monkeypatch.setattr(jev, "_allgather_rows",
                        lambda rows: seen.append(rows) or rows)
    want = jexp.eval(jmodel, v, jexp.get_evaluator(batch_size=4))
    pmodel = pexp.get_model(device="cpu")
    pmodel.load_state_dict(state_dict_from_jax(v), strict=True)
    ev = pexp.get_evaluator(batch_size=4)
    assert isinstance(ev, EventEvaluator) and ev.confthre == 0.01
    got = pexp.eval(pmodel.train(), ev)
    assert pmodel.training  # exp.eval restores the mode
    assert abs(got[0] - want[0]) <= 1e-3 and abs(got[1] - want[1]) <= 1e-3
    (det, gt), (jdet, jgt) = ev.last_rows, seen
    assert np.array_equal(gt, jgt) and len(gt) > 0
    assert det.shape == jdet.shape and len(det) > 100  # real detections
    order = lambda r: r[np.lexsort((r[:, 3], r[:, 2], r[:, 1], r[:, 0]))]
    det, jdet = order(det), order(jdet)
    assert np.array_equal(det[:, :2], jdet[:, :2])  # image ids, classes
    np.testing.assert_allclose(det[:, 2:6], jdet[:, 2:6], rtol=0, atol=1e-3)
    np.testing.assert_allclose(det[:, 6], jdet[:, 6], rtol=0, atol=1e-4)
    assert ev.timing["samples"] == len(ev.dataloader.dataset) == 12

    pexp.eval_proph = True
    pev = pexp.get_evaluator(batch_size=4)
    assert isinstance(pev, PSEEEvaluator) and pev.confthre == 0.001
    assert (pev.camera, pev.downsampled_by_2) == ("gen1", False)
    ap, ap50, text = pexp.eval(pmodel, pev)
    assert -1.0 <= ap <= 1.0 and "AP_50" in text


def test_eval_constants_follow_new_weights(tiny):
    """Evaluate, change the weights in place (as the trainer's refresh and
    an EMA copy do), evaluate again: the outputs follow, and equal a fresh
    model's with the new weights bit for bit."""
    _, v, pm, ev = tiny
    x = torch.from_numpy(ev)
    m = EASYOLOX(use_spike="backbone", **TINY).eval()
    m.load_state_dict(pm.state_dict())
    with torch.inference_mode():
        first = m(x)
    new = {k: (t * 1.25 if k.endswith((".bn.weight", ".act.w",
                                       "running_mean")) else t)
           for k, t in pm.state_dict().items()}
    with torch.no_grad():
        for k, t in m.state_dict().items():
            t.copy_(new[k])
    fresh = EASYOLOX(use_spike="backbone", **TINY).eval()
    fresh.load_state_dict(new)
    with torch.inference_mode():
        again, want = m(x), fresh(x)
    assert not torch.equal(again, first)
    assert torch.equal(again, want)


# -------------------------------------------------------------- trainer

def _argv(data, out, *extra):
    return ["-n", "gen1_syolox_s", "-b", "2", "-l", "jsonl", *extra,
            "data_dir", data, "output_dir", out, "width", "0.125", "depth",
            "0.33", "compute_dtype", "float32", "input_size", "(32, 32)",
            "test_size", "(32, 32)", "data_num_workers", "0",
            "print_interval", "1", "max_epoch", "2", "eval_interval", "1",
            "seed", "1", "max_events_per_slice", "4096"]


def _train_state(tr):
    out = [t.clone() for t in tr.model.state_dict().values()]
    for g in tr.optimizer.param_groups:
        for p in g["params"]:
            out += [t.clone() for t in tr.optimizer.state[p].values()
                    if isinstance(t, torch.Tensor)]
    return out + [t.clone() for t in tr.ema.values()]


@pytest.fixture(scope="module")
def gen1(tmp_path_factory):
    return write_tree(str(tmp_path_factory.mktemp("gen1_hook")), groups=3)


def test_trainer_evaluates_between_epochs(tmp_path, gen1):
    """eval_interval 1: each epoch's end evaluates the EMA weights in the
    separate eval model, logs a val row and checkpoints; a further
    evaluation leaves every train-state tensor as it was."""
    out = str(tmp_path / "out")
    exp, args = build(_argv(gen1, out))
    exp.iters_per_epoch = 2
    tr = exp.get_trainer(args, device="cpu")
    tr.before_train()
    for tr.epoch in range(tr.max_epoch):
        tr.before_epoch()
        assert tr.train_in_iter()
        tr.after_epoch()
    run = os.path.join(out, "gen1_syolox_s")
    rows = [json.loads(r) for r in open(os.path.join(run, "metrics.jsonl"))]
    val = [r for r in rows if r["split"] == "val"]
    assert [r["step"] for r in val] == [2, 4]
    assert all(0.0 <= r["AP50_95"] <= 1.0 and 0.0 <= r["AP50"] <= 1.0
               for r in val)
    assert tr.eval_model is not None and tr.eval_model is not tr.model
    assert not tr.eval_model.training and tr.model.training
    for n, p in tr.eval_model.named_parameters():
        assert torch.equal(p, tr.ema[n]), n
    for n, b in tr.eval_model.named_buffers():
        assert torch.equal(b, dict(tr.model.named_buffers())[n]), n
    log = open(os.path.join(run, "train_log.txt")).read()
    assert "epoch 2 eval: AP=" in log and "conv GFLOPs/frame" in log

    before = _train_state(tr)
    tr.evaluate_and_save_model()
    after = _train_state(tr)
    tr.after_train()
    assert len(before) == len(after)
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_best_ap_best_checkpoint_and_resume(tmp_path, gen1, monkeypatch):
    """Scripted APs 0.2, 0.1, 0.3: best_ap rises only on a new best,
    ``best.pth`` holds the best epoch's state (EMA for eval), and a
    resumed trainer starts from the saved best AP."""
    out = str(tmp_path / "out")
    exp, args = build(_argv(gen1, out) + ["max_epoch", "3"])
    exp.iters_per_epoch = 1
    aps = iter([0.2, 0.1, 0.3])
    calls = []

    def scripted(model, evaluator):
        calls.append(model)
        ap = next(aps)
        return ap, ap + 0.5, "scripted"

    monkeypatch.setattr(exp, "eval", scripted)
    tr = exp.get_trainer(args, device="cpu")
    tr.before_train()
    best_steps, bests = [], []
    ckpt_dir = os.path.join(out, "gen1_syolox_s", "ckpt")
    try:
        for tr.epoch in range(tr.max_epoch):
            tr.before_epoch()
            assert tr.train_in_iter()
            tr.after_epoch()
            best = os.path.join(ckpt_dir, "best.pth")
            best_steps.append(torch.load(best, weights_only=True)["step"])
            bests.append(tr.best_ap)
    finally:
        tr.after_train()
    assert bests == [0.2, 0.2, 0.3]
    assert best_steps == [1, 1, 3]
    assert all(m is tr.eval_model for m in calls)  # built once
    sd = eval_state_dict(os.path.join(ckpt_dir, "best.pth"))
    for n, e in tr.ema.items():
        assert torch.equal(sd[n], e), n  # the EMA, not the trained weights
    assert torch.load(os.path.join(ckpt_dir, "ckpt_3.pth"),
                      weights_only=True)["best_ap"] == 0.3
    rows = [json.loads(r) for r in open(os.path.join(
        out, "gen1_syolox_s", "metrics.jsonl"))]
    assert [r["AP50_95"] for r in rows if r["split"] == "val"] == [
        0.2, 0.1, 0.3]

    exp, args = build(_argv(gen1, out, "--resume") + ["max_epoch", "4"])
    exp.iters_per_epoch = 1
    tr2 = exp.get_trainer(args, device="cpu")
    tr2.before_train()
    tr2.after_train()
    assert tr2.best_ap == 0.3 and tr2.start_epoch == 3
    assert poptim.updates(tr2.optimizer) == 3


# ------------------------------------------------------------------ CLI

def test_eval_command_line_on_the_cpu(tmp_path, val_tree):
    base = ["-n", "gen1_syolox_s", "-b", "4", "--device", "cpu"]
    opts = ["data_dir", val_tree] + _OPTS
    exp, args = eval_event.build(base + ["--fp16", "--eval_proh"] + opts)
    assert (exp.compute_dtype, exp.fused_sampler) == ("float32", "auto")
    assert exp.eval_proph and args.device == "cpu" and args.batch_size == 4
    assert eval_event.make_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            eval_event.main(["-n", "gen1_syolox_s"] + opts)
    with pytest.raises(SystemExit, match="JAX package"):
        eval_event.build(["-f", "exps/default/gen1_syolox_s.py"])

    # a port checkpoint: its EMA is what gets evaluated
    m = get_exp("gen1_syolox_s").merge(_OPTS).get_model(device="cpu")
    sd = m.state_dict()
    ema = {n: p.detach() * 0.5 for n, p in m.named_parameters()}
    ckpt = str(tmp_path / "best.pth")
    torch.save({"model": sd, "optimizer": {}, "ema": ema, "step": 7,
                "best_ap": 0.1}, ckpt)
    ref = str(tmp_path / "ref.pth")
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, ref)
    got = eval_state_dict(ckpt)
    assert all(torch.equal(got[n], e) for n, e in ema.items())
    got = eval_state_dict(ref)
    assert all(torch.equal(got[k], v) for k, v in sd.items())

    coco = eval_event.main(base + ["-c", ckpt] + opts)
    assert isinstance(coco["evaluator"], EventEvaluator)
    assert coco["timing"]["samples"] == 12 and -1 <= coco["ap"] <= 1
    proph = eval_event.main(base + ["-c", ref, "--eval_proh"] + opts)
    assert isinstance(proph["evaluator"], PSEEEvaluator)
    energy = eval_event.main(base + ["--energy"] + opts)["energy"]
    assert energy["sops"] > 0 and energy["total_energy_mJ"] > 0
    assert energy["dense_macs"] > 0 and energy["snn_equivalent_macs"] > 0
    speed = eval_event.main(base + ["--speed"] + opts)["speed"]
    assert speed["ms_per_batch"] > 0 and speed["frames_per_s"] > 0
    assert coco["conv_gflops_per_frame"] > 0
