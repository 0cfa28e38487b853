"""The RGB family's models and exps, port against the JAX package on the
CPU in f32: ``DWConv``, Darknet-21 / -53, ``YOLOFPN``, the YOLOv3
detector and YOLOX-Nano (depthwise, three input channels) at 64x64,
B=2, on weights drawn with numpy into the JAX model's shapes and carried
over by ``state_dict_from_jax`` (strict: every leaf maps, none is left
over); the eval forward and one train step; every RGB preset's fields
against the JAX exp file's; a user ``-f`` file subclassing ``YOLOXExp``
through both CLIs on ``--device cpu``.

Tolerances: the eval outputs within rtol 1e-5, atol 1e-4 (the slice's,
``tests/test_torch_model.py``); module features, whose magnitudes grow
with the 0-255 pixel inputs, within rtol 1e-5 and 1e-5 of the tensor's
largest magnitude; a train step's loss terms within 1e-5 relative and
each gradient within 1e-3 of its tensor's largest magnitude
(``tests/test_torch_variants_model.py:_grad_tol``).
"""

import copy
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eas_snn_tpu.exp import get_exp as jget_exp
from eas_snn_tpu.models import blocks as jblocks
from eas_snn_tpu.models import yolo_fpn as jyolo_fpn

from eas_snn_tpu_torch.exp import YOLOXExp, get_exp
from eas_snn_tpu_torch.models.blocks import DWConv
from eas_snn_tpu_torch.models.yolo_fpn import YOLOFPN, Darknet, YOLOv3
from eas_snn_tpu_torch.tools import eval_event, train_event
from eas_snn_tpu_torch.utils import state_dict_from_jax

from test_torch_model import _random_variables
from test_torch_train_step import _labels
from test_torch_variants_model import _grad_tol, check_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RGB_PRESETS = {
    "yolox_nano": "exps/default/yolox_nano.py",
    "yolox_tiny": "exps/default/yolox_tiny.py",
    "yolox_s": "exps/default/yolox_s.py",
    "yolox_m": "exps/default/yolox_m.py",
    "yolox_l": "exps/default/yolox_l.py",
    "yolox_x": "exps/default/yolox_x.py",
    "yolov3": "exps/default/yolov3.py",
    "yolox_voc_s": "exps/example/yolox_voc_s.py",
}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _images(seed, shape=(2, 1, 1, 64, 64, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.float32)


def _close(got, want):
    """rtol 1e-5 and 1e-5 of the largest magnitude (features of 0-255
    inputs)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _load(module, variables):
    module.load_state_dict(state_dict_from_jax(variables), strict=True)
    return module.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_dwconv_matches_jax():
    """A stride-2 depthwise 3x3 + pointwise 1x1 (dconv / pconv, the
    reference's names), eval and train-mode BN."""
    x = _images(0, (2, 33, 31, 8)) / 255.0
    jm = jblocks.DWConv(16, 3, 2)
    v = _random_variables(jm, x, np.random.default_rng(1))
    pm = _load(DWConv(8, 16, 3, 2), v)
    assert tuple(pm.dconv.conv.weight.shape) == (8, 1, 3, 3)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    _close(got, want)
    want, _ = jm.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    with torch.no_grad():
        got = pm.train()(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    _close(got, np.asarray(want))


@pytest.mark.parametrize("depth", [21, 53])
def test_darknet_matches_jax(depth):
    """Darknet's dark3-dark5 features, the SPP tail included; every JAX
    leaf lands on the reference's names (``stem.{0,1,2}``, ``dark5`` the
    SPP tail after its ResLayers)."""
    x = _images(2, (2, 64, 64, 3))
    jm = jyolo_fpn.Darknet(depth=depth)
    v = _random_variables(jm, x, np.random.default_rng(depth))
    pm = _load(Darknet(depth), v)
    names = {n for n, _ in pm.named_parameters()}
    n5 = Darknet.DEPTH2BLOCKS[depth][3]
    assert {"stem.2.layer1.conv.weight", "dark2.1.layer2.bn.weight",
            f"dark5.{n5 + 3}.conv2.conv.weight"} <= names
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = pm(_nchw(x))
    assert sorted(got) == sorted(want) == ["dark3", "dark4", "dark5"]
    for k in want:
        _close(got[k].numpy().transpose(0, 2, 3, 1), want[k])


def test_yolofpn_matches_jax():
    x = _images(3, (2, 64, 64, 3))
    jm = jyolo_fpn.YOLOFPN(depth=21)
    v = _random_variables(jm, x, np.random.default_rng(4))
    pm = _load(YOLOFPN(21), v)
    assert {"out1_cbl.conv.weight", "out1.4.bn.bias",
            "out2.0.conv.weight"} <= {n for n, _ in pm.named_parameters()}
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = pm(_nchw(x))
    assert [tuple(g.shape[1:]) for g in got] == [(128, 8, 8), (256, 4, 4),
                                                 (512, 2, 2)]
    for g, w in zip(got, want):
        _close(g.numpy().transpose(0, 2, 3, 1), w)


def _jax_model(name, darknet21=False, monkeypatch=None):
    exp = jget_exp(exp_file=os.path.join(REPO, RGB_PRESETS[name]))
    if darknet21:
        monkeypatch.setattr(jyolo_fpn, "YOLOFPN",
                            functools.partial(jyolo_fpn.YOLOFPN, depth=21))
    return exp.get_model()


def _port_model(name, darknet21=False):
    if name == "yolov3":
        return YOLOv3(80, depth=21 if darknet21 else 53)
    exp = get_exp(name)
    return exp.get_model(device="cpu")


# the 64x64 labels of ``_labels`` scaled to 128x128 (class ids kept)
_LAB128 = np.array([1, 2, 2, 2, 2], np.float32)


def _pair(name, seed, darknet21=False, monkeypatch=None, size=64):
    ev = _images(seed, (2, 1, 1, size, size, 3))
    jm = _jax_model(name, darknet21, monkeypatch)
    v = _random_variables(jm, ev, np.random.default_rng(seed + 1))
    # obj and cls biases at 0 so that the decoded scores are not all ~0;
    # the reg kernels at 1e-2 of the draw, so that exp(wh), on features
    # of 0-255 pixels through Darknet-53, stays at a trained detector's
    # O(1) logits (at the full draw the logits are large enough that f32
    # rounding alone, amplified by exp, breaks rtol 1e-5)
    for k in range(3):
        head = v["params"]["head"]
        for pred in ("obj_pred", "cls_pred"):
            head[f"{pred}{k}"]["bias"] = np.zeros_like(
                head[f"{pred}{k}"]["bias"])
        head[f"reg_pred{k}"]["kernel"] = head[f"reg_pred{k}"]["kernel"] * 0.01
    pm = _port_model(name, darknet21)
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return jm, pm, v, ev


@pytest.mark.parametrize("name", ["yolov3", "yolox_nano"])
def test_detector_eval_matches_jax(name):
    """The decoded eval outputs of Darknet-53 YOLOv3 and of YOLOX-Nano
    (depthwise backbone, neck and head; three input channels), rtol 1e-5,
    atol 1e-4."""
    jm, pm, v, ev = _pair(name, 10 + len(name))
    if name == "yolox_nano":
        dw = [n for n, _ in pm.named_parameters() if ".dconv." in n]
        assert any(n.startswith("head.") for n in dw)
        assert any(n.startswith("backbone.bu_conv") for n in dw)
        assert "backbone.backbone.stem.0.conv.conv.weight" in dict(
            pm.named_parameters())
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(ev)))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(ev)).numpy()
    assert got.shape == want.shape == (2, 84, 85)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_yolox_nano_train_step_matches_jax():
    """One YOLOX-Nano train step at 128x128 (depthwise convs in every
    stage, the neck and the head): the loss terms and every gradient
    (``check_train``'s tolerances)."""
    jm, pm, v, ev = _pair("yolox_nano", 30, size=128)
    params = check_train("none", jm, pm, v, ev, _labels() * _LAB128)
    assert any(p.grad is not None and float(p.grad.abs().max()) > 0
               for n, p in params.items() if ".dconv." in n)


def test_yolov3_train_step_matches_jax(monkeypatch):
    """One train step of YOLOv3 over Darknet-21 at 64x64, in two parts.

    f32: the loss terms within 1e-5 relative and the prediction convs'
    gradients within ``_grad_tol``. At this random init the JAX package's
    f32 gradients of the other tensors swing: jitted against op by op by
    up to 0.426 of a tensor's largest magnitude, and 0.307 on the batch
    reversed, while the port's f32 stays within 1.5e-4 of its f64 and
    within 0.048 of JAX (``python tests/test_torch_rgb_model.py
    --conditioning`` prints these on the CPU), so no port could be held
    to JAX's f32 at 1e-3 there.

    f64, where the step is well-conditioned: both models in float64 (the
    JAX one under ``jax.enable_x64`` with its modules' dtype set to f64),
    the train-mode forward of the head's outputs and the backward of a
    fixed random weighting of them (JAX's SimOTA does not trace in x64),
    every gradient within 1e-3 of its tensor's largest magnitude
    (``_grad_tol``)."""
    jm, pm, v, ev = _pair("yolov3", 23, darknet21=True,
                          monkeypatch=monkeypatch)
    lab = _labels()

    def loss_fn(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]}, ev, lab,
                          train=True, mutable=["batch_stats"])
        return out["total_loss"], out

    (_, jout), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    want = state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, jg)})
    pm.train()
    out = pm(torch.from_numpy(ev), torch.from_numpy(lab))
    out["total_loss"].backward()
    for k, x in jout.items():
        np.testing.assert_allclose(float(out[k].detach()), float(x),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(out["num_fg"]) > 0
    params = dict(pm.named_parameters())
    assert set(params) == set(want)
    preds = [n for n in want if "_preds." in n]
    assert len(preds) == 18
    for name in preds:
        np.testing.assert_allclose(params[name].grad.numpy(),
                                   want[name].numpy(), rtol=0,
                                   atol=_grad_tol(name, want[name]) + 1e-12,
                                   err_msg=name)

    # float64: every gradient
    import eas_snn_tpu.models as jmodels

    f64 = jnp.float64
    for mod, name in ((jyolo_fpn, "BaseConv"), (jyolo_fpn, "SPPBottleneck"),
                      (jmodels, "YOLOXHead")):
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), dtype=f64))
    weight = np.random.default_rng(5).normal(0, 1, (2, 84, 85))
    with jax.enable_x64():
        jm64 = _jax_model("yolov3")
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)

        def fn(params):
            y, _ = jm64.apply({"params": params,
                               "batch_stats": v64["batch_stats"]},
                              ev.astype(np.float64), train=True,
                              mutable=["batch_stats"])
            return (y * weight).sum()

        jg64 = jax.jit(jax.grad(fn))(v64["params"])
        want64 = state_dict_from_jax({"params": jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), jg64)})
    pm64 = YOLOv3(80, depth=21, compute_dtype=torch.float64).double()
    pm64.load_state_dict(pm.state_dict())
    y = pm64.train()(torch.from_numpy(ev).double())
    (y * torch.from_numpy(weight)).sum().backward()
    for name, p in pm64.named_parameters():
        g = want64[name].double()
        assert g.dtype == p.grad.dtype == torch.float64
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), rtol=0,
                                   atol=_grad_tol(name, g) + 1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("name", sorted(RGB_PRESETS))
def test_rgb_preset_fields_equal_the_jax_files(name):
    """Every field of the JAX exp file, equal in the port's preset (which
    adds the fields its CLIs read: Tl, Tm, in_dim, ...)."""
    want = vars(jget_exp(exp_file=os.path.join(REPO, RGB_PRESETS[name])))
    got = get_exp(name)
    assert isinstance(got, YOLOXExp) and got.exp_name == name
    for k, v in want.items():
        assert getattr(got, k) == v, k
    assert (got.Tl, got.Tm, got.in_dim) == (1, 1, 3)
    assert got.compute_dtype == "float32"


def _coco_tree(root, n=4, size=(64, 80)):
    """A COCO tree of cv2-free JPEG-less PNG images (the port's writer)
    with two annotated boxes each, train and val splits alike."""
    from eas_snn_tpu_torch.utils.png import write_png

    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "annotations"))
    h, w = size
    for split in ("train2017", "val2017"):
        os.makedirs(os.path.join(root, split))
        images, anns = [], []
        for i in range(n):
            img = rng.integers(0, 256, (h, w, 3), np.uint8)
            name = f"{i:012d}.jpg"
            write_png(os.path.join(root, split, name), img)
            images.append({"id": i + 1, "file_name": name, "width": w,
                           "height": h})
            anns += [{"id": 2 * i, "image_id": i + 1, "category_id": 1,
                      "bbox": [5, 8, 30, 20], "iscrowd": 0},
                     {"id": 2 * i + 1, "image_id": i + 1, "category_id": 2,
                      "bbox": [40, 30, 20, 25], "iscrowd": 0}]
        with open(os.path.join(root, "annotations",
                               f"instances_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": [{"id": 1, "name": "a"},
                                      {"id": 2, "name": "b"}]}, f)


_USER_RGB_EXP = '''
from eas_snn_tpu_torch.exp import YOLOXExp


class Exp(YOLOXExp):
    def __init__(self):
        super().__init__()
        self.exp_name = "my_rgb"
        self.num_classes = 2
        self.depth, self.width = 0.33, 0.125
        self.input_size = self.test_size = (64, 64)
        self.max_epoch, self.warmup_epochs, self.no_aug_epochs = 1, 0, 0
        self.eval_interval = 1
        self.data_num_workers = 0
        self.print_interval = 1
'''


def test_user_yolox_exp_file_through_both_clis(tmp_path):
    """``-f`` a file whose Exp subclasses YOLOXExp: the train CLI takes
    one mosaic-and-mixup SGD step on the CPU (EMA, an epoch-end
    evaluation), the eval CLI evaluates the val split."""
    data = tmp_path / "coco"
    _coco_tree(str(data))
    f = tmp_path / "my_rgb.py"
    f.write_text(_USER_RGB_EXP)
    out = tmp_path / "out"
    train_event.main(["-f", str(f), "-b", "2", "--device", "cpu",
                      "data_dir", str(data), "output_dir", str(out)])
    run = out / "my_rgb"
    assert (run / "ckpt").is_dir()
    rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert [r["split"] for r in rows if "AP50_95" in r] == ["val"]
    losses = [r["total_loss"] for r in rows if "total_loss" in r]
    assert losses and all(np.isfinite(losses))
    res = eval_event.main(["-f", str(f), "-b", "2", "--device", "cpu",
                           "data_dir", str(data)])
    assert res["exp"] == "my_rgb" and 0.0 <= res["ap"] <= 1.0
    assert res["timing"]


def conditioning(name: str, size: int) -> dict:
    """How well-conditioned one train step of ``name`` is in f32 at
    ``size`` x ``size`` (YOLOv3 over Darknet-21): the largest, over the
    parameters, of each difference relative to the tensor's largest
    JAX gradient: JAX jitted against op by op, JAX on the batch reversed
    (the same sum in another order), the port in f32 and JAX against the
    port in f64."""
    mp = pytest.MonkeyPatch()
    jm, pm, v, ev = _pair(name, 20 + len(name), darknet21=True,
                          monkeypatch=mp, size=size)
    lab = _labels() * (_LAB128 if size == 128 else 1)

    def grads(ev, lab, jit=True):
        def loss_fn(params):
            out, _ = jm.apply({"params": params,
                               "batch_stats": v["batch_stats"]}, ev, lab,
                              train=True, mutable=["batch_stats"])
            return out["total_loss"]

        g = jax.grad(loss_fn)
        g = (jax.jit(g) if jit else g)(v["params"])
        return state_dict_from_jax(
            {"params": jax.tree_util.tree_map(np.asarray, g)})

    want = grads(ev, lab)
    others = {"jax op by op": grads(ev, lab, jit=False),
              "jax reversed": grads(ev[::-1].copy(), lab[::-1].copy())}
    port = {}
    for dt in (torch.float32, torch.float64):
        m = copy.deepcopy(pm).to(dt)
        for mod in m.modules():
            if isinstance(getattr(mod, "dtype", None), torch.dtype):
                mod.dtype = dt
        m.train()
        m(torch.from_numpy(ev).to(dt),
          torch.from_numpy(lab).to(dt))["total_loss"].backward()
        port[dt] = {n: p.grad.double() for n, p in m.named_parameters()}
    others["port f32"] = port[torch.float32]
    out = {}
    for what, g in list(others.items()) + [("port f64", port[torch.float64])]:
        out[f"{what} - jax"] = max(
            float((g[n].double() - w.double()).abs().max())
            / (float(w.abs().max()) or 1.0) for n, w in want.items())
    out["port f32 - port f64"] = max(
        float((port[torch.float32][n] - port[torch.float64][n]).abs().max())
        / (float(want[n].abs().max()) or 1.0) for n in want)
    mp.undo()
    return out


if __name__ == "__main__":
    import argparse


    ap = argparse.ArgumentParser(description="f32 conditioning of the RGB "
                                 "train steps on the CPU")
    ap.add_argument("--conditioning", action="store_true", required=True)
    ap.parse_args()
    torch.set_num_threads(2)
    for name, size in (("yolov3", 64), ("yolox_nano", 64),
                       ("yolox_nano", 128)):
        res = conditioning(name, size)
        print(name, size, json.dumps({k: float(f"{v:.3g}")
                                      for k, v in res.items()}))
