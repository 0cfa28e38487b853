"""The RGB YOLOX experiment (counterpart of
``eas_snn_tpu/exp/yolox_base.py``; reference yolox/exp/yolox_base.py:
16-359): COCO images through mosaic and mixup into an analog YOLOX (the
count embedding over one frame of three channels), SGD with a quadratic
warm-up, EMA, the COCO protocol. Its presets are the JAX package's
``exps/default/yolox_{nano,tiny,s,m,l,x}.py``, ``yolov3.py`` and
``exps/example/yolox_voc_s.py`` (``RGB_PRESETS``).

The front doors are ``EventExp``'s, and the CLIs and the trainer drive it
as they drive an event exp: ``get_model(device, seed, train)``,
``detect``, ``get_data_loader``, ``get_evaluator``, ``eval``,
``get_trainer``. It adds the fields they read (``Tl = Tm = 1``,
``in_dim = 3``, no device binning, no multiscale). An exp computes in
f32, with TF32 off (``apply_precision``).
"""

from __future__ import annotations

import torch

from ..models import EASYOLOX
from .base_exp import BaseExp
from .event_exp import _DTYPES, EventExp, resolve_device

__all__ = ["YOLOXExp", "YOLOv3Exp", "YOLOXVOCExp", "RGB_PRESETS"]


class YOLOXExp(BaseExp):
    """The fields and defaults of the JAX ``yolox_base.Exp``."""

    def __init__(self):
        # model
        self.num_classes = 80
        self.depth = 1.00
        self.width = 1.00
        self.act = "silu"
        # depthwise-separable convs (YOLOX-Nano)
        self.depthwise = False
        self.compute_dtype = "float32"
        # data
        self.data_dir = None
        self.train_ann = "instances_train2017.json"
        self.val_ann = "instances_val2017.json"
        self.train_name = "train2017"
        self.val_name = "val2017"
        self.input_size = (640, 640)
        self.data_num_workers = 4
        self.max_labels = 120
        # mosaic and mixup (reference :43-58)
        self.mosaic_prob = 1.0
        self.mixup_prob = 1.0
        self.degrees = 10.0
        self.translate = 0.1
        self.mosaic_scale = (0.1, 2.0)
        self.mixup_scale = (0.5, 1.5)
        self.shear = 2.0
        self.flip_prob = 0.5
        # training (reference :60-95)
        self.warmup_epochs = 5
        self.max_epoch = 300
        self.warmup_lr = 0
        self.min_lr_ratio = 0.05
        self.basic_lr_per_img = 0.01 / 64.0
        self.scheduler = "yoloxwarmcos"
        self.no_aug_epochs = 15
        self.ema = True
        self.optimizer = "SGD"
        self.weight_decay = 5e-4
        self.momentum = 0.9
        self.print_interval = 10
        self.eval_interval = 10
        self.exp_name = "yolox_base"
        self.seed = None
        self.output_dir = "./outputs"
        # test
        self.test_size = (640, 640)
        self.test_conf = 0.01
        self.nmsthre = 0.65
        # what the port's CLIs and trainer read of an exp: one frame of
        # three channels a sample, binned on the host, one size
        self.Tl = 1
        self.Tm = 1
        self.in_dim = 3
        self.device_binning = False
        self.multiscale_interval = 0
        self.multiscale_range = 5

    # the event exp's front doors: they read only fields both exps have
    detect = EventExp.detect
    get_lr_schedule = EventExp.get_lr_schedule
    get_data_loader = EventExp.get_data_loader
    eval = EventExp.eval
    check_exp_value = EventExp.check_exp_value
    apply_precision = EventExp.apply_precision
    get_trainer = EventExp.get_trainer

    def deploy(self) -> "YOLOXExp":
        """bf16 conv/BN compute (the eval CLI's ``--fp16``)."""
        self.compute_dtype = "bfloat16"
        return self

    def _init(self, model: torch.nn.Module, device, seed: int,
              train: bool) -> torch.nn.Module:
        dev = resolve_device(device)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        return model.to(dev).train(train)

    def get_model(self, device="cuda", seed: int = 0,
                  train: bool = False) -> torch.nn.Module:
        """The analog YOLOX (JAX ``get_model``: EASYOLOX with
        ``use_spike='none'`` and the count embedding) on ``device``, its
        weights drawn from a generator seeded with ``seed``."""
        model = EASYOLOX(
            num_classes=self.num_classes, depth=self.depth, width=self.width,
            act=self.act, use_spike="none", T=1, embedding="count", Ts=1,
            depthwise=self.depthwise, in_channels=self.in_dim,
            compute_dtype=_DTYPES[self.compute_dtype])
        return self._init(model, device, seed, train)

    def get_optimizer(self, model: torch.nn.Module, batch_size: int,
                      iters_per_epoch: int = 1000) -> torch.optim.Optimizer:
        from ..core.optim import build_optimizer

        return build_optimizer(
            model, self.get_lr_schedule(batch_size, iters_per_epoch),
            optimizer=self.optimizer, weight_decay=self.weight_decay,
            momentum=self.momentum,
            base_lr=self.basic_lr_per_img * batch_size)

    def _mosaic(self, base):
        from ..data.mosaic import MosaicDataset

        return MosaicDataset(
            base, input_size=self.input_size, mosaic_prob=self.mosaic_prob,
            mixup_prob=self.mixup_prob, degrees=self.degrees,
            translate=self.translate, mosaic_scale=self.mosaic_scale,
            mixup_scale=self.mixup_scale, shear=self.shear,
            max_labels=self.max_labels)

    def get_dataset(self, training: bool = True, map_val: bool = False):
        """COCO under ``data_dir``: mosaic and mixup over ``train2017`` in
        training, ``val2017`` letterboxed otherwise (JAX :85-115)."""
        from ..data.coco import COCODataset

        base = COCODataset(
            self.data_dir,
            json_file=self.train_ann if training else self.val_ann,
            name=self.train_name if training else self.val_name,
            input_size=self.input_size if training else self.test_size,
            training=training, map_val=map_val, max_labels=self.max_labels,
            flip_prob=self.flip_prob)
        return self._mosaic(base) if training else base

    def get_evaluator(self, batch_size: int, testdev: bool = False):
        """The COCO protocol over the map_val loader (JAX :153-163)."""
        from ..evaluators import EventEvaluator

        return EventEvaluator(
            dataloader=self.get_data_loader(batch_size, training=False,
                                            map_val=True),
            img_size=self.test_size, confthre=self.test_conf,
            nmsthre=self.nmsthre, num_classes=self.num_classes)


class YOLOv3Exp(YOLOXExp):
    """``exps/default/yolov3.py``: Darknet-53 + YOLOFPN and the YOLOX head
    (LeakyReLU) on its (128, 256, 512) channels."""

    def __init__(self):
        super().__init__()
        self.depth = 1.0
        self.width = 1.0
        self.exp_name = "yolov3"
        self.head_in_channels = (128, 256, 512)

    def get_model(self, device="cuda", seed: int = 0,
                  train: bool = False) -> torch.nn.Module:
        from ..models.yolo_fpn import YOLOv3

        model = YOLOv3(self.num_classes, depth=53, in_channels=self.in_dim,
                       compute_dtype=_DTYPES[self.compute_dtype])
        return self._init(model, device, seed, train)


class YOLOXVOCExp(YOLOXExp):
    """``exps/example/yolox_voc_s.py``: YOLOX-S on PASCAL VOC, 20 classes,
    2007 + 2012 trainval in training, 2007 test otherwise; ``data_dir`` is
    the VOCdevkit."""

    def __init__(self):
        super().__init__()
        self.depth = 0.33
        self.width = 0.50
        self.num_classes = 20
        self.exp_name = "yolox_voc_s"

    def get_dataset(self, training: bool = True, map_val: bool = False):
        from ..data.coco import VOCDataset

        base = VOCDataset(
            self.data_dir,
            image_sets=(("2007", "trainval"), ("2012", "trainval"))
            if training else (("2007", "test"),),
            input_size=self.input_size if training else self.test_size,
            training=training, map_val=map_val, max_labels=self.max_labels)
        return self._mosaic(base) if training else base


def _preset(cls, name: str, **fields):
    def make():
        exp = cls()
        for k, v in fields.items():
            setattr(exp, k, v)
        exp.exp_name = name
        return exp
    return make


_416 = dict(input_size=(416, 416), test_size=(416, 416),
            mosaic_scale=(0.5, 1.5), mixup_prob=0.0)

RGB_PRESETS = {
    # exps/default/yolox_nano.py: depthwise, mosaic at half probability
    "yolox_nano": _preset(YOLOXExp, "yolox_nano", depth=0.33, width=0.25,
                          depthwise=True, mosaic_prob=0.5, **_416),
    "yolox_tiny": _preset(YOLOXExp, "yolox_tiny", depth=0.33, width=0.375,
                          **_416),
    "yolox_s": _preset(YOLOXExp, "yolox_s", depth=0.33, width=0.50),
    "yolox_m": _preset(YOLOXExp, "yolox_m", depth=0.67, width=0.75),
    "yolox_l": _preset(YOLOXExp, "yolox_l", depth=1.0, width=1.0),
    "yolox_x": _preset(YOLOXExp, "yolox_x", depth=1.33, width=1.25),
    "yolov3": _preset(YOLOv3Exp, "yolov3"),
    "yolox_voc_s": _preset(YOLOXVOCExp, "yolox_voc_s"),
}
