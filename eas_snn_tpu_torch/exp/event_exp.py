"""The event-detection experiment config, model and training fields
(counterpart of ``eas_snn_tpu/exp/event_exp.py:EventExp``), with the
presets the port serves, its eval front door and its training factories.

``get_exp(name)`` gives a preset, ``exp.deploy()`` switches it to the
deployment precision and the fused sampler route (the counterpart of the
JAX ``tpu_deploy()``, whose space-to-depth sampler packing is a TPU layout
trick),
``exp.get_model()`` builds the seeded model on the card (in train mode
with ``train=True``), ``exp.detect(model, events)`` runs the forward
without gradients, then the confidence filter and NMS,
``exp.get_data_loader()`` gives the training batches of ``data_dir`` and
``exp.get_evaluator()`` the evaluator over its map_val split,
``exp.eval(model, evaluator)`` its AP, and ``exp.get_trainer()`` the
trainer; ``exp.merge(["key", "value", ...])``
applies command-line overrides (JAX ``exp/base_exp.py:24``).
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.optim import build_lr_schedule, build_optimizer
from ..models import EASYOLOX
from ..ops.boxes import postprocess

__all__ = ["EventExp", "get_exp", "detect", "resolve_device"]

# reference use_spike strings -> internal mode names
_USE_SPIKE_MAP = {
    False: "none", "False": "none", True: "backbone", "True": "backbone",
    "full_spike": "full", "full_spike_v2": "full_v2",
    "none": "none", "backbone": "backbone", "full": "full",
    "full_v2": "full_v2",
}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return dev


class EventExp:
    """Model, training and test fields of the JAX EventExp, with its
    defaults."""

    def __init__(self):
        self.exp_name = "event_exp"
        self.num_classes = 100
        self.depth = 1.00
        self.width = 1.00
        self.act = "silu"
        self.use_spike = "False"
        self.in_dim = 2
        self.embedding = "count"
        self.embedding_depth = 1
        self.embedding_ksize = 7
        self.spike_attach = False
        self.write_zero = False
        self.abs = False
        self.Tl = 1
        self.Tm = 4
        self.Ts = 1
        self.T = 4
        self.reset = 0
        self.thresh = 1
        self.readout = "sum"
        self.spike_fn = "rect"
        # conv/BN compute dtype and ARSNN state dtype (None: f32)
        self.compute_dtype = "float32"
        self.embedding_state_dtype = None
        # conv+BN+PLIF site policy mode (ops/conv_plif_policy.py)
        self.conv_plif_fuse = "auto"
        # 'never' | 'auto' | 'always': the fused sampler kernels (the JAX
        # use_pallas; models/embedding.py)
        self.fused_sampler = "never"
        # data (reference event_yolox_base.py:61-79); the loader's workers
        # are processes (the JAX data_worker_mode has no counterpart)
        self.data_name = "n-caltech"
        self.data_dir = None
        self.data_num_workers = 4
        self.aggregation = "micro_sum"
        self.measure = "count"
        self.window = -200  # ms
        self.input_size = (640, 640)
        self.flip_prob = 0.5
        self.max_labels = 50
        # every N train steps a seeded size from input_size +- 32 * k,
        # k <= multiscale_range (0: off)
        self.multiscale_interval = 0
        self.multiscale_range = 5
        # ship raw indexed events and bin them on the card
        self.device_binning = False
        self.max_events_per_slice = 131072
        # training (reference event_yolox_base.py:101-133)
        self.warmup_epochs = 0
        self.max_epoch = 300
        self.warmup_lr = 0
        self.min_lr_ratio = 0.05
        self.basic_lr_per_img = 1e-3 / 64.0
        self.scheduler = "yoloxwarmcos"
        self.no_aug_epochs = 0
        self.ema = True
        self.optimizer = "ADAM"
        self.weight_decay = 0
        self.momentum = 0.9
        self.emb_lr = -1.0
        self.print_interval = 10
        self.eval_interval = 10
        self.save_history_ckpt = False
        self.seed = None
        self.output_dir = "./outputs"
        self.test_size = (640, 640)
        self.test_conf = 0.01
        self.nmsthre = 0.65
        # evaluate with the Prophesee protocol (gen* datasets)
        self.eval_proph = False

    def deploy(self) -> "EventExp":
        """bf16 conv/BN compute, bf16 sampler state and the fused sampler
        route ('auto': the whole-scan kernel on a CUDA device, which
        computes in f32 on the bf16-rounded events): the deployment
        precision of the JAX ``tpu_deploy()``, with the sampler route
        measured fastest on the H100 (PERF.md) in place of the TPU's
        space-to-depth packing. int8 spike storage and the site policy are
        the eval defaults already."""
        self.compute_dtype = "bfloat16"
        self.embedding_state_dtype = "bfloat16"
        self.fused_sampler = "auto"
        return self

    @property
    def use_spike_mode(self) -> str:
        return _USE_SPIKE_MAP[self.use_spike]

    def get_model(self, device="cuda", seed: int = 0,
                  train: bool = False) -> EASYOLOX:
        """The detector on ``device``, in eval mode (train mode with
        ``train``), its weights drawn from a ``torch.Generator`` seeded
        with ``seed``."""
        dev = resolve_device(device)
        if self.embedding != "arsnn":
            raise NotImplementedError(
                f"embedding '{self.embedding}' is not ported yet (ROADMAP.md, "
                "modules to port: 'Remaining model surface')")
        state_dt = self.embedding_state_dtype
        model = EASYOLOX(
            num_classes=self.num_classes, depth=self.depth, width=self.width,
            act=self.act, use_spike=self.use_spike_mode, T=self.T,
            spike_fn=self.spike_fn, embedding_ksize=self.embedding_ksize,
            embedding_depth=self.embedding_depth, Ts=self.Ts,
            readout=self.readout, spike_attach=self.spike_attach,
            write_zero=self.write_zero, use_abs=self.abs,
            thresh=float(self.thresh),
            vreset=None if self.reset is None else float(self.reset),
            compute_dtype=_DTYPES[self.compute_dtype],
            embedding_state_dtype=None if state_dt is None else _DTYPES[state_dt],
            fuse=self.conv_plif_fuse, fused_sampler=self.fused_sampler,
        )
        model.reset_parameters(torch.Generator().manual_seed(seed))
        return model.to(dev).train(train)

    def detect(self, model: EASYOLOX, events: torch.Tensor
               ) -> List[Optional[np.ndarray]]:
        return detect(model, events, self.test_conf, self.nmsthre)

    def get_lr_schedule(self, batch_size: int, iters_per_epoch: int):
        return build_lr_schedule(
            self.scheduler, self.basic_lr_per_img * batch_size,
            iters_per_epoch, self.max_epoch,
            warmup_epochs=self.warmup_epochs, warmup_lr_start=self.warmup_lr,
            no_aug_epochs=self.no_aug_epochs, min_lr_ratio=self.min_lr_ratio,
            milestones=tuple(getattr(self, "milestones", ()) or ()),
            gamma=getattr(self, "gamma", 0.1),
            semi_epoch=getattr(self, "semi_epoch", 0),
            iters_per_epoch_semi=getattr(self, "iters_per_epoch_semi", None),
        )

    def get_optimizer(self, model: EASYOLOX, batch_size: int,
                      iters_per_epoch: int = 1000) -> torch.optim.Optimizer:
        return build_optimizer(
            model, self.get_lr_schedule(batch_size, iters_per_epoch),
            optimizer=self.optimizer, weight_decay=self.weight_decay,
            momentum=self.momentum, emb_lr=self.emb_lr,
            base_lr=self.basic_lr_per_img * batch_size,
        )

    def get_slice_args(self) -> dict:
        """(reference get_slice_args :433-443)"""
        return dict(aggregation=self.aggregation, overlap=0,
                    num_slice=self.Tl, micro_slice=self.Tm,
                    measure=self.measure, window=(self.window * 1000, 0))

    def get_dataset(self, training: bool = True, map_val: bool = False):
        """The dataset of ``data_name`` (reference :220-247, :445-482)."""
        from ..data import build_dataset

        return build_dataset(
            self.data_name, data_dir=self.data_dir, training=training,
            map_val=map_val,
            input_size=self.input_size if training else self.test_size,
            max_labels=self.max_labels,
            flip_prob=self.flip_prob if training else 0.0,
            raw_events=self.device_binning and training,
            max_events_per_slice=self.max_events_per_slice,
            **self.get_slice_args())

    def get_data_loader(self, batch_size: int, training: bool = True,
                        map_val: bool = False, seed: int = 0,
                        pin_memory: bool = False):
        """Training batches (infinite, shuffled) or one ordered pass. One
        process: rank 0 of 1 until the distributed slice (ROADMAP.md §1
        item 10)."""
        from ..data import EventDataLoader

        return EventDataLoader(
            self.get_dataset(training=training, map_val=map_val),
            batch_size=batch_size, shuffle=training, infinite=training,
            num_workers=self.data_num_workers, seed=self.seed or seed,
            rank=0, world_size=1, pin_memory=pin_memory)

    def get_evaluator(self, batch_size: int, testdev: bool = False):
        """The COCO-protocol evaluator over the map_val loader; the
        Prophesee protocol when ``eval_proph`` is set on a gen* dataset
        (JAX ``exp/event_exp.py:271-294``; reference :509-545)."""
        from ..evaluators import EventEvaluator, PSEEEvaluator

        loader = self.get_data_loader(batch_size, training=False,
                                      map_val=True)
        if "gen" in self.data_name and self.eval_proph:
            return PSEEEvaluator(
                dataloader=loader, img_size=self.test_size, confthre=0.001,
                nmsthre=self.nmsthre, num_classes=self.num_classes,
                camera="gen4" if "gen4" in self.data_name else "gen1",
                # RVT frames are downsampled by 2 (the protocol's
                # thresholds halve)
                downsampled_by_2="rvt" in self.data_name.lower())
        return EventEvaluator(
            dataloader=loader, img_size=self.test_size,
            confthre=self.test_conf, nmsthre=self.nmsthre,
            num_classes=self.num_classes)

    def eval(self, model: EASYOLOX, evaluator):
        """``evaluator.evaluate`` over ``model`` in eval mode (its mode is
        restored): each batch's frames go to the model's device, the
        forward runs under ``torch.inference_mode`` and its decoded outputs
        come back as float32 (a bf16 output is cast on the device, before
        the copy). Returns (AP, AP50, summary)."""
        dev = next(model.parameters()).device

        def forward_fn(frames: torch.Tensor) -> np.ndarray:
            with torch.inference_mode():
                out = model(frames.to(dev, non_blocking=True))
                return out.float().cpu().numpy()

        was_training = model.training
        model.eval()
        try:
            return evaluator.evaluate(forward_fn)
        finally:
            model.train(was_training)

    def merge(self, cfg_list: Sequence[str]) -> "EventExp":
        """Command-line 'key value' overrides, each value coerced to the
        type of the field it replaces (reference base_exp.py:67-90). A
        field that is None (``seed``, ``data_dir``) takes the value as a
        Python literal where it parses as one (``seed 5`` an int), else as
        the string: the JAX package keeps the string, which its trainer
        cannot seed from."""
        if len(cfg_list) % 2:
            raise ValueError("overrides must be 'key value' pairs, got "
                             f"{list(cfg_list)}")
        for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
            k = k[2:] if k.startswith("--") else k
            if not hasattr(self, k):
                raise KeyError(f"unknown config key '{k}'")
            if not isinstance(getattr(self, k), str):
                try:
                    v = ast.literal_eval(v)
                except (ValueError, SyntaxError):
                    pass
            setattr(self, k, v)
        return self

    def check_exp_value(self) -> None:
        h, w = self.input_size
        if h % 32 or w % 32:
            raise ValueError(f"input size {self.input_size} must be "
                             "multiples of 32")

    def get_trainer(self, args=None, device="cuda",
                    iters_per_epoch: Optional[int] = None):
        from ..core.trainer import Trainer

        return Trainer(self, args, device=device,
                       iters_per_epoch=iters_per_epoch)


def detect(model: EASYOLOX, events: torch.Tensor, conf_thre: float = 0.01,
           nms_thre: float = 0.65) -> List[Optional[np.ndarray]]:
    """The eval forward without gradients, then per image the confidence
    filter and class-aware NMS: a (n, 7) [x1, y1, x2, y2, obj, cls_conf,
    cls] array, or None."""
    with torch.no_grad():
        preds = model(events)
    return postprocess(preds.float().cpu().numpy(), model.head.num_classes,
                       conf_thre, nms_thre)


def _gen1_syolox(exp: EventExp, depth: float, width: float) -> EventExp:
    """The reference README's published Gen1 recipe (readme.md:124-146):
    arsnn sampler depth 2 ksize 5, spiking backbone, analog FPN/head,
    Tl=1 Tm=4 Ts=T=3, write_zero, atan, soft reset."""
    exp.depth, exp.width = depth, width
    exp.num_classes = 2
    exp.data_name = "gen1"
    exp.input_size = exp.test_size = (256, 320)
    exp.window = -200
    exp.use_spike = "True"
    exp.embedding = "arsnn"
    exp.embedding_depth = 2
    exp.embedding_ksize = 5
    exp.readout = "sum"
    exp.write_zero = True
    exp.thresh = 1
    exp.reset = None
    exp.spike_fn = "atan"
    exp.Tl, exp.Tm, exp.Ts, exp.T = 1, 4, 3, 3
    exp.compute_dtype = "bfloat16"
    exp.max_epoch = 30
    exp.scheduler = "fixed"
    exp.basic_lr_per_img = 1.5625e-5
    exp.eval_interval = 5
    return exp


def _gen4_rvt_syolox_m(exp: EventExp) -> EventExp:
    """exps/default/gen4_rvt_syolox_m.py: the Gen1 recipe at M width on
    1Mpx (RVT-preprocessed) histories, 384x640, 3 classes, Tl=Tm=Ts=T=3."""
    _gen1_syolox(exp, 0.67, 0.75)
    exp.num_classes = 3
    exp.data_name = "rvt-gen4"
    exp.input_size = exp.test_size = (384, 640)
    exp.Tl, exp.Tm = 3, 3
    return exp


def _named(name: str, exp: EventExp) -> EventExp:
    exp.exp_name = name
    return exp


_PRESETS = {
    # the flagship: exps/default/gen1_syolox_m.py
    "gen1_syolox_m": lambda: _named(
        "gen1_syolox_m", _gen1_syolox(EventExp(), 0.67, 0.75)),
    # exps/default/gen1_syolox_s.py
    "gen1_syolox_s": lambda: _named(
        "gen1_syolox_s", _gen1_syolox(EventExp(), 0.33, 0.50)),
    # exps/default/gen4_rvt_syolox_m.py
    "gen4_rvt_syolox_m": lambda: _named(
        "gen4_rvt_syolox_m", _gen4_rvt_syolox_m(EventExp())),
}


def get_exp(name: str) -> EventExp:
    if name not in _PRESETS:
        raise KeyError(f"unknown exp '{name}'; the port has {sorted(_PRESETS)}")
    return _PRESETS[name]()
