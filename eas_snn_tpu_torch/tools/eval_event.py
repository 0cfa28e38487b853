"""Evaluation CLI of the port (counterpart of ``tools/eval_event.py:19-139``;
reference tools/eval_event.py:24-237): an experiment by name or from a
file, a checkpoint, the COCO or the Prophesee protocol, a speed or an
energy report, free-form ``key value`` overrides.

    python -m eas_snn_tpu_torch.tools.eval_event -n gen1_syolox_m -b 64 \\
        -c best.pth [--fp16] [--eval_proh [--save_boxes DIR] | --speed |
        --energy] data_dir /data/gen1 [key value ...]
    python -m eas_snn_tpu_torch.tools.eval_event -f my_exp.py ...

``-f`` loads a Python file whose ``Exp`` class subclasses
``eas_snn_tpu_torch.exp.EventExp`` or, for the RGB family,
``eas_snn_tpu_torch.exp.YOLOXExp``; ``-n`` names a preset of the port
(the event presets and the RGB ones: ``yolox_nano`` ... ``yolox_x``,
``yolov3``, ``yolox_voc_s``).

Runs on the card (``--device cuda``, the default) or on the CPU with
``--device cpu``. ``main`` returns what it reported as a dict.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["make_parser", "build", "main"]

logger = logging.getLogger("eas_snn_tpu_torch.eval")


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "eas_snn_tpu_torch eval",
        epilog="-f loads a Python file whose Exp class subclasses "
               "eas_snn_tpu_torch.exp.EventExp or YOLOXExp (a file that "
               "imports the JAX package is refused); -n names a preset of "
               "the port.")
    parser.add_argument("-n", "--name", type=str, default=None,
                        help="exp name (a preset of the port)")
    parser.add_argument("-f", "--exp_file", type=str, default=None,
                        help="exp file: a Python file whose Exp class "
                             "subclasses eas_snn_tpu_torch.exp.EventExp or "
                             "YOLOXExp (taken before -n)")
    parser.add_argument("-b", "--batch-size", type=int, default=64)
    parser.add_argument(
        "-c", "--ckpt", type=str, default=None,
        help="weights: a checkpoint of the port (ckpt_<step>.pth or "
             "best.pth; its EMA where it has one), a reference PyTorch "
             ".pth state dict or a zoo name (syolox-s-gen1). The JAX "
             "CLI's Orbax checkpoint trees need JAX to read and are not "
             "accepted; without -c the weights are "
             "the exp's seeded random draw")
    parser.add_argument("--eval_proh", action="store_true",
                        help="use the Prophesee +/-50 ms protocol")
    parser.add_argument(
        "--save_boxes", type=str, default=None, metavar="DIR",
        help="with --eval_proh: save each stream's ground truth and "
             "predictions under DIR/gt and DIR/dt, the folders "
             "tools/psee_evaluate_folders.py reads")
    parser.add_argument(
        "--fp16", "--bf16", dest="fp16", action="store_true",
        help="deployment precision (exp.deploy(): bf16 compute, bf16 "
             "sampler state, the fused sampler route on the card; the "
             "counterpart of the JAX CLI's tpu_deploy() and of the "
             "reference's --fp16, reference tools/eval_event.py:66)")
    parser.add_argument("--speed", action="store_true",
                        help="forward-latency report only: detect over 5 "
                             "device-resident Poisson batches")
    parser.add_argument("--energy", action="store_true",
                        help="SOP / energy estimate on Poisson(0.2) events")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None,
                        help="free-form 'key value' config overrides")
    return parser


def build(argv: Optional[Sequence[str]] = None):
    """(exp, args) from a command line; sets the exp's precision
    process-wide (``EventExp.apply_precision``)."""
    from ..exp.build import exp_from_args

    args = make_parser().parse_args(argv)
    exp = exp_from_args(args.exp_file, args.name)
    if args.fp16:
        exp.deploy()  # before merge: explicit 'key value' opts still win
    if args.opts:
        exp.merge(args.opts)
    exp.eval_proph = args.eval_proh
    if args.save_boxes and not args.eval_proh:
        raise SystemExit("--save_boxes: the box files are the Prophesee "
                         "protocol's; pass --eval_proh")
    exp.apply_precision()
    return exp, args


def speed(exp, model, batch_size: int, device, n: int = 5) -> dict:
    """ms a batch and frames/s of ``exp.detect`` (forward, filter, NMS)
    over ``n`` Poisson(0.2) batches on the device, after one warm-up, as
    ``chip_smoke.py`` phase 3 times the main path."""
    h, w = exp.test_size
    shape = (batch_size, exp.Tl, exp.Tm, h, w, exp.in_dim)
    gen = torch.Generator(device=device).manual_seed(exp.seed or 0)
    batches = [torch.poisson(torch.full(shape, 0.2, device=device),
                             generator=gen) for _ in range(n)]
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    exp.detect(model, batches[0])
    sync()
    t0 = time.perf_counter()
    for ev in batches:
        exp.detect(model, ev)
    sync()
    dt = time.perf_counter() - t0
    return {"ms_per_batch": dt / n * 1e3,
            "frames_per_s": n * batch_size * exp.Tl / dt}


def energy(exp, model, device) -> dict:
    """``estimate_energy`` on one Poisson(0.2) window (synaptic ops depend
    on the data: JAX tools/eval_event.py:79-92)."""
    from ..evaluators import estimate_energy

    h, w = exp.test_size
    probe = np.random.default_rng(0).poisson(
        0.2, (1, exp.Tl, exp.Tm, h, w, exp.in_dim)).astype(np.float32)
    return estimate_energy(model, torch.from_numpy(probe).to(device))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from ..core.checkpoint import load_eval_weights
    from ..exp.event_exp import resolve_device
    from ..models.build import zoo_path
    from ..utils.model_info import model_info

    exp, args = build(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(message)s")
    device = resolve_device(args.device)
    model = exp.get_model(device=device, seed=exp.seed or 0)
    if args.ckpt:
        load_eval_weights(model, zoo_path(args.ckpt))
        logger.info("loaded weights from %s", args.ckpt)
    h, w = exp.test_size
    n_params, gflops = model_info(model, (1, exp.Tl, exp.Tm, h, w,
                                          exp.in_dim))
    # the JAX CLI's get_model_info line (tools/eval_event.py:85)
    logger.info("%s on %s at %dx%d: Params: %.2fM, Gflops: %.2f",
                exp.exp_name, device, h, w, n_params / 1e6, gflops)
    out = {"exp": exp.exp_name, "device": str(device),
           "params": n_params, "conv_gflops_per_frame": gflops}

    if args.energy:
        out["energy"] = e = energy(exp, model, device)
        for k, v in e.items():
            logger.info("%s: %.6g", k, v)
        return out
    if args.speed:
        out["speed"] = s = speed(exp, model, args.batch_size, device)
        logger.info("detect: %.2f ms/batch at B=%d, %.1f frames/s",
                    s["ms_per_batch"], args.batch_size, s["frames_per_s"])
        return out

    evaluator = exp.get_evaluator(batch_size=args.batch_size)
    if args.save_boxes:
        if not hasattr(evaluator, "box_dir"):
            raise SystemExit("--save_boxes: the Prophesee protocol runs on "
                             f"gen* datasets, not '{exp.data_name}'")
        evaluator.box_dir = args.save_boxes
    ap, ap50, summary = exp.eval(model, evaluator)
    logger.info("\n%s", summary)
    logger.info("AP: %.4f, AP50: %.4f", ap, ap50)
    out.update(ap=ap, ap50=ap50, summary=summary,
               timing=dict(evaluator.timing), evaluator=evaluator)
    return out


if __name__ == "__main__":
    main()
