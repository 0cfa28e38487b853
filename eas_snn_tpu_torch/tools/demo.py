"""Demo CLI of the port: detection over a recorded event stream with
``StreamingDetector``, each detection drawn over the window's events into
a PNG (counterpart of ``tools/demo.py:22-102``).

    python -m eas_snn_tpu_torch.tools.demo -n gen1_syolox_m --fp16 \\
        -c best.pth --input seq_td.dat --out demo_out --fps 20 \\
        [--conf 0.3] [--max-frames 100] [--device cuda] [key value ...]

Every ``1 / fps`` s of stream time the events since the last tick are
pushed and the window ending at the tick is detected (``--conf``, the
exp's ``nmsthre``); the frame's background is the window's events summed
into one polarity frame (``event_frame_to_image(micro_sum(window, 1, H,
W)[0])``), the detections are drawn by ``utils/visualize.py`` and the
frame is written as ``<out>/frame_%05d.png`` by ``utils/png.py``.

``-c`` takes a checkpoint of the port (its EMA where it has one), a
reference ``.pth`` state dict or a zoo name (``models/build.py:
ZOO_CKPTS``); without it the weights are the exp's seeded random draw.
``--fp16`` is ``exp.deploy()``, as in the eval CLI. Runs on the card
(``--device cuda``, the default: the detection is one captured CUDA
graph) or on the CPU with ``--device cpu``. ``main`` returns the frames
written, each frame's detections, and the ms a frame of detection
(``push`` and ``detect``), drawing and PNG writing, with the frames/s of
the whole loop.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Optional, Sequence

import numpy as np

__all__ = ["make_parser", "main"]

logger = logging.getLogger("eas_snn_tpu_torch.demo")


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("eas_snn_tpu_torch demo")
    p.add_argument("-n", "--name", type=str, default=None,
                   help="exp name (a preset of the port)")
    p.add_argument("-f", "--exp_file", type=str, default=None,
                   help="exp file whose Exp subclasses "
                        "eas_snn_tpu_torch.exp.EventExp")
    p.add_argument("-c", "--ckpt", type=str, default=None,
                   help="weights: a checkpoint of the port, a reference "
                        ".pth state dict or a zoo name")
    p.add_argument("--input", type=str, required=True,
                   help=".dat / .npy event stream")
    p.add_argument("--out", type=str, default="demo_out")
    p.add_argument("--fps", type=float, default=20.0,
                   help="detections per second of stream time")
    p.add_argument("--conf", type=float, default=0.3)
    p.add_argument("--max-frames", type=int, default=100)
    p.add_argument("--fp16", action="store_true",
                   help="deployment precision (exp.deploy())")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None,
                   help="free-form 'key value' config overrides")
    return p


def _ms(xs) -> dict:
    a = np.asarray(xs, np.float64) * 1e3
    return {"mean": float(a.mean()), "p50": float(np.percentile(a, 50))} \
        if len(a) else {"mean": None, "p50": None}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from ..core.checkpoint import load_eval_weights
    from ..data import EventStream, micro_sum
    from ..exp.build import exp_from_args
    from ..exp.event_exp import resolve_device
    from ..inference import StreamingDetector
    from ..models.build import zoo_path
    from ..utils.png import write_png
    from ..utils.visualize import event_frame_to_image, vis_detections

    args = make_parser().parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(message)s")
    exp = exp_from_args(args.exp_file, args.name)
    if args.fp16:
        exp.deploy()  # before merge: explicit 'key value' opts still win
    if args.opts:
        exp.merge(args.opts)
    exp.apply_precision()
    device = resolve_device(args.device)
    model = exp.get_model(device=device, seed=exp.seed or 0)
    if args.ckpt:
        load_eval_weights(model, zoo_path(args.ckpt))
        logger.info("loaded weights from %s", zoo_path(args.ckpt))

    stream = EventStream(args.input)
    sh, sw = stream.get_size()
    if sh is None:
        sh, sw = (240, 304)
    window_us = abs(exp.window) * 1000
    det = StreamingDetector(
        model, img_size=(sh, sw), input_size=exp.test_size, Tm=exp.Tm,
        window_us=window_us, num_classes=exp.num_classes,
        confthre=args.conf, nmsthre=exp.nmsthre, device=device)
    names = getattr(exp, "class_names", ())

    os.makedirs(args.out, exist_ok=True)
    step_us = int(1e6 / args.fps)
    t = stream.first_time() + window_us
    detections, paths = [], []
    times = {"detect": [], "draw": [], "write": []}
    t_start = time.perf_counter()
    while t < stream.total_time() and len(paths) < args.max_frames:
        t0 = time.perf_counter()
        det.push(stream.events_between(t - step_us, t))
        dets = det.detect(t)
        t1 = time.perf_counter()
        window = stream.events_between(t - window_us, t)
        frame = (micro_sum(window, 1, sh, sw)[0] if len(window)
                 else np.zeros((sh, sw, 2), np.float32))
        img = event_frame_to_image(frame)
        if dets is not None:
            img = vis_detections(img, dets[:, :4], dets[:, 4] * dets[:, 5],
                                 dets[:, 6], conf=args.conf,
                                 class_names=names)
        t2 = time.perf_counter()
        path = os.path.join(args.out, f"frame_{len(paths):05d}.png")
        write_png(path, img)
        t3 = time.perf_counter()
        times["detect"].append(t1 - t0)
        times["draw"].append(t2 - t1)
        times["write"].append(t3 - t2)
        detections.append(dets)
        paths.append(path)
        t += step_us
    wall = time.perf_counter() - t_start
    boxes = [0 if d is None else len(d) for d in detections]
    out = {"exp": exp.exp_name, "device": str(device), "frames": len(paths),
           "paths": paths, "detections": detections,
           "boxes_per_frame": boxes, "tick_us": step_us,
           "ms": {k: _ms(v) for k, v in times.items()},
           "frames_per_s": len(paths) / wall if wall > 0 else None}
    logger.info("wrote %d frames to %s (%d boxes); ms a frame: detect %s, "
                "draw %s, write %s; %.2f frames/s", len(paths), args.out,
                sum(boxes), out["ms"]["detect"]["mean"],
                out["ms"]["draw"]["mean"], out["ms"]["write"]["mean"],
                out["frames_per_s"] or 0.0)
    return out


if __name__ == "__main__":
    main()
