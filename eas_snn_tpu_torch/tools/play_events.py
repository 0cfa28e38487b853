"""Event-stream playback: one or several ``.dat`` streams (with their
``_bbox.npy`` boxes) drawn window by window into a tiled PNG sequence
(the port's counterpart of ``tools/play_events.py``; reference
yolox/utils/psee_loader/event_visual.py:29-87 and
visualize/vis_utils.py:22-60).

    python -m eas_snn_tpu_torch.tools.play_events seq_a_td.dat \\
        seq_b_td.dat --frames outdir/ [-d 50000] [-s 0] [--max-frames N]

Each ``delta_t`` window of every stream becomes one tile of a square-ish
grid: grey background, positive events white, negative black, and the
boxes whose timestamps fall in the window drawn at thickness 1 in the
colour of OpenCV's HSV colour map at ``(class * 60) % 255``, with the
class name at text scale 0.35 above them. Frames are written as
``<frames>/f%06d.png`` by ``utils/png.py``. The JAX tool also writes an
mp4 through ``cv2.VideoWriter``; the port has no video encoder, so ``-t
out.mp4`` raises and ``--frames`` is required.
"""

from __future__ import annotations

import argparse
import glob
import math
import os
from typing import Optional, Sequence

import numpy as np

from ..data.psee_io import EventStream, load_bboxes
from ..utils.draw import put_text, rectangle
from ..utils.png import write_png

__all__ = ["HSV_COLORS", "make_binary_histo", "draw_bboxes", "play_files",
           "main"]

LABELMAP = ("car", "pedestrian")
LABELMAP_LARGE = (
    "pedestrian", "two wheeler", "car", "truck", "bus",
    "traffic sign", "traffic light",
)
LABEL_SCALE = 0.35

# cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
# cv2.COLORMAP_HSV): BGR, one row an entry
HSV_COLORS = np.frombuffer(bytes.fromhex(
    "0000ff0006ff000cff0012ff0018ff001eff0024ff002aff0030ff0036ff003cff0042ff"
    "0048ff004eff0054ff005aff0060ff0066ff006cff0072ff0078ff007eff0084ff008aff"
    "0090ff0096ff009cff00a2ff00a8ff00aeff00b4ff00baff00c0ff00c6ff00ccff00d2ff"
    "00d8ff00deff00e4ff00eaff00f0ff00f4fd00f7fa00faf700fdf400fff000ffea00ffe4"
    "00ffde00ffd800ffd200ffcc00ffc600ffc000ffba00ffb400ffae00ffa800ffa200ff9c"
    "00ff9600ff9000ff8a00ff8400ff7e00ff7800ff7200ff6c00ff6600ff6000ff5a00ff54"
    "00ff4e00ff4800ff4200ff3c00ff3600ff3000ff2a00ff2400ff1e00ff1800ff1200ff0c"
    "00ff0600ff0006ff000cff0012ff0018ff001eff0024ff002aff0030ff0036ff003cff00"
    "42ff0048ff004eff0054ff005aff0060ff0066ff006cff0072ff0078ff007eff0084ff00"
    "8aff0090ff0096ff009cff00a2ff00a8ff00aeff00b4ff00baff00c0ff00c6ff00ccff00"
    "d2ff00d8ff00deff00e4ff00eaff00f0ff00f4fd00f7fa00faf700fdf400fff000ffea00"
    "ffe400ffde00ffd800ffd200ffcc00ffc600ffc000ffba00ffb400ffae00ffa800ffa200"
    "ff9c00ff9600ff9000ff8a00ff8400ff7e00ff7800ff7200ff6c00ff6600ff6000ff5a00"
    "ff5400ff4e00ff4800ff4200ff3c00ff3600ff3000ff2a00ff2400ff1e00ff1800ff1200"
    "ff0c00ff0600ff0000ff0006ff000cff0012ff0018ff001eff0024ff002aff0030ff0036"
    "ff003cff0042ff0048ff004eff0054ff005aff0060ff0066ff006cff0072ff0078ff007e"
    "ff0084ff008aff0090ff0096ff009cff00a2ff00a8ff00aeff00b4ff00baff00c0ff00c6"
    "ff00ccff00d2ff00d8ff00deff00e4ff00eaff00f0fd00f4fa00f7f700faf400fdf000ff"
    "ea00ffe400ffde00ffd800ffd200ffcc00ffc600ffc000ffba00ffb400ffae00ffa800ff"
    "a200ff9c00ff9600ff9000ff8a00ff8400ff7e00ff7800ff7200ff6c00ff6600ff6000ff"
    "5a00ff5400ff4e00ff4800ff4200ff3c00ff3600ff3000ff2a00ff2400ff1e00ff1800ff"
    "1200ff0c00ff0600ff0000ff"), np.uint8).reshape(256, 3)


def make_binary_histo(events, img, width, height):
    """Negative events black, positive white, grey background
    (vis_utils.py:22-45); fills ``img`` in place and returns it."""
    img[...] = 127
    if len(events):
        img[events["y"], events["x"], :] = (
            255 * events["p"].astype(np.uint8)[:, None]
        )
    return img


def draw_bboxes(img, boxes, labelmap=LABELMAP):
    """Each box of the structured array ``boxes`` (x, y, w, h, class_id)
    at thickness 1 in its class's HSV colour, its class name above it."""
    for i in range(len(boxes)):
        x, y = int(boxes["x"][i]), int(boxes["y"][i])
        w, h = int(boxes["w"][i]), int(boxes["h"][i])
        cls = int(boxes["class_id"][i])
        color = tuple(int(c) for c in HSV_COLORS[(cls * 60) % 255])
        rectangle(img, (x, y), (x + w, y + h), color, 1)
        put_text(img, labelmap[cls % len(labelmap)], (x, max(y - 2, 8)),
                 LABEL_SCALE, color)


def play_files(td_files: Sequence[str], delta_t: int = 50000, skip: int = 0,
               frames_dir: Optional[str] = None,
               max_frames: Optional[int] = None) -> int:
    """Draw the streams ``td_files`` window by window, tiled, into PNGs
    under ``frames_dir``; returns the frames drawn."""
    streams = [EventStream(f) for f in td_files]
    box_arrays = []
    for f in td_files:
        cands = glob.glob(f.split("_td.dat")[0] + "*.npy")
        box_arrays.append(load_bboxes(cands[0]) if cands else None)

    height, width = streams[0].get_size()
    if height is None or width is None:  # .npy / headerless .dat streams
        height, width = 240, 304
    labelmap = LABELMAP if height == 240 else LABELMAP_LARGE

    size_x = int(math.ceil(math.sqrt(len(streams))))
    size_y = int(math.ceil(len(streams) / size_x))
    frame = np.zeros((size_y * height, size_x * width, 3), np.uint8)
    if frames_dir:
        os.makedirs(frames_dir, exist_ok=True)

    t_end = max(s.total_time() for s in streams)
    n = 0
    for t0 in range(skip, int(t_end), delta_t):
        for idx, (s, boxes) in enumerate(zip(streams, box_arrays)):
            y, x = divmod(idx, size_x)
            tile = frame[y * height:(y + 1) * height,
                         x * width:(x + 1) * width]
            evs = s.events_between(t0, t0 + delta_t)
            make_binary_histo(evs, tile, width, height)
            if boxes is not None and len(boxes):
                ts = boxes["t"].astype(np.int64)
                sel = boxes[(ts >= t0) & (ts < t0 + delta_t)]
                draw_bboxes(tile, sel, labelmap)
        if frames_dir:
            write_png(os.path.join(frames_dir, f"f{n:06d}.png"), frame)
        n += 1
        if max_frames and n >= max_frames:
            break
    return n


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser("eas_snn_tpu_torch play_events",
                                description=__doc__.splitlines()[0])
    p.add_argument("records", nargs="+", help="_td.dat event files")
    p.add_argument("-s", "--skip", type=int, default=0, help="skip first us")
    p.add_argument("-d", "--delta_t", type=int, default=50000)
    p.add_argument("-t", "--to", type=str, default=None,
                   help="a video file: refused (no mp4 encoder); use "
                        "--frames")
    p.add_argument("--frames", type=str, required=True,
                   help="write PNG frames to this directory")
    p.add_argument("--max-frames", type=int, default=None)
    args = p.parse_args(argv)
    if args.to:
        raise ValueError(
            f"play_events: {args.to}: writing a video needs an mp4 "
            "(MPEG-4) encoder, which the JAX tool takes from "
            "cv2.VideoWriter and the port does not have; write PNG frames "
            "with --frames DIR")
    n = play_files(args.records, delta_t=args.delta_t, skip=args.skip,
                   frames_dir=args.frames, max_frames=args.max_frames)
    print(f"wrote {n} frames -> {args.frames}")
    return n


if __name__ == "__main__":
    main()
