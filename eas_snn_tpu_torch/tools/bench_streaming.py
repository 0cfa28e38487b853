"""Latency of streaming detection against the re-read-and-re-bin protocol
(the port's counterpart of ``tools/bench_streaming.py``).

On one synthetic Gen1 stream (``tools/ap_drift.py:_make_stream``, 240x304)
and ``gen1_syolox_m`` under ``deploy()``, a detection every ``--tick-us``
over ``--ticks`` ticks:

  baseline - the Gen1 val pipeline a detection: re-read the window ending
             at the tick from the .dat (``search_events``), bin its
             micro-frames on the host (``micro_sum`` through the native
             core), letterbox (bilinear), copy the dense frames to the
             device, run the forward at B=1 (one CUDA graph, as the
             stream's, where the JAX tool jits the same forward for both
             paths), filter and NMS on the host;
  stream   - ``inference.StreamingDetector``: push only the events since
             the last tick, then ``detect`` (the window's raw events into
             pinned buffers, one replay of the captured program: copy,
             binning, letterbox and forward; filter and NMS on the host).

Per detection: host ms (baseline: the re-read, binning and letterbox;
stream: ``push`` and the copy into the pinned buffers), end-to-end ms at
p50 and p99 (host clock to the detections in hand), detections a second,
and the ratios of the two paths.

    python -m eas_snn_tpu_torch.tools.bench_streaming [--ticks 100] \\
        [--tick-us 100000] [--window-us 200000] [--max-events 65536] \\
        [--events-per-s 60000] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["make_stream", "baseline", "stream", "summary", "main"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
IMG_SIZE = (240, 304)  # the Gen1 sensor
CONFTHRE = 0.3  # the JAX tool's confidence threshold


def make_stream(root: str, duration_us: int, events_per_s: int,
                seed: int = 11) -> str:
    """The stream of ``duration_us`` at ``events_per_s`` drawn from
    ``seed``: stream_td.dat (and its label file) in a directory of
    ``root`` named by the three, written once; returns the .dat path."""
    from .ap_drift import _make_stream

    d = os.path.join(root, f"{duration_us}us_{events_per_s}eps_seed{seed}")
    dat = os.path.join(d, "stream_td.dat")
    if not os.path.exists(dat):
        os.makedirs(d, exist_ok=True)
        _make_stream(dat, os.path.join(d, "stream_bbox.npy"), seed=seed,
                     duration_us=duration_us, events_per_s=events_per_s)
    return dat


def baseline(exp, model, dat: str, ticks: Sequence[int], confthre: float,
             device: torch.device) -> dict:
    """The re-read protocol over the stream ``dat`` at each tick: host ms
    and end-to-end ms a detection (after ``CapturedProgram.WARMUP + 1``
    untimed detections, which warm up and capture the forward)."""
    from ..data.augment import letterbox
    from ..inference import CapturedProgram
    from ..ops.boxes import postprocess

    exp.data_dir = os.path.dirname(dat)
    ds = exp.get_dataset(training=False, map_val=False)

    def prep(t1):
        ev = ds.search_events(0, t1)              # the window, re-read
        frames = ds.aggregate(ev)                 # (Tm, H, W, 2) host bins
        frames, _ = letterbox(frames, np.zeros((0, 5)), exp.test_size)
        return frames[None, None]                 # (1, Tl=1, Tm, h, w, 2)

    first = prep(ticks[0])
    x = torch.zeros(first.shape, dtype=torch.float32, device=device)

    def fwd():
        with torch.no_grad():
            return model(x).float()

    program = CapturedProgram(fwd, device)

    def forward(frames):
        x.copy_(torch.from_numpy(frames))         # pageable, as jnp.asarray
        return postprocess(program().numpy(), exp.num_classes, confthre,
                           exp.nmsthre)[0]

    for _ in range(program.WARMUP + 1):
        forward(first)
    host, total = [], []
    for t1 in ticks:
        w0 = time.perf_counter()
        frames = prep(t1)
        w1 = time.perf_counter()
        forward(frames)
        w2 = time.perf_counter()
        host.append(w1 - w0)
        total.append(w2 - w0)
    return {"host_s": host, "total_s": total}


def stream(det, dat: str, ticks: Sequence[int]) -> dict:
    """``StreamingDetector`` fed the stream tick by tick: host ms (push
    and fill) and end-to-end ms a detection. Everything before the first
    tick is pushed first, and ``det.WARMUP + 1`` detections there warm up
    and capture the program, untimed."""
    from ..data.psee_io import EventStream

    src = EventStream(dat)
    det.push(src.load_delta_t(ticks[0]))
    for _ in range(det.WARMUP + 1):
        det.detect(ticks[0] - 1)
    push, fill, total, found = [], [], [], 0
    prev = ticks[0]
    for t1 in ticks[1:]:
        pkt = src.load_delta_t(t1 - prev)         # only the new events
        prev = t1
        w0 = time.perf_counter()
        det.push(pkt)
        w1 = time.perf_counter()
        dets = det.detect(t1 - 1)
        w2 = time.perf_counter()
        push.append(w1 - w0)
        fill.append(det.fill_s)
        total.append(w2 - w0)
        found += 0 if dets is None else len(dets)
    return {"push_s": push, "fill_s": fill, "total_s": total,
            "detections": found}


def _ms(xs: List[float], q: Optional[float] = None) -> float:
    a = np.asarray(xs) * 1e3
    return float(a.mean() if q is None else np.percentile(a, q))


def summary(base: dict, strm: dict) -> dict:
    """Means and percentiles of both paths, in ms, and their ratios."""
    host_s = [p + f for p, f in zip(strm["push_s"], strm["fill_s"])]
    res = {
        "baseline_host_ms": _ms(base["host_s"]),
        "baseline_total_ms_p50": _ms(base["total_s"], 50),
        "baseline_total_ms_p99": _ms(base["total_s"], 99),
        "stream_push_ms": _ms(strm["push_s"]),
        "stream_fill_ms": _ms(strm["fill_s"]),
        "stream_host_ms": _ms(host_s),
        "stream_total_ms_p50": _ms(strm["total_s"], 50),
        "stream_total_ms_p99": _ms(strm["total_s"], 99),
        "stream_detections_per_s": 1.0 / float(np.mean(strm["total_s"])),
        "stream_boxes": strm["detections"],
    }
    res["host_ratio"] = res["baseline_host_ms"] / res["stream_host_ms"]
    res["total_ratio_p50"] = (res["baseline_total_ms_p50"]
                              / res["stream_total_ms_p50"])
    return res


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("eas_snn_tpu_torch bench_streaming")
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--tick-us", type=int, default=100_000)
    ap.add_argument("--window-us", type=int, default=200_000)
    ap.add_argument("--max-events", type=int, default=65_536)
    ap.add_argument("--events-per-s", type=int, default=60_000)
    ap.add_argument("--root", default=os.path.join(_REPO, "outputs",
                                                   "bench_streaming"))
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from ..exp import get_exp
    from ..exp.event_exp import resolve_device
    from ..inference import StreamingDetector

    a = make_parser().parse_args(argv)
    device = resolve_device(a.device)
    exp = get_exp("gen1_syolox_m").deploy()
    model = exp.get_model(device=device, seed=exp.seed or 0)
    ticks = [a.window_us + 100_000 + i * a.tick_us for i in range(a.ticks)]
    dat = make_stream(a.root, ticks[-1] + 2 * a.tick_us, a.events_per_s)
    base = baseline(exp, model, dat, ticks, CONFTHRE, device)
    det = StreamingDetector(
        model, img_size=IMG_SIZE, input_size=exp.test_size, Tm=exp.Tm,
        window_us=a.window_us, max_events=a.max_events,
        num_classes=exp.num_classes, confthre=CONFTHRE,
        nmsthre=exp.nmsthre, device=device)
    res = dict(ticks=a.ticks, max_events=a.max_events,
               events_per_s=a.events_per_s,
               device=(torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
               **summary(base, stream(det, dat, ticks)))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
