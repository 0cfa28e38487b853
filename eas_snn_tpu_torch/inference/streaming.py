"""Streaming event-camera detection (the port's counterpart of
``eas_snn_tpu/inference/streaming.py:StreamingDetector``).

A ``StreamingDetector`` takes decoded event packets as they arrive
(``push``), keeps a rolling host buffer of the newest ``window_us`` of
them, and on ``detect`` runs one fixed-shape program over the window
``[t1 - window_us, t1)``: the newest ``max_events`` events go into pinned
host buffers, then, on the device, the copy into static buffers, the
binning by timestamps (``data/reps.py:bin_events_device``), a
nearest-neighbour letterbox and the detector's eval forward; the decoded
outputs come back to the host for the confidence filter and NMS
(``ops/boxes.py:postprocess``), and the boxes are scaled back to the
sensor. Host work a detection is O(buffer) for ``push`` (the packet is
concatenated onto the whole buffer, as in the JAX detector) and O(window)
for one copy into the pinned buffers: nothing is re-read or binned on the
host.

On a CUDA device the fixed-shape part is captured once as one CUDA graph
(where the JAX package has ``jax.jit``) after two eager warm-up runs on a
side stream; every later ``detect`` fills the pinned buffers and the
per-call scalars (the first event's offset in the window, the bin width
and the count of valid events) and replays it. A capture that fails
raises: nothing runs the eager program in its place. ``eager=True`` runs
the same code uncaptured; on the CPU it always runs eagerly.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..data.psee_io import EVENT_DTYPE
from ..data.reps import bin_events_device
from ..exp.event_exp import resolve_device
from ..ops.boxes import postprocess

__all__ = ["CapturedProgram", "StreamingDetector"]


class CapturedProgram:
    """A fixed-shape program as one CUDA graph (where the JAX package has
    ``jax.jit``). ``fn`` takes no arguments, reads only tensors that stay
    in place (static input buffers, the weights) and returns one device
    tensor; each call returns its value in a host buffer, pinned on CUDA
    (the copy is part of the program). On a CUDA device the first
    ``WARMUP`` calls run ``fn`` eagerly on a side stream, the next one
    captures it and replays, and every later call replays. A capture that
    fails raises: nothing runs ``fn`` eagerly in its place. ``eager=True``
    runs ``fn`` at every call; on the CPU it always does."""

    WARMUP = 2  # eager runs on the capture's side stream before it

    def __init__(self, fn: Callable[[], torch.Tensor], device: torch.device,
                 eager: bool = False):
        self.fn, self.device = fn, device
        self.eager = eager or device.type != "cuda"
        self.graph = None
        self.replays = 0
        self._warm = 0
        self._host = None

    def _program(self) -> None:
        out = self.fn()
        if self._host is None:
            self._host = torch.empty(out.shape, dtype=out.dtype,
                                     pin_memory=self.device.type == "cuda")
        self._host.copy_(out, non_blocking=True)

    def __call__(self) -> torch.Tensor:
        if self.eager:
            self._program()
        elif self.graph is not None:
            self.graph.replay()
            self.replays += 1
        elif self._warm < self.WARMUP:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._program()
            torch.cuda.current_stream(self.device).wait_stream(side)
            self._warm += 1
        else:
            torch.cuda.current_stream(self.device).synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._program()
            self.graph = graph
            graph.replay()
            self.replays += 1
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self._host


class StreamingDetector:
    """Detection on a live event stream with ``model`` (a port
    ``EASYOLOX``, e.g. built under ``exp.deploy()``), which is moved to
    ``device`` and set to eval mode."""

    WARMUP = CapturedProgram.WARMUP

    def __init__(self, model: nn.Module, *,
                 img_size: Tuple[int, int],      # raw sensor (H, W)
                 input_size: Tuple[int, int],    # model input (H, W), /32
                 Tm: int = 4, window_us: int = 200_000,
                 max_events: int = 262_144, num_classes: int = 2,
                 confthre: float = 0.3, nmsthre: float = 0.65,
                 device="cuda", eager: bool = False):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.img_size, self.input_size = tuple(img_size), tuple(input_size)
        self.Tm, self.window_us, self.max_events = Tm, window_us, max_events
        self.num_classes, self.confthre, self.nmsthre = (
            num_classes, confthre, nmsthre)
        self._buf = np.zeros(0, EVENT_DTYPE)
        self._scale = min(input_size[0] / img_size[0],
                          input_size[1] / img_size[1])
        self._scaled_hw = (int(img_size[0] * self._scale),
                           int(img_size[1] * self._scale))
        pin = self.device.type == "cuda"
        # rows t (relative to the window start), x, y, p; the scalars rel0
        # (first event - window start), tw (bin width) and n (valid events)
        self._host_ev = torch.zeros((4, max_events), dtype=torch.int32,
                                    pin_memory=pin)
        self._host_sc = torch.zeros(3, dtype=torch.int64, pin_memory=pin)
        self._ev = torch.zeros((4, max_events), dtype=torch.int32,
                               device=self.device)
        self._sc = torch.zeros(3, dtype=torch.int64, device=self.device)
        self._slot = torch.arange(max_events, device=self.device)
        # frames, the forward at B=1 and its decoded outputs (1, A, 5 +
        # classes) f32 into a host buffer: what a replay runs
        self.program = CapturedProgram(self._forward, self.device, eager)
        self.eager = self.program.eager
        self.fill_s = 0.0  # host seconds of the last detection's fill

    # ------------------------------------------------------------ host
    def push(self, events: np.ndarray) -> None:
        """Append a packet of decoded events (EVENT_DTYPE, time-sorted) and
        drop everything older than ``window_us`` behind the newest one."""
        if len(events) == 0:
            return
        self._buf = np.concatenate([self._buf, events])
        horizon = int(self._buf["t"][-1]) - self.window_us
        if horizon > 0:
            lo = np.searchsorted(self._buf["t"], horizon)
            self._buf = self._buf[lo:]

    def _fill(self, t_now: Optional[int]) -> bool:
        """The window ending at ``t_now`` (default: the newest event) into
        the pinned buffers; False when it holds no event."""
        if len(self._buf) == 0:
            return False
        t1 = int(t_now if t_now is not None else self._buf["t"][-1]) + 1
        t0 = t1 - self.window_us
        lo = np.searchsorted(self._buf["t"], t0)
        hi = np.searchsorted(self._buf["t"], t1)
        ev = self._buf[lo:hi]
        if len(ev) == 0:
            return False
        n = min(len(ev), self.max_events)
        ev = ev[len(ev) - n:]
        host = self._host_ev.numpy()
        host[0, :n] = ev["t"].astype(np.int64) - t0
        host[1, :n] = ev["x"]
        host[2, :n] = ev["y"]
        host[3, :n] = ev["p"]
        span = int(ev["t"][-1]) - int(ev["t"][0])
        self._host_sc.numpy()[:] = (int(ev["t"][0]) - t0,
                                    max(span // self.Tm, 1), n)
        return True

    # ---------------------------------------------------------- device
    def _frames(self) -> torch.Tensor:
        """The static buffers' window as letterboxed frames (Tm, H, W, 2):
        bin by timestamps, nearest resize (half-pixel centres, the JAX
        ``jax.image.resize(..., "nearest")``), zero pad right and below."""
        self._ev.copy_(self._host_ev, non_blocking=True)
        self._sc.copy_(self._host_sc, non_blocking=True)
        t, x, y, p = self._ev
        frames = bin_events_device(
            t, x, y, p, self._slot < self._sc[2], t0=self._sc[0],
            time_window=self._sc[1], n_bins=self.Tm,
            height=self.img_size[0], width=self.img_size[1])
        ih, iw = self._scaled_hw
        h, w = self.input_size
        fh = F.interpolate(frames.permute(0, 3, 1, 2), size=(ih, iw),
                           mode="nearest-exact")
        return F.pad(fh, (0, w - iw, 0, h - ih)).permute(0, 2, 3, 1)

    def _forward(self) -> torch.Tensor:
        with torch.no_grad():
            return self.model(self._frames()[None, None]).float()

    @property
    def replays(self) -> int:
        """Replays of the captured program so far."""
        return self.program.replays

    # ---------------------------------------------------------- public
    def frames(self, t_now: Optional[int] = None) -> Optional[torch.Tensor]:
        """The letterboxed frames (Tm, H, W, 2) of the window ending at
        ``t_now`` on the device, run eagerly, or None for an empty
        window."""
        if not self._fill(t_now):
            return None
        return self._frames()

    def outputs(self, t_now: Optional[int] = None) -> Optional[np.ndarray]:
        """The decoded outputs (1, A, 5 + classes) f32 of the window ending
        at ``t_now``, before the filter and NMS, or None for an empty
        window."""
        t0 = time.perf_counter()
        filled = self._fill(t_now)
        self.fill_s = time.perf_counter() - t0
        if not filled:
            return None
        return self.program().numpy().copy()

    def detect(self, t_now: Optional[int] = None) -> Optional[np.ndarray]:
        """Detections in the window ending at ``t_now`` (default: the newest
        event): (n, 7) [x1, y1, x2, y2, obj, cls_conf, cls] at raw sensor
        resolution, or None."""
        out = self.outputs(t_now)
        if out is None:
            return None
        dets = postprocess(out, self.num_classes, self.confthre,
                           self.nmsthre)[0]
        if dets is None:
            return None
        dets = dets.copy()
        dets[:, :4] /= self._scale
        return dets
