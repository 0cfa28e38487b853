"""The traced window: ``torch.profiler`` over the window's work, read back
from its chrome trace. It gives the device's busy seconds (the union of
the kernels', copies' and sets' intervals inside the window), the
window's length, each kernel's device seconds by name, and the idle gaps
of the device named by the host op that was running in them (the
innermost one that covers the gap's midpoint)."""

from __future__ import annotations

import json
import os
import tempfile
from contextlib import contextmanager
from typing import Dict, List, Tuple

import torch

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Trace:
    """What a traced window read: ``window_s``, ``busy_s``, ``kernels``
    {name: device seconds}, ``launches`` {name: count}, ``gaps`` [(host
    op, seconds)] longest first."""

    def __init__(self):
        self.window_s = 0.0
        self.busy_s = 0.0
        self.kernels: Dict[str, float] = {}
        self.launches: Dict[str, int] = {}
        self.gaps: List[Tuple[str, float]] = []

    def kernel_s(self, symbol: str) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds
        ``symbol``."""
        hits = [k for k in self.kernels if symbol in k]
        return (sum(self.kernels[k] for k in hits),
                sum(self.launches[k] for k in hits))

    def device_ops(self, top: int = 10) -> List[list]:
        rows = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:top]
        return [[k[:120], v] for k, v in rows]

    def idle_gaps(self, top: int = 10) -> List[list]:
        return [[n[:120], s] for n, s in self.gaps[:top]]


@contextmanager
def traced():
    """Profile the block (wrap the window's work in ``window()``); the
    :class:`Trace` is filled when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    out = Trace()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    try:
        yield out
    finally:
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    _read(events.get("traceEvents", events), out)


def window():
    """The span that marks the measured window inside ``traced``."""
    return torch.profiler.record_function(WINDOW)


def _read(events: list, out: Trace) -> None:
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    if not win:
        return
    w0 = min(float(e["ts"]) for e in win)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in win)
    out.window_s = (w1 - w0) * 1e-6
    dev = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        dev.append((a, b))
        name = e.get("name", "?")
        out.kernels[name] = out.kernels.get(name, 0.0) + (b - a) * 1e-6
        out.launches[name] = out.launches.get(name, 0) + 1
    dev.sort()
    busy, gaps, cur_a, cur_b = 0.0, [], None, w0
    for a, b in dev:
        if cur_a is None:
            if a > w0:
                gaps.append((w0, a))
            cur_a, cur_b = a, b
        elif a > cur_b:
            busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_a is not None:
        busy += cur_b - cur_a
        if cur_b < w1:
            gaps.append((cur_b, w1))
    out.busy_s = busy * 1e-6
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
             e.get("name", "?")) for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and e.get("name") != WINDOW]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (a + b)
        cover = [h for h in host if h[0] <= mid <= h[1]]
        name = min(cover, key=lambda h: h[1] - h[0])[2] if cover \
            else "(no host op)"
        named.append((name, (b - a) * 1e-6))
    out.gaps = named
