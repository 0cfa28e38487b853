"""Event -> tensor representations (the port's copy of
``eas_snn_tpu/data/reps.py``).

Host (numpy) side, run by the datasets in loader workers: ``sum`` and
``micro_sum`` polarity histograms (reference yolox/data/datasets/gen1.py:
313-373), the time-window slicing they share, the bilinear-in-time
``voxel_grid``, the ``voxel_cube``, the exponential ``timesurface`` and its
decay weights (reference yolox/utils/event_reps.py:13-160), and
``pad_events``. The histograms go through the native core (``fastbin``)
where the event fields fit its u16/u16/u8 layout; the numpy versions are
its plain versions (``native=False``) and its test oracle.

Device side: ``bin_event_batch`` scatter-adds host-indexed events into
(B, Tl, Tm, H, W, 2) micro-frames on the card, the training path's device
binning, and ``bin_events_device`` bins padded raw events by their
timestamps, the streaming detector's. JAX computes both as one XLA scatter
outside any Pallas kernel; here each is one ``index_add_`` onto a flat
buffer with a dead slot for padded and out-of-window events. Counts stay
below 2^24, so the atomic f32 adds are exact whatever their order.

Channel-last everywhere: a micro-frame stack is (Tm, H, W, 2).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["polarity_histogram", "slice_time_windows", "micro_sum",
           "voxel_grid", "voxel_cube", "timesurface_measure", "timesurface",
           "pad_events", "bin_event_batch", "bin_events_device"]


def _native_xyp(events: np.ndarray):
    """x/y/p arrays in the native core's u16/u16/u8 layout, or None where
    a wider field holds a value that would wrap (then numpy runs, which
    raises IndexError on coordinates outside the frame)."""
    xs, ys, ps = events["x"], events["y"], events["p"]
    for arr, want in ((xs, np.uint16), (ys, np.uint16), (ps, np.uint8)):
        if arr.dtype != want and len(arr) and (
            arr.min() < 0 or arr.max() > np.iinfo(want).max
        ):
            return None
    return (np.ascontiguousarray(xs, np.uint16),
            np.ascontiguousarray(ys, np.uint16),
            np.ascontiguousarray(ps, np.uint8))


def _native(events: np.ndarray, native: bool):
    """(core, x, y, p) when the native core takes these events."""
    if not native or not len(events):
        return None
    xyp = _native_xyp(events)
    if xyp is None:
        return None
    from .fastbin import load_native

    return (load_native(),) + xyp


def polarity_histogram(events: np.ndarray, height: int, width: int,
                       native: bool = True) -> np.ndarray:
    """(H, W, 2) float32 count image by polarity (the reference's 'sum'
    aggregation, gen1.py:333-349)."""
    core = _native(events, native)
    if core is not None:
        lib, xs, ys, ps = core
        out = np.zeros((2, height * width), np.float32)
        lib.polarity_histogram(len(events), xs, ys, ps, height, width, out)
        return np.moveaxis(out.reshape(2, height, width), 0, -1).copy()
    out = np.zeros((height * width, 2), np.float32)
    if len(events):
        idx = events["y"].astype(np.int64) * width \
            + events["x"].astype(np.int64)
        p = events["p"].astype(np.int64) & 1
        np.add.at(out, (idx, p), 1.0)
    return out.reshape(height, width, 2)


def slice_time_windows(
    events: np.ndarray, n: int, overlap: float = 0.0
) -> Tuple[Sequence[Optional[np.ndarray]], float]:
    """n equal windows over [t_first, t_last) (reference gen1.py:313-328):
    length ``(t_last - t_first) // (n(1 - overlap) + overlap)``, the i-th
    starting at ``t_first + i(1 - overlap)tw``; with overlap 0 the
    remainder ``(t_last - t_first) mod n`` is dropped. Returns (slices,
    stride)."""
    times = events["t"]
    if len(times) == 0:
        return [None] * n, 0
    tw = (int(times[-1]) - int(times[0])) // (n * (1 - overlap) + overlap)
    stride = (1 - overlap) * tw
    starts = np.arange(n) * stride + times[0]
    ends = starts + tw
    i0 = np.searchsorted(times, starts)
    i1 = np.searchsorted(times, ends)
    return [events[a:b] for a, b in zip(i0, i1)], stride


def micro_sum(events: np.ndarray, n_micro: int, height: int, width: int,
              native: bool = True) -> np.ndarray:
    """(Tm, H, W, 2) stack of polarity histograms of the Tm windows of
    ``slice_time_windows`` (the reference's 'micro_sum', gen1.py:356-360);
    the native core bins in one pass with the same window edges."""
    core = _native(events, native)
    if core is not None:
        lib, xs, ys, ps = core
        t0 = int(events["t"][0])
        tw = (int(events["t"][-1]) - t0) // n_micro
        out = np.zeros((n_micro, 2, height * width), np.float32)
        if tw > 0:
            lib.micro_sum(len(events),
                          np.ascontiguousarray(events["t"], np.int64),
                          xs, ys, ps, t0, tw, n_micro, height, width, out)
        return np.moveaxis(out.reshape(n_micro, 2, height, width), 1,
                           -1).copy()
    out = np.zeros((n_micro, height, width, 2), np.float32)
    if len(events):
        slices, _ = slice_time_windows(events, n_micro)
        for i, ev in enumerate(slices):
            if ev is not None and len(ev):
                out[i] = polarity_histogram(ev, height, width, native=False)
    return out


def voxel_grid(events: np.ndarray, height: int, width: int,
               n_time_bins: int = 10) -> np.ndarray:
    """(n_time_bins, H, W, 1) f32 event volume of Zhu et al.: polarity as
    +/-1, split bilinearly between the two nearest time bins (reference
    event_reps.py:30-89)."""
    if len(events) == 0:
        return np.zeros((n_time_bins, height, width, 1), np.float32)
    grid = np.zeros((n_time_bins, height, width), np.float64).ravel()
    t = events["t"].astype(np.float64)
    denom = t[-1] - t[0]
    ts = n_time_bins * (t - t[0]) / (denom if denom > 0 else 1)
    xs = events["x"].astype(np.int64)
    ys = events["y"].astype(np.int64)
    praw = events["p"].astype(np.float64)
    pol = np.where(praw == 0, -1.0, praw)
    tis = ts.astype(np.int64)
    dts = ts - tis
    base = xs + ys * width
    m = tis < n_time_bins
    np.add.at(grid, base[m] + tis[m] * width * height,
              (pol * (1.0 - dts))[m])
    m = (tis + 1) < n_time_bins
    np.add.at(grid, base[m] + (tis[m] + 1) * width * height, (pol * dts)[m])
    return grid.reshape(n_time_bins, height, width, 1).astype(np.float32)


def voxel_cube(events: np.ndarray, height: int, width: int, num_slices: int,
               tbins: int = 2) -> np.ndarray:
    """(num_slices, H, W, 2 * tbins) f32 voxel cube (IJCNN'22): each of
    ``num_slices`` windows of [first, last) split into ``tbins`` micro
    bins, channel (p + 1)(tbin + 1) - 1 (reference event_reps.py:92-138)."""
    out = np.zeros((num_slices, height, width, 2 * tbins), np.float32)
    if len(events) == 0:
        return out
    t = events["t"].astype(np.int64) - int(events["t"][0])
    time_window = (t[-1] - t[0]) // num_slices
    if time_window <= 0:
        return out
    keep = t < time_window * num_slices
    t = t[keep]
    ev = events[keep]
    sl = t // time_window
    tbin = ((t % time_window) / (time_window / tbins)).astype(np.int64)
    ch = ((ev["p"].astype(np.int64) + 1) * (tbin + 1)) - 1
    flat = (sl * (height * width * 2 * tbins)
            + ev["y"].astype(np.int64) * (width * 2 * tbins)
            + ev["x"].astype(np.int64) * (2 * tbins) + ch)
    np.add.at(out.reshape(-1), flat, 1.0)
    return out


def timesurface_measure(t_events: np.ndarray, t_target: float, tau: float,
                        decay: str = "exp") -> np.ndarray:
    """Exponential, tanh or linear time-decay weights of events at
    ``t_events`` seen from ``t_target`` (reference event_reps.py:13-23)."""
    if decay == "exp":
        return np.exp((t_events - t_target) / tau)
    if decay == "tanh":
        return 1.0 - np.tanh((t_target - t_events) / tau)
    if decay == "lin":
        return (t_events - t_target) / tau
    raise ValueError(f"unknown decay '{decay}'")


def timesurface(slices: Sequence[np.ndarray], height: int, width: int,
                dt: float, tau: float) -> np.ndarray:
    """(n, H, W, 2) f32 exponential time surface over consecutive slices:
    a (polarity, pixel) memory of the last event time; after slice i the
    surface is exp((memory - t_i) / tau), t_i = start + (i + 1) dt
    (reference event_reps.py:141-160)."""
    n = len(slices)
    out = np.zeros((n, height, width, 2), np.float32)
    if n == 0 or slices[0] is None or len(slices[0]) == 0:
        return out
    memory = np.zeros((2, height, width), np.int64)
    start_t = int(slices[0]["t"][0])
    for i, ev in enumerate(slices):
        if len(ev):
            memory[ev["p"].astype(np.int64) & 1, ev["y"].astype(np.int64),
                   ev["x"].astype(np.int64)] = ev["t"].astype(np.int64)
        diff = memory - ((i + 1) * dt + start_t)
        out[i] = np.moveaxis(np.exp(diff / tau), 0, -1)
    return out


def pad_events(events: np.ndarray, max_events: int):
    """int32 (t, x, y, p) and bool valid arrays of length ``max_events``;
    a longer stream keeps its most recent events (the windows end at the
    label time, gen1.py:115-137)."""
    n = len(events)
    if n > max_events:
        events = events[n - max_events:]
        n = max_events
    t = np.zeros(max_events, np.int32)
    x = np.zeros(max_events, np.int32)
    y = np.zeros(max_events, np.int32)
    p = np.zeros(max_events, np.int32)
    v = np.zeros(max_events, bool)
    t[:n] = events["t"].astype(np.int64) & 0x7FFFFFFF
    x[:n] = events["x"]
    y[:n] = events["y"]
    p[:n] = events["p"]
    v[:n] = True
    return t, x, y, p, v


def bin_event_batch(b: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    p: torch.Tensor, valid: torch.Tensor, *, n_bins: int,
                    height: int, width: int) -> torch.Tensor:
    """(..., N) host-indexed events (micro-bin ``b``, pixel, polarity,
    validity) -> (..., n_bins, H, W, 2) f32 counts on the events' device:
    (B, Tl, N) is the JAX ``bin_event_batch``, (N,) its
    ``bin_indexed_events_device``."""
    lead = tuple(b.shape[:-1])
    n_slices = int(np.prod(lead, dtype=np.int64))
    size = n_bins * height * width * 2
    dev = b.device
    base = torch.arange(n_slices, device=dev, dtype=torch.int64).reshape(
        lead + (1,)) * size
    flat = (b.long() * (height * width * 2) + y.long() * (width * 2)
            + x.long() * 2 + (p.long() & 1))
    flat = torch.where(valid, base + flat, n_slices * size).reshape(-1)
    hist = torch.zeros(n_slices * size + 1, dtype=torch.float32, device=dev)
    hist.index_add_(0, flat, torch.ones(flat.shape[0], dtype=torch.float32,
                                        device=dev))
    return hist[:-1].reshape(lead + (n_bins, height, width, 2))


def bin_events_device(t: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      p: torch.Tensor, valid: torch.Tensor, *,
                      t0, time_window, n_bins: int, height: int,
                      width: int) -> torch.Tensor:
    """(N,) int events -> (n_bins, H, W, 2) f32 polarity counts on the
    events' device (JAX ``data/reps.py:bin_events_device``). Bin i covers
    [t0 + i * tw, t0 + (i + 1) * tw) with tw = max(time_window, 1): with
    t0 the first event's time and time_window (t_last - t_first) // n_bins
    it is ``micro_sum``'s layout, whose remainder past n_bins * tw is
    dropped. ``t0`` and ``time_window`` may be 0-d integer tensors on the
    device (a captured graph reads them at replay) or Python ints.
    Events before t0, at bin n_bins or later, or not ``valid`` go to a
    dead slot."""
    dev = t.device
    tw = torch.clamp_min(torch.as_tensor(time_window, device=dev).long(), 1)
    rel = t.long() - torch.as_tensor(t0, device=dev).long()
    b = torch.div(rel, tw, rounding_mode="floor")
    inside = valid & (rel >= 0) & (b < n_bins)
    return bin_event_batch(b.clamp(0, n_bins - 1), x, y, p, inside,
                           n_bins=n_bins, height=height, width=width)
