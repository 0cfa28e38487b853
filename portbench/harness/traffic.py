"""The one traffic generator: every mix is a data file of parameters
(``portbench/traffic/<cell>.json``) that these functions read. The same
seed gives the same inputs; every seed gives the same sizes, counts and
rates, drawn in another order.

Frozen copies, each after its source:

* event windows: a window of ``events_per_window`` events at the mix's
  rate over the sensor, binned into Tm micro-frames of polarity counts,
  as Poisson counts (the binned uniform events of ``chip_smoke.py:
  write_gen1_tree`` and ``_poisson_batch``, at ``EVENTS_PER_S`` = 500k
  events/s in a 200 ms window; N-Caltech recordings of ``NC_EVENTS``),
  then letterboxed: nearest resize by the one scale that fits the input,
  zeros right and below (the port's ``StreamingDetector._frames``);
* labels: ``chip_smoke.py:random_labels`` (1-8 boxes an image, sides at
  least 8 px and at most a third of the frame, inside it), with the
  mix's box count and classes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def seeded(seed: int, stream: int) -> int:
    """A seed for the sub-stream ``stream`` of the run's ``seed`` (any
    whole number, also beyond 32 bits)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 63), stream])
    return int(ss.generate_state(1, np.uint64)[0] >> 1)


def letterbox_hw(sensor: Tuple[int, int], size: Tuple[int, int]):
    """(scaled H, scaled W, scale) of a sensor letterboxed into ``size``."""
    s = min(size[0] / sensor[0], size[1] / sensor[1])
    return int(sensor[0] * s), int(sensor[1] * s), s


def letterbox(frames: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(..., Hs, Ws, C) -> (..., H, W, C): nearest-exact resize by the one
    scale that fits, zeros right and below."""
    lead = frames.shape[:-3]
    Hs, Ws, C = frames.shape[-3:]
    ih, iw, _ = letterbox_hw((Hs, Ws), size)
    x = frames.reshape((-1, Hs, Ws, C)).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(ih, iw), mode="nearest-exact")
    x = F.pad(x, (0, size[1] - iw, 0, size[0] - ih))
    return x.permute(0, 2, 3, 1).reshape(lead + (size[0], size[1], C))


def event_batch(mix: dict, model: dict, B: int, gen: torch.Generator,
                device) -> torch.Tensor:
    """(B, Tl, Tm, H, W, 2) f32 polarity counts: each of the B * Tl
    windows holds ``events_per_window`` events on average over the
    ``sensor``, in Tm micro-frames."""
    Hs, Ws = mix["sensor"]
    Tl, Tm = model["Tl"], model["Tm"]
    lam = mix["events_per_window"] / (Hs * Ws * 2 * Tm)
    counts = torch.poisson(torch.full((B, Tl, Tm, Hs, Ws, 2), lam,
                                      device=device), generator=gen)
    return letterbox(counts, tuple(model["input_size"]))


def labels(mix: dict, model: dict, B: int, rng: np.random.Generator,
           max_labels: int = 50) -> torch.Tensor:
    """(B, max_labels, 5) [cls, cx, cy, w, h] in input pixels, zero rows
    after each image's boxes."""
    H, W = model["input_size"]
    lo, hi = mix["boxes_per_image"]
    lab = np.zeros((B, max_labels, 5), np.float32)
    for b in range(B):
        n = int(rng.integers(lo, hi + 1))
        w = rng.uniform(8, W / 3, n)
        h = rng.uniform(8, H / 3, n)
        lab[b, :n] = np.stack([
            rng.integers(0, model["num_classes"], n),
            rng.uniform(w / 2, W - w / 2), rng.uniform(h / 2, H - h / 2),
            w, h], 1)
    return torch.from_numpy(lab)
