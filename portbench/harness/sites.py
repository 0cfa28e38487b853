"""The eval forward held site by site. A random spiking detector is
chaotic: a spike that flips at its threshold on rounding flips others
downstream, and after a few stages two correct forwards share no more
spikes than two independent draws at the same rate (``PERF.md``). So the
reference follows the program step by step from the program's own
state: one timed call records what every site of the program received
and produced (the sampler's output, each conv + BN + activation site's
input pieces and output, the decoded outputs), and the reference then
runs its own forward with every site's output replaced by the
program's. It computes

* each site again from the program's inputs: the share of spikes that
  differ at a spiking site, the widest relative gap at an analog one;
* the glue between the sites (the shortcut adds, concats, pools,
  upsampling, rate decoding) from the program's outputs: each site's
  input has to equal the program's, element for element;
* the sampler from the events and the decoded outputs from the
  program's last sites;
* the NMS from the program's decoded outputs: the detections have to
  equal the program's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn


def _sites(model: nn.Module):
    return [(n, m) for n, m in model.named_modules()
            if type(m).__name__ == "BaseConv"]


class Capture:
    """Hooks that record, in a forward of ``model`` while ``armed``, the
    sampler's output and every site's input pieces and output."""

    def __init__(self, model: nn.Module, armed: bool = False):
        self.data: Dict[str, dict] = {}
        self.handles = []
        self.armed = armed
        emb = model.embedding
        self.handles.append(emb.register_forward_hook(
            lambda m, a, out: self._put("embedding", None, out)))
        for n, m in _sites(model):
            self.handles.append(m.register_forward_hook(
                lambda m, a, out, n=n: self._put(n, a[0], out)))

    def _put(self, name, x, out) -> None:
        if not self.armed:
            return
        pieces = None
        if x is not None:
            xs = tuple(x) if isinstance(x, (tuple, list)) else (x,)
            pieces = tuple(p.detach().clone() for p in xs)
        self.data[name] = {"in": pieces, "out": out.detach().clone()}

    def close(self) -> None:
        self.armed = False
        for h in self.handles:
            h.remove()
        self.handles = []


def _flip_share(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() != b.float()).float().mean())


def _rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def teacher_forced(ref: nn.Module, cap: Dict[str, dict],
                   events: torch.Tensor, prog_out: torch.Tensor,
                   strides: np.ndarray) -> Dict[str, float]:
    """Run ``ref`` (eval) on ``events`` with every site's output replaced
    by the program's (``cap``); the gaps, as the module docstring says."""
    res = {"sampler_gap": 0.0, "site_flip_gap": 0.0, "analog_gap": 0.0,
           "glue_gap": 0.0}
    handles = []

    def emb_hook(m, a, out):
        got = cap["embedding"]["out"]
        rel = (got.float() - out.float()).abs() / (1.0 + out.float().abs())
        res["sampler_gap"] = float((rel > 1e-5).float().mean())
        return got.to(out.dtype)

    handles.append(ref.embedding.register_forward_hook(emb_hook))

    def pre(m, a, n):
        x = a[0]
        xs = tuple(x) if isinstance(x, (tuple, list)) else (x,)
        want = cap[n]["in"]
        bad = sum(int((p.float() != q.float()).sum())
                  for p, q in zip(xs, want))
        bad += abs(len(xs) - len(want))
        res["glue_gap"] += float(bad)
        return (want if isinstance(x, (tuple, list)) else want[0],)

    def post(m, a, out, n):
        got = cap[n]["out"]
        if m.spiking:
            res["site_flip_gap"] = max(res["site_flip_gap"],
                                       _flip_share(got, out))
        else:
            res["analog_gap"] = max(res["analog_gap"], _rel_gap(got, out))
        return got

    for n, m in _sites(ref):
        handles.append(m.register_forward_pre_hook(
            lambda m, a, n=n: pre(m, a, n)))
        handles.append(m.register_forward_hook(
            lambda m, a, out, n=n: post(m, a, out, n)))
    try:
        with torch.no_grad():
            out = ref(events).float()
    finally:
        for h in handles:
            h.remove()
    p, r = prog_out.float(), out
    st = torch.as_tensor(strides, device=r.device)[None, :, None]
    res["pred_gap"] = max(float((p[..., 4:] - r[..., 4:]).abs().max()),
                          float(((p[..., :4] - r[..., :4]).abs() / st).max()))
    return res


def dets_gap(prog: List[Optional[np.ndarray]],
             ref: List[Optional[np.ndarray]]) -> float:
    """Detections that differ between two lists (an image's array against
    the other's, row by row, exactly)."""
    bad = 0
    for a, b in zip(prog, ref):
        na = 0 if a is None else len(a)
        nb = 0 if b is None else len(b)
        if na != nb:
            bad += max(na, nb)
        elif na:
            bad += int((~np.isclose(a, b, rtol=0, atol=0)).any(1).sum())
    return float(bad)
