"""The numbers that decide ``correct`` in the train cells (the eval cell's
are in ``sites.py``): each a gap between what the program produced on
its timed path and what the plain reference works out from the same
inputs, held against a limit of its own (the cell's traffic file,
``limits``). Each limit was set between the widest reading
of sound runs over a dozen seeds or more and the narrowest reading of the
control (the reference in the precision below the configuration's), as
``PERF.md`` records."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

Reading = Tuple[str, float, float]  # (name, value, limit)

# a leaf whose reference gradient norm is below this share of the median
# leaf's moves by round-off alone under Adam: its change is not compared
STILL_LEAF = 1e-3


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    if not names:
        return {}
    norms = torch.stack([torch.linalg.vector_norm(tensors[n].double())
                         for n in names]).cpu().tolist()
    return dict(zip(names, norms))


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              leaves=None) -> Dict[str, float]:
    """|got - ref| / max(ref, the median leaf's ref), by leaf."""
    leaves = list(ref) if leaves is None else list(leaves)
    if not leaves:
        return {}
    med = float(np.median([ref[n] for n in leaves]))
    out = {}
    for n in leaves:
        gap = abs(got.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30)
        out[n] = gap if math.isfinite(gap) else math.inf
    return out


def worst_leaf(got: Dict[str, float], ref: Dict[str, float],
               leaves=None) -> float:
    """The widest of :func:`leaf_gaps`."""
    return max(leaf_gaps(got, ref, leaves).values(), default=0.0)


def median_leaf(got: Dict[str, float], ref: Dict[str, float],
                leaves=None) -> float:
    """The median of :func:`leaf_gaps`."""
    gaps = list(leaf_gaps(got, ref, leaves).values())
    return float(np.median(gaps)) if gaps else 0.0


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {'losses': [{term: value}, ...] a step,
    'grad': {leaf: norm} of the first gradient, 'update' and 'ema':
    {leaf: norm} of the change over the steps, and optionally 'update1':
    {leaf: norm} of the change after the first step}."""
    steps = []
    for lp, lr in zip(prog["losses"], ref["losses"]):
        a, b = lp["total_loss"], lr["total_loss"]
        gap = abs(a - b) / max(abs(b), 1e-12)
        steps.append(gap if math.isfinite(gap) else math.inf)
    med = float(np.median(list(ref["grad"].values())))
    moving = [n for n, v in ref["grad"].items() if v >= STILL_LEAF * med]
    out = {"loss1_gap": steps[0], "loss_gap": max(steps),
           "grad_gap": worst_leaf(prog["grad"], ref["grad"]),
           "grad_median_gap": median_leaf(prog["grad"], ref["grad"]),
           "update_gap": worst_leaf(prog["update"], ref["update"], moving),
           "update_median_gap": median_leaf(prog["update"], ref["update"],
                                            moving),
           "ema_gap": worst_leaf(prog["ema"], ref["ema"], moving),
           "ema_median_gap": median_leaf(prog["ema"], ref["ema"], moving)}
    if "update1" in prog and "update1" in ref:
        out["update1_gap"] = worst_leaf(prog["update1"], ref["update1"],
                                        moving)
    return out


def replay_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """:func:`train_numbers` of one step taken by both sides from the same
    state (the program's replay), named ``replay_*``."""
    nums = train_numbers(prog, ref)
    out = {"replay_loss_gap": nums.pop("loss1_gap")}
    nums.pop("loss_gap")
    out.update({f"replay_{k}": v for k, v in nums.items()})
    return out


def train_report(prog: dict, ref: dict, tag: str = "") -> List[str]:
    """Lines that show where the train numbers come from: each step's
    loss on both sides and the leaves of the widest gaps, each line
    starting with ``tag``."""
    lines = [f"{tag}step {t + 1} total_loss program {a['total_loss']!r} "
             f"reference {b['total_loss']!r}"
             for t, (a, b) in enumerate(zip(prog["losses"], ref["losses"]))]
    for key in ("grad", "update1", "update"):
        if key not in prog or key not in ref:
            continue
        gaps = leaf_gaps(prog[key], ref[key])
        for n in sorted(gaps, key=lambda n: -gaps[n])[:4]:
            lines.append(f"{tag}{key} {n} gap {gaps[n]:.3e} program "
                         f"{prog[key].get(n, 0.0):.6e} reference "
                         f"{ref[key][n]:.6e}")
    return lines


def anchor_strides(model: dict) -> np.ndarray:
    """The stride of every anchor of the head's three levels, in order."""
    H, W = model["input_size"]
    return np.concatenate([np.full((H // s) * (W // s), float(s), np.float32)
                           for s in (8, 16, 32)])


def hold(numbers: Dict[str, float], limits: Dict[str, float]
         ) -> List[Reading]:
    """Each compared number (those the traffic file gives a limit) beside
    its limit; every limit has its number."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"no number {sorted(missing)} to hold to its limit")
    return [(k, numbers[k], float(limits[k])) for k in limits]


def passed(readings: List[Reading]) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in readings)
