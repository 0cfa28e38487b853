"""The Prophesee protocol over folders of saved box files (counterpart of
``tools/psee_evaluate_folders.py``; reference yolox/utils/psee_loader/
psee_evaluator.py:18-50 evaluate_folders): each ground-truth
``<stream>_bbox.npy`` of ``--gt`` against its prediction file in ``--dt``
(``<stream>.npy``, ``<stream>_bbox.npy``, else the first ``<stream>*.npy``
by name).

    python -m eas_snn_tpu_torch.tools.psee_evaluate_folders --gt GT_DIR \\
        --dt DT_DIR [--camera gen1|gen4] [--downsampled-by-2]

``PSEEEvaluator(box_dir=...)`` (``tools/eval_event.py --save_boxes``)
writes such folders; both arrays are ordered by time with a stable sort,
as the evaluator orders them, so its AP comes out again. ``main`` returns
the metrics.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

import numpy as np

__all__ = ["make_parser", "main", "find_prediction"]


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("eas_snn_tpu_torch prophesee folder eval")
    p.add_argument("--gt", required=True,
                   help="folder of <stream>_bbox.npy ground-truth files")
    p.add_argument("--dt", required=True,
                   help="folder of predicted box files, one a stream")
    p.add_argument("--camera", default="gen1", choices=["gen1", "gen4"])
    p.add_argument("--downsampled-by-2", action="store_true",
                   help="frames downsampled by 2 (RVT): the box filters' "
                        "minima halve")
    return p


def find_prediction(dt_dir: str, stream: str) -> str:
    for name in (f"{stream}.npy", f"{stream}_bbox.npy"):
        path = os.path.join(dt_dir, name)
        if os.path.exists(path):
            return path
    cands = sorted(glob.glob(os.path.join(dt_dir, glob.escape(stream)
                                          + "*.npy")))
    if not cands:
        raise FileNotFoundError(f"no prediction file for {stream} in "
                                f"{dt_dir}")
    return cands[0]


def _by_time(boxes: np.ndarray) -> np.ndarray:
    return boxes[np.argsort(boxes["t"], kind="stable")]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from ..data.psee_io import load_bboxes
    from ..evaluators import evaluate_lists

    args = make_parser().parse_args(argv)
    gt_files = sorted(glob.glob(os.path.join(args.gt, "*_bbox.npy")))
    if not gt_files:
        raise SystemExit(f"no *_bbox.npy files under {args.gt}")
    gt_list, dt_list = [], []
    for g in gt_files:
        stream = os.path.basename(g)[:-len("_bbox.npy")]
        gt_list.append(_by_time(load_bboxes(g)))
        dt_list.append(_by_time(load_bboxes(find_prediction(args.dt,
                                                            stream))))
    out = evaluate_lists(dt_list, gt_list, camera=args.camera,
                         downsampled_by_2=args.downsampled_by_2)
    for k, v in out.items():
        if not isinstance(v, dict):
            print(f"{k}: {v:.4f}")
    return out


if __name__ == "__main__":
    main()
