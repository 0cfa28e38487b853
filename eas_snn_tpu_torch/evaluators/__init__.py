"""The evaluation layer of the port (counterpart of
``eas_snn_tpu/evaluators/``): COCO-protocol and Prophesee-protocol mAP
with the native matcher, VOC AP, and SOP / energy profiling.

(reference: yolox/evaluators/*, yolox/utils/psee_loader/{evaluator,
evaluation}.py, yolox/layers/*.)
"""

from .coco_map import DetEval, EvalResults, summarize
from .energy import conv_macs_per_frame, count_ops, estimate_energy
from .event_evaluator import EventEvaluator, PSEEEvaluator
from .prophesee import (PropheseeEvaluator, boxes_to_prophesee,
                        evaluate_lists, filter_boxes, match_times)
from .voc_eval import VOCDetEval, voc_ap, voc_eval_class

__all__ = [
    "VOCDetEval", "voc_ap", "voc_eval_class",
    "DetEval", "EvalResults", "summarize",
    "EventEvaluator", "PSEEEvaluator",
    "PropheseeEvaluator", "evaluate_lists", "filter_boxes", "match_times",
    "boxes_to_prophesee",
    "count_ops", "estimate_energy", "conv_macs_per_frame",
]
