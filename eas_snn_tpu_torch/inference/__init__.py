"""Inference on event streams (the port's counterpart of
``eas_snn_tpu/inference``)."""

from .streaming import CapturedProgram, StreamingDetector

__all__ = ["CapturedProgram", "StreamingDetector"]
