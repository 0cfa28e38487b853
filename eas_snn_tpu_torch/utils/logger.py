"""Logging on stdlib logging (the port's copy of
``eas_snn_tpu/utils/logger.py``; reference yolox/utils/logger.py:82-114):
to stderr and to ``train_log.txt`` in the run directory. One process:
rank 0 of 1 until the distributed slice (ROADMAP.md §1 item 10)."""

from __future__ import annotations

import logging
import os
import sys
__all__ = ["setup_logger"]

_FMT = "%(asctime)s | %(levelname)s | %(name)s:%(lineno)d - %(message)s"
NAME = "eas_snn_tpu_torch"


def setup_logger(output_dir: str) -> logging.Logger:
    """The port's logger, its handlers replaced by stderr and
    ``<output_dir>/train_log.txt`` (appended)."""
    logger = logging.getLogger(NAME)
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    logger.propagate = False
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
    logger.addHandler(sh)
    os.makedirs(output_dir, exist_ok=True)
    fh = logging.FileHandler(os.path.join(output_dir, "train_log.txt"))
    fh.setFormatter(logging.Formatter(_FMT))
    logger.addHandler(fh)
    return logger
