"""Logging on stdlib logging (the port's copy of
``eas_snn_tpu/utils/logger.py``; reference yolox/utils/logger.py:82-114):
to stderr and to ``train_log.txt`` in the run directory. In a
data-parallel run only rank 0 logs at INFO and writes the file; the other
processes log warnings and errors to stderr."""

from __future__ import annotations

import logging
import os
import sys
__all__ = ["setup_logger"]

_FMT = "%(asctime)s | %(levelname)s | %(name)s:%(lineno)d - %(message)s"
NAME = "eas_snn_tpu_torch"


def setup_logger(output_dir: str, rank: int = 0) -> logging.Logger:
    """The port's logger, its handlers replaced by stderr and, on rank 0,
    ``<output_dir>/train_log.txt`` (appended)."""
    logger = logging.getLogger(NAME)
    logger.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    logger.propagate = False
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
    logger.addHandler(sh)
    if rank != 0:
        return logger
    os.makedirs(output_dir, exist_ok=True)
    fh = logging.FileHandler(os.path.join(output_dir, "train_log.txt"))
    fh.setFormatter(logging.Formatter(_FMT))
    logger.addHandler(fh)
    return logger
