"""The trainer's logger: ``create_logger`` of
``mmmot_tpu/utils/meters.py``."""

from __future__ import annotations

import logging
import os
from typing import Optional


def create_logger(name: str, log_file: Optional[str] = None,
                  level=logging.INFO) -> logging.Logger:
    """A logger that writes to stderr (once) and, optionally, a file."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    if not logger.handlers:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
