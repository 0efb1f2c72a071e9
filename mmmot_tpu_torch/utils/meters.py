"""Training meters and logging helpers: port of
``mmmot_tpu/utils/meters.py`` (the reference's ``AverageMeter`` and
``create_logger``, a wall-clock ``Timer`` and a JSONL ``ScalarWriter``
that appends to one file)."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional


class AverageMeter:
    """Running average over the last ``window`` updates (0: all)."""

    def __init__(self, window: int = 0):
        self.window = window
        self.reset()

    def reset(self):
        self.vals = []
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.sum += val * n
        self.count += n
        if self.window:
            self.vals.append((val, n))
            while len(self.vals) > self.window:
                v, m = self.vals.pop(0)
                self.sum -= v * m
                self.count -= m

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class Timer:
    """Wall-clock meter (data time, batch time): ``toc`` returns the
    seconds since the last ``tic`` or ``toc`` and adds them to a running
    average over the last 100."""

    def __init__(self):
        self.meter = AverageMeter(window=100)
        self._t = time.perf_counter()

    def tic(self):
        self._t = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self._t
        self.meter.update(dt)
        self._t = time.perf_counter()
        return dt


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


class ScalarWriter:
    """Append-only JSONL scalar log at ``path``: one ``{"step", "tag",
    "value", "wall"}`` object a line (the trainer's own sink is
    ``utils/scalars.py``, one file a log directory)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def write(self, step: int, scalars: Dict[str, float]):
        wall = time.time()
        for tag, value in scalars.items():
            self._f.write(json.dumps(
                {"step": step, "tag": tag, "value": float(value),
                 "wall": wall}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
