"""Profiling helpers: port of ``mmmot_tpu/utils/profiling.py``.

``trace(logdir)`` records the enclosed region with ``torch.profiler``
(the CPU, and CUDA when it is available) and writes a Chrome trace,
``<logdir>/trace.json`` (chrome://tracing or Perfetto);
``FpsMeter`` is the tracking frames-per-second meter.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

from mmmot_tpu_torch.utils.meters import AverageMeter


@contextlib.contextmanager
def trace(logdir: str = "traces") -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region; on exit the Chrome trace is written
    to ``<logdir>/trace.json``.  Yields the profiler (its
    ``key_averages()`` is the kernel table)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class FpsMeter:
    """Frames per second over measured calls, the first (warm-up) call
    left out.  ``measure`` synchronises the current CUDA device (when
    CUDA is in use) before it reads the clock on entry and on exit, so a
    call's queued device work counts in its own time."""

    def __init__(self):
        self._meter = AverageMeter()
        self._calls = 0

    @contextlib.contextmanager
    def measure(self, frames: int) -> Iterator[None]:
        _synchronize()
        t0 = time.perf_counter()
        yield
        _synchronize()
        dt = time.perf_counter() - t0
        self._calls += 1
        if self._calls > 1:      # the first call warms up
            self._meter.update(frames / dt)

    @property
    def fps(self) -> float:
        return self._meter.avg
