"""The traced run's instruments: a profiler window read into device busy
time, kernel times by name and the idle gaps by what the host was
doing; and synchronising spans around the program's own stage
functions (a copy of ``chip_smoke.py::stage_timers``)."""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Tuple

import torch


def profile_window(fn: Callable[[], object]) -> dict:
    """Run ``fn`` once under ``torch.profiler`` (CPU and CUDA activity),
    synchronised at both ends.  Returns {"window_s", "busy_s" (the union
    of device kernel and copy intervals), "kernels" {name: seconds},
    "gaps" {host op: seconds of device idle under it}, "result"}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    out = read_events(prof.events())
    out.update(window_s=window, result=result)
    return out


def read_events(events) -> dict:
    """Device busy time, kernel times and idle gaps of profiler events
    (``torch.autograd`` ``FunctionEvent``s, times in microseconds)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in events:
        span = (e.time_range.start, e.time_range.end, e.name)
        (dev if e.device_type == DeviceType.CUDA else host).append(span)
    kernels: Dict[str, float] = {}
    for lo, hi, name in dev:
        kernels[name] = kernels.get(name, 0.0) + (hi - lo) * 1e-6
    busy, gaps_us = union(sorted((lo, hi) for lo, hi, _ in dev))
    return {"busy_s": busy * 1e-6, "kernels": kernels,
            "gaps": gaps_by_host(gaps_us, host)}


def union(spans: List[Tuple[float, float]]):
    """(length of the union of sorted intervals, the gaps between them)."""
    total, end, gaps = 0.0, None, []
    for lo, hi in spans:
        if end is None or lo > end:
            if end is not None:
                gaps.append((end, lo))
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total, gaps


def gaps_by_host(gaps, host) -> Dict[str, float]:
    """Seconds of device idle time by the host operation that covers each
    gap's middle: the innermost one, found by a sweep that keeps the
    stack of nested host operations open at that point."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out: Dict[str, float] = {}
    stack, k = [], 0
    for lo, hi in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (lo + hi)
        while k < len(host) and host[k][0] <= mid:
            while stack and stack[-1][1] < host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        key = stack[-1][2] if stack else "(no host op)"
        out[key] = out.get(key, 0.0) + (hi - lo) * 1e-6
    return out


def top(d: Dict[str, float], n: int = 10):
    return [[k[:200], v] for k, v in sorted(d.items(),
                                            key=lambda kv: -kv[1])[:n]]


@contextlib.contextmanager
def stage_spans(stages: Dict[str, Tuple[object, str]]):
    """While open, each stage function ``getattr(obj, attr)`` runs inside
    a span that synchronises the device before and after it.  Yields
    {stage: [ms of each call]}."""
    times: Dict[str, List[float]] = {k: [] for k in stages}
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)

    def timer(name, fn):
        def run(*args, **kw):
            sync()
            t = time.perf_counter()
            r = fn(*args, **kw)
            sync()
            times[name].append((time.perf_counter() - t) * 1e3)
            return r
        return run

    saved = {k: getattr(o, a) for k, (o, a) in stages.items()}
    own = {k: a in vars(o) for k, (o, a) in stages.items()}
    for k, (o, a) in stages.items():
        setattr(o, a, timer(k, saved[k]))
    try:
        yield times
    finally:
        for k, (o, a) in stages.items():
            if own[k]:
                setattr(o, a, saved[k])
            else:
                delattr(o, a)       # a method: the class's again
