"""Profiling helpers: port of ``mmmot_tpu/utils/profiling.py``, and the
port's tracer.

The tracer records spans and counts inside the program.  ``span(name)``
opens a span (name, start, end, the enclosing span, the window); a span
opened with no span open starts a window, the id shared by every span
inside it (one ``track_sequences_from_frames_batched`` call is one
window).  Spans are recorded only while ``enable(True)`` holds; off,
``span`` returns one shared null context after one flag test.  Times are
``time.perf_counter_ns()``; each window also keeps the offset from that
clock to ``time.time_ns()``, the Unix-epoch clock ``torch.profiler``
stamps its events on, so that ``epoch`` places spans on a profiler's
timeline.  ``COUNTS`` counts whether tracing is on or off;
``host_syncs`` counts every read of a device value by the host
(``host_read``).  The tracer is one per process and assumes one tracking
thread.

``trace(logdir)`` records the enclosed region with ``torch.profiler``
(the CPU, and CUDA when it is available) and the tracer, and writes a
Chrome trace, ``<logdir>/trace.json`` (chrome://tracing or Perfetto),
the spans on its clock, ``<logdir>/spans.jsonl``, and the region's
counts, ``<logdir>/counters.json``.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import time
from typing import Dict, Iterator, List, Tuple

import torch

Span = collections.namedtuple("Span", "name start_ns end_ns parent window")

COUNTS: collections.Counter = collections.Counter()

_on = False
_null = contextlib.nullcontext()
_records: List[list] = []     # [name, start_ns, end_ns, parent, window]
_open: List[int] = []         # indices of the open spans, innermost last
_offsets: Dict[int, int] = {}     # window -> time_ns - perf_counter_ns
_windows = 0


class _Span:
    __slots__ = ("name", "index")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _windows
        if _open:
            parent = _open[-1]
            window = _records[parent][4]
        else:
            parent, window = -1, _windows
            _windows += 1
            _offsets[window] = time.time_ns() - time.perf_counter_ns()
        self.index = len(_records)
        _records.append([self.name, time.perf_counter_ns(), None, parent,
                         window])
        _open.append(self.index)
        return self

    def __exit__(self, *exc):
        _records[self.index][2] = time.perf_counter_ns()
        _open.pop()
        return False


def span(name: str):
    """A span around the enclosed code while tracing is on; the shared
    null context while it is off."""
    if not _on:
        return _null
    return _Span(name)


def spanned(name: str):
    """Decorator: the function runs in a span ``name`` while tracing is
    on."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def count(name: str, n: int = 1) -> None:
    COUNTS[name] += n


def host_read(t: torch.Tensor, name: str) -> bool:
    """``bool(t)``: the one way the tracking window reads a device value
    on the host.  Counts ``COUNTS["host_syncs"]``, runs in a span
    ``name`` while tracing is on, and lifts CUDA's sync debug mode
    (``torch.cuda.set_sync_debug_mode``) around its own read, so that
    the mode flags every other sync."""
    COUNTS["host_syncs"] += 1
    with span(name):
        mode = torch.cuda.get_sync_debug_mode() if t.is_cuda else 0
        if not mode:
            return bool(t)
        torch.cuda.set_sync_debug_mode(0)
        try:
            return bool(t)
        finally:
            torch.cuda.set_sync_debug_mode(mode)


def enable(on: bool = True) -> None:
    global _on
    _on = bool(on)


def take() -> Tuple[List[Span], Dict[int, int]]:
    """The spans recorded since the last ``take`` or ``reset``
    (``parent`` indexes this list, -1 for a window's root) and each
    window's offset from ``perf_counter_ns`` to ``time_ns``; clears
    them.  Call it with no span open."""
    if _open:
        raise RuntimeError(f"take() inside {len(_open)} open span(s)")
    spans = [Span(*r) for r in _records]
    offsets = dict(_offsets)
    _records.clear()
    _offsets.clear()
    return spans, offsets


def reset() -> None:
    """Forget the spans, open ones too, and zero the counts."""
    _open.clear()
    take()
    COUNTS.clear()


def epoch(spans: List[Span], offsets: Dict[int, int]) -> List[Span]:
    """``spans`` with their times on ``time.time_ns()``'s clock, the
    clock of ``torch.profiler``'s events: subtract the profile's
    ``kineto_results.trace_start_ns()`` and divide by 1000 to meet its
    ``FunctionEvent`` times."""
    return [s._replace(start_ns=s.start_ns + offsets[s.window],
                       end_ns=s.end_ns + offsets[s.window]) for s in spans]


@contextlib.contextmanager
def trace(logdir: str = "traces") -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region with the tracer on; on exit the Chrome
    trace is written to ``<logdir>/trace.json``, the region's spans to
    ``<logdir>/spans.jsonl`` (one ``Span`` a line, times in Unix-epoch
    ns: the Chrome trace's ``ts`` is ``(start_ns -
    baseTimeNanoseconds) / 1000``; ``parent`` is the line of the
    enclosing span, -1 for a window's root) and the region's counts to
    ``<logdir>/counters.json``.  Yields the profiler (its
    ``key_averages()`` is the kernel table)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    before, was_on, n0 = COUNTS.copy(), _on, len(_records)
    enable(True)
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        enable(was_on)
    # The region's spans only: spans recorded before it stay for take().
    spans = [Span(*r)._replace(parent=max(r[3] - n0, -1))
             for r in _records[n0:]]
    del _records[n0:]
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.jsonl"), "w") as f:
        for s in epoch(spans, _offsets):
            f.write(json.dumps(s._asdict()) + "\n")
    with open(os.path.join(logdir, "counters.json"), "w") as f:
        json.dump(dict(COUNTS - before), f, indent=1, sort_keys=True)
