"""Milliseconds of association a window (``assoc/solve.py::associate``,
the batched auction over every frame pair of the window), from the
synchronising spans of a traced run's span windows."""

SOURCE, UNIT, BETTER = "program_span", "ms", "lower"
LAYER, MOVES = "association", "track_fps"


def read(ctx):
    calls = ctx["spans"].get("auction") or []
    windows = len(ctx["rounds"])
    return sum(calls) / windows if calls and windows else None
