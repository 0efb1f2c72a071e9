"""Milliseconds of extraction a window (crops, frustum points and the
embeddings of every compacted row: ``tracker/sequence.py::
extract_frames_batched``), from the synchronising spans of a traced
run's span windows."""

SOURCE, UNIT, BETTER = "program_span", "ms", "lower"
LAYER, MOVES = "extraction", "track_fps"


def read(ctx):
    calls = ctx["spans"].get("extract") or []
    return sum(calls) / len(calls) if calls else None
