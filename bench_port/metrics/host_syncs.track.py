"""Host reads of a device value a tracking window: the program's counter
``COUNTS["host_syncs"]`` (``utils/profiling.py::host_read``, the one way
the window reads a device value on the host: the auction's check every
64 rounds and its completion check) over ``COUNTS["track.windows"]``,
every window the run tracked, the warm ones included.  A program without
the counters gives nothing to read."""

SOURCE, UNIT, BETTER = "program_counter", "syncs", "lower"
LAYER, MOVES = "entry", "track_fps"


def read(ctx):
    from mmmot_tpu_torch.utils import profiling

    counts = getattr(profiling, "COUNTS", None)
    if not counts or not counts.get("track.windows"):
        return None
    return counts["host_syncs"] / counts["track.windows"]
