"""``metrics/host_syncs.track.py``: the program's host-sync counter a
tracking window, on synthetic counts, on a program without the counters,
and in the traced line of a tiny tracking cell."""

import collections
import importlib.util
import json
import time

from bench_port.harness import common, entry_track, trace
from bench_port.tests.tiny import track_cell


def reader():
    path = common.BENCH_DIR / "metrics" / "host_syncs.track.py"
    spec = importlib.util.spec_from_file_location("host_syncs_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reads_syncs_a_window(monkeypatch):
    from mmmot_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "COUNTS", collections.Counter(
        {"host_syncs": 70, "track.windows": 2, "other": 5}))
    assert reader().read({}) == 35.0


def test_nothing_to_read_without_the_counters(monkeypatch):
    from mmmot_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "COUNTS", collections.Counter())
    assert reader().read({}) is None
    monkeypatch.delattr(profiling, "COUNTS")
    assert reader().read({}) is None


def test_traced_line_counts_the_auction_checks(capsys, monkeypatch):
    from mmmot_tpu_torch.assoc.auction import SYNC_EVERY, auction_lap
    from mmmot_tpu_torch.utils import profiling

    def fake_profile(fn):
        fn()
        return {"window_s": 1.0, "busy_s": 0.5, "kernels": {},
                "gaps": {"aten::mm": 0.5}}

    monkeypatch.setattr(trace, "profile_window", fake_profile)
    monkeypatch.setattr(profiling, "COUNTS", collections.Counter())
    r0 = auction_lap.rounds
    cell = track_cell()
    cell["per_layer"] = [{"name": "host_syncs.track", "unit": "syncs"}]
    entry_track.run(cell, 3, 0.2, True, "cpu", time.perf_counter())
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    windows = profiling.COUNTS["track.windows"]
    rounds = auction_lap.rounds - r0
    # One check every SYNC_EVERY rounds, one before the first round and
    # one for the completion: a window's rounds are a multiple of it.
    assert windows >= 3 and rounds % SYNC_EVERY == 0
    assert profiling.COUNTS["host_syncs"] == rounds // SYNC_EVERY + 2 * windows
    got = line["metrics"]["host_syncs.track"]
    assert got == {"value": profiling.COUNTS["host_syncs"] / windows,
                   "unit": "syncs"}
