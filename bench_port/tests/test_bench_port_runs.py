"""Runs of tiny cells on the CPU, the look for a card skipped: the result
line holds exactly the contract's keys; the plain reference agrees with
the program at small widths; the control and each planted fault come
out not correct."""

import json
import time

import pytest
import torch

from bench_port.harness import common, entry_track, entry_train
from bench_port.harness.check_track import reference_outputs
from bench_port.tests.tiny import (INT8_LIMITS, LIMITS, TRAIN_LIMITS,
                                   track_cell, train_cell)

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def last_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_track_run_line_and_agreement(capsys, int8):
    entry_track.run(track_cell(int8), 2 ** 31 + 5, 0.2, False, "cpu",
                    time.perf_counter())
    line = last_line(capsys)
    assert list(line) == KEYS
    assert set(line["metrics"]) == {"track_fps", "setup_s"}
    assert line["correct"] and line["failed"] == 0
    assert line["attempted"] % 8 == 0 and line["attempted"] > 0


def test_train_run_line_and_agreement(capsys):
    entry_train.run(train_cell(), 17, 0.5, False, "cpu",
                    time.perf_counter())
    line = last_line(capsys)
    assert list(line) == KEYS
    assert set(line["metrics"]) == {"train_pairs_per_s", "setup_s"}
    assert line["correct"] and line["failed"] == 0


# The per-layer readers of each entry: the tracking cell's, with the int8
# trunk's roofline, and the training readers (no cell of BENCHMARK.json
# runs them now; PERF.md keeps why).
READERS = {"track": ["extract_ms.track", "affinity_roofline.track",
                     "auction_ms.track", "auction_rounds.track",
                     "idle_share.track", "mfu.track",
                     "int8_conv_roofline.track"],
           "train": ["idle_share.train", "mfu.train", "peak_mem_gib.train"]}


@pytest.mark.parametrize("entry_name", ["track", "train"])
def test_traced_line_has_breakdown(capsys, monkeypatch, entry_name):
    from bench_port.harness import trace

    def fake_profile(fn):
        fn()
        return {"window_s": 1.0, "busy_s": 0.5, "kernels": {
            "products_kernel": 0.1, "int8_conv_main_kernel": 0.2},
            "gaps": {"aten::mm": 0.5}}

    monkeypatch.setattr(trace, "profile_window", fake_profile)
    track = entry_name == "track"
    cell = track_cell(int8=True) if track else train_cell()
    cell["per_layer"] = [{"name": n, "unit": "%"}
                         for n in READERS[entry_name]]
    entry = entry_track if track else entry_train
    entry.run(cell, 3, 0.2, True, "cpu", time.perf_counter())
    line = last_line(capsys)
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["busy_s"] == 0.5
    # The allocator's peak is a card's counter: on the CPU there is none.
    assert set(line["metrics"]) == {m["name"] for m in cell["per_layer"]} \
        - {"peak_mem_gib.train"}
    assert all(0 < m["value"] for m in line["metrics"].values())


def control_readings(int8):
    tc = entry_track.TrackCell(track_cell(int8), 23, "cpu")
    tc.step(tc.warm % len(tc.windows))
    tc.free_program()
    low = tc.reference(lowp=True)
    return tc.check(outputs=lambda f, p: reference_outputs(
        low, f, p, tc.crop, tc.P))


@pytest.mark.parametrize("int8", [False, True], ids=["fp8", "int4"])
def test_track_control_is_not_correct(int8):
    ok, _ = common.judge(control_readings(int8),
                         INT8_LIMITS if int8 else LIMITS)
    assert not ok


def test_train_control_is_not_correct():
    r = entry_train.calibration_readings(train_cell(), 23, "cpu",
                                         program=False, control=True)
    ok, _ = common.judge(r["control"], TRAIN_LIMITS)
    assert not ok


def swap_ids(fn):
    """``propagate_ids`` with the ids of each frame's first two slots
    swapped where it produces them."""
    def run(*a, **kw):
        ids, ages, nxt = fn(*a, **kw)
        ids = ids.clone()
        ids[..., [0, 1]] = ids[..., [1, 0]]
        return ids, ages, nxt
    return run


def half_sequences(fn):
    """Extraction that leaves out the second half of the sequences."""
    def run(*a, **kw):
        feats, kept = fn(*a, **kw)
        S = kept.shape[0]
        feats = {k: torch.cat([v[:S // 2], torch.zeros_like(v[S // 2:])])
                 for k, v in feats.items()}
        return feats, kept
    return run


@pytest.mark.parametrize("fault", ["ids_altered", "half_left_out"])
def test_track_faults_are_not_correct(capsys, monkeypatch, fault):
    import mmmot_tpu_torch.tracker.sequence as seq

    if fault == "ids_altered":
        monkeypatch.setattr(seq, "propagate_ids", swap_ids(seq.propagate_ids))
    else:
        monkeypatch.setattr(seq, "extract_frames_batched",
                            half_sequences(seq.extract_frames_batched))
    entry_track.run(track_cell(), 29, 0.2, False, "cpu", time.perf_counter())
    assert not last_line(capsys)["correct"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out"])
def test_train_faults_are_not_correct(capsys, monkeypatch, fault):
    import mmmot_tpu_torch.train.trainer as trainer

    if fault == "state_unchanged":
        monkeypatch.setattr(trainer.OptaxChain, "step",
                            lambda self, closure=None: None)
        entry_train.run(train_cell(), 31, 0.2, False, "cpu",
                        time.perf_counter())
    else:
        with entry_train.planted("half_batch"):
            entry_train.run(train_cell(), 31, 0.2, False, "cpu",
                            time.perf_counter())
    assert not last_line(capsys)["correct"]


@pytest.mark.cuda
def test_control_on_the_card_is_not_correct(cuda):
    """The control at each cell's own size on the card (one seed; PERF.md
    keeps the readings of three and more)."""
    bench = json.loads((common.REPO / "BENCHMARK.json").read_text())
    for name in [w["name"] for w in bench["workloads"]]:
        cell = common.load_cell(name)
        entry = {"track": entry_track, "train": entry_train}[
            cell["mix"]["entry"]]
        r = entry.calibration_readings(cell, 5, cuda, program=False,
                                       control=True)
        ok, _ = common.judge(r["control"], cell["limits"])
        assert not ok, name
