"""Tracking cells: ``tracker/sequence.py::track_sequences_from_frames_batched``
called window after window with the state carried, as
``tracker/kitti_runner.py`` calls it, on a scene of the cell's traffic
mix.

The measured window runs whole windows, cycling through the scene's
distinct windows, until ``--seconds`` have passed; the ids of each
window come back to the host at its end.  ``track_fps`` is every frame
of every window over the time they took.  A traced run profiles its
first window (device busy time, kernel times, idle gaps) and runs the
rest with synchronising spans around the path's stages.
"""

from __future__ import annotations

import random
import sys
import time

import torch

from bench_port.harness import common, trace
from bench_port.harness.check_track import readings
from bench_port.harness.traffic import capacity_of, crop_window, make_scene
from bench_port.harness.check_track import reference_outputs
from bench_port.reference.mmmot import (FIT_ROWS, Ref, crops_of,
                                        fit_to_traffic, frustum_points,
                                        param_shapes)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class TrackCell:
    """Set-up of a tracking cell: the scene, the weights, the program's
    module and its call, and the warm windows."""

    def __init__(self, cell: dict, seed: int, device):
        from mmmot_tpu_torch.config import config_from_dict
        from mmmot_tpu_torch.models.tracking_net import TrackingNet
        from mmmot_tpu_torch.tracker.tracker import TrackingModule

        self.cell, self.seed, self.device = cell, seed, device
        raw = cell["cfg"]["config"]
        self.mcfg = raw["model"]
        self.cfg = config_from_dict(raw)
        mix = self.mix = cell["mix"]
        self.N = self.cfg.data.max_dets
        self.T = mix["window"]
        self.crop = tuple(self.cfg.model.appearance.crop_size)
        self.P = self.cfg.model.point.point_len
        scene = make_scene(mix, seed, self.N, device)
        self.proj = scene["proj"]
        n_win = mix["frames"] // self.T
        self.capacity = capacity_of(scene["det_mask"], self.T, mix["chunk"])
        self.crop_window = crop_window(scene["boxes"], scene["det_mask"],
                                       mix["width"])
        keys = ("images", "clouds", "boxes", "det_mask")
        self.windows = []
        for w in range(n_win):
            self.windows.append({k: scene[k][:, w * self.T:(w + 1) * self.T]
                                 .contiguous() for k in keys})
        del scene
        # A deployed tracker runs one model over varying traffic: the mix
        # may fix the weights' seed, so that every run's seed changes the
        # scene and not the model (and with it the LP's difficulty).
        weight_seed = mix.get("weight_seed", seed)
        weights = common.make_weights(param_shapes(self.mcfg), weight_seed,
                                      device)
        crops, pts, pm = reference_inputs(
            self.windows[0], self.first_rows(FIT_ROWS), self.proj, self.crop,
            self.P)
        self.weights = fit_to_traffic(weights, self.mcfg, crops, pts, pm)
        net = TrackingNet(self.cfg.model, device=device)
        net.load_state_dict(self.weights, strict=True)
        self.int8 = bool(self.mcfg.get("int8_appearance"))
        if self.int8:
            from mmmot_tpu_torch.models.quantize import with_int8_appearance
            with torch.inference_mode():
                with_int8_appearance(net, self.calibration_crops())
        self.net = net
        self.module = TrackingModule(net)
        self.records = []
        # Warm windows: the first from an empty state, the rest from a
        # carried one, so that every shape and path of the window runs.
        self.state = None
        for w in range(mix["warm_windows"]):
            self.step(w % n_win)
        self.warm = len(self.records)

    def first_rows(self, k: int):
        """(sequence, frame, slot) of the first ``k`` valid detections of
        the first window, sequence by sequence, frame by frame."""
        s, t, n = self.windows[0]["det_mask"].nonzero(as_tuple=True)
        return s[:k], t[:k], n[:k]

    def calibration_rows(self):
        return self.first_rows(self.mix["calib_crops"])

    def calibration_crops(self):
        """The calibration set: the crops of ``calibration_rows``, cut
        and normalised by the benchmark (``reference/mmmot.py::
        crops_of``) and handed to the program's calibration and the
        reference's alike, as real crops are handed to
        ``with_int8_appearance``."""
        return reference_inputs(self.windows[0], self.calibration_rows(),
                                self.proj, self.crop, self.P)[0]

    def step(self, w: int):
        """Track window ``w`` from the carried state; returns the ids."""
        from mmmot_tpu_torch.assoc.auction import auction_lap
        from mmmot_tpu_torch.tracker.sequence import \
            track_sequences_from_frames_batched

        t0 = time.perf_counter()
        x = self.windows[w]
        state_in = self.state
        r0 = auction_lap.rounds
        out, self.state = track_sequences_from_frames_batched(
            self.module, x["images"], x["clouds"], x["boxes"],
            x["det_mask"], self.proj, self.crop, self.P,
            compact_capacity=self.capacity,
            extract_chunk=self.mix["chunk"], crop_window=self.crop_window,
            state0=state_in, return_state=True)
        ids = out["ids"].cpu().numpy()
        self.records.append({"w": w, "ids": ids,
                             "det_score": out["det_score"],
                             "last": dict(self.state.feats),
                             "rounds": auction_lap.rounds - r0,
                             "seconds": time.perf_counter() - t0})
        return ids

    def frames_per_window(self) -> int:
        return self.mix["sequences"] * self.T

    # ---- the per-window work the yardstick counts ----------------------
    def window_work(self, w: int) -> dict:
        """Valid crops, detections, pairs (current window's frame pairs,
        the first against the carried frame) of window ``w``."""
        dm = self.windows[w]["det_mask"]
        prev = self.windows[(w - 1) % len(self.windows)]["det_mask"][:, -1:]
        both = torch.cat([prev, dm], 1).sum(-1).double()     # [S, T + 1]
        np_, nc = both[:, :-1], both[:, 1:]
        return {"dets": float(dm.sum()),
                "pairs": float((np_ * nc).sum()),
                "pair_dets": float((np_ + nc).sum()),
                "frame_pairs": int(dm.shape[0] * dm.shape[1])}

    def free_program(self) -> None:
        """Drop the program's net and module (their memory goes back to
        the allocator) before the reference runs."""
        self.module = self.net = self.state = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # ---- correctness ----------------------------------------------------
    def check(self, outputs=None) -> dict:
        """The compared numbers over a window and sequences drawn from the
        seed; ``outputs(frames, prev)`` (default: the program's records)
        hands the outputs to judge."""
        rng = random.Random(self.seed)
        k = rng.randrange(self.warm, len(self.records))
        seqs = rng.sample(range(self.mix["sequences"]),
                          self.mix["check_sequences"])
        rec, before = self.records[k], self.records[k - 1]
        win, pwin = self.windows[rec["w"]], self.windows[before["w"]]
        ref = self.reference()
        worst: dict = {}
        for s in seqs:
            frames = {key: win[key][s] for key in win}
            frames["proj"] = self.proj
            prev = {key: pwin[key][s, -1] for key in pwin}
            prev["ids"] = before["ids"][s, -1]
            if outputs is None:
                got = {"ids": rec["ids"][s],
                       "det_score": rec["det_score"][s],
                       "last": {b: v[s] for b, v in rec["last"].items()}}
            else:
                got = outputs(frames, prev)
            r = readings(ref, frames, prev, got, self.crop, self.P)
            for key, v in r.items():
                worst[key] = max(worst.get(key, 0.0), v)
        return worst

    def reference(self, lowp: bool = False):
        """The plain reference over the cell's weights (its int8 trunk
        calibrated as the program's was, on the same detections);
        ``lowp``: the control, one precision below the configuration."""
        if not self.int8:
            return Ref(self.weights, self.mcfg, lowp=lowp)
        from bench_port.reference.int8 import RefInt8
        ref = RefInt8(self.weights, self.mcfg, lowp=lowp)
        ref.calibrate(self.calibration_crops())
        return ref

    def failed_frames(self) -> int:
        """Frames whose ids break the tracker's rules or drop a valid
        detection, over every measured window."""
        from bench_port.reference.mmmot import check_ids

        bad = 0
        for k in range(self.warm, len(self.records)):
            rec, before = self.records[k], self.records[k - 1]
            dm = self.windows[rec["w"]]["det_mask"].cpu().numpy()
            for s in range(dm.shape[0]):
                bad += int(check_ids(rec["ids"][s], dm[s],
                                     prev=before["ids"][s, -1]).sum())
        return bad


@torch.no_grad()
def reference_inputs(win: dict, rows, proj, crop, P):
    """Crops and frustum points of the detections ``rows`` (sequence,
    frame, slot) of a window, cut by the reference."""
    crops, pts, pms = [], [], []
    for s, t, n in zip(*(r.tolist() for r in rows)):
        b = win["boxes"][s, t, n][None]
        crops.append(crops_of(win["images"][s, t], b, crop))
        p, m = frustum_points(win["clouds"][s, t], b, proj, P)
        pts.append(p)
        pms.append(m)
    return torch.cat(crops), torch.cat(pts), torch.cat(pms)


def run(cell: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> None:
    tc = TrackCell(cell, seed, device)
    sync(device)
    setup_s = time.perf_counter() - t_start
    n_win = len(tc.windows)
    metrics, breakdown = {}, None
    i = tc.warm
    if not traced:
        t0 = time.perf_counter()
        while True:
            tc.step(i % n_win)
            i += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        frames = (i - tc.warm) * tc.frames_per_window()
        metrics["track_fps"] = {"value": frames / elapsed,
                                "unit": "frames/s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        metrics, breakdown, i, busy = traced_window(tc, seconds)
    failed = tc.failed_frames()
    dev = common.device_info(cell["chips"]) if torch.cuda.is_available() \
        else {"platform": "cpu", "kind": "cpu", "count": 0,
              "memory_peak_bytes": 0}
    if traced:
        dev["busy_s"], dev["window_s"] = busy
    tc.free_program()
    found = common.forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    t_ref = time.perf_counter()
    reads = tc.check()
    print(f"set-up {setup_s:.1f} s, reference {time.perf_counter() - t_ref:.1f}"
          " s, window seconds " + ", ".join(
              f"{r['seconds']:.3f}" for r in tc.records), file=sys.stderr)
    correct, checks = common.judge(reads, cell["limits"])
    correct = correct and failed == 0
    attempted = (i - tc.warm) * tc.frames_per_window()
    common.emit(correct, attempted, failed, metrics, dev, checks, breakdown,
                reads)


def traced_window(tc: TrackCell, seconds: float):
    """The traced run: one window under the profiler, then windows under
    the stage spans until ``seconds`` have passed (at least one).
    Returns (per-layer metrics, breakdown, next window index, (device
    busy seconds, profiled window seconds))."""
    import mmmot_tpu_torch.tracker.sequence as seq_mod

    n_win = len(tc.windows)
    t0 = time.perf_counter()
    w = tc.warm % n_win
    prof = trace.profile_window(lambda: tc.step(w))
    work_w = tc.window_work(w)
    i = tc.warm + 1
    stages = {"extract": (seq_mod, "extract_frames_batched"),
              "affinity": (tc.module, "affinity"),
              "auction": (seq_mod, "associate"),
              "ids": (seq_mod, "propagate_ids")}
    with trace.stage_spans(stages) as spans:
        while True:
            tc.step(i % n_win)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
    rounds = [r["rounds"] for r in tc.records[tc.warm + 1:]]
    ctx = {"profile": prof, "spans": spans, "rounds": rounds,
           "work": work_w, "mcfg": tc.mcfg, "int8": tc.int8, "slots": tc.N}
    metrics = common.read_metrics(tc.cell, ctx)
    breakdown = {"device_ops": trace.top(prof["kernels"]),
                 "idle_gaps": trace.top(prof["gaps"])}
    return metrics, breakdown, i, (prof["busy_s"], prof["window_s"])


def calibration_readings(cell: dict, seed: int, device, program: bool = True,
                         control: bool = False) -> dict:
    """The compared numbers after the set-up and one window: the
    program's, and the control's (the reference one precision below the
    configuration, in the program's place) on the same window."""
    tc = TrackCell(cell, seed, device)
    tc.step(tc.warm % len(tc.windows))
    tc.free_program()
    out = {}
    if program:
        last = tc.records[-1]
        out["program"] = dict(tc.check(), rounds=last["rounds"],
                              window_s=last["seconds"])
    if control:
        low = tc.reference(lowp=True)
        out["control"] = tc.check(outputs=lambda f, p: reference_outputs(
            low, f, p, tc.crop, tc.P))
    return out
