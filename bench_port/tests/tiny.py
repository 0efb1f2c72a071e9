"""Tiny cells for the CPU tests: the benchmark's configurations at small
widths and shapes, with traffic mixes and limits of their own."""

from __future__ import annotations

import copy
import json

from bench_port.harness import common

# Limits of the tiny cells, from 17 seeds of each on the CPU (program's
# largest; control's smallest, 4 seeds): float32 tracking feat_err 0.028
# (0.43), det_err 0.033 (0.34), assoc_gap 0.030 (0.52); the int8 trunk
# at these widths and 16 calibration crops feat_err 0.19 (int4: 1.15);
# training loss_gap 0.012 (0.042), change_gap 0.13 (a state left
# unchanged reads 1).  The training grad_gap is not compared: on one
# seed of 18 the fusion gate's gradient reads twice the reference's
# (1.08), the port's bfloat16 crop resize against the exact crops of
# this float32 configuration, amplified on a leaf of cancelling terms.
LIMITS = {"feat_err": 0.1, "det_err": 0.05, "assoc_gap": 0.05}
INT8_LIMITS = {"feat_err": 0.5}


def tiny_config(int8: bool = False) -> dict:
    """``full_mmmot`` (or its form with the int8 trunk) at small widths,
    float32."""
    name = "full_mmmot_int8" if int8 else "full_mmmot"
    raw = json.loads((common.BENCH_DIR / "configs" / "full_mmmot.json")
                     .read_text())
    cfg = copy.deepcopy(raw["config"])
    cfg["name"] = name
    m = cfg["model"]
    m["compute_dtype"] = "float32"
    m["int8_appearance"] = int8
    m["appearance"].update(width_mult=0.125, reduction_dim=16, out_dim=32,
                           crop_size=[32, 32])
    m["point"].update(point_len=16, channels=[16, 32], out_dim=32)
    m["fusion"]["out_dim"] = 32
    m["affinity"]["hidden_dim"] = 16
    m["new_end"]["hidden_dim"] = 16
    cfg["data"].update(max_dets=8, crop_size=[32, 32], point_len=16)
    cfg["train"]["compact_capacity"] = 24
    return {"name": name, "config": cfg}


def track_mix() -> dict:
    return {"entry": "track", "sequences": 2, "window": 4, "frames": 12,
            "height": 96, "width": 320, "cloud_points": 512,
            "cars": [3, 5], "lifetime": [3, 6], "dropout_share": 0.1,
            "dropout_frames": [1, 2], "chunk": 8, "check_sequences": 2,
            "calib_crops": 16, "warm_windows": 2}


def track_cell(int8: bool = False, limits=None) -> dict:
    return {"name": "track.tiny", "chips": 1, "cfg": tiny_config(int8),
            "mix": track_mix(),
            "limits": dict(limits or (INT8_LIMITS if int8 else LIMITS)),
            "per_layer": [], "end_to_end": []}


def train_mix() -> dict:
    return {"entry": "train", "sequences": 4, "frames": 4, "height": 96,
            "width": 320, "cloud_points": 512, "cars": [2, 3, 3, 4],
            "lifetime": [3, 6], "dropout_share": 0.1,
            "dropout_frames": [1, 2], "check_steps": 3, "profile_steps": 2,
            "steps_per_epoch": 1000}


def train_cell(limits=None) -> dict:
    return {"name": "train.tiny", "chips": 1, "cfg": tiny_config(),
            "mix": train_mix(), "limits": dict(limits or TRAIN_LIMITS),
            "per_layer": [], "end_to_end": []}


TRAIN_LIMITS = {"loss_gap": 0.03, "change_gap": 0.5}
