"""Online tracking service of the port, newline-delimited JSON over stdin
and stdout: ``mmmot_tpu/cli/serve.py``'s protocol.

A long-lived process holds the model and the tracker state on the device
and answers one request per frame.

    python -m mmmot_tpu_torch.cli.serve --config full_mmmot --warmup
    python -m mmmot_tpu_torch.cli.serve --config full_mmmot --streams 4
    python -m mmmot_tpu_torch.cli.serve --exported artifacts/full_mmmot

Protocol (one JSON object per line):

  request:  {"npz": "/path/to/frame.npz"}        # arrays for one frame
            {"npz": ..., "stream": "cam0"}        # with --streams S
            {"cmd": "reset"}                      # drop all tracks
            {"cmd": "reset", "stream": "cam0"}    # one stream's (--streams)
            {"cmd": "quit"}
  response: {"ids": [...], "frame": k}            # track id per det slot
            {"ids": [...], "frame": k, "stream": "cam0"}
            {"ok": true}                          # for commands
            {"error": "..."}                      # the service keeps running

The npz carries: image [H, W, 3] uint8, cloud [M, 4] float32, boxes [n, 4]
float32, proj [3, 4] float32.  Detections are padded to the config's
``max_dets`` internally; ids align with the input order.  ``--config``
names a preset of ``mmmot_tpu_torch.config``; weights come from
``--load-path`` (a checkpoint dir of the port's trainer), ``--weights``
(flax variables as a flat numpy archive) or are random from ``--seed``;
``--exported`` serves an artifact of ``cli/export.py`` (or of the JAX
package's ``mmmot-export``) instead.  The GPU is used unless ``--cpu``
is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def parse_args(argv=None):
    from mmmot_tpu_torch.cli.track import PRESETS

    p = argparse.ArgumentParser(description="mmmot_tpu_torch tracking "
                                            "service")
    p.add_argument("--config", default=None, choices=PRESETS,
                   help="config preset (required unless --exported)")
    weights = p.add_mutually_exclusive_group()
    weights.add_argument("--load-path", default=None, metavar="DIR",
                         help="checkpoint dir of the port's trainer (its "
                              "latest step)")
    weights.add_argument("--weights", default=None, metavar="NPZ",
                         help="flax variables as a flat numpy archive; "
                              "default: random weights from --seed")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--exported", default=None, metavar="DIR",
                   help="serve an artifact directory (cli/export, or the "
                        "JAX package's mmmot-export) instead of building "
                        "the model from --config; a multi-stream artifact "
                        "brings its own S and compact capacity")
    p.add_argument("--warmup", action="store_true",
                   help="run the per-frame step once at startup (on dummy "
                        "arrays of --warmup-shape; this builds the CUDA "
                        "kernel) so the first client request does not pay "
                        "for it; the ready line is printed after it")
    p.add_argument("--warmup-shape", default="384x1248x16384",
                   help="HxWxM of the warmup frame and cloud (KITTI "
                        "default)")
    p.add_argument("--streams", type=int, default=1, metavar="S",
                   help="MULTI-STREAM serving: micro-batch up to S "
                        "concurrent streams' frames into one step (one "
                        "kernel launch and one auction; per-stream "
                        "tracker state; requests carry a \"stream\" id).  "
                        "A batch flushes when S distinct streams are "
                        "pending, when a second frame arrives for a "
                        "pending stream (in-stream order is a state "
                        "dependency), or when --flush-ms elapses")
    p.add_argument("--flush-ms", type=float, default=6.0,
                   help="latency budget: max milliseconds a pending frame "
                        "waits for more streams before the batch flushes")
    p.add_argument("--compact", type=int, default=None, metavar="C",
                   help="multi-stream compact capacity: extract features "
                        "for at most C detections ACROSS the batch "
                        "(valid-first; overflow detections are dropped, "
                        "ids -1) instead of all S*N padded slots")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    return p.parse_args(argv)


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _serve_exported(args):
    """Protocol loop over an artifact: ``DeployedTracker`` for a
    ``serve_step`` one, the multi-stream loop for a ``multistream_step``
    one (its streams and compact capacity are the manifest's)."""
    from mmmot_tpu_torch.deploy import (DeployedTracker, _read_manifest,
                                        load_multistream_step)

    device = "cpu" if args.cpu else "cuda"
    if _read_manifest(args.exported).get("kind") == "multistream_step":
        prog = load_multistream_step(args.exported, device=device)
        man = prog.manifest
        _serve_multistream(
            args, lambda states, *ins: prog(prog.weights, states, *ins),
            prog.state0, man["streams"], man["max_dets"],
            (*man["image_hw"], man["cloud_points"]),
            {"config": man["config"], "exported": True,
             "platforms": man["platforms"]})
        return
    trk = DeployedTracker.load(args.exported, device=device)
    man = trk.manifest
    ready = {"ready": True, "config": man.get("config", "?"),
             "exported": True, "platforms": man.get("platforms")}
    if args.warmup:
        h, w = man["image_hw"]
        t0 = time.perf_counter()
        trk.step(np.zeros((h, w, 3), np.uint8),
                 np.zeros((man["cloud_points"], 4), np.float32),
                 np.zeros((1, 4), np.float32), np.zeros((3, 4), np.float32))
        trk.reset()
        ready["warmup_secs"] = round(time.perf_counter() - t0, 3)
    _emit(ready)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            if req.get("cmd") == "quit":
                _emit({"ok": True})
                break
            if req.get("cmd") == "reset":
                trk.reset()
                _emit({"ok": True})
                continue
            data = np.load(req["npz"])
            frame = trk.frame_idx
            ids, _scores = trk.step(data["image"], data["cloud"],
                                    data["boxes"], data["proj"])
            _emit({"frame": frame, "ids": ids})
        except Exception as e:  # noqa: BLE001 — service must keep running
            _emit({"error": f"{type(e).__name__}: {e}"})


def _serve_multistream(args, multi, state0, S: int, N: int, warmup_hwm,
                       ready: dict):
    """Micro-batched multi-stream protocol loop (``--streams S``, or a
    multi-stream artifact).

    ``multi(states, active, images, clouds, boxes, det_mask, projs)`` is
    ``deploy.py``'s multi-stream step and ``state0`` its S zero states.
    Requests carry ``"stream": <id>`` (default 0).  Pending frames from
    distinct streams batch into ONE step; a batch flushes when S streams
    are pending, when a second frame arrives for an already-pending
    stream, or when ``--flush-ms`` elapses.  Responses come in request
    order, tagged with the stream id.
    """
    import queue
    import threading

    import torch

    from mmmot_tpu_torch.deploy import _padded, _tree_map

    states = state0
    slots: dict = {}          # stream id -> slot index
    frame_idx = [0] * S

    # Reused host staging buffers; inactive slots keep stale or zero
    # content (their lanes are masked out).
    bufs = None

    def ensure_bufs(image, cloud):
        nonlocal bufs
        if bufs is None:
            bufs = {"images": np.zeros((S,) + image.shape, np.uint8),
                    "clouds": np.zeros((S, cloud.shape[0], 4), np.float32),
                    "boxes": np.zeros((S, N, 4), np.float32),
                    "det_mask": np.zeros((S, N), bool),
                    "projs": np.zeros((S, 3, 4), np.float32)}
        elif (image.shape != bufs["images"].shape[1:]
              or cloud.shape[0] != bufs["clouds"].shape[1]):
            raise ValueError(
                f"multi-stream serving batches one shape: got image "
                f"{image.shape} / cloud {cloud.shape}, the batch holds "
                f"{bufs['images'].shape[1:]} / {bufs['clouds'].shape[1:]}")

    def run(active):
        nonlocal states
        states, ids, _scores = multi(
            states, active, bufs["images"], bufs["clouds"], bufs["boxes"],
            bufs["det_mask"], bufs["projs"])
        return ids.cpu().numpy()

    pending: set = set()      # slots with a frame in the batch
    order: list = []          # request arrival order: (slot, stream, n)

    def flush():
        if not order:
            return
        active = np.zeros((S,), bool)
        active[[slot for slot, _, _ in order]] = True
        ids = run(active)
        for slot, sid, n in order:
            _emit({"stream": sid, "frame": frame_idx[slot],
                   "ids": ids[slot, :n].tolist()})
            frame_idx[slot] += 1
        pending.clear()
        order.clear()

    ready = {"ready": True, **ready, "streams": S}
    if args.warmup:
        hh, ww, mm = warmup_hwm
        ensure_bufs(np.zeros((hh, ww, 3), np.uint8),
                    np.zeros((mm, 4), np.float32))
        t0 = time.perf_counter()
        run(np.zeros((S,), bool))
        ready["warmup_secs"] = round(time.perf_counter() - t0, 3)
    _emit(ready)

    lines: queue.Queue = queue.Queue()

    def reader():
        for line in sys.stdin:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=reader, daemon=True).start()
    deadline = None
    while True:
        timeout = (None if deadline is None
                   else max(0.0, deadline - time.perf_counter()))
        try:
            line = lines.get(timeout=timeout)
        except queue.Empty:   # latency budget expired
            flush()
            deadline = None
            continue
        if line is None:
            flush()
            break
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            if req.get("cmd") == "quit":
                flush()
                _emit({"ok": True})
                break
            if req.get("cmd") == "reset":
                flush()
                deadline = None
                sid = req.get("stream")
                if sid is None:
                    states = state0
                    slots.clear()
                    frame_idx[:] = [0] * S
                elif sid in slots:
                    lane = torch.zeros((S,), dtype=torch.bool,
                                       device=state0["mask"].device)
                    lane[slots[sid]] = True
                    with torch.inference_mode():
                        states = _tree_map(
                            lambda st, fr: torch.where(lane.reshape(
                                (S,) + (1,) * (st.dim() - 1)), fr, st),
                            states, state0)
                    frame_idx[slots[sid]] = 0
                _emit({"ok": True})
                continue
            sid = req.get("stream", 0)
            if sid not in slots:
                if len(slots) >= S:
                    raise ValueError(
                        f"stream {sid!r}: all {S} stream slots in use "
                        "(raise --streams or reset)")
                slots[sid] = len(slots)
            slot = slots[sid]
            if slot in pending:
                # In-stream order is a state dependency: flush first.
                flush()
                deadline = None
            data = np.load(req["npz"])
            boxes, det_mask, n = _padded(data["boxes"], N)
            image = np.asarray(data["image"], np.uint8)
            cloud = np.asarray(data["cloud"], np.float32)
            ensure_bufs(image, cloud)
            bufs["images"][slot] = image
            bufs["clouds"][slot] = cloud
            bufs["boxes"][slot] = boxes
            bufs["det_mask"][slot] = det_mask
            bufs["projs"][slot] = np.asarray(data["proj"], np.float32)
            pending.add(slot)
            order.append((slot, sid, n))
            if len(order) == 1:
                deadline = time.perf_counter() + args.flush_ms / 1e3
            if len(pending) == S:
                flush()
                deadline = None
        except Exception as e:  # noqa: BLE001 — service must keep running
            _emit({"error": f"{type(e).__name__}: {e}"})


def _serve_single(args, cfg, module):
    """The live single-stream loop: one ``_build_step`` call a frame."""
    from mmmot_tpu_torch.deploy import (_build_step, _fresh_state, _padded,
                                        _state_to_dict)

    N = cfg.data.max_dets
    step = _build_step(module, tuple(cfg.data.crop_size), cfg.data.point_len)

    def fresh():
        return _state_to_dict(_fresh_state(module, N))

    ready = {"ready": True, "config": cfg.name}
    if args.warmup:
        h, w, m = (int(x) for x in args.warmup_shape.split("x"))
        t0 = time.perf_counter()
        _state, ids, _scores = step(
            fresh(), np.zeros((h, w, 3), np.uint8),
            np.zeros((m, 4), np.float32), np.zeros((N, 4), np.float32),
            np.zeros((N,), bool), np.zeros((3, 4), np.float32))
        ids.cpu()
        ready["warmup_secs"] = round(time.perf_counter() - t0, 3)

    track_state = None
    frame_idx = 0
    _emit(ready)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            if req.get("cmd") == "quit":
                _emit({"ok": True})
                break
            if req.get("cmd") == "reset":
                track_state = None
                frame_idx = 0
                _emit({"ok": True})
                continue
            data = np.load(req["npz"])
            boxes, det_mask, n = _padded(data["boxes"], N)
            if track_state is None:
                track_state = fresh()
            track_state, ids, _scores = step(
                track_state, np.asarray(data["image"], np.uint8),
                np.asarray(data["cloud"], np.float32), boxes, det_mask,
                np.asarray(data["proj"], np.float32))
            _emit({"frame": frame_idx, "ids": ids[:n].cpu().tolist()})
            frame_idx += 1
        except Exception as e:  # noqa: BLE001 — service must keep running
            _emit({"error": f"{type(e).__name__}: {e}"})


def main(argv=None):
    args = parse_args(argv)
    if args.exported:
        _serve_exported(args)
        return
    if not args.config:
        raise SystemExit("--config is required unless --exported is given")

    from mmmot_tpu_torch import config as presets
    from mmmot_tpu_torch.cli.track import build_module

    cfg = getattr(presets, args.config)()
    module = build_module(cfg, args.weights, args.seed,
                          "cpu" if args.cpu else "cuda", args.load_path)
    if args.streams > 1:
        from mmmot_tpu_torch.deploy import (_build_multistream_step,
                                            _stacked_state)

        N = cfg.data.max_dets
        _serve_multistream(
            args, _build_multistream_step(module, tuple(cfg.data.crop_size),
                                          cfg.data.point_len, args.compact),
            _stacked_state(module, N, args.streams), args.streams, N,
            tuple(int(x) for x in args.warmup_shape.split("x")),
            {"config": cfg.name})
    else:
        _serve_single(args, cfg, module)


if __name__ == "__main__":
    main()
