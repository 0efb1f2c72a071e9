"""The benchmark's one traffic generator: driving scenes made on the
device from a seed and the parameters of a traffic file.

A scene is ``sequences`` camera + LiDAR sequences of ``frames`` frames.
Each sequence holds a fixed number of cars at once (``cars``, one entry
a sequence, shuffled over the sequences by the seed, so every seed
makes the same amount of work); a car keeps its track for a lifetime
drawn from ``lifetime`` frames, then a new car with a new track id
takes its place.  Cars move smoothly in the camera frame (lateral and
depth speeds drawn per track, reflected at the scene's bounds) and
project to 2D boxes through bench.py's camera; a car is missed by the
detector for runs of ``dropout_frames`` frames at the rate
``dropout_share``.  The frames are uint8 noise with every visible car
painted as an 8 x 8 texture of its own, nearest car on top; the clouds
are bench.py's uniform points.  Detections fill the first slots of each
frame in a random order; ``ids`` are the cars' track ids (-1 at empty
slots).

The distributions of bench.py (frame size, 16384-point clouds, the
camera matrix) are rewritten here in torch; nothing of bench.py is
read.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

FOCAL = 720.0
KITTI_W = 1248
CAR_W, CAR_H, CAM_H = 1.8, 1.5, 1.65
CLOUD_LO = (-25.0, -3.0, 2.0, 0.0)
CLOUD_HI = (25.0, 3.0, 70.0, 1.0)
DEPTH = (8.0, 45.0)
TEX = 8


def focal(W: int) -> float:
    """bench.py's focal length, scaled to a frame W pixels wide."""
    return FOCAL * W / KITTI_W


def camera(H: int, W: int, device) -> torch.Tensor:
    """bench.py's camera matrix [3, 4] for an H x W frame."""
    f = focal(W)
    return torch.tensor([[f, 0.0, W / 2, 40.0 * f / FOCAL],
                         [0.0, f, H / 2, 1.0],
                         [0.0, 0.0, 1.0, 0.003]], device=device)


def _bounce(p0, v, t, lo, hi):
    """Position at frame t of a point starting at p0 with speed v,
    reflected at lo and hi."""
    span = hi - lo
    x = torch.remainder(p0 - lo + v * t, 2 * span)
    return lo + torch.where(x > span, 2 * span - x, x)


def make_scene(mix: dict, seed: int, slots: int, device) -> Dict:
    """Frames, clouds, boxes, det_mask, ids and the camera of one scene
    (see the module docstring), every tensor on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    S, F = mix["sequences"], mix["frames"]
    H, W, M = mix["height"], mix["width"], mix["cloud_points"]
    cars = torch.tensor(mix["cars"], device=device)
    if len(cars) != S or int(cars.max()) > slots:
        raise ValueError(f"cars {mix['cars']}: one count a sequence, at "
                         f"most {slots}")
    A = int(cars.max())
    cars = cars[torch.randperm(S, generator=gen, device=device)]

    def u(shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)

    # Track segments of every car slot: lifetimes, a random phase.
    lmin, lmax = mix["lifetime"]
    G = F // lmin + lmax // lmin + 2
    life = torch.randint(lmin, lmax + 1, (S, A, G), generator=gen,
                         device=device)
    ends = torch.cumsum(life, -1) - (u((S, A, 1)) * life[..., :1]).long()
    t = torch.arange(F, device=device)
    seg = torch.searchsorted(ends, t.expand(S, A, F).contiguous(),
                             right=True)                      # [S, A, F]
    track = (torch.arange(S * A, device=device).reshape(S, A, 1) * G + seg)
    n_tracks = S * A * G
    start = torch.where(seg > 0, torch.gather(
        ends, 2, (seg - 1).clamp_min(0)), torch.zeros_like(seg))
    age = (t - start).float()

    # Per-track motion in the camera frame and texture.
    z0 = u((n_tracks,), *DEPTH)
    x0 = u((n_tracks,), -0.6, 0.6) * z0
    vz = u((n_tracks,), -0.3, 0.3)
    vx = u((n_tracks,), -0.05, 0.05)
    tex = torch.randint(0, 256, (n_tracks, TEX, TEX, 3), generator=gen,
                        device=device, dtype=torch.uint8)
    z = _bounce(z0[track], vz[track], age, *DEPTH)
    x = _bounce(x0[track] / z0[track], vx[track] / DEPTH[0], age, -0.6,
                0.6) * z
    f = focal(W)
    cu, cv = f * x / z + W / 2, f * CAM_H / z + H / 2
    bw, bh = f * CAR_W / z, f * CAR_H / z
    box = torch.stack([cu - bw / 2, cv - bh, cu + bw / 2, cv], -1)
    box[..., 0::2] = box[..., 0::2].clamp(0.0, W - 1.0)
    box[..., 1::2] = box[..., 1::2].clamp(0.0, H - 1.0)

    # Detector misses: runs of 1 or 2 frames.
    share = mix["dropout_share"]
    dmin, dmax = mix["dropout_frames"]
    rate = share / ((dmin + dmax) / 2)
    run = torch.rand((S, A, F), generator=gen, device=device) < rate
    length = torch.randint(dmin, dmax + 1, (S, A, F), generator=gen,
                           device=device)
    hidden = torch.zeros_like(run)
    for k in range(dmax):
        shifted = torch.zeros_like(run)
        shifted[..., k:] = run[..., :F - k] & (length[..., :F - k] > k)
        hidden |= shifted
    exists = torch.arange(A, device=device)[None, :, None] < cars[:, None,
                                                                 None]
    visible = exists & ~hidden                                # [S, A, F]

    # Slots: visible cars in a random order, first slots first.
    key = torch.where(visible, u((S, A, F)), torch.full((S, A, F), -1.0,
                                                          device=device))
    order = torch.argsort(key, dim=1, descending=True)[:, :min(A, slots)]
    take = torch.gather(visible, 1, order)                    # [S, k, F]
    k = order.shape[1]
    det_mask = torch.zeros((S, F, slots), dtype=torch.bool, device=device)
    det_mask[:, :, :k] = take.transpose(1, 2)
    car_of = order.transpose(1, 2)                            # [S, F, k]
    boxes = torch.zeros((S, F, slots, 4), device=device)
    boxes[:, :, :k] = torch.gather(
        box.permute(0, 2, 1, 3), 2, car_of[..., None].expand(S, F, k, 4))
    ids = torch.full((S, F, slots), -1, dtype=torch.int64, device=device)
    ids[:, :, :k] = torch.gather(track.transpose(1, 2), 2, car_of)
    ids = torch.where(det_mask, ids, torch.full_like(ids, -1))
    depth = torch.zeros((S, F, slots), device=device)
    depth[:, :, :k] = torch.gather(z.transpose(1, 2), 2, car_of)
    boxes = boxes * det_mask[..., None]

    images = _paint(gen, boxes, det_mask, ids, depth, tex, H, W, device)
    lo = torch.tensor(CLOUD_LO, device=device)
    hi = torch.tensor(CLOUD_HI, device=device)
    clouds = lo + (hi - lo) * torch.rand((S, F, M, 4), generator=gen,
                                         device=device)
    return {"images": images, "clouds": clouds, "boxes": boxes,
            "det_mask": det_mask, "ids": ids, "cars": cars,
            "proj": camera(H, W, device)}


def _paint(gen, boxes, det_mask, ids, depth, tex, H, W, device,
           chunk: int = 64):
    """uint8 frames [S, F, H, W, 3]: noise, each visible car's texture
    stretched over its box, nearer cars over farther ones."""
    S, F, N = det_mask.shape
    images = torch.randint(0, 256, (S, F, H, W, 3), generator=gen,
                           device=device, dtype=torch.uint8)
    ys = torch.arange(H, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(W, device=device, dtype=torch.float32)[None, :]
    flat = images.view(S * F, H, W, 3)
    bx = boxes.reshape(S * F, N, 4)
    dm = det_mask.reshape(S * F, N)
    tid = ids.reshape(S * F, N).clamp_min(0)
    near = torch.where(dm, 1.0 / depth.reshape(S * F, N).clamp_min(1e-3),
                       torch.zeros_like(dm, dtype=torch.float32))
    for f0 in range(0, S * F, chunk):
        f1 = min(f0 + chunk, S * F)
        best = torch.zeros((f1 - f0, H, W), device=device)
        who = torch.full((f1 - f0, H, W), -1, dtype=torch.long,
                         device=device)
        for n in range(N):
            l, t, r, b = (bx[f0:f1, n, c, None, None] for c in range(4))
            cover = (ys >= t) & (ys < b) & (xs >= l) & (xs < r)
            pri = near[f0:f1, n, None, None]
            win = cover & (pri > best)
            best = torch.where(win, pri, best)
            who = torch.where(win, torch.full_like(who, n), who)
        painted = who >= 0
        w = who.clamp_min(0)
        b4 = torch.gather(bx[f0:f1], 1, w.reshape(f1 - f0, -1, 1)
                          .expand(-1, -1, 4)).reshape(f1 - f0, H, W, 4)
        cu = ((xs - b4[..., 0]) / (b4[..., 2] - b4[..., 0]).clamp_min(1.0)
              * TEX).long().clamp(0, TEX - 1)
        cv = ((ys - b4[..., 1]) / (b4[..., 3] - b4[..., 1]).clamp_min(1.0)
              * TEX).long().clamp(0, TEX - 1)
        track = torch.gather(tid[f0:f1], 1, w.reshape(f1 - f0, -1)).reshape(
            f1 - f0, H, W)
        colour = tex[track, cv, cu]                           # [f, H, W, 3]
        flat[f0:f1] = torch.where(painted[..., None], colour, flat[f0:f1])
    return images


def capacity_of(det_mask: torch.Tensor, window: int, chunk: int) -> int:
    """The runner's compaction capacity for windows of ``det_mask`` [S,
    F, N]: the densest window's valid detections of one sequence, in
    steps of ``chunk`` (at least one), capped at window * N."""
    S, F, N = det_mask.shape
    per = det_mask.reshape(S, F // window, window * N).sum(-1)
    dens = int(per.max())
    return min(max(chunk, -(-dens // chunk) * chunk), window * N)


def crop_window(boxes: torch.Tensor, det_mask: torch.Tensor,
                width: int) -> int:
    """The runner's crop band: at least the widest valid box, in steps of
    128, at least 256, at most the frame width."""
    widths = (boxes[..., 2] - boxes[..., 0])[det_mask]
    wmax = float(widths.max()) if widths.numel() else 0.0
    return int(min(max(256, math.ceil(wmax / 128) * 128), width))
