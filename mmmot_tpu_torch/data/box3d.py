"""3D bounding-box utilities: port of ``mmmot_tpu/data/box3d.py``.

KITTI convention: a box is (h, w, l, x, y, z, ry) in rectified camera
coordinates, (x, y, z) the *bottom centre* of the box and ry its yaw
about the camera's Y axis.  ``box3d_corners`` and ``points_in_box3d``
take numpy arrays or torch tensors and answer in the same kind;
``iou3d`` is host-side numpy (a convex polygon clip of the footprints).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _xp(x):
    return torch if isinstance(x, torch.Tensor) else np


def box3d_corners(boxes):
    """[..., 7] (h, w, l, x, y, z, ry) -> [..., 8, 3] corner coordinates:
    4 bottom (y = y0) then 4 top (y = y0 - h), counter-clockwise from
    (+l/2, +w/2)."""
    xp = _xp(boxes)
    h, w, l = boxes[..., 0], boxes[..., 1], boxes[..., 2]
    x, y, z = boxes[..., 3], boxes[..., 4], boxes[..., 5]
    ry = boxes[..., 6]
    stack = (lambda xs: torch.stack(xs, dim=-1)) if xp is torch else (
        lambda xs: np.stack(xs, axis=-1))
    xs = stack([l / 2, l / 2, -l / 2, -l / 2] * 2)
    zs = stack([w / 2, -w / 2, -w / 2, w / 2] * 2)
    ys = stack([xp.zeros_like(h)] * 4 + [-h] * 4)
    c, s = xp.cos(ry)[..., None], xp.sin(ry)[..., None]
    rx = c * xs + s * zs
    rz = -s * xs + c * zs
    return stack([rx + x[..., None], ys + y[..., None], rz + z[..., None]])


def points_in_box3d(points, box):
    """points [M, 3] (rect coordinates), box [7] -> bool [M]: the points
    rotated into the box's frame and tested against its bounds."""
    xp = _xp(points)
    h, w, l = box[0], box[1], box[2]
    cx, cy, cz, ry = box[3], box[4], box[5], box[6]
    px = points[:, 0] - cx
    py = points[:, 1] - cy
    pz = points[:, 2] - cz
    c, s = xp.cos(ry), xp.sin(ry)
    lx = c * px - s * pz
    lz = s * px + c * pz
    return ((xp.abs(lx) <= l / 2) & (xp.abs(lz) <= w / 2)
            & (py <= 0) & (py >= -h))


def _signed_area(poly) -> float:
    a = 0.0
    for i in range(len(poly)):
        x1, y1 = poly[i]
        x2, y2 = poly[(i + 1) % len(poly)]
        a += x1 * y2 - x2 * y1
    return a / 2.0


def _intersect(p, q, a, b):
    x1, y1, x2, y2 = p[0], p[1], q[0], q[1]
    x3, y3, x4, y4 = a[0], a[1], b[0], b[1]
    den = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)
    if abs(den) < 1e-12:
        return q
    tt = ((x1 - x3) * (y3 - y4) - (y1 - y3) * (x3 - x4)) / den
    return (x1 + tt * (x2 - x1), y1 + tt * (y2 - y1))


def _polygon_clip(subject, clip):
    """Sutherland-Hodgman clip of convex polygons (lists of (x, y)); the
    clip polygon is turned counter-clockwise first (the half-plane test
    assumes it; box footprints come out clockwise)."""
    if _signed_area(clip) < 0:
        clip = list(reversed(clip))
    out = list(subject)
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        edge = (b[0] - a[0], b[1] - a[1])

        def inside(p):
            return edge[0] * (p[1] - a[1]) - edge[1] * (p[0] - a[0]) >= 0

        inp, out = out, []
        if not inp:
            break
        prev = inp[-1]
        for cur in inp:
            if inside(cur):
                if not inside(prev):
                    out.append(_intersect(prev, cur, a, b))
                out.append(cur)
            elif inside(prev):
                out.append(_intersect(prev, cur, a, b))
            prev = cur
    return out


def _poly_area(poly) -> float:
    return abs(_signed_area(poly)) if len(poly) >= 3 else 0.0


def iou3d(box_a: np.ndarray, box_b: np.ndarray) -> Tuple[float, float]:
    """Exact (IoU3D, BEV IoU) of two KITTI boxes [7], on the host: the
    rotated footprints' overlap by convex polygon clipping, the height
    overlap along Y."""
    ca = box3d_corners(np.asarray(box_a, float))
    cb = box3d_corners(np.asarray(box_b, float))
    pa = [(float(x), float(z)) for x, z in zip(ca[:4, 0], ca[:4, 2])]
    pb = [(float(x), float(z)) for x, z in zip(cb[:4, 0], cb[:4, 2])]
    inter2d = _poly_area(_polygon_clip(pa, pb))
    area_a = float(box_a[1]) * float(box_a[2])
    area_b = float(box_b[1]) * float(box_b[2])
    iou_bev = inter2d / max(area_a + area_b - inter2d, 1e-9)
    ymax = min(float(box_a[4]), float(box_b[4]))
    ymin = max(float(box_a[4]) - float(box_a[0]),
               float(box_b[4]) - float(box_b[0]))
    inter3d = inter2d * max(0.0, ymax - ymin)
    vol_a = area_a * float(box_a[0])
    vol_b = area_b * float(box_b[0])
    return inter3d / max(vol_a + vol_b - inter3d, 1e-9), iou_bev
