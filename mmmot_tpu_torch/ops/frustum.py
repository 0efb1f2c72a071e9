"""Frustum and 3D-box point sampling: port of ``mmmot_tpu/ops/frustum.py``
(``frustum_sample``, ``box3d_sample`` and their batched forms).

Every point is projected once; a detection keeps the points whose
projection falls inside its 2D box (depth > 0.1), or, with
``box3d_sample``, the points inside its KITTI 3D box, up to
``num_samples`` of them in ascending cloud order, chosen by a top-k over
``inside * (M - index)``.  Only the selected (non-zero, unique) scores
are ordered, so indices are defined where ``sample_mask`` is True;
padded samples are zeroed whatever index they carry.
"""

from __future__ import annotations

from typing import Optional

import torch


def project_points(points_xyz, proj):
    """[..., M, 3] points, [..., 3, 4] camera matrix -> (u, v, depth).

    The product is written out per term so that it runs in plain float32
    on every device (no TF32 matmul), and summed pairwise,
    ``(x p0 + y p1) + (z p2 + p3)``, as the reference's ``hom @ proj.T``
    rounds it: another order moves ``u`` or ``v`` by an ulp in about half
    of the points, which flips points on a box edge in or out."""
    p = proj[..., None, :, :]                               # [..., 1, 3, 4]
    x, y, z = points_xyz[..., 0:1], points_xyz[..., 1:2], points_xyz[..., 2:3]
    cam = (x * p[..., 0] + y * p[..., 1]) + (z * p[..., 2] + p[..., 3])
    depth = cam[..., 2]
    uv = cam[..., :2] / depth.clamp_min(1e-6)[..., None]
    return uv[..., 0], uv[..., 1], depth


def _select(points, inside, num_samples: int):
    """Up to ``num_samples`` points of each row of ``inside`` [B, N, M]
    in ascending cloud order, from ``points`` [B, M, C] ->
    (sampled [B, N, P, C] with each detection's xyz centred on the
    centroid of its samples, the extra channels as they are;
    sample_mask [B, N, P])."""
    B, M, _ = points.shape
    P = num_samples
    rank = torch.arange(M, 0, -1, dtype=torch.int32, device=points.device)
    score = torch.where(inside, rank, torch.zeros((), dtype=torch.int32,
                                                  device=points.device))
    k = min(P, M)
    top_scores, top_idx = torch.topk(score, k, dim=-1, sorted=True)
    if k < P:
        pad = (0, P - k)
        top_scores = torch.nn.functional.pad(top_scores, pad)
        top_idx = torch.nn.functional.pad(top_idx, pad)
    sample_mask = top_scores > 0
    batch = torch.arange(B, device=points.device)[:, None, None]
    m = sample_mask[..., None].to(points.dtype)
    sampled = points[batch, top_idx] * m
    cnt = sample_mask.sum(-1, keepdim=True).clamp_min(1).to(points.dtype)
    centroid = (sampled[..., :3] * m).sum(-2, keepdim=True) / cnt[..., None]
    xyz = (sampled[..., :3] - centroid) * m
    return torch.cat([xyz, sampled[..., 3:]], dim=-1), sample_mask


def _valid(inside, det_mask, point_valid):
    if point_valid is not None:
        inside = inside & point_valid[:, None, :]
    if det_mask is not None:
        inside = inside & det_mask[:, :, None]
    return inside


def frustum_sample(points, boxes, proj, num_samples: int,
                   det_mask: Optional[torch.Tensor] = None,
                   point_valid: Optional[torch.Tensor] = None):
    """points [B, M, C], boxes [B, N, 4], proj [3, 4] or [B, 3, 4]
    -> (sampled [B, N, P, C], sample_mask [B, N, P]).

    ``point_valid`` [B, M] masks padded cloud entries: they never count
    as inside.
    Each detection's xyz is centred on the centroid of its samples; the
    extra channels (reflectance) are kept as they are.
    """
    B = points.shape[0]
    proj = proj.expand(B, 3, 4) if proj.dim() == 2 else proj
    u, v, depth = project_points(points[..., :3], proj)     # [B, M]
    u, v, depth = u[:, None, :], v[:, None, :], depth[:, None, :]
    bx = boxes[..., None]                                   # [B, N, 4, 1]
    inside = ((u >= bx[:, :, 0]) & (u <= bx[:, :, 2]) & (v >= bx[:, :, 1])
              & (v <= bx[:, :, 3]) & (depth > 0.1))         # [B, N, M]
    return _select(points, _valid(inside, det_mask, point_valid),
                   num_samples)


def box3d_sample(points, boxes3d, num_samples: int, velo_to_rect=None,
                 det_mask: Optional[torch.Tensor] = None,
                 point_valid: Optional[torch.Tensor] = None):
    """points [B, M, C] (xyz + extra channels; in the velodyne frame with
    ``velo_to_rect`` [3, 4] or [B, 3, 4], else already rectified),
    boxes3d [B, N, 7] KITTI (h, w, l, x, y, z, ry) in rect coordinates
    -> (sampled [B, N, P, C], sample_mask [B, N, P]).

    A detection keeps the points inside its 3D box (the host's
    ``data/box3d.py::points_in_box3d``), chosen and centred as
    ``frustum_sample`` does; its samples carry rect-frame xyz when the
    points were transformed.  The transform is written out per term and
    summed pairwise, ``(x t0 + y t1) + (z t2 + t3)``, as
    ``project_points`` rounds the reference's ``hom @ T.T``."""
    B = points.shape[0]
    xyz = points[..., :3]
    if velo_to_rect is not None:
        t = velo_to_rect.expand(B, 3, 4) if velo_to_rect.dim() == 2 \
            else velo_to_rect
        t = t[:, None]                                      # [B, 1, 3, 4]
        x, y, z = xyz[..., 0:1], xyz[..., 1:2], xyz[..., 2:3]
        xyz = (x * t[..., 0] + y * t[..., 1]) + (z * t[..., 2] + t[..., 3])
        points = torch.cat([xyz, points[..., 3:]], dim=-1)
    b = boxes3d[..., None]                                  # [B, N, 7, 1]
    h, w, l = b[:, :, 0], b[:, :, 1], b[:, :, 2]
    px = xyz[:, None, :, 0] - b[:, :, 3]                    # [B, N, M]
    py = xyz[:, None, :, 1] - b[:, :, 4]
    pz = xyz[:, None, :, 2] - b[:, :, 5]
    c, s = torch.cos(b[:, :, 6]), torch.sin(b[:, :, 6])
    lx = c * px - s * pz
    lz = s * px + c * pz
    inside = ((lx.abs() <= l / 2) & (lz.abs() <= w / 2) & (py <= 0)
              & (py >= -h))
    return _select(points, _valid(inside, det_mask, point_valid),
                   num_samples)


def frustum_sample_batched(points, boxes, proj, num_samples: int,
                           det_mask: Optional[torch.Tensor] = None,
                           point_valid: Optional[torch.Tensor] = None):
    """points [..., M, C], boxes [..., N, 4], proj [3, 4] or [..., 3, 4]
    -> (sampled [..., N, P, C], sample_mask [..., N, P]):
    ``frustum_sample`` over the flattened leading axes."""
    lead = boxes.shape[:-2]
    M, C = points.shape[-2:]
    N = boxes.shape[-2]
    pf = points.reshape(-1, M, C)
    B = pf.shape[0]
    projf = proj if proj.dim() == 2 else proj.expand(lead + (3, 4)).reshape(
        B, 3, 4)
    sampled, mask = frustum_sample(
        pf, boxes.reshape(B, N, 4), projf, num_samples,
        det_mask=None if det_mask is None else det_mask.reshape(B, N),
        point_valid=None if point_valid is None else point_valid.reshape(
            B, M))
    return (sampled.reshape(lead + (N, num_samples, C)),
            mask.reshape(lead + (N, num_samples)))


def box3d_sample_batched(points, boxes3d, num_samples: int,
                         velo_to_rect=None,
                         det_mask: Optional[torch.Tensor] = None,
                         point_valid: Optional[torch.Tensor] = None):
    """points [..., M, C], boxes3d [..., N, 7], velo_to_rect [3, 4], one
    [..., 3, 4] per leading index, or None -> (sampled [..., N, P, C],
    sample_mask [..., N, P]): ``box3d_sample`` over the flattened
    leading axes."""
    lead = boxes3d.shape[:-2]
    M, C = points.shape[-2:]
    N = boxes3d.shape[-2]
    pf = points.reshape(-1, M, C)
    B = pf.shape[0]
    v2r = velo_to_rect
    if v2r is not None and v2r.dim() > 2:
        v2r = v2r.expand(lead + (3, 4)).reshape(B, 3, 4)
    sampled, mask = box3d_sample(
        pf, boxes3d.reshape(B, N, 7), num_samples, v2r,
        det_mask=None if det_mask is None else det_mask.reshape(B, N),
        point_valid=None if point_valid is None else point_valid.reshape(
            B, M))
    return (sampled.reshape(lead + (N, num_samples, C)),
            mask.reshape(lead + (N, num_samples)))
