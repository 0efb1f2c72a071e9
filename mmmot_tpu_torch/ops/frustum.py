"""Frustum point sampling: port of ``mmmot_tpu/ops/frustum.py``.

Every point is projected once; a detection keeps the points whose
projection falls inside its 2D box (depth > 0.1), up to ``num_samples`` of
them in ascending cloud order, chosen by a top-k over ``inside * (M -
index)``.  Only the selected (non-zero, unique) scores are ordered, so
indices are defined where ``sample_mask`` is True; padded samples are
zeroed whatever index they carry.
"""

from __future__ import annotations

from typing import Optional

import torch


def project_points(points_xyz, proj):
    """[..., M, 3] points, [..., 3, 4] camera matrix -> (u, v, depth).

    The product is written out per term so that it runs in plain float32
    on every device (no TF32 matmul)."""
    p = proj[..., None, :, :]                               # [..., 1, 3, 4]
    x, y, z = points_xyz[..., 0:1], points_xyz[..., 1:2], points_xyz[..., 2:3]
    cam = x * p[..., 0] + y * p[..., 1] + z * p[..., 2] + p[..., 3]
    depth = cam[..., 2]
    uv = cam[..., :2] / depth.clamp_min(1e-6)[..., None]
    return uv[..., 0], uv[..., 1], depth


def frustum_sample(points, boxes, proj, num_samples: int,
                   det_mask: Optional[torch.Tensor] = None):
    """points [B, M, C], boxes [B, N, 4], proj [3, 4] or [B, 3, 4]
    -> (sampled [B, N, P, C], sample_mask [B, N, P]).

    Each detection's xyz is centred on the centroid of its samples; the
    extra channels (reflectance) are kept as they are.
    """
    B, M, C = points.shape
    N = boxes.shape[1]
    P = num_samples
    proj = proj.expand(B, 3, 4) if proj.dim() == 2 else proj
    u, v, depth = project_points(points[..., :3], proj)     # [B, M]
    u, v, depth = u[:, None, :], v[:, None, :], depth[:, None, :]
    bx = boxes[..., None]                                   # [B, N, 4, 1]
    inside = ((u >= bx[:, :, 0]) & (u <= bx[:, :, 2]) & (v >= bx[:, :, 1])
              & (v <= bx[:, :, 3]) & (depth > 0.1))         # [B, N, M]
    if det_mask is not None:
        inside = inside & det_mask[:, :, None]
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
