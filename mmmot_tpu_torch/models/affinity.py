"""Per-branch link scorer, its message-passing refinement, the learned
motion term and link normalisation: port of
``mmmot_tpu/models/affinity.py`` (``correlation_tensor`` with ``subabs``,
``GNNRefine``, ``MotionScore``, ``AffinityModule`` with a 2-layer head,
``normalize_link`` dual mode).

This is the unfused module path; the fused CUDA kernel
(``mmmot_tpu_torch/kernels/affinity.py``) computes the same function
without materialising the [.., N, N, D] pair tensor.
"""

from __future__ import annotations

import torch
from torch import nn

from mmmot_tpu_torch.models.layers import Dense, MaskedBatchNorm
from mmmot_tpu_torch.ops.boxes import MOTION_FEATURE_DIM, pair_motion_features
from mmmot_tpu_torch.ops.masking import masked_softmax, pair_mask


def correlation_tensor(a, b):
    """subabs: a [.., Na, D], b [.., Nb, D] -> |a_i - b_j| [.., Na, Nb, D]."""
    return (a[..., :, None, :] - b[..., None, :, :]).abs()


class GNNRefine(nn.Module):
    """One round of message passing across the two frames: each detection
    attends (scaled dot product, softmax over the OTHER frame's valid
    slots) to the other frame's detections and adds the projected message
    to its embedding; invalid slots come out zero.  Both sides update
    from the round's inputs.  Every Dense and product runs in the compute
    dtype, and the scale 1/sqrt(dim) is rounded to it, as in the
    reference."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.q, self.k, self.v, self.o = (Dense(dim, dim, dtype)
                                          for _ in range(4))
        root = torch.tensor(float(dim)).sqrt().to(dtype)
        self.scale = float((1.0 / root.float()).to(dtype))

    def hop(self, x, y, mask_y, valid_x):
        att = torch.matmul(self.q(x), self.k(y).transpose(-1, -2)) * self.scale
        w = masked_softmax(att, mask_y[..., None, :], dim=-1)
        out = x + self.o(torch.matmul(w, self.v(y)))
        return out * valid_x[..., None].to(out.dtype)

    def forward(self, feat_a, feat_b, mask_a, mask_b):
        return (self.hop(feat_a, feat_b, mask_b, mask_a),
                self.hop(feat_b, feat_a, mask_a, mask_b))


class MotionScore(nn.Module):
    """The learned motion term [.., Np, Nc] float32: Dense 6 -> hidden,
    ReLU, Dense -> 1 over ``pair_motion_features`` of the two frames'
    boxes, zero at invalid pairs.  Float32 throughout, whatever the
    compute dtype (the reference's choice: boxes are pixel coordinates)."""

    def __init__(self, hidden: int):
        super().__init__()
        self.dense_0 = Dense(MOTION_FEATURE_DIM, hidden, torch.float32)
        self.dense_1 = Dense(hidden, 1, torch.float32)

    def forward(self, box_prev, box_curr, mask_prev, mask_curr):
        g = pair_motion_features(box_prev, box_curr)
        s = self.dense_1(torch.relu(self.dense_0(g)))[..., 0]
        return s * pair_mask(mask_prev, mask_curr).float()


class AffinityModule(nn.Module):
    """Raw link scores [.., Np, Nc], zero at invalid pairs, after
    ``gnn_rounds`` rounds of ``GNNRefine`` (submodules ``gnn_{r}``).  In
    train mode the head's BatchNorm counts the valid pairs only."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype,
                 gnn_rounds: int = 0):
        super().__init__()
        for r in range(gnn_rounds):
            self.add_module(f"gnn_{r}", GNNRefine(dim, dtype))
        self.gnn_rounds = gnn_rounds
        self.head_0 = Dense(dim, hidden, dtype)
        self.head_bn_0 = MaskedBatchNorm(hidden, dtype)
        self.head_out = Dense(hidden, 1, dtype)

    def refine(self, feat_prev, feat_curr, mask_prev, mask_curr):
        """The message-passing rounds alone: refined (prev, curr)."""
        for r in range(self.gnn_rounds):
            feat_prev, feat_curr = getattr(self, f"gnn_{r}")(
                feat_prev, feat_curr, mask_prev, mask_curr)
        return feat_prev, feat_curr

    def forward(self, feat_prev, feat_curr, mask_prev, mask_curr):
        feat_prev, feat_curr = self.refine(feat_prev, feat_curr, mask_prev,
                                           mask_curr)
        pm = pair_mask(mask_prev, mask_curr)
        x = self.head_0(correlation_tensor(feat_prev, feat_curr))
        x = torch.relu(self.head_bn_0(x, pm))
        score = self.head_out(x)[..., 0]
        return score * pm.to(score.dtype)


def normalize_link(score, mask_prev, mask_curr):
    """Dual softmax: mean of the masked row and column softmaxes."""
    pm = pair_mask(mask_prev, mask_curr)
    row = masked_softmax(score, pm, dim=-1)
    col = masked_softmax(score, pm, dim=-2)
    return 0.5 * (row + col)
