"""Per-branch link scorer, its message-passing refinement, the learned
motion term and link normalisation: port of
``mmmot_tpu/models/affinity.py`` (``correlation_tensor`` with the ops
``mul``, ``subabs``, ``diff`` and ``cosine``, ``GNNRefine``,
``MotionScore``, ``AffinityModule`` with ``num_layers - 1`` hidden
layers, ``normalize_link`` in its three modes).

This is the unfused module path; the fused CUDA kernel
(``mmmot_tpu_torch/kernels/affinity.py``) computes the same function
without materialising the [.., N, N, D] pair tensor.
"""

from __future__ import annotations

import torch
from torch import nn

from mmmot_tpu_torch.models.layers import Dense, MaskedBatchNorm, ordered_sum
from mmmot_tpu_torch.ops.boxes import MOTION_FEATURE_DIM, pair_motion_features
from mmmot_tpu_torch.ops.masking import masked_softmax, pair_mask

CORRELATION_OPS = ("mul", "subabs", "diff", "cosine")
COSINE_EPS = 1e-8


def unit_rows(x):
    """``x * rsqrt(sum(x * x) + 1e-8)`` over the last axis, in the dtype
    of ``x``, rounded where the reference's compiled program rounds: the
    squares stay float32 and are summed in its order (``ordered_sum``),
    the sum is rounded to the dtype, the epsilon added (itself rounded
    to the dtype) and rounded, ``rsqrt`` rounded, the product rounded.
    In float32 none of these rounds.  ``rsqrt`` is ``1 / sqrt``, two
    correctly rounded float32 operations, as the CUDA kernel takes it:
    ``torch.rsqrt`` on the CPU is off by an ulp in about one value of
    three."""
    dt = x.dtype
    xf = x.float()
    s = ordered_sum(xf * xf, -1)
    eps = torch.tensor(COSINE_EPS, dtype=dt).float()
    t = (s.to(dt).float() + eps).to(dt).float()
    r = (1.0 / torch.sqrt(t)).to(dt).float()
    return (xf * r[..., None]).to(dt)


def correlation_tensor(a, b, ops=("subabs",)):
    """Pairwise interaction features: a [.., Na, D], b [.., Nb, D] ->
    [.., Na, Nb, len(ops) * D], one D-wide block an op in ``ops`` order:
    ``mul`` a_i * b_j, ``subabs`` |a_i - b_j|, ``diff`` a_i - b_j,
    ``cosine`` the product of the unit rows (``unit_rows``), each in the
    dtype of the inputs."""
    ai, bj = a[..., :, None, :], b[..., None, :, :]
    outs = []
    for op in ops:
        if op == "mul":
            outs.append(ai * bj)
        elif op == "subabs":
            outs.append((ai - bj).abs())
        elif op == "diff":
            outs.append(ai - bj)
        elif op == "cosine":
            outs.append(unit_rows(a)[..., :, None, :]
                        * unit_rows(b)[..., None, :, :])
        else:
            raise ValueError(f"unknown correlation op {op!r}")
    return torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]


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
    ``gnn_rounds`` rounds of ``GNNRefine`` (submodules ``gnn_{r}``): the
    correlation ``ops``, then ``num_layers - 1`` x (``head_{i}``,
    ``head_bn_{i}``, ReLU) and ``head_out``.  In train mode the heads'
    BatchNorms count the valid pairs only."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype,
                 gnn_rounds: int = 0, ops=("subabs",), num_layers: int = 2):
        super().__init__()
        for r in range(gnn_rounds):
            self.add_module(f"gnn_{r}", GNNRefine(dim, dtype))
        self.gnn_rounds = gnn_rounds
        self.ops = tuple(ops)
        self.n_hidden = num_layers - 1
        width = len(self.ops) * dim
        for i in range(self.n_hidden):
            self.add_module(f"head_{i}", Dense(width, hidden, dtype))
            self.add_module(f"head_bn_{i}", MaskedBatchNorm(hidden, dtype))
            width = hidden
        self.head_out = Dense(width, 1, dtype)

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
        x = correlation_tensor(feat_prev, feat_curr, self.ops)
        for i in range(self.n_hidden):
            x = getattr(self, f"head_{i}")(x)
            x = torch.relu(getattr(self, f"head_bn_{i}")(x, pm))
        score = self.head_out(x)[..., 0]
        return score * pm.to(score.dtype)


def normalize_link(score, mask_prev, mask_curr, mode: str = "dual"):
    """The link's normalisation: ``dual`` the mean of the masked row and
    column softmaxes, ``single`` the row softmax, ``none`` the masked
    link itself."""
    pm = pair_mask(mask_prev, mask_curr)
    if mode == "none":
        return score * pm.to(score.dtype)
    row = masked_softmax(score, pm, dim=-1)
    if mode == "single":
        return row
    col = masked_softmax(score, pm, dim=-2)
    return 0.5 * (row + col)
