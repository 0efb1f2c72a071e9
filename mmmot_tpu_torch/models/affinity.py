"""Per-branch link scorer and link normalisation: port of
``mmmot_tpu/models/affinity.py`` (``correlation_tensor`` with ``subabs``,
``AffinityModule`` with a 2-layer head, ``normalize_link`` dual mode).

This is the unfused module path; the fused CUDA kernel
(``mmmot_tpu_torch/kernels/affinity.py``) computes the same function
without materialising the [.., N, N, D] pair tensor.
"""

from __future__ import annotations

import torch
from torch import nn

from mmmot_tpu_torch.models.layers import Dense, MaskedBatchNorm
from mmmot_tpu_torch.ops.masking import masked_softmax, pair_mask


def correlation_tensor(a, b):
    """subabs: a [.., Na, D], b [.., Nb, D] -> |a_i - b_j| [.., Na, Nb, D]."""
    return (a[..., :, None, :] - b[..., None, :, :]).abs()


class AffinityModule(nn.Module):
    """Raw link scores [.., Np, Nc], zero at invalid pairs."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.head_0 = Dense(dim, hidden, dtype)
        self.head_bn_0 = MaskedBatchNorm(hidden, dtype)
        self.head_out = Dense(hidden, 1, dtype)

    def forward(self, feat_prev, feat_curr, mask_prev, mask_curr):
        pm = pair_mask(mask_prev, mask_curr)
        x = self.head_0(correlation_tensor(feat_prev, feat_curr))
        x = torch.relu(self.head_bn_0(x))
        score = self.head_out(x)[..., 0]
        return score * pm.to(score.dtype)


def normalize_link(score, mask_prev, mask_curr):
    """Dual softmax: mean of the masked row and column softmaxes."""
    pm = pair_mask(mask_prev, mask_curr)
    row = masked_softmax(score, pm, dim=-1)
    col = masked_softmax(score, pm, dim=-2)
    return 0.5 * (row + col)
