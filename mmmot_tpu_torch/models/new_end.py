"""v2 birth/death heads with max pooling: port of
``mmmot_tpu/models/new_end.py::NewEndHead``."""

from __future__ import annotations

import torch
from torch import nn

from mmmot_tpu_torch.models.layers import MLP2
from mmmot_tpu_torch.ops.masking import masked_max, pair_mask


class NewEndHead(nn.Module):
    """-> (new [.., Nc], end [.., Np]) logits, zero at invalid slots."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.new_mlp = MLP2(dim + 1, hidden, 1, dtype)
        self.end_mlp = MLP2(dim + 1, hidden, 1, dtype)

    def forward(self, feat_prev, feat_curr, link, mask_prev, mask_curr):
        pm = pair_mask(mask_prev, mask_curr)
        row_best = masked_max(link, pm, dim=-1)          # [.., Np]
        col_best = masked_max(link, pm, dim=-2)          # [.., Nc]
        end_in = torch.cat([feat_prev, row_best[..., None]], dim=-1)
        new_in = torch.cat([feat_curr, col_best[..., None]], dim=-1)
        new = self.new_mlp(new_in)[..., 0]
        end = self.end_mlp(end_in)[..., 0]
        return new * mask_curr.to(new.dtype), end * mask_prev.to(end.dtype)
