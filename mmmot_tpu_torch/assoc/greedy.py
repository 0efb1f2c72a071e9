"""Greedy matching: port of ``mmmot_tpu/assoc/greedy.py``
(``greedy_matching``, ``solve_greedy``).

M rounds, each taking the best remaining (row, column) score of every
instance at once and retiring that row and column: the cheap baseline
solver and the rounding stage of the Sinkhorn plan.  The first maximal
flat index wins a tie, as ``jnp.argmax`` (and ``torch.argmax``) pick it.
No round reads anything back to the host.
"""

from __future__ import annotations

import torch

from mmmot_tpu_torch.assoc.auction import build_gain_matrix, decode_matching
from mmmot_tpu_torch.assoc.cost import Decisions

BIG_NEG = -1e9      # the score of a retired row or column


def greedy_matching(score):
    """Greedy perfect matching of [..., M, M] scores -> row_to_col int32
    [..., M]."""
    lead, M = score.shape[:-2], score.shape[-1]
    flat = score.reshape(-1, M, M)
    n = flat.shape[0]
    dev = score.device
    ar = torch.arange(M, device=dev)
    row_used = torch.zeros((n, M), dtype=torch.bool, device=dev)
    col_used = torch.zeros_like(row_used)
    assign = torch.full((n, M), -1, dtype=torch.int32, device=dev)
    big = torch.full((), BIG_NEG, dtype=score.dtype, device=dev)
    for _ in range(M):
        masked = torch.where(row_used[:, :, None] | col_used[:, None, :],
                             big, flat)
        idx = masked.reshape(n, M * M).argmax(dim=1)
        i, j = (idx // M)[:, None], (idx % M)[:, None]
        assign = torch.where(ar == i, j.to(torch.int32), assign)
        row_used = row_used | (ar == i)
        col_used = col_used | (ar == j)
    return assign.reshape(*lead, M)


def solve_greedy(link, new, end, mask_prev, mask_curr, det_prev=None,
                 det_curr=None) -> Decisions:
    """Greedy on the gain matrix (``build_gain_matrix``): a pair is kept
    while its gain is positive (else the outside option end + new is
    better)."""
    gain = build_gain_matrix(link, new, end, mask_prev, mask_curr,
                             det_prev=det_prev, det_curr=det_curr)
    rc = greedy_matching(gain)
    picked = torch.gather(gain, -1, rc.clamp_min(0).long()[..., None])[..., 0]
    rc = torch.where((rc >= 0) & (picked > 0.0), rc, -1)
    return decode_matching(rc, mask_prev, mask_curr, new=new, end=end,
                           det_prev=det_prev, det_curr=det_curr)
