"""Exact reduction of the tracking ILP to a square assignment problem:
port of ``mmmot_tpu/assoc/cost.py`` (``build_assignment_cost``,
``decode_assignment``).

For N slots the [2N, 2N] score matrix holds the links (top left), each
prev det's own death sink (top right diagonal), each curr det's own birth
source (bottom left diagonal) and a zero filler (bottom right); every
other entry is the forbidden score ``NEG``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG = -1e5  # forbidden-entry score; finite so auction prices stay NaN-free


class Decisions(NamedTuple):
    match_prev: torch.Tensor        # [.., N] curr index linked to prev i, -1
    match_curr: torch.Tensor        # [.., N] prev index linked to curr j, -1
    is_end: torch.Tensor            # [.., N] prev i's track ends
    is_new: torch.Tensor            # [.., N] curr j starts a track
    keep_prev: torch.Tensor         # [.., N] prev i linked or ended
    keep_curr: torch.Tensor         # [.., N] curr j linked or new


def build_assignment_cost(link, new, end, mask_prev, mask_curr):
    """[.., N, N] link, [.., N] new/end -> [.., 2N, 2N] scores (max)."""
    N = link.shape[-1]
    dt = link.dtype
    mp, mc = mask_prev.bool(), mask_curr.bool()
    pair_ok = mp[..., :, None] & mc[..., None, :]
    eye = torch.eye(N, dtype=torch.bool, device=link.device)
    neg = torch.tensor(NEG, dtype=dt, device=link.device)
    zero = torch.zeros((), dtype=dt, device=link.device)
    tl = torch.where(pair_ok, link, neg)
    tr = torch.where(eye, torch.where(mp, end, zero)[..., :, None], neg)
    bl = torch.where(eye, torch.where(mc, new, zero)[..., None, :], neg)
    br = torch.zeros_like(tl)
    return torch.cat([torch.cat([tl, tr], dim=-1),
                      torch.cat([bl, br], dim=-1)], dim=-2)


def decode_assignment(row_to_col, mask_prev, mask_curr) -> Decisions:
    """A [.., 2N] perfect matching (row -> col) -> Decisions."""
    N = mask_prev.shape[-1]
    mp, mc = mask_prev.bool(), mask_curr.bool()
    prev_assign = row_to_col[..., :N]
    birth_assign = row_to_col[..., N:]
    linked_prev = (prev_assign < N) & mp
    match_prev = torch.where(linked_prev, prev_assign, -1).to(torch.int32)
    is_end = mp & ~linked_prev
    cols = torch.arange(N, device=row_to_col.device)
    is_new = mc & (birth_assign == cols)
    # Invert match_prev: curr j <- prev i; unlinked rows go to column N.
    lead = match_prev.shape[:-1]
    idx = torch.where(linked_prev, match_prev, N).long().reshape(-1, N)
    src = torch.where(linked_prev, cols.to(torch.int32), -1).reshape(-1, N)
    inv = torch.full((idx.shape[0], N + 1), -1, dtype=torch.int32,
                     device=row_to_col.device)
    inv.scatter_(1, idx, src)
    match_curr = torch.where(mc, inv[:, :N].reshape(*lead, N), -1)
    keep_prev = linked_prev | is_end
    keep_curr = ((match_curr >= 0) | is_new) & mc
    return Decisions(match_prev, match_curr.to(torch.int32), is_end, is_new,
                     keep_prev, keep_curr)
