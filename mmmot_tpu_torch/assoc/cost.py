"""Exact reduction of the tracking ILP to a square assignment problem:
port of ``mmmot_tpu/assoc/cost.py`` (``build_assignment_cost``,
``decode_assignment``).

For N slots the [2N, 2N] score matrix holds the links (top left), each
prev det's own death sink (top right diagonal), each curr det's own birth
source (bottom left diagonal) and a zero filler (bottom right); every
other entry is the forbidden score ``NEG``.

With detection-confidence scores (the reference ILP's ``y_det``
variables) the LP may also reject a detection.  That folds into the same
square problem: a link earns ``link + det_prev[i] + det_curr[j]``, and
each virtual cell takes the better of its two exclusive arms,
``max(det + end, 0)`` ("end" against "reject") and ``max(det + new, 0)``;
decoding recovers the arm from the sign of ``det + end`` / ``det + new``.
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


def build_assignment_cost(link, new, end, mask_prev, mask_curr,
                          det_prev=None, det_curr=None):
    """[.., N, N] link, [.., N] new/end -> [.., 2N, 2N] scores (max).

    ``det_prev``/``det_curr`` [.., N] are optional per-detection
    confidence scores (log-odds-like) that let the LP reject detections.
    """
    N = link.shape[-1]
    dt = link.dtype
    mp, mc = mask_prev.bool(), mask_curr.bool()
    pair_ok = mp[..., :, None] & mc[..., None, :]
    eye = torch.eye(N, dtype=torch.bool, device=link.device)
    neg = torch.full((), NEG, dtype=dt, device=link.device)
    zero = torch.zeros((), dtype=dt, device=link.device)
    if det_prev is not None:
        dp = torch.where(mp, det_prev, zero).to(dt)
        dc = torch.where(mc, det_curr, zero).to(dt)
        link = link + dp[..., :, None] + dc[..., None, :]
        end = torch.maximum(end + dp, zero)
        new = torch.maximum(new + dc, zero)
    tl = torch.where(pair_ok, link, neg)
    tr = torch.where(eye, torch.where(mp, end, zero)[..., :, None], neg)
    bl = torch.where(eye, torch.where(mc, new, zero)[..., None, :], neg)
    br = torch.zeros_like(tl)
    return torch.cat([torch.cat([tl, tr], dim=-1),
                      torch.cat([bl, br], dim=-1)], dim=-2)


def decode_assignment(row_to_col, mask_prev, mask_curr, new=None, end=None,
                      det_prev=None, det_curr=None) -> Decisions:
    """A [.., 2N] perfect matching (row -> col) -> Decisions.

    With det scores, a det parked on its virtual counterpart is "end" /
    "new" only when that arm beat the reject arm (``det + end/new >= 0``);
    otherwise it is rejected (``keep`` False)."""
    N = mask_prev.shape[-1]
    mp, mc = mask_prev.bool(), mask_curr.bool()
    prev_assign = row_to_col[..., :N]
    birth_assign = row_to_col[..., N:]
    linked_prev = (prev_assign < N) & mp
    match_prev = torch.where(linked_prev, prev_assign, -1).to(torch.int32)
    is_end = mp & ~linked_prev
    cols = torch.arange(N, device=row_to_col.device)
    is_new = mc & (birth_assign == cols)
    if det_prev is not None:
        is_end = is_end & ((det_prev + end) >= 0.0)
        is_new = is_new & ((det_curr + new) >= 0.0)
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
