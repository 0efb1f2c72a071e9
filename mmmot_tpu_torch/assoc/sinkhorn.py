"""Entropic Sinkhorn-LP association: port of
``mmmot_tpu/assoc/sinkhorn.py`` (``sinkhorn_lap``, ``solve_sinkhorn``).

The square assignment reduction of ``cost.py`` is solved as entropy
regularised optimal transport with unit marginals (log-domain Sinkhorn,
a fixed number of iterations), and the plan is rounded to a perfect
matching by ``greedy_matching``.  Every instance of the batch runs every
iteration; nothing is read back to the host.

The reference runs in the cost's dtype, bfloat16 at the flagship width,
so its rounding decides which entries of the plan win.  Here each step
rounds where the reference's compiled CPU program (XLA) rounds:

- the division by tau is a product with ``1 / tau`` (tau first rounded
  to the dtype, the reciprocal a float32 constant); every elementwise
  result is rounded to the dtype;
- ``logsumexp``: the max over a line, replaced by 0 where it is not
  finite; ``exp`` of the rounded differences in float32, NOT rounded
  before the sum; the sum in float32 (rounded to the dtype before the
  ``log``), taken in windows of 32 entries, each summed in order, and
  the window sums then added in order (XLA's tree reduction of lines
  longer than 32).

In float32 the same steps run without the roundings.
"""

from __future__ import annotations

import numpy as np
import torch

from mmmot_tpu_torch.assoc.cost import (Decisions, build_assignment_cost,
                                        decode_assignment)
from mmmot_tpu_torch.assoc.greedy import greedy_matching
from mmmot_tpu_torch.models.layers import ordered_sum


def sinkhorn_lap(cost, tau: float = 0.05, iters: int = 100):
    """Log-domain Sinkhorn on scores [..., M, M] (maximisation), in the
    dtype of ``cost`` (float32 or bfloat16).  Returns the dual-adjusted
    log-plan ``(cost + f_i + g_j) / tau`` in that dtype, a soft
    assignment whose argmax structure approaches the LAP optimum as tau
    goes to 0."""
    cdt = cost.dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sinkhorn_lap: dtype {cdt} not supported")
    tau_c = torch.tensor(tau, dtype=cdt).item()          # tau in the dtype
    inv = float(np.float32(1.0) / np.float32(tau_c))     # f32 constant
    if cdt == torch.float32:
        def rnd(x):
            return x
    else:
        def rnd(x):
            return x.to(cdt).float()

    c = cost.float()
    zero = torch.zeros((), device=cost.device)

    def lse_update(scaled, dim: int):
        """-tau * logsumexp(scaled, dim), ``scaled`` the rounded
        ``(cost + dual) / tau`` in float32."""
        m = scaled.amax(dim=dim, keepdim=True)
        m = rnd(torch.where(torch.isfinite(m), m, zero))
        e = torch.exp(rnd(scaled - m))
        s = rnd(ordered_sum(e, dim).abs())
        out = rnd(rnd(torch.log(s)) + m.squeeze(dim))
        return rnd(out * -tau_c)

    f = torch.zeros(cost.shape[:-1], device=cost.device)
    g = torch.zeros_like(f)
    for _ in range(iters):
        f = lse_update(rnd(rnd(c + g[..., None, :]) * inv), -1)
        g = lse_update(rnd(rnd(c + f[..., :, None]) * inv), -2)
    return (rnd(rnd(c + f[..., :, None]) + g[..., None, :]) * inv).to(cdt)


def solve_sinkhorn(link, new, end, mask_prev, mask_curr, tau: float = 0.05,
                   iters: int = 100, det_prev=None,
                   det_curr=None) -> Decisions:
    """Scores -> square reduction -> Sinkhorn plan -> greedy rounding ->
    decisions, for any leading batch shape."""
    cost = build_assignment_cost(link, new, end, mask_prev, mask_curr,
                                 det_prev=det_prev, det_curr=det_curr)
    rc = greedy_matching(sinkhorn_lap(cost, tau=tau, iters=iters))
    return decode_assignment(rc, mask_prev, mask_curr, new=new, end=end,
                             det_prev=det_prev, det_curr=det_curr)
