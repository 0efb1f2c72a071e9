"""Host-side exact solvers, the parity oracles: port of
``mmmot_tpu/assoc/ilp_oracle.py`` (``solve_lap_oracle``,
``solve_ilp_oracle``, ``solve_native_oracle``).

* ``solve_ilp_oracle``: the ILP as the reference tracker writes it
  (binary y_link / y_new / y_end, per-detection flow conservation, and
  y_det confidence variables with det scores), solved by
  ``scipy.optimize.milp`` (HiGHS): the ground truth.
* ``solve_lap_oracle``: ``scipy.optimize.linear_sum_assignment`` on the
  square reduction of ``cost.py``.
* ``solve_native_oracle``: the same reduction through the port's C++
  Hungarian solver (``csrc/lap.cpp``, built with g++ on first use and
  loaded with ctypes); it also takes a batch.

They are host solvers, as in the reference: the scores go to host numpy
(float64), and the decisions come back as tensors on the input's device.
``ilp`` and ``lap`` take one instance and raise on a batch.  scipy is
imported inside the functions that use it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mmmot_tpu_torch.assoc.cost import (Decisions, build_assignment_cost,
                                        decode_assignment)


def _host_cost(link, new, end, mask_prev, mask_curr, det_prev, det_curr):
    return build_assignment_cost(link, new, end, mask_prev, mask_curr,
                                 det_prev=det_prev, det_curr=det_curr
                                 ).double().cpu().numpy()


def _decode(rc: np.ndarray, link, new, end, mask_prev, mask_curr, det_prev,
            det_curr) -> Decisions:
    return decode_assignment(torch.as_tensor(rc, device=link.device),
                             mask_prev, mask_curr, new=new, end=end,
                             det_prev=det_prev, det_curr=det_curr)


def solve_lap_oracle(link, new, end, mask_prev, mask_curr, det_prev=None,
                     det_curr=None) -> Decisions:
    """Exact: Hungarian (Jonker-Volgenant) on the 2N x 2N reduction."""
    from scipy.optimize import linear_sum_assignment

    cost = _host_cost(link, new, end, mask_prev, mask_curr, det_prev,
                      det_curr)
    if cost.ndim != 2:
        raise ValueError("oracle solves one instance at a time")
    row, col = linear_sum_assignment(cost, maximize=True)
    rc = np.empty(cost.shape[0], np.int32)
    rc[row] = col.astype(np.int32)
    return _decode(rc, link, new, end, mask_prev, mask_curr, det_prev,
                   det_curr)


@functools.cache
def _native() -> ctypes.CDLL:
    """Build (first use in a checkout) and load ``csrc/lap.cpp``."""
    from mmmot_tpu_torch.kernels.build import build_host

    lib = ctypes.CDLL(str(build_host("lap")))
    dbl = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.lap_solve.restype = ctypes.c_double
    lib.lap_solve.argtypes = [dbl, ctypes.c_int32, i32p]
    lib.lap_solve_batch.restype = ctypes.c_int32
    lib.lap_solve_batch.argtypes = [dbl, ctypes.c_int32, ctypes.c_int32,
                                    i32p]
    return lib


def lap_solve(cost: np.ndarray, maximize: bool = False):
    """Exact assignment of a square cost matrix [n, n] or a batch
    [b, n, n] with the native solver: (row_to_col int32, objective) for
    one instance, (row_to_col [b, n], None) for a batch."""
    cost = np.ascontiguousarray(-cost if maximize else cost, np.float64)
    lib = _native()
    if cost.ndim == 2:
        n = cost.shape[0]
        out = np.empty(n, np.int32)
        obj = lib.lap_solve(cost, n, out)
        return out, (-obj if maximize else obj)
    if cost.ndim == 3:
        b, n, _ = cost.shape
        out = np.empty((b, n), np.int32)
        lib.lap_solve_batch(cost, b, n, out)
        return out, None
    raise ValueError(f"cost must be [n,n] or [b,n,n], got {cost.shape}")


def solve_native_oracle(link, new, end, mask_prev, mask_curr, det_prev=None,
                        det_curr=None) -> Decisions:
    """Exact: the native Hungarian solver on the same reduction as
    :func:`solve_lap_oracle`, for one instance or any leading batch
    shape."""
    cost = _host_cost(link, new, end, mask_prev, mask_curr, det_prev,
                      det_curr)
    M = cost.shape[-1]
    rc, _ = lap_solve(cost.reshape(-1, M, M), maximize=True)
    return _decode(rc.reshape(cost.shape[:-1]), link, new, end, mask_prev,
                   mask_curr, det_prev, det_curr)


def solve_ilp_oracle(link, new, end, mask_prev, mask_curr, det_prev=None,
                     det_curr=None) -> Decisions:
    """Exact: the reference-shaped binary ILP via ``scipy.optimize.milp``.

    Variables (valid slots only): y_link[i, j], y_end[i], y_new[j] and,
    with det scores, y_det_p[i], y_det_c[j].  Constraints:
    sum_j y_link[i, j] + y_end[i] = y_det_p[i] (or 1), and
    sum_i y_link[i, j] + y_new[j] = y_det_c[j] (or 1).  Objective:
    maximise the scores of the chosen variables.
    """
    import scipy.optimize as sopt
    import scipy.sparse as sp

    dev = link.device

    def host(x):
        return x.double().cpu().numpy()

    if link.dim() != 2:
        raise ValueError("oracle solves one instance at a time")
    lk, nw, ed = host(link), host(new), host(end)
    mp = mask_prev.bool().cpu().numpy()
    mc = mask_curr.bool().cpu().numpy()
    use_det = det_prev is not None
    if use_det:
        dp, dc = host(det_prev), host(det_curr)
    N = lk.shape[-1]
    pi, ci = np.flatnonzero(mp), np.flatnonzero(mc)
    npv, ncv = len(pi), len(ci)
    n_link = npv * ncv
    n_base = n_link + npv + ncv
    n_var = n_base + (npv + ncv if use_det else 0)
    parts = [-lk[np.ix_(pi, ci)].ravel(), -ed[pi], -nw[ci]]
    if use_det:
        parts += [-dp[pi], -dc[ci]]
    c = np.concatenate(parts) if n_var else np.zeros(0)

    rows, cols, vals = [], [], []
    for a in range(npv):               # prev: links + end [- det] = 1 | 0
        for b in range(ncv):
            rows.append(a), cols.append(a * ncv + b), vals.append(1.0)
        rows.append(a), cols.append(n_link + a), vals.append(1.0)
        if use_det:
            rows.append(a), cols.append(n_base + a), vals.append(-1.0)
    for b in range(ncv):               # curr: links + new [- det] = 1 | 0
        for a in range(npv):
            rows.append(npv + b), cols.append(a * ncv + b), vals.append(1.0)
        rows.append(npv + b), cols.append(n_link + npv + b), vals.append(1.0)
        if use_det:
            rows.append(npv + b), cols.append(n_base + npv + b)
            vals.append(-1.0)

    match_prev = np.full(N, -1, np.int32)
    is_end, is_new = np.zeros(N, bool), np.zeros(N, bool)
    keep_prev, keep_curr = np.zeros(N, bool), np.zeros(N, bool)
    if n_var:
        A = sp.csr_matrix((vals, (rows, cols)), shape=(npv + ncv, n_var))
        rhs = np.zeros(npv + ncv) if use_det else np.ones(npv + ncv)
        res = sopt.milp(c=c, constraints=sopt.LinearConstraint(A, rhs, rhs),
                        integrality=np.ones(n_var), bounds=sopt.Bounds(0, 1))
        if not res.success:
            raise RuntimeError(f"ILP oracle failed: {res.message}")
        y = np.round(res.x).astype(int)
        y_link = y[:n_link].reshape(npv, ncv)
        y_end, y_new = y[n_link:n_link + npv], y[n_link + npv:n_base]
        for a in range(npv):
            if y_end[a]:
                is_end[pi[a]] = True
            elif y_link[a].any():
                match_prev[pi[a]] = ci[np.argmax(y_link[a])]
        is_new[ci[y_new.astype(bool)]] = True
        if use_det:
            keep_prev[pi] = y[n_base:n_base + npv].astype(bool)
            keep_curr[ci] = y[n_base + npv:].astype(bool)
        else:
            keep_prev[pi] = True
            keep_curr[ci] = True
    match_curr = np.full(N, -1, np.int32)
    linked = np.flatnonzero(match_prev >= 0)
    match_curr[match_prev[linked]] = linked

    def t(x):
        return torch.as_tensor(x, device=dev)

    return Decisions(t(match_prev), t(match_curr), t(is_end), t(is_new),
                     t(keep_prev), t(keep_curr))
