"""The port's other solvers against the JAX package's on shared inputs:
``sinkhorn_lap`` (its log-plan), ``greedy_matching``, and the decisions
of ``solve_sinkhorn``, ``solve_greedy`` and the host oracles ``lap``,
``ilp`` and ``native``, through ``associate`` with and without det
scores and with a link threshold.

Tolerances.  bfloat16: the port rounds where the reference's compiled
CPU program rounds and sums in its order (``assoc/sinkhorn.py``), and the
log-plan must be bit-equal.  float32: ``exp`` and ``log`` of PyTorch's
and XLA's CPU libraries may differ in the last bit, so the log-plan is
held to 1e-9 of its scale (its entries reach 2e6, ``NEG / tau``; the
differences seen are about 1e-10 of it) and the decisions exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmot_tpu.assoc.greedy import greedy_matching as j_greedy_matching
from mmmot_tpu.assoc.sinkhorn import sinkhorn_lap as j_sinkhorn_lap
from mmmot_tpu.assoc.solve import associate as j_associate
from mmmot_tpu.config import AssocConfig as JAssocConfig
from mmmot_tpu_torch.assoc.cost import build_assignment_cost
from mmmot_tpu_torch.assoc.greedy import greedy_matching
from mmmot_tpu_torch.assoc.ilp_oracle import lap_solve
from mmmot_tpu_torch.assoc.sinkhorn import sinkhorn_lap
from mmmot_tpu_torch.assoc.solve import associate
from mmmot_tpu_torch.config import AssocConfig
from mmmot_tpu_torch.kernels.build import GXX_FLAGS

from tests.test_torch_assoc import FIELDS, make_instances
from tests.torch_port_fixtures import torch_one_thread  # noqa: F401

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def instance_costs(N, batch, seed, dtype):
    """Square costs [batch, 2N, 2N] of seeded instances, in ``dtype``,
    made by the reference's ``build_assignment_cost`` (the port's own is
    tested apart)."""
    from mmmot_tpu.assoc.cost import build_assignment_cost as j_cost

    rng = np.random.default_rng(seed)
    link = rng.normal(0, 1, (batch, N, N)).astype(np.float32)
    new = rng.uniform(0, 1, (batch, N)).astype(np.float32)
    end = rng.uniform(0, 1, (batch, N)).astype(np.float32)
    mp = rng.random((batch, N)) < 0.6
    mc = rng.random((batch, N)) < 0.7
    dt = JDT[dtype]
    return j_cost(*(jnp.asarray(x, dt) for x in (link, new, end)),
                  jnp.asarray(mp), jnp.asarray(mc))


def to_torch(x):
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32))).to(
        {jnp.dtype(jnp.bfloat16): torch.bfloat16,
         jnp.dtype(jnp.float32): torch.float32}[jnp.asarray(x).dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [8, 32, 64])
def test_sinkhorn_log_plan_equals_reference(N, dtype):
    """M = 2N = 16 sums in one window, 64 in two, 128 in four."""
    for seed in range(3):
        cost = instance_costs(N, 4, seed, dtype)
        ref = np.asarray(j_sinkhorn_lap(cost).astype(jnp.float32))
        got = sinkhorn_lap(to_torch(cost))
        assert got.dtype == to_torch(cost).dtype
        got = got.float().numpy()
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got, ref)
        else:
            scale = np.abs(ref).max()
            assert np.abs(got - ref).max() <= 1e-9 * scale


@pytest.mark.parametrize("ties", [False, True])
def test_greedy_matching_equals_reference(ties):
    """Untied scores, and scores on a coarse grid (many ties: the first
    maximal flat index wins)."""
    rng = np.random.default_rng(5 + ties)
    for M in (6, 16):
        s = rng.normal(0, 1, (8, M, M)).astype(np.float32)
        if ties:
            s = np.round(s)
        ref = np.asarray(j_greedy_matching(jnp.asarray(s)))
        got = greedy_matching(torch.from_numpy(s)).numpy()
        np.testing.assert_array_equal(got, ref)


CASES = {
    "plain": dict(),
    "det_scores": dict(det=True),
    "link_threshold": dict(cfg=dict(link_threshold=0.2)),
    "det_threshold_bf16": dict(det=True, cfg=dict(link_threshold=0.1),
                               dtype="bfloat16"),
}


def solver_inputs(seed, N, batch, det: bool, dtype):
    link, new, end, mp, mc = make_instances("rand", N, batch, seed)
    rng = np.random.default_rng(seed + 99)
    dp = rng.normal(0, 1.5, (batch, N)).astype(np.float32) if det else None
    dc = rng.normal(0, 1.5, (batch, N)).astype(np.float32) if det else None
    j = [None if x is None else jnp.asarray(x, JDT[dtype] if x.dtype ==
                                            np.float32 else None)
         for x in (link, new, end, mp, mc, dp, dc)]
    t = [None if x is None else to_torch(x) if x.dtype != jnp.bool_
         else torch.from_numpy(np.array(x)) for x in j]
    return j, t


def decisions_equal(got, ref, what):
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), np.asarray(getattr(ref, f)),
            err_msg=f"{what}: {f}")


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("solver", ["sinkhorn", "greedy"])
def test_device_solver_decisions_equal_reference(solver, case):
    """Batched instances (N=12, 6 of them) through ``associate``."""
    c = CASES[case]
    dtype = c.get("dtype", "float32")
    j, t = solver_inputs(7, 12, 6, c.get("det", False), dtype)
    kw = dict(solver=solver, **c.get("cfg", {}))
    ref = jax.jit(lambda *a: j_associate(
        *a[:5], JAssocConfig(**kw), det_prev=a[5], det_curr=a[6]))(*j)
    got = associate(*t[:5], AssocConfig(**kw), det_prev=t[5],
                    det_curr=t[6])
    decisions_equal(got, ref, f"{solver} {case}")


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("solver", ["lap", "ilp", "native"])
def test_host_oracle_decisions_equal_reference(solver, case):
    """One instance at a time for ``lap`` and ``ilp`` (both raise on a
    batch, as the reference's do); ``native`` also on the whole batch."""
    c = CASES[case]
    dtype = c.get("dtype", "float32")
    j, t = solver_inputs(8, 10, 4, c.get("det", False), dtype)
    kw = dict(solver=solver, **c.get("cfg", {}))
    for b in range(4):
        def one(xs):
            return [None if x is None else x[b] for x in xs]
        ref = j_associate(*one(j)[:5], JAssocConfig(**kw),
                          det_prev=one(j)[5], det_curr=one(j)[6])
        got = associate(*one(t)[:5], AssocConfig(**kw),
                        det_prev=one(t)[5], det_curr=one(t)[6])
        decisions_equal(got, ref, f"{solver} {case} instance {b}")
    if solver == "native":
        got = associate(*t[:5], AssocConfig(**kw), det_prev=t[5],
                        det_curr=t[6])
        ref = j_associate(*j[:5], JAssocConfig(**kw), det_prev=j[5],
                          det_curr=j[6])
        decisions_equal(got, ref, f"native {case} batch")
    else:
        with pytest.raises(ValueError, match="one instance"):
            associate(*t[:5], AssocConfig(**kw), det_prev=t[5],
                      det_curr=t[6])


def test_oracles_agree_on_the_optimum():
    """lap, ilp and native find the same decisions on 32 seeded
    instances (the reduction is exact; ties have probability 0)."""
    for seed in range(32):
        _, t = solver_inputs(100 + seed, 8, 1, seed % 2 == 1, "float32")
        one = [None if x is None else x[0] for x in t]
        decs = [associate(*one[:5], AssocConfig(solver=s), det_prev=one[5],
                          det_curr=one[6]) for s in ("lap", "ilp", "native")]
        for d in decs[1:]:
            decisions_equal(d, decs[0], f"seed {seed}")


def test_native_lap_solve_objective_and_build_flags():
    """The native solver's objective is the optimum of
    ``scipy.optimize.linear_sum_assignment``, for one instance and a
    batch; it is built without host-specific code generation."""
    from scipy.optimize import linear_sum_assignment

    assert not any(f.startswith("-march") for f in GXX_FLAGS)
    c = np.random.default_rng(3).normal(size=(5, 9, 9))
    rc, obj = lap_solve(c[0], maximize=True)
    r, k = linear_sum_assignment(c[0], maximize=True)
    assert obj == pytest.approx(c[0][r, k].sum())
    np.testing.assert_array_equal(rc[r], k)
    rcb, none = lap_solve(c, maximize=True)
    assert none is None and rcb.shape == (5, 9)
    for i in range(5):
        r, k = linear_sum_assignment(c[i], maximize=True)
        np.testing.assert_array_equal(rcb[i][r], k)


def test_sinkhorn_solver_config_matches_reference():
    """The Sinkhorn knobs and their defaults are the reference's."""
    for f in ("sinkhorn_tau", "sinkhorn_iters", "solver"):
        assert getattr(AssocConfig(), f) == getattr(JAssocConfig(), f)
    cost = build_assignment_cost(torch.zeros(1, 3, 3), torch.zeros(1, 3),
                                 torch.zeros(1, 3), torch.ones(1, 3).bool(),
                                 torch.ones(1, 3).bool())
    with pytest.raises(TypeError):
        sinkhorn_lap(cost.double())
    assert dataclasses.replace(AssocConfig(), solver="sinkhorn",
                               sinkhorn_iters=3).sinkhorn_iters == 3


def test_greedy_rounding_can_leave_a_detection_unassigned():
    """The greedy rounding of a Sinkhorn plan is not a perfect LAP solve:
    on these coarse bf16 scores it leaves a valid current detection
    neither linked nor new (the reference's ``solve_sinkhorn`` does the
    same, so the tracker gives it no id).  The port's decisions equal
    the reference's there."""
    from mmmot_tpu.assoc.sinkhorn import solve_sinkhorn as j_solve_sinkhorn
    from mmmot_tpu_torch.assoc.sinkhorn import solve_sinkhorn

    r = np.random.default_rng(26)
    N = 8
    link = np.round(r.normal(0, 1, (16, N, N)) * 2) / 8
    new, end = r.uniform(0, 1, (16, N)), r.uniform(0, 1, (16, N))
    mp, mc = r.random((16, N)) < 0.8, r.random((16, N)) < 0.8
    j = [jnp.asarray(x, jnp.bfloat16) for x in (link, new, end)]
    ref = jax.jit(j_solve_sinkhorn)(*j, jnp.asarray(mp), jnp.asarray(mc))
    got = solve_sinkhorn(*(to_torch(x) for x in j), torch.from_numpy(mp),
                         torch.from_numpy(mc))
    decisions_equal(got, ref, "seed 26")
    unassigned = mc & (got.match_curr.numpy() < 0) & ~got.is_new.numpy()
    assert unassigned.any()
