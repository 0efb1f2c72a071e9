"""Data parallelism of the port over ``torch.distributed`` against one
process and the JAX package (the counterpart of ``tests/test_parallel.py``
and of ``__graft_entry__.py::dryrun_multichip``).

One spawn of two ``gloo`` ranks on the CPU (``parallel/dryrun.py``, a
module-scoped fixture) runs every leg: a data-parallel train step on a
batch split 2 + 2 (loss within 1e-4 and gradient norm within 1e-3 of one
process on the whole batch, the reference's tolerances; the SGD step's
parameters move, are equal on both ranks, and their change differs from
one process's by at most 1e-3 of its norm, as one process's does with
the batch in another order), train-mode BatchNorm over the group
(outputs, running statistics and gradients equal to the whole batch's),
and the tracking legs (the auction, the quality stack with ghosts,
learned motion) on S=4 sequences split 2 + 2, their gathered ids equal to
one process's and to the reference's ``track_sequences_batched`` on the
same weights, bit for bit.
"""

import dataclasses
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmot_tpu.config import AssocConfig as JAssocConfig
from mmmot_tpu.models import model_entry
from mmmot_tpu.tracker import TrackingModule as JTrackingModule
from mmmot_tpu.tracker.sequence import \
    track_sequences_batched as j_track_batched
from mmmot_tpu_torch.config import tiny_debug
from mmmot_tpu_torch.parallel.dryrun import (LEGS, QUALITY, T_FRAMES,
                                             dryrun, dryrun_inputs,
                                             motion_model)
from mmmot_tpu_torch.parallel.mesh import (ParallelConfig, init_distributed,
                                           make_mesh, shard_batch)

from tests.torch_port_fixtures import (init_flax, port_net, randomize_stats,
                                       tiny_cfg_jax)

S, T = 4, T_FRAMES      # two ranks track 2 sequences each


def flax_weights():
    """(JAX model config, variables) of the tiny net and of its
    learned-motion twin, whose motion MLP is drawn nonzero (the flax
    output layer starts at zero) as the reference's dry run does."""
    jcfg = tiny_cfg_jax().model
    _, variables = init_flax(jcfg, seed=0)
    jcfg_m = dataclasses.replace(jcfg, affinity=dataclasses.replace(
        jcfg.affinity, motion_dim=8))
    jnet_m = model_entry(jcfg_m)
    N, P = tiny_debug().data.max_dets, tiny_debug().data.point_len
    dummy = {"crops": jnp.zeros((1, 2, N, 32, 32, 3)),
             "points": jnp.zeros((1, 2, N, P, 4)),
             "point_mask": jnp.ones((1, 2, N, P), bool),
             "det_mask": jnp.ones((1, 2, N), bool),
             "boxes": jnp.zeros((1, 2, N, 4))}
    vars_m = randomize_stats(jax.jit(lambda r, b: jnet_m.init(
        {"params": r}, b, train=False))(jax.random.PRNGKey(3), dummy), 3)
    rng = np.random.default_rng(11)
    params = dict(vars_m["params"])
    params["motion"] = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(0, 0.5, x.shape), jnp.float32),
        params["motion"])
    vars_m = {"params": params, "batch_stats": vars_m["batch_stats"]}
    return (jcfg, variables), (jcfg_m, vars_m)


@pytest.fixture(scope="module")
def found():
    """Every leg over two gloo ranks on the CPU, in one spawn, and the
    reference's ids for the tracking legs on the same inputs."""
    (jcfg, variables), (jcfg_m, vars_m) = flax_weights()
    cfg = tiny_debug()
    weights = {
        "net": port_net(variables, cfg.model).state_dict(),
        "motion": port_net(vars_m, motion_model(cfg.model)).state_dict()}
    got = dryrun(2, "gloo", "cpu", cfg, weights, B=4)
    inputs = {k: jnp.asarray(v) for k, v in dryrun_inputs(cfg, S).items()}
    ref = {}
    for leg, (jc, v, assoc) in {
            "auction": (jcfg, variables, JAssocConfig(solver="auction")),
            "quality": (jcfg, variables, JAssocConfig(**QUALITY)),
            "motion": (jcfg_m, vars_m, JAssocConfig(**QUALITY))}.items():
        mod = JTrackingModule(model_entry(jc), v, assoc)
        out = jax.jit(lambda c, p, q, d, b: j_track_batched(
            mod, c, p, q, d, boxes=b if mod.carry_boxes else None))(
            inputs["crops"], inputs["points"], inputs["point_mask"],
            inputs["det_mask"], inputs["boxes"])
        ref[leg] = {k: np.asarray(out[k]) for k in ("ids", "ghost_ids")
                    if k in out}
    return got, ref


def test_mesh_layout_and_its_error():
    """The reference's layouts (8 x 1, 4 x 2) and its error for a layout
    that is not the world size; a rank's share of the batch."""
    mesh = make_mesh(ParallelConfig(num_data=8), world_size=8, rank=3)
    assert mesh.ranks.shape == (8, 1) and mesh.data_index == 3
    mesh2 = make_mesh(ParallelConfig(num_data=4, num_model=2),
                      world_size=8, rank=5)
    assert mesh2.ranks.shape == (4, 2) and mesh2.data_index == 2
    assert make_mesh(world_size=8, rank=0).ranks.shape == (8, 1)
    with pytest.raises(ValueError, match="mesh 3x1 != 8"):
        make_mesh(ParallelConfig(num_data=3), world_size=8, rank=0)
    x = np.arange(24).reshape(8, 3)
    part = shard_batch(mesh2, {"x": x, "none": None})
    assert part["none"] is None
    np.testing.assert_array_equal(part["x"].numpy(), x[4:6])
    with pytest.raises(ValueError, match="split evenly"):
        shard_batch(mesh2, {"x": np.zeros((6, 2))})


def test_backends_are_explicit():
    """No silent switch: nccl without CUDA and an unknown backend raise
    before any process group is made."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        addr = f"tcp://localhost:{s.getsockname()[1]}"
    with pytest.raises(ValueError, match="nccl or gloo"):
        init_distributed(0, 1, addr, backend="mpi")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs CUDA"):
            init_distributed(0, 1, addr, backend="nccl")
    assert not torch.distributed.is_initialized()


def test_sharded_train_step_matches_one_process(found):
    got, _ = found
    tr = got["train"]
    assert got["world_size"] == 2 and got["backend"] == "gloo"
    assert tr["loss"] == pytest.approx(tr["loss_single"], rel=1e-4)
    assert tr["grad_norm"] == pytest.approx(tr["grad_norm_single"],
                                            rel=1e-3)
    assert tr["n_dets"] == tr["n_dets_single"] > 0
    assert tr["replicated"]
    assert tr["param_moved"] > 1e-5
    assert tr["param_err"] <= 1e-3 and tr["param_floor"] <= 1e-3


def test_batch_norm_moments_under_a_group_equal_the_whole_batch(found):
    """Outputs, running statistics, the gradient to x and to the scale
    and bias: the group's equal the whole batch's within float32 sums."""
    got, _ = found
    assert set(got["norm"]) == {"y", "gx", "gp", "stats"}
    for k, err in got["norm"].items():
        assert err <= 1e-5, (k, err)


@pytest.mark.parametrize("leg", LEGS)
def test_sharded_tracking_ids_equal_one_process_and_reference(found, leg):
    got, ref = found
    r = got["tracking"][leg]
    assert r["ids"].shape == (S, T, tiny_debug().data.max_dets)
    np.testing.assert_array_equal(r["ids"], r["ids_single"])
    np.testing.assert_array_equal(r["ids"], ref[leg]["ids"])
    assert (r["ids"] >= 0).any()
    if leg != "auction":
        np.testing.assert_array_equal(r["ghost_ids"], r["ghost_ids_single"])
        np.testing.assert_array_equal(r["ghost_ids"], ref[leg]["ghost_ids"])


def test_no_process_group_is_left(found):
    """The ranks ran in their own processes: this one never joined."""
    assert not torch.distributed.is_initialized()
    assert "MASTER_ADDR" not in os.environ
