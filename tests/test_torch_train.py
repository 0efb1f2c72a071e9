"""Port parity of training (``mmmot_tpu_torch.train``, the train-mode
model) against the JAX package at ``tiny_debug`` widths, float32.

The same flax weights (``torch_port_fixtures.init_flax``/``port_net``)
and the same numpy batches go through both packages.  Gradients, new
BatchNorm statistics and post-step parameters of the reference cross to
the port's names through ``compat.from_jax.load_flax_variables``, the
mapping its weights take.  Tolerances: forward values and the loss
within the fixtures' ``RTOL, ATOL = 1e-4, 1e-5``; each gradient and each
post-step tensor within ``GRAD_TOL = 1e-3`` of that tensor's largest
magnitude (the gradients sum thousands of float32 products in other
orders on each side); ``kept_mask`` exactly; the schedule's values within
float32 rounding (``rtol 1e-6``, ``atol 1e-10``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmmot_tpu.config import TrainConfig as JTrainConfig
from mmmot_tpu.data.synthetic import make_training_batch
from mmmot_tpu.models.layers import MaskedBatchNorm as JMaskedBatchNorm
from mmmot_tpu.train.losses import tracking_loss as j_tracking_loss
from mmmot_tpu.train.trainer import build_optimizer as j_build_optimizer
from mmmot_tpu.train.trainer import build_schedule as j_build_schedule
from mmmot_tpu.train.trainer import TrainState as JTrainState
from mmmot_tpu.train.trainer import train_step as j_train_step
from mmmot_tpu_torch.compat.from_jax import load_flax_variables
from mmmot_tpu_torch.config import TrainConfig, tiny_debug
from mmmot_tpu_torch.models.layers import MaskedBatchNorm
from mmmot_tpu_torch.models.tracking_net import TrackingNet, init_random_
from mmmot_tpu_torch.train.losses import tracking_loss
from mmmot_tpu_torch.train.parity import BN_FED_BIAS, step_agreement
from mmmot_tpu_torch.train.trainer import (build_schedule,
                                           create_train_state, eval_forward,
                                           global_norm, loss_and_grads,
                                           train_step)

from tests.torch_port_fixtures import (assert_close, init_flax, port_net,
                                       tiny_cfg_jax, to_numpy,
                                       torch_one_thread)  # noqa: F401

N = 8
GRAD_TOL = 1e-3
# Biases of the layers that feed a train-mode BatchNorm (``BN_FED_BIAS``):
# the normalisation removes them, so their gradient is 0 in exact
# arithmetic and float32 rounding noise on both sides.  Their gradients
# are held to the scale of the same layer's weight gradient, and after an
# sgd step their values to within the learning rate times the tolerance
# (``noise_bound``).


def assert_scaled(got, want, what, scale=None, slack=0.0):
    """max |got - want| <= GRAD_TOL * scale + slack; ``scale`` defaults to
    max |want|."""
    got = got.detach().float().numpy() if hasattr(got, "detach") else got
    want = np.asarray(want, np.float32)
    if scale is None:
        scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= GRAD_TOL * max(scale, 1e-12) + slack, (what, err, scale)


def assert_grads(net, want):
    """Every parameter's gradient against ``want`` (state-dict names)."""
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in net.named_parameters()}
    for name, g in grads.items():
        if BN_FED_BIAS.search(name):
            w = name[:-len("bias")] + "weight"
            scale = float(want[w].abs().max())
            assert_scaled(g, np.zeros(g.shape), name, scale)
            assert_scaled(want[name], np.zeros(g.shape), name, scale)
        else:
            assert_scaled(g, want[name].numpy(), name)


def assert_state(net, want, noise_bound, what=""):
    """Post-step parameters and statistics against ``want``."""
    for name, t in net.state_dict().items():
        slack = noise_bound if BN_FED_BIAS.search(name) else 0.0
        assert_scaled(t, want[name].numpy(), (what, name), slack=slack)


def make_batch(seed, batch_size=2):
    return make_training_batch(np.random.default_rng(seed),
                               batch_size=batch_size, num_slots=N,
                               crop_size=(32, 32), points_per_det=16,
                               drop_prob=0.1, fp_prob=0.2)


def to_torch(b):
    return {k: torch.tensor(np.asarray(v)) for k, v in b.items()}


def ref_loss_fn(jnet):
    def loss_fn(params, bs, batch, cap):
        out, mut = jnet.apply({"params": params, "batch_stats": bs}, batch,
                              train=True, mutable=["batch_stats"],
                              compact_capacity=cap)
        loss, metrics = j_tracking_loss(out, batch)
        return loss, (metrics, mut["batch_stats"], out)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                   static_argnums=3)


@pytest.fixture(scope="module")
def shared():
    jcfg = tiny_cfg_jax()
    jnet, variables = init_flax(jcfg.model, N=N)
    return jcfg, jnet, variables, ref_loss_fn(jnet)


def mapped(params, stats, net):
    """Reference params-shaped trees under the port's state-dict names."""
    return load_flax_variables({"params": to_numpy(params),
                                "batch_stats": to_numpy(stats)}, net)


# --- MaskedBatchNorm in train mode -----------------------------------

BN_CASES = {
    # [n, H, W, C] feature maps with a per-crop mask with holes (the
    # port runs them NCHW with the channel at dim 1)
    "conv_holed": ((6, 5, 7, 8), np.array([1, 0, 1, 1, 0, 1], bool)),
    "points_no_mask": ((2, 3, 5, 8), None),
    "points_holed": ((2, 3, 5, 8), "random"),
    # one valid pair of a pair BN: every channel is constant over the
    # valid set, the variance sits at the tie of max(var, 0)
    "pairs_single": ((2, 4, 4, 8), "single"),
}


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_masked_batchnorm_train_mode(case):
    shape, mask = BN_CASES[case]
    rng = np.random.default_rng(7)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    C = shape[-1]
    if isinstance(mask, str):
        mask = (rng.random(shape[:-1]) < 0.6 if mask == "random"
                else np.zeros(shape[:-1], bool))
        if not mask.any():
            mask[1, 2, 1] = True
    w = rng.normal(size=shape).astype(np.float32)
    if case == "pairs_single":
        # As in the link head (score * pair mask), no gradient reaches
        # the masked pairs.  (With one, 1/sqrt(var + eps) ~ 316 cubed
        # would scale float32 rounding noise of both sides into the
        # valid pair's gradient.)
        w = w * mask[..., None]
    v = {"params": {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
                    "bias": rng.normal(size=C).astype(np.float32)},
         "batch_stats": {"mean": rng.normal(size=C).astype(np.float32),
                         "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}}
    jbn = JMaskedBatchNorm()

    def fwd(params, x, m):
        y, mut = jbn.apply({"params": params,
                            "batch_stats": v["batch_stats"]}, x, m,
                           use_running_average=False,
                           mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mut["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.jit(jax.value_and_grad(
        fwd, argnums=(0, 1), has_aux=True))(v["params"], x, mask)

    conv = case.startswith("conv")
    bn = MaskedBatchNorm(C, dim=1 if conv else -1)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(v["params"]["scale"]))
        bn.bias.copy_(torch.tensor(v["params"]["bias"]))
        bn.running_mean.copy_(torch.tensor(v["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.tensor(v["batch_stats"]["var"]))
    xt = torch.tensor(x, requires_grad=True)
    xin = xt.permute(0, 3, 1, 2) if conv else xt
    mt = None if mask is None else torch.tensor(mask)
    out = bn.train()(xin, mt)
    out = out.permute(0, 2, 3, 1) if conv else out
    (out * torch.tensor(w)).sum().backward()
    assert_close(out, y)
    assert_close(bn.running_mean, stats["mean"])
    assert_close(bn.running_var, stats["var"])
    assert_scaled(xt.grad, gx, "x")
    assert_scaled(bn.weight.grad, gp["scale"], "scale")
    assert_scaled(bn.bias.grad, gp["bias"], "bias")
    # Eval mode is unchanged by the training step: running statistics.
    assert not torch.equal(bn.eval()(xin, mt), out.permute(0, 3, 1, 2)
                           if conv else out)


# --- the training forward, the loss and the gradients ---------------

@pytest.fixture(scope="module")
def reference_runs(shared):
    """Reference (value, grads) of three capacities on one batch: 0 (no
    compaction), 64 (every valid slot fits) and 10 (overflow)."""
    _, _, variables, vg = shared
    b = make_batch(3)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    runs = {}
    for cap in (0, 64, 10):
        (loss, (metrics, stats, out)), grads = vg(
            variables["params"], variables["batch_stats"], jb, cap)
        runs[cap] = (float(loss), to_numpy(metrics), stats,
                     to_numpy(out), grads)
    return b, runs


@pytest.mark.parametrize("cap", [0, 64, 10])
def test_training_forward_loss_and_grads(shared, reference_runs, cap):
    _, _, variables, _ = shared
    b, runs = reference_runs
    loss_ref, metrics_ref, stats_ref, out_ref, grads_ref = runs[cap]
    net = port_net(variables, tiny_debug().model)
    batch = to_torch(b)
    net.train()
    out = net(batch, compact_capacity=cap)
    for k in ("link", "link_norm", "new", "end", "det"):
        assert_close(out[k], out_ref[k], err_msg=k)
    if cap:
        kept = out["kept_mask"].numpy()
        np.testing.assert_array_equal(kept, out_ref["kept_mask"])
        valid = int(b["det_mask"].sum())
        assert kept.sum() == min(cap, valid)
        if cap < valid:
            assert kept.sum() < valid     # the overflow case drops some
    else:
        assert "kept_mask" not in out and "kept_mask" not in out_ref
    loss, metrics = tracking_loss(out, batch)
    assert_close(loss, loss_ref)
    assert set(metrics) == set(metrics_ref)
    for k in metrics:
        assert_close(metrics[k], metrics_ref[k], err_msg=k)

    net2 = port_net(variables, tiny_debug().model)
    loss2, _ = loss_and_grads(net2, batch, compact_capacity=cap)
    assert_close(loss2, loss_ref)
    want = mapped(grads_ref, stats_ref, net2)
    assert_grads(net2, want)
    for name, buf in net2.named_buffers():
        assert_close(buf, want[name], err_msg=name)


def test_eval_forward_matches_reference(shared, reference_runs):
    """``eval_forward``: the forward with the running statistics, as the
    reference's ``train=False`` apply; it leaves the statistics alone."""
    _, jnet, variables, _ = shared
    b, _ = reference_runs
    ref = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(
        variables, {k: jnp.asarray(v) for k, v in b.items()})
    net = port_net(variables, tiny_debug().model)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    out = eval_forward(net, to_torch(b))
    for k in ("link", "link_norm", "new", "end", "det"):
        assert_close(out[k], np.asarray(ref[k]), err_msg=k)
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_loss_without_gt_ids_and_on_reference_outputs(reference_runs):
    """The loss of the port on the reference's own forward outputs, with
    and without ``gt_ids`` (no false-positive terms, no det term)."""
    b, runs = reference_runs
    out_ref = runs[64][3]
    for drop_ids in (False, True):
        bb = {k: v for k, v in b.items() if not (drop_ids and k == "gt_ids")}
        ref_loss, ref_m = j_tracking_loss(
            {k: jnp.asarray(v) for k, v in out_ref.items()},
            {k: jnp.asarray(v) for k, v in bb.items()})
        loss, m = tracking_loss(to_torch(out_ref), to_torch(bb))
        assert_close(loss, ref_loss)
        assert set(m) == set(ref_m)
        assert ("bce_det" in m) == (not drop_ids)
        for k in m:
            assert_close(m[k], np.asarray(ref_m[k]), err_msg=k)


# --- schedule and optimizer -----------------------------------------

@pytest.mark.parametrize("kw", [
    dict(lr_schedule="step", warmup_steps=5, lr_decay_epochs=(2, 4)),
    dict(lr_schedule="step", warmup_steps=0, lr_decay_epochs=(2, 4)),
    dict(lr_schedule="cosine", warmup_steps=4, epochs=6),
    dict(lr_schedule="constant", warmup_steps=3)])
def test_schedule_matches_optax(kw):
    """Warmup (update 0 at lr 0) and both decay boundaries, which
    ``join_schedules`` moves by the warmup."""
    spe = 3
    port = build_schedule(TrainConfig(**kw), spe)
    ref = j_build_schedule(JTrainConfig(**kw), spe)
    counts = range(0, 30)
    got = np.array([port(c) for c in counts])
    want = np.array([float(ref(c)) for c in counts])
    # optax evaluates in float32: 1 + cos(x) loses digits near the end
    # of the cosine, hence the absolute floor (of a 3e-4 rate).
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-10)
    if kw.get("warmup_steps"):
        assert got[0] == 0.0
    if kw["lr_schedule"] == "step":
        w = kw["warmup_steps"]
        assert got[w + 2 * spe - 1] == pytest.approx(3e-4)
        assert got[w + 2 * spe] == pytest.approx(3e-5)
        assert got[w + 4 * spe] == pytest.approx(3e-6)


OPT_CASES = {
    "adam_clip": dict(optimizer="adam", grad_clip=1.0),
    "adam_noclip": dict(optimizer="adam", grad_clip=1e6),
    "sgd_clip": dict(optimizer="sgd", grad_clip=1.0, lr=1e-2),
    "sgd_noclip": dict(optimizer="sgd", grad_clip=1e6, lr=1e-2),
}


def ref_state(variables, jtcfg, steps_per_epoch):
    """The reference's ``TrainState`` over the shared weights, as its
    ``create_train_state`` builds it (without re-initialising)."""
    tx = j_build_optimizer(jtcfg, steps_per_epoch)
    return JTrainState(step=jnp.int32(0), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), tx=tx)


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_steps_match_optax(shared, case):
    """Three steps of the reference's optax chain and of ``OptaxChain``
    on the same gradients (the reference's, mapped), checked after the
    first and the third: warmup 2 so that update 0 runs at lr 0, the
    clip active (|g| >> 1) or not, adamw's decay on every parameter."""
    _, jnet, variables, vg = shared
    kw = dict(OPT_CASES[case], warmup_steps=2)
    jstate = ref_state(variables, JTrainConfig(**kw), 5)
    net = port_net(variables, tiny_debug().model)
    opt = create_train_state(net, TrainConfig(**kw), 5).optimizer
    for step in range(3):
        b = make_batch(20 + step)
        (_, (_, new_bs, _)), grads = vg(
            jstate.params, jstate.batch_stats,
            {k: jnp.asarray(v) for k, v in b.items()}, 0)
        jstate = jstate.apply_gradients(grads, new_bs)
        given = mapped(grads, new_bs, net)
        with torch.no_grad():
            for name, p in net.named_parameters():
                p.grad = given[name].clone()
            for name, buf in net.named_buffers():
                buf.copy_(given[name])
        norm = float(optax.global_norm(grads))
        assert_close(global_norm(opt.params_and_grads()[1]), norm)
        if "noclip" not in case:
            assert norm > kw["grad_clip"]
        opt.step()
        if step in (0, 2):
            want = mapped(jstate.params, jstate.batch_stats, net)
            for name, t in net.state_dict().items():
                assert_scaled(t, want[name].numpy(), (step, name))
    assert opt.param_groups[0]["update_count"] == int(jstate.step) == 3


def test_train_step_matches_reference_train_step(shared):
    """The reference's own ``train_step`` (compact-first, capacity 12,
    sgd with the clip active) against the port's: metrics, ``grad_norm``
    and the new state (sgd moves each parameter by lr times its
    gradient, so the state is held as the gradients are)."""
    jcfg, jnet, variables, _ = shared
    jtcfg = dataclasses.replace(jcfg.train, optimizer="sgd", lr=1e-2,
                                warmup_steps=0, grad_clip=1.0)
    b = make_batch(31)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jstate = ref_state(variables, jtcfg, 4)
    jstate, jm = jax.jit(lambda s, x: j_train_step(
        jnet, s, x, jax.random.PRNGKey(1), compact_capacity=12))(jstate, jb)
    cfg = tiny_debug()
    assert dataclasses.asdict(cfg.train) == dataclasses.asdict(jcfg.train)
    tcfg = dataclasses.replace(cfg.train, optimizer="sgd", lr=1e-2,
                               warmup_steps=0, grad_clip=1.0)
    state = create_train_state(port_net(variables, cfg.model), tcfg, 4)
    state, m = train_step(state, to_torch(b), compact_capacity=12)
    assert set(m) == set(jm)
    for k in m:
        assert_close(m[k], np.asarray(jm[k]), err_msg=k)
    assert float(m["grad_norm"]) > 1.0
    want = mapped(jstate.params, jstate.batch_stats, state.net)
    assert_state(state.net, want, GRAD_TOL * tcfg.lr)


# --- port-only checks ----------------------------------------------

def test_remat_step_equals_plain_step():
    """``model.remat`` (the VGG trunk under ``torch.utils.checkpoint``)
    changes nothing: loss, grad_norm, every parameter and every running
    statistic after a step are equal; the statistics moved once."""
    cfg = tiny_debug()
    b = to_torch(make_batch(5))
    results = []
    for remat in (False, True):
        model = dataclasses.replace(cfg.model, remat=remat)
        net = init_random_(TrackingNet(model, device="cpu"), 0)
        before = {k: v.clone() for k, v in net.state_dict().items()}
        state, m = train_step(create_train_state(net, cfg.train, 4), b,
                              compact_capacity=12)
        results.append((m, net.state_dict(), before))
    (m0, sd0, before), (m1, sd1, _) = results
    assert float(m0["total"]) == float(m1["total"])
    assert float(m0["grad_norm"]) == float(m1["grad_norm"])
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    # One update of the running mean: 0.9 * old + 0.1 * batch mean moves
    # it; a second would move it again, and remat would then differ.
    k = "appear_net.backbone.bn_0.running_mean"
    assert not torch.equal(sd0[k], before[k])


def test_loss_falls_in_twenty_steps():
    """The port's twin of ``tests/test_e2e_train.py``: 20 steps at lr
    1e-3 on synthetic batches; the mean loss of the last 5 steps is
    below 0.85 of that of the first 5."""
    cfg = tiny_debug()
    rng = np.random.default_rng(0)
    net = init_random_(TrackingNet(cfg.model, device="cpu"), 0)
    state = create_train_state(net, dataclasses.replace(cfg.train, lr=1e-3),
                               20)
    losses = []
    for _ in range(20):
        b = make_training_batch(rng, batch_size=4, num_slots=N,
                                crop_size=(32, 32), points_per_det=16,
                                drop_prob=0.05, fp_prob=0.1)
        state, m = train_step(state, to_torch(b))
        losses.append(float(m["total"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.85, losses


def test_step_agreement_on_cpu():
    """``train.parity.step_agreement``, the GPU's check against the CPU,
    run CPU against CPU: the step is deterministic there, so the loss
    and every post-step tensor are equal, and the gradient error is the
    BatchNorm-fed biases' rounding noise against their layer's scale."""
    out = step_agreement("cpu")
    assert out["loss"] == out["loss_cpu"] and out["grad_norm"] > 1.0
    assert out["max_rel_err"]["state"] == 0.0
    assert 0.0 < out["max_rel_err"]["grad"] <= GRAD_TOL
