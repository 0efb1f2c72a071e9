"""Checks of the port that need an NVIDIA GPU (marker ``cuda``): the
fused affinity, int8 conv and conv-epilogue (``fused_bn_relu``) CUDA
kernels against their plain versions,
and CPU/GPU agreement of the tiny tracker (float and int8 trunks).  They
skip without a GPU.  This file imports neither JAX nor the JAX package,
so it runs on the GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses

import pytest
import torch

from mmmot_tpu_torch.config import AssocConfig, tiny_debug
from mmmot_tpu_torch.device import f32_parity
from mmmot_tpu_torch.kernels.affinity import (affinity_plain,
                                              build_affinity_params,
                                              fused_affinity)
from mmmot_tpu_torch.models.tracking_net import TrackingNet, init_random_
from mmmot_tpu_torch.tracker.sequence import track_sequence_from_frames
from mmmot_tpu_torch.tracker.tracker import TrackingModule

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


# (N, prev, curr) per frame pair: an int is a prefix count of valid
# slots, a tuple the valid slots themselves (masks with holes).
CASES = [(8, [5, 8, 1], [7, 2, 8]), (8, [0, 6], [4, 0]),
         (13, [13, 9, 4], [11, 13, 0]), (64, [64, 40], [17, 64]),
         # alternating slots; a single valid slot at the last index
         (8, [(0, 2, 4, 6), (7,)], [(1, 3, 5, 7), (7,)]),
         # a full N=13 row against a holed column set: n_p * n_c = 65
         (13, [13], [(0, 3, 4, 9, 12)]),
         # n_p * n_c = 64 exactly (one full tile of pairs), holed
         (16, [tuple(range(0, 16, 2))], [(1, 2, 3, 5, 8, 11, 13, 15)])]


def masks(N, spec, dev):
    ar = torch.arange(N, device=dev)
    return torch.stack([ar < s if isinstance(s, int)
                        else torch.isin(ar, torch.tensor(s, device=dev))
                        for s in spec])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain(gpu, dtype):
    dt = getattr(torch, dtype)
    net = init_random_(TrackingNet(tiny_debug().model, device=gpu), 0)
    params = build_affinity_params(net, dt)
    gen = torch.Generator(device=gpu).manual_seed(0)
    for N, n_prev, n_curr in CASES:
        B = len(n_prev)
        a, b = (torch.randn((B, 3, N, 64), generator=gen, device=gpu).to(dt)
                for _ in range(2))
        mp, mc = masks(N, n_prev, gpu), masks(N, n_curr, gpu)
        before = fused_affinity.launches
        with f32_parity():
            got = fused_affinity(a, b, mp, mc, params)
            want = affinity_plain(a, b, mp, mc, params)
        torch.cuda.synchronize()
        assert fused_affinity.launches == before + 1
        # float32: sums in another order; bfloat16: a rounding flip moves
        # a value by a bf16 ulp (2^-7 relative), a softmax by a few.
        tol = 1e-4 if dtype == "float32" else 2.0 ** -5
        for name, x, y in zip(got._fields, got, want):
            scale = max(1.0, y.float().abs().max().item())
            err = (x.float() - y.float()).abs().max().item()
            assert err <= tol * scale, (N, name, err)
        pm = mp[:, :, None] & mc[:, None, :]
        assert (got.link[~pm] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_with_link_bias_matches_plain(gpu, dtype):
    """The bias instance (``link_bias``, counted in ``bias_launches``)
    against the plain version; the bias moves the link and masked links
    stay exactly 0."""
    dt = getattr(torch, dtype)
    net = init_random_(TrackingNet(tiny_debug().model, device=gpu), 0)
    params = build_affinity_params(net, dt)
    gen = torch.Generator(device=gpu).manual_seed(1)
    for N, n_prev, n_curr in ((8, [5, 0, 8], [7, 3, (1, 4)]),
                              (64, [64, 40], [17, (0, 9, 63)])):
        B = len(n_prev)
        a, b = (torch.randn((B, 3, N, 64), generator=gen, device=gpu).to(dt)
                for _ in range(2))
        bias = 2 * torch.randn((B, N, N), generator=gen, device=gpu)
        mp, mc = masks(N, n_prev, gpu), masks(N, n_curr, gpu)
        before = (fused_affinity.launches, fused_affinity.bias_launches)
        with f32_parity():
            got = fused_affinity(a, b, mp, mc, params, bias)
            want = affinity_plain(a, b, mp, mc, params, bias)
            plain = fused_affinity(a, b, mp, mc, params)
        torch.cuda.synchronize()
        assert (fused_affinity.launches, fused_affinity.bias_launches) == (
            before[0] + 1, before[1] + 1)
        tol = 1e-4 if dtype == "float32" else 2.0 ** -5
        for name, x, y in zip(got._fields, got, want):
            scale = max(1.0, y.float().abs().max().item())
            err = (x.float() - y.float()).abs().max().item()
            assert err <= tol * scale, (N, name, err)
        pm = mp[:, :, None] & mc[:, None, :]
        assert (got.link[~pm] == 0).all()
        assert (got.link.float() - plain.link.float()).abs().max() > 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("branches,avg", [
    (("fused",), False), (("fused", "lidar"), False),
    (("fused", "image"), False), (("fused", "image", "lidar"), True),
    (("fused",), True), (("fused", "lidar"), True)])
def test_kernel_instances_match_plain(gpu, dtype, branches, avg):
    """The K=1 and K=2 instances (one score branch; a dead sensor's branch
    absent) and ``avg`` (the branch sum divided by K) against the plain
    version, each counted under its K (and in ``avg_launches``)."""
    dt = getattr(torch, dtype)
    net = init_random_(TrackingNet(tiny_debug().model, device=gpu), 0)
    params = build_affinity_params(net, dt, branches)
    K = len(branches)
    gen = torch.Generator(device=gpu).manual_seed(2)
    for N, n_prev, n_curr in CASES:
        B = len(n_prev)
        a, b = (torch.randn((B, K, N, 64), generator=gen, device=gpu).to(dt)
                for _ in range(2))
        mp, mc = masks(N, n_prev, gpu), masks(N, n_curr, gpu)
        before = (fused_affinity.k_launches[K], fused_affinity.avg_launches)
        with f32_parity():
            got = fused_affinity(a, b, mp, mc, params, avg=avg)
            want = affinity_plain(a, b, mp, mc, params, avg=avg)
        torch.cuda.synchronize()
        assert (fused_affinity.k_launches[K], fused_affinity.avg_launches) \
            == (before[0] + 1, before[1] + int(avg))
        tol = 1e-4 if dtype == "float32" else 2.0 ** -5
        for name, x, y in zip(got._fields, got, want):
            scale = max(1.0, y.float().abs().max().item())
            err = (x.float() - y.float()).abs().max().item()
            assert err <= tol * scale, (K, avg, N, name, err)
        pm = mp[:, :, None] & mc[:, None, :]
        assert (got.link[~pm] == 0).all()


def variant_model(**sections):
    """tiny_debug's model with fields of its sub-configs replaced:
    ``affinity={"correlation_ops": ...}`` and the like."""
    m = tiny_debug().model
    return dataclasses.replace(m, **{
        k: dataclasses.replace(getattr(m, k), **v)
        for k, v in sections.items()})


# (correlation ops, pool, softmax mode): each op, several ops, each pool
# and mode, and one instance that mixes them.
INSTANCES = [(("mul",), "max", "dual"), (("diff",), "max", "dual"),
             (("cosine",), "max", "dual"), (("subabs", "mul"), "max", "dual"),
             (("mul", "subabs", "diff", "cosine"), "max", "dual"),
             (("subabs",), "mean", "dual"), (("subabs",), "softmax", "dual"),
             (("subabs",), "max", "single"), (("subabs",), "max", "none"),
             (("cosine", "mul"), "softmax", "none")]
# N above 64: holed, empty and full frames at N=100 and N=128, and at
# N=192, where launch 2 streams its lines from device memory (the
# revival's 2N at max_dets 96).
WIDE_CASES = [(100, [(0, 7, 33, 64, 65, 99), 0, 100],
               [tuple(range(1, 100, 3)), 57, 0]),
              (128, [128, (5, 64, 96, 127), 0],
               [tuple(range(0, 128, 2)), 0, (31, 32, 63, 64, 127)]),
              (192, [tuple(range(0, 192, 3)), 0, 192],
               [(0, 95, 96, 191), 120, 0]),
              (384, [tuple(range(1, 384, 5)), 384, 0],
               [(0, 255, 256, 383), 300, 384])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ops,pool,mode", INSTANCES)
def test_kernel_ops_pools_modes_match_plain(gpu, dtype, ops, pool, mode):
    """The correlation ops (W1 of len(ops) x D rows), the pools and the
    softmax modes against the plain version at every case, N=100 and
    N=128 among them, each counted under its instance."""
    dt = getattr(torch, dtype)
    net = init_random_(TrackingNet(variant_model(
        affinity={"correlation_ops": ops, "softmax_mode": mode},
        new_end={"pool": pool}), device=gpu), 0)
    params = build_affinity_params(net, dt)
    assert params["w1"].shape[1] == 64 * len(ops)
    gen = torch.Generator(device=gpu).manual_seed(4)
    for N, n_prev, n_curr in CASES + WIDE_CASES:
        B = len(n_prev)
        a, b = (torch.randn((B, 3, N, 64), generator=gen, device=gpu).to(dt)
                for _ in range(2))
        mp, mc = masks(N, n_prev, gpu), masks(N, n_curr, gpu)
        before = (fused_affinity.op_launches[ops],
                  fused_affinity.pool_launches[pool],
                  fused_affinity.mode_launches[mode])
        kw = dict(ops=ops, pool=pool, softmax_mode=mode)
        with f32_parity():
            got = fused_affinity(a, b, mp, mc, params, **kw)
            want = affinity_plain(a, b, mp, mc, params, **kw)
        torch.cuda.synchronize()
        assert (fused_affinity.op_launches[ops],
                fused_affinity.pool_launches[pool],
                fused_affinity.mode_launches[mode]) == tuple(
                    x + 1 for x in before)
        tol = 1e-4 if dtype == "float32" else 2.0 ** -5
        for name, x, y in zip(got._fields, got, want):
            scale = max(1.0, y.float().abs().max().item())
            err = (x.float() - y.float()).abs().max().item()
            assert err <= tol * scale, (ops, pool, mode, N, name, err)
        pm = mp[:, :, None] & mc[:, None, :]
        assert (got.link[~pm] == 0).all()
        if mode == "none":
            assert torch.equal(got.link_norm, got.link)


def test_kernel_refuses_n_above_128(gpu):
    """Past its limit (``MAX_N`` = 512 since launch 2 streams its lines
    above 128) the kernel refuses N by name; at 129 it launches the
    streaming instance."""
    net = init_random_(TrackingNet(tiny_debug().model, device=gpu), 0)
    params = build_affinity_params(net, torch.float32)
    a = torch.zeros((1, 3, 513, 64), device=gpu)
    m = torch.ones((1, 513), dtype=torch.bool, device=gpu)
    with pytest.raises(ValueError, match="N=513"):
        fused_affinity(a, a, m, m, params)
    before = fused_affinity.wide_launches
    fused_affinity(a[:, :, :129].contiguous(), a[:, :, :129].contiguous(),
                   m[:, :129].contiguous(), m[:, :129].contiguous(), params)
    torch.cuda.synchronize()
    assert fused_affinity.wide_launches == before + 1


# Model variants: fusion A with the T-Net, mul, the softmax pool and the
# single mode; fusion B with all four ops, the mean pool and no softmax;
# one score branch (keep_single off) on cosine; and two the kernel does
# not cover (new/end v1, a 3-layer link head: the module path).
VARIANTS = {
    "A_tnet_mul": dict(fusion={"variant": "A"}, point={"use_tnet": True},
                       affinity={"correlation_ops": ("mul",),
                                 "softmax_mode": "single"},
                       new_end={"pool": "softmax"}),
    "B_all_ops": dict(fusion={"variant": "B"},
                      affinity={"correlation_ops": ("mul", "subabs", "diff",
                                                    "cosine"),
                                "softmax_mode": "none"},
                      new_end={"pool": "mean"}),
    "no_single_cosine": dict(fusion={"keep_single": False},
                             affinity={"correlation_ops": ("cosine",)}),
    "v1": dict(new_end={"version": 1}),
    "layers3": dict(affinity={"num_layers": 3})}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_tiny_variant_cpu_equals_gpu(gpu, name):
    """tiny_debug float32 variants: the same ids on the CPU (plain
    versions) and the GPU; the kernel runs for the variants it covers,
    the module path (no launch) for the others."""
    from mmmot_tpu_torch.kernels.affinity import (kernel_supported,
                                                  reset_launches)

    mcfg = variant_model(**VARIANTS[name])
    images, clouds, boxes, det_mask, proj = tiny_frames()
    T, N = det_mask.shape
    ids = []
    for dev in ("cpu", gpu):
        net = init_random_(TrackingNet(mcfg, device=dev), 1)
        with torch.no_grad():
            for head in (net.new_end.new_mlp, net.new_end.end_mlp):
                head.dense_1.bias.fill_(-3.0)
        reset_launches()
        out = track_sequence_from_frames(
            TrackingModule(net), images, clouds, boxes, det_mask, proj,
            (32, 32), mcfg.point.point_len, compact_capacity=T * N,
            crop_window=128)
        ids.append(out["ids"].cpu())
        launched = fused_affinity.launches
        assert launched == (int(kernel_supported(mcfg))
                            if dev != "cpu" else 0), (dev, launched)
    assert torch.equal(ids[0], ids[1])


def test_kernel_refuses_four_branches(gpu):
    net = init_random_(TrackingNet(tiny_debug().model, device=gpu), 0)
    params = build_affinity_params(net, torch.float32)
    a = torch.zeros((1, 4, 8, 64), device=gpu)
    m = torch.ones((1, 8), dtype=torch.bool, device=gpu)
    with pytest.raises(ValueError, match="K=4"):
        fused_affinity(a, a, m, m, params)


def tiny_frames():
    gen = torch.Generator().manual_seed(3)
    T, N, H, W, M = 6, 8, 96, 320, 512
    images = torch.randint(0, 256, (T, H, W, 3), generator=gen,
                           dtype=torch.uint8)
    clouds = torch.rand((T, M, 4), generator=gen) * torch.tensor(
        [50.0, 6.0, 68.0, 1.0]) + torch.tensor([-25.0, -3.0, 2.0, 0.0])
    l = torch.rand((T, N), generator=gen) * (W - 60)
    t = torch.rand((T, N), generator=gen) * (H - 30)
    boxes = torch.stack([l, t, l + 50, t + 25], -1)
    det_mask = torch.rand((T, N), generator=gen) < 0.7
    proj = torch.tensor([[180.0, 0, W / 2, 0], [0, 180.0, H / 2, 0],
                         [0, 0, 1, 0]])
    return images, clouds, boxes, det_mask, proj


@pytest.mark.parametrize("model,solver,dead", [
    (dict(score_fusion="fused-only"), "sinkhorn", None),
    (dict(use_lidar=False), "sinkhorn", None),
    (dict(use_image=False), "greedy", None),
    ({}, "auction", "camera"), ({}, "sinkhorn", "lidar")])
def test_tiny_single_branch_cpu_equals_gpu(gpu, model, solver, dead):
    """tiny_debug float32 with one score branch, another solver or a
    dead sensor: the same ids on the CPU (plain versions) and the GPU."""
    cfg = tiny_debug()
    mcfg = dataclasses.replace(cfg.model, **model)
    images, clouds, boxes, det_mask, proj = tiny_frames()
    T, N = det_mask.shape
    ids = []
    for dev in ("cpu", gpu):
        net = init_random_(TrackingNet(mcfg, device=dev), 1)
        with torch.no_grad():
            for head in (net.new_end.new_mlp, net.new_end.end_mlp):
                head.dense_1.bias.fill_(-3.0)
        out = track_sequence_from_frames(
            TrackingModule(net, AssocConfig(solver=solver)), images, clouds,
            boxes, det_mask, proj, (32, 32), cfg.model.point.point_len,
            compact_capacity=T * N, crop_window=128, dead_sensor=dead)
        ids.append(out["ids"].cpu())
    assert torch.equal(ids[0], ids[1])


def test_tiny_tracking_cpu_equals_gpu(gpu):
    cfg = tiny_debug()
    gen = torch.Generator().manual_seed(3)
    T, N, H, W, M = 6, 8, 96, 320, 512
    images = torch.randint(0, 256, (T, H, W, 3), generator=gen,
                           dtype=torch.uint8)
    clouds = torch.rand((T, M, 4), generator=gen) * torch.tensor(
        [50.0, 6.0, 68.0, 1.0]) + torch.tensor([-25.0, -3.0, 2.0, 0.0])
    l = torch.rand((T, N), generator=gen) * (W - 60)
    t = torch.rand((T, N), generator=gen) * (H - 30)
    boxes = torch.stack([l, t, l + 50, t + 25], -1)
    det_mask = torch.rand((T, N), generator=gen) < 0.7
    proj = torch.tensor([[180.0, 0, W / 2, 0], [0, 180.0, H / 2, 0],
                         [0, 0, 1, 0]])
    ids = []
    for dev in ("cpu", gpu):
        net = init_random_(TrackingNet(cfg.model, device=dev), 1)
        with torch.no_grad():
            for head in (net.new_end.new_mlp, net.new_end.end_mlp):
                head.dense_1.bias.fill_(-3.0)
        out = track_sequence_from_frames(
            TrackingModule(net), images, clouds, boxes, det_mask, proj,
            (32, 32), cfg.model.point.point_len, compact_capacity=T * N,
            crop_window=128)
        ids.append(out["ids"].cpu())
    assert torch.equal(ids[0], ids[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_syncs_only_through_host_read(gpu, dtype):
    """A tiny two-sequence window under CUDA's sync debug mode "error":
    every device-to-host sync other than ``utils/profiling.py::
    host_read``'s (which lifts the mode around its own read) raises, so
    ``COUNTS["host_syncs"]`` counts every sync of the window; it counts
    one check every ``SYNC_EVERY`` rounds, one before the first and one
    for the completion.  The ids equal the same window's without the
    mode."""
    from mmmot_tpu_torch.assoc.auction import SYNC_EVERY, auction_lap
    from mmmot_tpu_torch.tracker.sequence import \
        track_sequences_from_frames_batched
    from mmmot_tpu_torch.utils.profiling import COUNTS

    cfg = tiny_debug()
    model = dataclasses.replace(cfg.model, compute_dtype=dtype)
    gen = torch.Generator().manual_seed(4)
    S, T, N, H, W, M = 2, 6, 8, 96, 320, 512
    images = torch.randint(0, 256, (S, T, H, W, 3), generator=gen,
                           dtype=torch.uint8)
    clouds = torch.rand((S, T, M, 4), generator=gen) * torch.tensor(
        [50.0, 6.0, 68.0, 1.0]) + torch.tensor([-25.0, -3.0, 2.0, 0.0])
    l = torch.rand((S, T, N), generator=gen) * (W - 60)
    t = torch.rand((S, T, N), generator=gen) * (H - 30)
    boxes = torch.stack([l, t, l + 50, t + 25], -1)
    det_mask = torch.rand((S, T, N), generator=gen) < 0.7
    proj = torch.tensor([[180.0, 0, W / 2, 0], [0, 180.0, H / 2, 0],
                         [0, 0, 1, 0]])
    frames = [x.to(gpu) for x in (images, clouds, boxes, det_mask, proj)]
    net = init_random_(TrackingNet(model, device=gpu), 1)
    with torch.no_grad():
        for head in (net.new_end.new_mlp, net.new_end.end_mlp):
            head.dense_1.bias.fill_(-3.0)
    module = TrackingModule(net)

    def window():
        return track_sequences_from_frames_batched(
            module, *frames, (32, 32), model.point.point_len,
            compact_capacity=T * N, extract_chunk=16, crop_window=128)

    want = window()["ids"].cpu()            # builds the kernel
    torch.cuda.synchronize()
    r0, c0 = auction_lap.rounds, COUNTS["host_syncs"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = window()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rounds = auction_lap.rounds - r0
    assert rounds > 0
    assert COUNTS["host_syncs"] - c0 == rounds // SYNC_EVERY + 2
    assert torch.equal(out["ids"].cpu(), want)


def test_tiny_train_step_cpu_equals_gpu(gpu):
    """One tiny_debug float32 training step (sgd with the clip active,
    compact-first at capacity 12; TF32 off) on the CPU and on the GPU,
    held by ``train.parity.step_agreement``: the loss and metrics within
    1e-4 relative, every gradient and post-step tensor within 1e-3 of its
    largest magnitude (the biases that feed a train-mode BatchNorm to
    the scale of their layer's weight gradient)."""
    from mmmot_tpu_torch.train.parity import step_agreement

    worst = step_agreement(gpu)["max_rel_err"]
    assert max(worst.values()) <= 1e-3, worst


@pytest.mark.parametrize("model", [dict(use_lidar=False),
                                   dict(score_fusion="fused-only")])
def test_single_branch_train_step_cpu_equals_gpu(gpu, model):
    """The same step for the tiny ``img_only`` net (no PointNet, no
    fusion weights) and the tiny ``fusion_C`` net (one link head)."""
    from mmmot_tpu_torch.train.parity import step_agreement

    worst = step_agreement(gpu, model)["max_rel_err"]
    assert max(worst.values()) <= 1e-3, worst


def test_deployed_tracker_launches_the_kernel_once_per_step(gpu, tmp_path):
    """A tiny serve_step artifact served on the GPU: one fused-kernel
    launch per ``step``, and the ids of the CPU's plain versions."""
    import numpy as np

    from mmmot_tpu_torch.deploy import DeployedTracker, export_serve_step

    cfg = tiny_debug()
    module = TrackingModule(init_random_(TrackingNet(cfg.model,
                                                     device="cpu"), 4))
    export_serve_step(str(tmp_path), cfg, module, (64, 96), 300)
    rng = np.random.default_rng(0)
    proj = np.array([[50.0, 0, 48, 0], [0, 50.0, 32, 0], [0, 0, 1, 0]],
                    np.float32)
    trackers = {d: DeployedTracker.load(str(tmp_path), device=d)
                for d in ("cpu", gpu)}
    for t in range(4):
        image = rng.integers(0, 255, (64, 96, 3)).astype(np.uint8)
        cloud = np.stack([rng.uniform(-8, 8, 300), rng.uniform(-2, 2, 300),
                          rng.uniform(2, 30, 300), np.zeros(300)],
                         -1).astype(np.float32)
        boxes = np.array([[4 + 2 * t + 20 * i, 8 + 6 * i, 20 + 2 * t + 20 * i,
                           28 + 6 * i] for i in range(3)], np.float32)
        ids = {}
        for d, trk in trackers.items():
            before = fused_affinity.launches
            with f32_parity():
                ids[d] = trk.step(image, cloud, boxes, proj)[0]
            assert fused_affinity.launches - before == (d == gpu)
        assert ids["cpu"] == ids[gpu]


# (n, H, W, Cin, Cout): conv_0's Cin=3 and a narrow Cin (the stem
# instance), Cin multiples of 32 (the main instance, TMA stages of 32, 64
# and 128 channels; Cin=96 takes three 32-channel stages a tap), pixel
# counts that leave a ragged last tile, Cout below and above one
# 64-channel tile (72: a second tile of 8 channels, 8-byte stores), a 7x7
# map (odd: its pool drops the last row and column), conv_1's shape (64
# channels at 224x224, 64-byte swizzle, the halo instance) and the halo
# instance at 32 and 128 channels a stage (a ragged last row of tiles) and
# with 128 output channels; the space-to-depth stem's conv_0 (Cin=12: K
# 108 padded to 128, 12-byte pixels) at 112x112 and at a ragged 9x11.
# Each runs with and without the fused pool.
INT8_SHAPES = [(3, 7, 9, 3, 8), (2, 5, 6, 8, 16), (1, 13, 11, 64, 64),
               (2, 14, 14, 512, 512), (1, 3, 3, 32, 72), (4, 28, 28, 128, 256),
               (2, 7, 7, 512, 512), (2, 9, 12, 96, 72),
               (1, 224, 224, 64, 64), (2, 10, 16, 32, 64),
               (1, 20, 16, 128, 64), (2, 12, 16, 64, 128), (1, 8, 8, 32, 128),
               (2, 112, 112, 12, 64), (1, 9, 11, 12, 8)]


@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("shape", INT8_SHAPES)
def test_int8_conv_matches_plain(gpu, shape, pool):
    """The int8 conv kernel against its plain version (a float64 conv,
    and with ``pool`` its 2x2 VALID max-pool): int8 outputs exactly
    equal, (a) on full-range int8 inputs with the requant spread around
    [0, 127] (clamped at both ends) and ``m`` negative on every third
    channel (a max taken before the requant would differ there), (b) on
    small inputs with ``m`` 0.5 and ``b`` 0, where every odd accumulator
    is an exact .5 tie that must round to even; one launch of the
    instance ``conv_instance`` names counted per call."""
    from mmmot_tpu_torch.kernels.int8_conv import (
        conv_instance, int8_conv3x3_requant, int8_conv3x3_requant_plain,
        int8_conv3x3_requant_pool_plain, launch_counts, pack_weights)

    n, H, W, cin, cout = shape
    gen = torch.Generator(device=gpu).manual_seed(cin + cout)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=gpu,
                             dtype=torch.int8)

    acc_std = 73.3 ** 2 * (9 * cin) ** 0.5    # of uniform int8 products
    m = 40.0 / acc_std * (0.5 + torch.rand(cout, generator=gen, device=gpu))
    m[2::3] *= -1.0
    b = 60.0 * torch.rand(cout, generator=gen, device=gpu) - 10.0
    # (b): acc / 2 plus an integer, centred in [0, 127] (E[acc] = 4.5 Cin).
    cases = [(ints(-127, 128, (n, H, W, cin)),
              ints(-127, 128, (3, 3, cin, cout)), m, b),
             (ints(0, 3, (n, H, W, cin)), ints(0, 2, (3, 3, cin, cout)),
              torch.full_like(m, 0.5),
              torch.full_like(b, 60.0 - round(2.25 * cin)))]
    plain = (int8_conv3x3_requant_pool_plain if pool
             else int8_conv3x3_requant_plain)
    out_hw = (H // 2, W // 2) if pool else (H, W)
    for x, w, mm, bb in cases:
        wq = pack_weights(w)
        before = launch_counts()
        got = int8_conv3x3_requant(x, wq, mm, bb, pool=pool)
        torch.cuda.synchronize()
        after = launch_counts()
        instance = conv_instance(cin)
        assert {k: after[k] - before[k] for k in after} == {
            "launches": 1, "main_launches": int(instance == "main"),
            "stem_launches": int(instance == "stem"),
            "pool_launches": int(pool)}
        want = plain(x, wq, mm, bb)
        assert got.shape == (n, *out_hw, cout) and got.dtype == torch.int8
        assert torch.equal(got, want), (got.int() - want.int()).abs().max()
        assert ((got > 0) & (got < 127)).float().mean() > 0.2


def test_int8_trunk_cpu_equals_gpu(gpu):
    """The tiny int8 trunk, calibrated once on the CPU and moved to the
    GPU: every stage map equal bit for bit, 8 kernel launches (VGG11's
    convs; the 5 pools fused into the convs before them), the appearance embeddings within float32 tolerance (the
    tail's matmuls sum in other orders) and masked rows exactly 0."""
    import copy

    from mmmot_tpu_torch.kernels.int8_conv import launch_counts
    from mmmot_tpu_torch.models.quantize import (quantized_appearance_apply,
                                                 quantized_trunk_stages,
                                                 with_int8_appearance)

    cfg = tiny_debug()
    cpu = init_random_(TrackingNet(cfg.model, device="cpu"), 2)
    crops = torch.randn((12, 32, 32, 3), generator=torch.Generator()
                        .manual_seed(0))
    with_int8_appearance(cpu, crops)
    net = TrackingNet(cfg.model, device=gpu)
    net.load_state_dict(cpu.state_dict())
    net.quant_int8 = copy.deepcopy(cpu.quant_int8).to(gpu)
    before = launch_counts()
    got = quantized_trunk_stages(net.quant_int8, crops.to(gpu))
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["launches"] == before["launches"] + 8
    assert after["pool_launches"] == before["pool_launches"] + 5
    for (g, _), (w, _) in zip(got, quantized_trunk_stages(cpu.quant_int8,
                                                          crops)):
        assert torch.equal(g.cpu(), w)
    mask = torch.arange(12) < 10
    with f32_parity():
        fg = quantized_appearance_apply(net.quant_int8, net.appear_net,
                                        crops.to(gpu), mask.to(gpu))
    fc = quantized_appearance_apply(cpu.quant_int8, cpu.appear_net, crops,
                                    mask)
    torch.testing.assert_close(fg.cpu(), fc, rtol=1e-4, atol=1e-5)
    assert (fg[10:] == 0).all()


# Conv outputs [C, H] of VGG16's 13 layers at 224² (conv_0/1; 2/3; 4-6;
# 7-9; 10-12), the space-to-depth stem's conv_0 (64 channels at 112²),
# and two odd widths (20 channels: bfloat16 takes the kernel's
# one-channel instance; 6: float32 does too) on odd maps (the pool drops
# the last row and column).  Each runs with and without the pool.
BN_RELU_SHAPES = [(64, 224), (128, 112), (256, 56), (512, 28), (512, 14),
                  (64, 112), (20, 15), (6, 9)]


def bn_relu_case(C, gen, dev, dtype):
    """A ``Conv3x3`` (its bias drawn) and an eval ``MaskedBatchNorm`` with
    running statistics far from 0 and 1, scales of both signs (negative
    on every third channel) and shifts far from 0; channel 1 has mean 0,
    shift -0.0 and a negative scale, so a conv output of exactly -bias
    there gives -0.0 before the ReLU; channel 2 a subnormal scale and a
    zero shift, so its outputs are subnormal."""
    from mmmot_tpu_torch.models.layers import Conv3x3, MaskedBatchNorm

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    conv = Conv3x3(C, C, dtype).to(dev).eval()
    bn = MaskedBatchNorm(C, dtype, dim=1).to(dev).eval()
    with torch.no_grad():
        conv.bias.copy_(10.0 * rnd(C))
        bn.running_mean.copy_(40.0 * rnd(C) + 25.0)
        bn.running_var.copy_(torch.exp(6.0 * rnd(C)))
        bn.weight.copy_(3.0 * rnd(C))
        bn.weight[::3] = -bn.weight[::3].abs()
        bn.bias.copy_(5.0 * rnd(C) + 2.0)
        bn.running_mean[1] = 0.0
        bn.bias[1] = -0.0
        bn.weight[1] = -1.5
        bn.weight[2] = 1e-39
        bn.bias[2] = 0.0
    return conv, bn


@torch.no_grad()
def bn_relu_input(n, C, H, conv, bn, gen, dev, dtype):
    """A conv output [n, C, H, H] (channels-last) around each channel's
    BatchNorm mean (less the conv bias), so the ReLU keeps about half;
    planted: ±0, float32 and bfloat16 subnormals, ±inf, NaN, and -bias on
    channel 1 (see ``bn_relu_case``) beside a +0 in the same windows."""
    sd = bn.running_var.sqrt()
    y = (bn.running_mean - conv.bias)[:, None, None] + 2.0 * sd[
        :, None, None] * torch.randn((n, C, H, H), generator=gen, device=dev)
    flat = y.view(-1)
    k = flat.numel()
    idx = torch.randint(0, k, (9, max(1, k // 97)), generator=gen,
                        device=dev)
    for row, v in zip(idx, (0.0, -0.0, 1e-40, -1e-40, 1e-39, float("inf"),
                            -float("inf"), float("nan"), -3e-41)):
        flat[row] = v
    y = y.to(dtype)
    y[:, 1, :2, :2] = (-conv.bias[1]).to(dtype)
    y[:, 1, :1, :1] = 0.0
    return y.contiguous(memory_format=torch.channels_last)


def bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("shape", BN_RELU_SHAPES)
def test_fused_bn_relu_bit_equal_to_chain(gpu, shape, pool, dtype):
    """``fused_bn_relu`` against the trunk's op chain on the same conv
    output (``Conv3x3.forward``'s bias add, the eval ``MaskedBatchNorm``,
    ``torch.relu``, ``F.max_pool2d(x, 2)``): equal bits, planted ±0,
    subnormals, ±inf and NaN included, for 1, 3 and 40 crops; one launch
    counted per call, with the pool in ``pool_launches``."""
    from torch.nn import functional as F

    from mmmot_tpu_torch.kernels.bn_relu import fused_bn_relu, launch_counts

    dt = getattr(torch, dtype)
    C, H = shape
    gen = torch.Generator(device=gpu).manual_seed(C * 1000 + H)
    conv, bn = bn_relu_case(C, gen, gpu, dt)
    for n in (1, 3, 40):
        y = bn_relu_input(n, C, H, conv, bn, gen, gpu, dt)
        conv.product = lambda _x, y=y: y     # the conv's output, as planted
        with torch.inference_mode():
            want = torch.relu(bn(conv(None)))
            if pool:
                want = F.max_pool2d(want, 2)
            before = launch_counts()
            got = fused_bn_relu(y, conv.bias, bn, pool)
            torch.cuda.synchronize()
        after = launch_counts()
        assert {k: after[k] - before[k] for k in after} == {
            "launches": 1, "pool_launches": int(pool)}
        assert got.shape == want.shape and got.dtype == dt
        assert got.is_contiguous(memory_format=torch.channels_last)
        same = bits(got) == bits(want)
        assert same.all(), (n, (~same).sum().item(), got[~same][:4],
                            want[~same][:4])
        assert (want > 0).float().mean() > 0.2
        assert torch.isnan(want).any() and (want == 0).any()
        if not pool:    # -0.0 reaches the ReLU on channel 1
            with torch.inference_mode():
                assert bn(conv(None))[:, 1, :2, :2].signbit().any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s2d", [False, True])
def test_appearance_net_fused_equals_chain(gpu, s2d, dtype):
    """A whole flagship ``AppearanceNet`` (VGG16-bn, skip pooling, 224²
    crops; with ``s2d`` the space-to-depth stem) in eval mode: under
    ``inference_mode`` every conv's epilogue takes ``fused_bn_relu``
    (13 launches, 5 pooled; 4 with the stem, which replaces the first
    pool), with gradients on it takes the op chain (no launch), and the
    embeddings are bit-equal.  In train mode nothing launches."""
    from mmmot_tpu_torch.config import full_mmmot
    from mmmot_tpu_torch.kernels.bn_relu import launch_counts
    from mmmot_tpu_torch.models.appearance import AppearanceNet
    from mmmot_tpu_torch.models.layers import MaskedBatchNorm

    dt = getattr(torch, dtype)
    acfg = dataclasses.replace(full_mmmot().model.appearance, s2d_stem=s2d)
    gen = torch.Generator(device=gpu).manual_seed(5)
    net = AppearanceNet(acfg, dt).to(gpu)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, MaskedBatchNorm):
                m.running_mean.normal_(0.0, 0.3, generator=gen)
                m.running_var.normal_(generator=gen).exp_()
                m.weight.normal_(generator=gen)
                m.bias.normal_(1.0, 0.1, generator=gen)
    crops = torch.randn((6, 224, 224, 3), generator=gen, device=gpu)
    mask = torch.arange(6, device=gpu) < 5
    net.eval()

    def run():
        before = launch_counts()
        out = net(crops, mask)
        torch.cuda.synchronize()
        after = launch_counts()
        return out.detach(), {k: after[k] - before[k] for k in after}

    with torch.inference_mode():
        fused, n_fused = run()
    chain, n_chain = run()
    assert n_fused == {"launches": 13, "pool_launches": 4 if s2d else 5}
    assert n_chain == {"launches": 0, "pool_launches": 0}
    assert torch.equal(bits(fused), bits(chain))
    net.train()
    with torch.no_grad():
        _, n_train = run()
    assert n_train == {"launches": 0, "pool_launches": 0}


def test_no_batch_norm_trunk_takes_the_chain(gpu):
    """The VGG variant without BatchNorm, in eval mode under
    ``inference_mode`` on the GPU: every conv takes the op chain
    (``Conv3x3.forward``, ``relu``, ``F.max_pool2d``), so the kernel's
    counters stay 0, and its embeddings equal the CPU's within float32
    tolerance."""
    from mmmot_tpu_torch.kernels.bn_relu import launch_counts
    from mmmot_tpu_torch.models.appearance import AppearanceNet

    acfg = dataclasses.replace(tiny_debug().model.appearance,
                               batch_norm=False)
    torch.manual_seed(6)
    cpu = AppearanceNet(acfg, torch.float32).eval()
    net = AppearanceNet(acfg, torch.float32).to(gpu).eval()
    net.load_state_dict(cpu.state_dict())
    crops = torch.randn((5, 32, 32, 3), generator=torch.Generator()
                        .manual_seed(7))
    before = launch_counts()
    with torch.inference_mode(), f32_parity():
        got = net(crops.to(gpu))
        torch.cuda.synchronize()
        want = cpu(crops)
    assert launch_counts() == before
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
