"""Checks of the port that need an NVIDIA GPU (marker ``cuda``): the
fused affinity CUDA kernel against its plain version, and CPU/GPU
agreement of the tiny tracker.  They skip without a GPU.  This file
imports neither JAX nor the JAX package, so it runs on the GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from mmmot_tpu_torch.config import tiny_debug
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
