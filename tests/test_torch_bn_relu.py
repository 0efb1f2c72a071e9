"""The conv-epilogue kernel's wrapper (``kernels/bn_relu.py``) and the VGG
trunk's dispatch to it, on the CPU: the module imports and runs with no
CUDA compiler, its plain version is the trunk's op chain bit for bit,
and the trunk never launches it on the CPU, in train mode, with
gradients on, or without BatchNorm.  The kernel itself is held to the
chain on the GPU (``tests/test_torch_cuda.py``)."""

import copy

import pytest
import torch
from torch.nn import functional as F

from mmmot_tpu_torch.config import tiny_debug
from mmmot_tpu_torch.kernels import bn_relu
from mmmot_tpu_torch.kernels.bn_relu import (bn_relu_plain, fused_bn_relu,
                                             launch_counts)
from mmmot_tpu_torch.models.appearance import VGGBackbone
from mmmot_tpu_torch.models.layers import Conv3x3, MaskedBatchNorm

ZERO = {"launches": 0, "pool_launches": 0}


def conv_bn(C, dtype, seed=0):
    """A ``Conv3x3`` and an eval ``MaskedBatchNorm`` with drawn bias,
    running statistics, scales of both signs and shifts."""
    gen = torch.Generator().manual_seed(seed)
    conv = Conv3x3(C, C, dtype).eval()
    bn = MaskedBatchNorm(C, dtype, dim=1).eval()
    with torch.no_grad():
        for t, s, m in ((conv.bias, 3.0, 0.0), (bn.running_mean, 2.0, 1.0),
                        (bn.weight, 1.5, 0.0), (bn.bias, 1.0, 0.5)):
            t.copy_(m + s * torch.randn(C, generator=gen))
        bn.running_var.copy_(torch.exp(torch.randn(C, generator=gen)))
    return conv, bn


def test_module_imports_and_runs_without_nvcc():
    """Importing the wrapper, and running it on CPU tensors, builds
    nothing (there is no nvcc here) and counts no launch."""
    conv, bn = conv_bn(8, torch.float32)
    before = launch_counts()
    with torch.inference_mode():
        fused_bn_relu(torch.randn(2, 8, 6, 6), conv.bias, bn, True)
    assert launch_counts() == before
    assert bn_relu._library.cache_info().currsize == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", [False, True])
def test_plain_is_the_op_chain(pool, dtype):
    """``fused_bn_relu`` on CPU tensors (its plain version) equals the
    trunk's chain, ``Conv3x3.forward``, the eval BatchNorm, ``relu`` and
    ``F.max_pool2d``, bit for bit, on an odd map."""
    dt = getattr(torch, dtype)
    conv, bn = conv_bn(16, dt, seed=1)
    x = torch.randn(3, 16, 11, 9, generator=torch.Generator().manual_seed(2))
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        want = torch.relu(bn(conv(x)))
        if pool:
            want = F.max_pool2d(want, 2)
        got = fused_bn_relu(conv.product(x), conv.bias, bn, pool)
    assert got.dtype == dt and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(bn_relu_plain(conv.product(x), conv.bias, bn, pool),
                       want)


def test_conv_product_is_forward_without_bias():
    """``Conv3x3.product`` is the conv that ``forward`` adds its bias to."""
    conv, _ = conv_bn(8, torch.bfloat16, seed=3)
    x = torch.randn(2, 8, 7, 7)
    with torch.no_grad():
        assert torch.equal(conv.product(x) + conv.bias.to(torch.bfloat16)[
            :, None, None], conv(x))


@pytest.mark.parametrize("case", ["eval_inference", "eval_grad", "train",
                                  "no_batch_norm", "train_remat"])
def test_trunk_takes_the_chain_off_the_gpu(case):
    """The tiny VGG trunk on the CPU: whatever the mode, each conv's
    epilogue is the op chain (stage maps equal to a copy's modules run
    one by one in the same mode) and the kernel's counters stay 0."""
    acfg = tiny_debug().model.appearance
    bb = VGGBackbone(acfg.depth, acfg.width_mult, torch.float32,
                     remat=case == "train_remat",
                     batch_norm=case != "no_batch_norm")
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in bb.modules():
            if isinstance(m, MaskedBatchNorm):
                m.running_mean.normal_(0.0, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    bb.train(case.startswith("train"))
    ref = copy.deepcopy(bb)
    x = torch.randn(3, 3, 32, 32, generator=gen)
    mask = torch.tensor([True, True, False])

    def ctx():
        return (torch.inference_mode() if case == "eval_inference"
                else torch.enable_grad())

    before = launch_counts()
    with ctx():
        got = bb(x, mask)
    assert {k: v - before[k] for k, v in launch_counts().items()} == ZERO
    y, want = x, []
    with ctx():
        for op in ref.ops:
            if op[0] == "stage":
                want.append(y)
            elif op[0] == "pool":
                y = F.max_pool2d(y, 2)
            else:
                y = getattr(ref, f"conv_{op[1]}")(y)
                if ref.batch_norm:
                    y = getattr(ref, f"bn_{op[1]}")(y, mask)
                y = torch.relu(y)
    assert len(got) == len(want)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("bad", ["train_bn", "dtype", "rank"])
def test_wrapper_refuses(bad):
    """What the kernel does not take raises before any launch: a
    BatchNorm in train mode, a float16 map, a map that is not 4-D."""
    conv, bn = conv_bn(8, torch.float32)
    x = torch.randn(2, 8, 4, 4)
    if bad == "train_bn":
        bn.train()
    elif bad == "dtype":
        x = x.half()
    else:
        x = x[0]
    err = TypeError if bad == "dtype" else ValueError
    with pytest.raises(err):
        fused_bn_relu(x, conv.bias, bn)


def test_tracking_net_extract_unchanged_on_cpu():
    """The tiny net's embeddings under ``inference_mode`` (the tracker's
    mode) equal the same eval forward with gradients on, and nothing
    launches: on the CPU both take the chain."""
    from mmmot_tpu_torch.models.tracking_net import TrackingNet, init_random_

    net = init_random_(TrackingNet(tiny_debug().model, device="cpu"),
                       3).eval()
    crops = torch.randn(4, 32, 32, 3, generator=torch.Generator()
                        .manual_seed(6))
    before = launch_counts()
    with torch.inference_mode():
        a = net.appear_net(crops)
    b = net.appear_net(crops).detach()
    assert launch_counts() == before
    assert torch.equal(a, b)
