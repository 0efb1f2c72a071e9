"""ImageNet-trained VGG initialisation from a local torchvision
checkpoint: port of ``mmmot_tpu/compat/pretrained.py``.

The reference trains from ``torchvision.models.vgg16_bn(pretrained=True)``.
Nothing here downloads: the trunk comes from a local ``.pth`` file
(torchvision's ``vgg16_bn`` state dict, or any checkpoint holding a
VGG-bn trunk, found by its shapes when the ``features.N`` prefix is
absent).

    report = load_pretrained_vgg(net, "vgg16_bn.pth")
    # or: python -m mmmot_tpu_torch.cli.train --config ... \\
    #         --pretrained-vgg vgg16_bn.pth
"""

from __future__ import annotations

from typing import Dict

import torch

# torchvision's classifier: in every vgg*_bn checkpoint, not used (the
# reference's appear_net reads ``.features`` only).
_EXPECTED_UNUSED_PREFIXES = ("classifier.",)


def load_pretrained_vgg(net, pth_path: str, depth: int = 16,
                        allow_pickle: bool = False) -> Dict:
    """Copy a torchvision ``vgg<depth>_bn`` checkpoint into ``net``'s
    appearance trunk (``appear_net.backbone``), in place, each tensor
    cast to the net's dtype for it.

    Returns the report: ``converted`` (the port's tensor names that were
    filled) and ``unexpected_unused`` (checkpoint keys neither mapped nor
    torchvision's classifier).  Raises ``ValueError`` when the checkpoint
    has no VGG-bn trunk or a tensor does not fit the net (a width or
    depth mismatch: the config does not match the checkpoint)."""
    from mmmot_tpu_torch.compat.mappings import (detect_vgg_prefix,
                                                 torchvision_vgg_mapping)
    from mmmot_tpu_torch.compat.torch_convert import (load_torch_checkpoint,
                                                      torch_to_port)

    sd = load_torch_checkpoint(pth_path, allow_pickle=allow_pickle)
    prefix = detect_vgg_prefix(sd, depth=depth)
    if prefix is None:
        raise ValueError(
            f"no VGG-bn trunk found in {pth_path!r} (expected "
            f"'features.0.weight' [64,3,3,3]-shaped keys)")
    mapping, kind = torchvision_vgg_mapping(depth, torch_prefix=prefix)
    tensors, unused = torch_to_port(sd, mapping, kind)
    unexpected = [k for k in unused
                  if not k.startswith(_EXPECTED_UNUSED_PREFIXES)]
    own = net.state_dict()
    errors = []
    for name, v in tensors.items():
        if name not in own:
            errors.append(f"{name}: not in model")
        elif tuple(own[name].shape) != tuple(v.shape):
            errors.append(f"{name}: model {tuple(own[name].shape)} vs "
                          f"checkpoint {tuple(v.shape)}")
    if errors:
        raise ValueError(
            "pretrained VGG does not fit this model config (width_mult / "
            "depth mismatch?):\n  " + "\n  ".join(errors[:10]))
    with torch.no_grad():
        for name, v in tensors.items():
            own[name].copy_(v.to(own[name].dtype))
    return {"converted": sorted(tensors),
            "unexpected_unused": sorted(unexpected)}
