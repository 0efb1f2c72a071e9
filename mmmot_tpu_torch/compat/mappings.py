"""Name-mapping tables: original PyTorch mmMOT state dicts -> the port's
``TrackingNet`` names; port of ``mmmot_tpu/compat/mappings.py``.

* ``torchvision_vgg_mapping``: torchvision's ``vgg{11,13,16,19}_bn``
  ``features.N`` indexing (a conv at i, its BatchNorm at i+1, a ReLU at
  i+2, a max-pool one index) onto the appearance trunk, to start it from
  an ImageNet-trained checkpoint (the reference builds
  ``vgg16_bn(pretrained=True)``).
* ``mmmot_trackingnet_mapping``: the whole reference ``TrackingNet``.
  Its attribute names (``MMMOT_DEFAULT_NAMES``) are the JAX package's
  best recollection, not yet checked against a real checkpoint; each is
  one table entry, and ``names=`` overrides any of them.
  ``detect_vgg_prefix`` finds the VGG trunk inside any checkpoint by its
  shapes.

Targets are the port's module paths (``appear_net.backbone.conv_0``),
which are the flax paths of the JAX package joined by dots.  Every
builder returns ``(mapping, kind)`` for
``compat.torch_convert.torch_to_port``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

from mmmot_tpu_torch.models.appearance import VGG_PLANS


def torchvision_vgg_mapping(depth: int = 16, torch_prefix: str = "features",
                            port_prefix: str = "appear_net.backbone",
                            ) -> Tuple[Dict[str, str], Dict[str, str]]:
    """torchvision ``vgg<depth>_bn`` conv trunk -> ``VGGBackbone``
    (``make_layers(cfg, batch_norm=True)``: per conv a Conv2d at index i,
    a BatchNorm2d at i+1, a ReLU at i+2; each MaxPool2d one index).  The
    classifier is not mapped: the reference reads ``.features`` only."""
    mapping: Dict[str, str] = {}
    kind: Dict[str, str] = {}
    sep = "." if port_prefix else ""
    idx = ci = 0
    for item in VGG_PLANS[depth]:
        if item == "M":
            idx += 1
            continue
        conv_name = f"{torch_prefix}.{idx}"
        bn_name = f"{torch_prefix}.{idx + 1}"
        mapping[conv_name] = f"{port_prefix}{sep}conv_{ci}"
        kind[conv_name] = "conv"
        mapping[bn_name] = f"{port_prefix}{sep}bn_{ci}"
        kind[bn_name] = "bn"
        idx += 3
        ci += 1
    return mapping, kind


def detect_vgg_prefix(state_dict: Mapping, depth: int = 16) -> Optional[str]:
    """The prefix P of a VGG-bn trunk in any checkpoint: ``P.0.weight``
    is the stem conv ([64, 3, 3, 3]-shaped) and ``P.1.running_mean``
    exists; None if there is none.  Handles bare torchvision dumps
    ("features") and nested attributes ("appear_net.vgg.features")."""
    for key in state_dict:
        if not key.endswith(".0.weight"):
            continue
        shape = tuple(getattr(state_dict[key], "shape", ()))
        if len(shape) == 4 and shape[1] == 3 and shape[2:] == (3, 3):
            prefix = key[: -len(".0.weight")]
            if f"{prefix}.1.running_mean" in state_dict:
                return prefix
    return None


# The reference's attribute names as the JAX package recalls them (not
# yet checked against a real checkpoint): correct them here, or pass
# ``names=``.
MMMOT_DEFAULT_NAMES = {
    "appearance": "appear_net",
    "vgg_features": "appear_net.vgg.features",
    "reduce": "appear_net.reduce",
    "appear_proj": "appear_net.proj",
    "point": "point_net",
    "point_conv": "point_net.conv",
    "point_bn": "point_net.bn",
    "point_proj": "point_net.proj",
    "fusion": "fusion_module",
    "affinity": "w_link",
    "new_end": "w_new_end",
    "det": "w_det",
}


def appearance_mapping(depth: int, names: Mapping[str, str],
                       n_reduce: int = 3
                       ) -> Tuple[Dict[str, str], Dict[str, str]]:
    """The appearance branch: the VGG trunk, the skip-pool reducers (1x1
    convs in the reference, Dense here) with their BatchNorms, and the
    projection."""
    mapping, kind = torchvision_vgg_mapping(
        depth, torch_prefix=names["vgg_features"],
        port_prefix="appear_net.backbone")
    for k in range(n_reduce):
        rname = f"{names['reduce']}.{k}"
        mapping[rname] = f"appear_net.reduce_{k}"
        kind[rname] = "conv1x1"
        bname = f"{names['reduce']}_bn.{k}"
        mapping[bname] = f"appear_net.reduce_bn_{k}"
        kind[bname] = "bn"
    mapping[names["appear_proj"]] = "appear_net.proj"
    kind[names["appear_proj"]] = "linear"
    return mapping, kind


def pointnet_mapping(names: Mapping[str, str], n_layers: int
                     ) -> Tuple[Dict[str, str], Dict[str, str]]:
    """The PointNet: conv1d (kernel 1) per-point MLP, BatchNorms and the
    projection."""
    mapping: Dict[str, str] = {}
    kind: Dict[str, str] = {}
    for i in range(n_layers):
        cname = f"{names['point_conv']}.{i}"
        mapping[cname] = f"point_net.mlp_{i}"
        kind[cname] = "conv"
        bname = f"{names['point_bn']}.{i}"
        mapping[bname] = f"point_net.bn_{i}"
        kind[bname] = "bn"
    mapping[names["point_proj"]] = "point_net.proj"
    kind[names["point_proj"]] = "linear"
    return mapping, kind


def fusion_mapping(names: Mapping[str, str]
                   ) -> Tuple[Dict[str, str], Dict[str, str]]:
    """Fusion variant C: the per-modality projections and the gate."""
    f = names["fusion"]
    mapping = {f"{f}.{m}": f"fusion.{m}"
               for m in ("proj_image", "proj_lidar", "gate")}
    return mapping, {k: "linear" for k in mapping}


def affinity_mapping(names: Mapping[str, str],
                     branches=("fused", "image", "lidar")
                     ) -> Tuple[Dict[str, str], Dict[str, str]]:
    """The link heads: per branch a 1x1-conv stack over the correlation
    volume, which is the port's Dense over the feature axis."""
    mapping: Dict[str, str] = {}
    kind: Dict[str, str] = {}
    a = names["affinity"]
    for b in branches:
        for src, dst, k in (("conv.0", "head_0", "conv1x1"),
                            ("bn.0", "head_bn_0", "bn"),
                            ("conv_out", "head_out", "conv1x1")):
            mapping[f"{a}_{b}.{src}"] = f"affinity_{b}.{dst}"
            kind[f"{a}_{b}.{src}"] = k
    return mapping, kind


def new_end_mapping(names: Mapping[str, str]
                    ) -> Tuple[Dict[str, str], Dict[str, str]]:
    ne = names["new_end"]
    mapping = {f"{ne}.{head}_mlp.{i}": f"new_end.{head}_mlp.dense_{i}"
               for head in ("new", "end") for i in range(2)}
    return mapping, {k: "linear" for k in mapping}


def det_head_mapping(names: Mapping[str, str]
                     ) -> Tuple[Dict[str, str], Dict[str, str]]:
    d = names["det"]
    mapping = {f"{d}.0": "det_head.dense_0", f"{d}.1": "det_head.dense_1"}
    return mapping, {k: "linear" for k in mapping}


def mmmot_trackingnet_mapping(model_cfg,
                              names: Optional[Mapping[str, str]] = None,
                              ) -> Tuple[Dict[str, str], Dict[str, str]]:
    """The whole reference ``TrackingNet`` state dict -> the port's, for
    ``model_cfg`` (a ``ModelConfig``: the VGG depth, which branches
    exist, the PointNet's depth); ``names`` overrides entries of
    ``MMMOT_DEFAULT_NAMES``."""
    from mmmot_tpu_torch.models.tracking_net import score_branches

    nm = dict(MMMOT_DEFAULT_NAMES)
    if names:
        nm.update(names)
    mapping: Dict[str, str] = {}
    kind: Dict[str, str] = {}

    def add(m, k):
        mapping.update(m)
        kind.update(k)

    if model_cfg.use_image:
        add(*appearance_mapping(model_cfg.appearance.depth, nm))
    if model_cfg.use_lidar:
        add(*pointnet_mapping(nm, n_layers=len(model_cfg.point.channels)))
    if model_cfg.use_image and model_cfg.use_lidar:
        add(*fusion_mapping(nm))
    add(*affinity_mapping(nm, branches=score_branches(model_cfg)))
    add(*new_end_mapping(nm))
    add(*det_head_mapping(nm))
    return mapping, kind
