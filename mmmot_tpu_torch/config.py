"""Configuration of the port: frozen dataclasses and Python presets.

Only the knobs the flagship raw-frames path reads are carried.  The
values that the path supports but does not vary (VGG with batch norm and
skip pooling, subabs correlation, a 2-layer link head, dual softmax, v2
new/end heads with max pooling, ``add`` score fusion over the
fused/image/lidar branches, fusion variant C) are fixed by the modules
themselves.  The crop size and the points per detection are the
model's (the JAX ``data`` section repeats them).  Field names and
defaults follow the JAX package's ``mmmot_tpu/config.py``.  No YAML is parsed:
``full_mmmot()`` and ``tiny_debug()`` spell out
``experiments/full_mmmot/config.yaml`` and
``experiments/tiny_debug/config.yaml``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class AppearanceConfig:
    """VGG-bn trunk with skip pooling over its last three stages."""

    depth: int = 16
    reduction_dim: int = 256
    out_dim: int = 512
    crop_size: Tuple[int, int] = (224, 224)
    width_mult: float = 1.0

    def __post_init__(self):
        if self.depth not in (11, 13, 16, 19):
            raise ValueError(
                f"VGG depth must be 11/13/16/19, got {self.depth}")
        if min(self.crop_size) < 32:
            raise ValueError(f"crop_size {self.crop_size} too small: VGG has "
                             "5 pooling stages, crops must be >= 32x32")


@dataclass(frozen=True)
class PointConfig:
    """PointNet over frustum point samples (no T-Net)."""

    point_len: int = 512
    channels: Tuple[int, ...] = (64, 128, 256, 512)
    out_dim: int = 512


@dataclass(frozen=True)
class FusionConfig:
    """Attention-gated fusion (variant C) with the single branches kept."""

    out_dim: int = 512


@dataclass(frozen=True)
class AffinityConfig:
    """Per-branch link head: subabs correlation -> Dense+BN+ReLU -> Dense."""

    hidden_dim: int = 512


@dataclass(frozen=True)
class NewEndConfig:
    """v2 birth/death heads over max-pooled link evidence."""

    hidden_dim: int = 256


@dataclass(frozen=True)
class ModelConfig:
    appearance: AppearanceConfig = field(default_factory=AppearanceConfig)
    point: PointConfig = field(default_factory=PointConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    affinity: AffinityConfig = field(default_factory=AffinityConfig)
    new_end: NewEndConfig = field(default_factory=NewEndConfig)
    compute_dtype: str = "float32"     # "bfloat16" | "float32" (parity)

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32/bfloat16, "
                             f"got {self.compute_dtype!r}")
        d = self.fusion.out_dim
        if self.appearance.out_dim != d or self.point.out_dim != d:
            raise ValueError(
                "appearance.out_dim, point.out_dim and fusion.out_dim must "
                "agree: the single branches feed fused-width heads")


@dataclass(frozen=True)
class Config:
    name: str = "default"
    model: ModelConfig = field(default_factory=ModelConfig)


def full_mmmot() -> Config:
    """``experiments/full_mmmot/config.yaml``: the flagship at full width."""
    return Config(
        name="full_mmmot",
        model=ModelConfig(
            appearance=AppearanceConfig(depth=16, reduction_dim=256,
                                        out_dim=512, crop_size=(224, 224)),
            point=PointConfig(point_len=512, channels=(64, 128, 256, 512),
                              out_dim=512),
            fusion=FusionConfig(out_dim=512),
            affinity=AffinityConfig(hidden_dim=512),
            new_end=NewEndConfig(hidden_dim=256),
            compute_dtype="bfloat16"))


def tiny_debug() -> Config:
    """``experiments/tiny_debug/config.yaml``: CPU-sized widths."""
    return Config(
        name="tiny_debug",
        model=ModelConfig(
            appearance=AppearanceConfig(depth=11, crop_size=(32, 32),
                                        reduction_dim=32, out_dim=64,
                                        width_mult=0.125),
            point=PointConfig(point_len=16, channels=(16, 32), out_dim=64),
            fusion=FusionConfig(out_dim=64),
            affinity=AffinityConfig(hidden_dim=32),
            new_end=NewEndConfig(hidden_dim=32),
            compute_dtype="float32"))
