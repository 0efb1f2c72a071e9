"""Configuration of the port: frozen dataclasses and Python presets.

Only the knobs the flagship raw-frames path, the KITTI runner, the
association quality stack, the look-alike stack (GNN refine, learned
motion, the class gate) and training read are carried.  The values that the path
supports but does not vary (VGG with batch norm and skip pooling, subabs
correlation, a 2-layer link head, dual softmax, v2 new/end heads with
max pooling, ``add`` score fusion over the fused/image/lidar branches,
fusion variant C) are fixed by the modules themselves.  The crop size
and the points per detection are the model's (the JAX ``data`` section
repeats them).  Field names and defaults follow the JAX package's
``mmmot_tpu/config.py``.  No YAML is parsed: each preset spells out its
``experiments/<name>/config.yaml``.
"""

from __future__ import annotations

import dataclasses
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
    dropblock: bool = False            # not ported: raises when set

    def __post_init__(self):
        if self.dropblock:
            raise NotImplementedError(
                "appearance.dropblock (DropBlock2D on the VGG stages) is not "
                "ported to mmmot_tpu_torch (ROADMAP Queue 1)")
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
    """Per-branch link head: subabs correlation -> Dense+BN+ReLU -> Dense.

    ``gnn_rounds`` message-passing hops refine each branch's embeddings
    across the frame pair before the correlation (``GNNRefine``);
    ``motion_dim`` > 0 adds a learned box-geometry term of that hidden
    width to the raw link (``MotionScore``)."""

    hidden_dim: int = 512
    gnn_rounds: int = 0
    motion_dim: int = 0

    def __post_init__(self):
        if self.motion_dim < 0:
            raise ValueError(f"motion_dim must be >= 0, got "
                             f"{self.motion_dim}")


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
    remat: bool = False                # training: recompute the VGG trunk's
                                       # activations in the backward pass

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
class DataConfig:
    """The KITTI tree the runner reads (``mmmot_tpu/config.py::DataConfig``,
    the fields the runner reads, with their defaults and checks)."""

    root: str = "data/kitti_tracking"
    det_source: str = "pointpillars"   # detections/<det_source>/<seq>.txt
    max_dets: int = 64                 # padded detection slots per frame
    crop_size: Tuple[int, int] = (224, 224)
    point_len: int = 512
    point_source: str = "frustum"      # frustum (2D box) | box3d
    score_threshold: float = 0.0       # drop detections scored below
    track_class: str = "Car"           # Car | Pedestrian | Cyclist | All
    cloud_filter: str = "boxes"        # boxes: keep the scan's points that
                                       # project into a detection box, in a
                                       # 4096 bucket; none: raw scan to M
    packed_cache: bool = False         # memmapped packed sequences
    augmentation: bool = True          # training: data/augment.py

    def __post_init__(self):
        if self.track_class not in ("Car", "Pedestrian", "Cyclist", "All"):
            raise ValueError(
                f"track_class must be Car/Pedestrian/Cyclist/All, "
                f"got {self.track_class!r}")
        if self.point_source not in ("frustum", "box3d"):
            raise ValueError(
                f"point_source must be frustum/box3d, "
                f"got {self.point_source!r}")
        if self.cloud_filter not in ("boxes", "none"):
            raise ValueError(
                f"cloud_filter must be boxes/none, "
                f"got {self.cloud_filter!r}")


# Solvers of the reference that the port does not have yet (ROADMAP
# Queue 1, "parts the flagship slice left out").
UNPORTED_SOLVERS = ("sinkhorn", "greedy", "ilp", "lap", "native")


@dataclass(frozen=True)
class AssocConfig:
    """The association (``mmmot_tpu/config.py::AssocConfig``), with the
    fields the port reads, their defaults and the reference's checks.

    - ``use_det_scores``: detection-confidence variables (y_det) in the
      LP, weighted by ``det_score_weight``, so the solver may reject a
      detection; ``raw_new_end`` feeds the raw new/end logits to the LP
      instead of their sigmoids.
    - ``link_threshold`` > 0 forbids links scoring below it.
    - ``iou_gate`` > 0 forbids links whose 2D box IoU is below it;
      ``iou_weight`` != 0 adds ``iou_weight * IoU`` to the link scores.
    - ``revival_window`` K > 0 keeps unmatched tracks as ghosts for up
      to K frames; a later detection that matches one revives its id.
    - ``ghost_coverage`` emits each ghost's constant-velocity box while
      it is missing, for its first ``coverage_max_miss`` missed frames
      (0: all K) and while its last det-head confidence is at least
      ``coverage_min_score``.
    - ``gate_predict`` gates against each track's predicted box (frozen
      box + (missed + 1) * last link velocity).
    - ``class_gate`` forbids links between detections of different
      class groups (joint classes, ``data.track_class="All"``).
    """

    solver: str = "auction"
    auction_scaling_steps: int = 8     # eps-scaling phases
    link_threshold: float = 0.0
    use_det_scores: bool = False
    det_score_weight: float = 1.0
    raw_new_end: bool = False
    iou_gate: float = 0.0
    iou_weight: float = 0.0
    revival_window: int = 0
    class_gate: bool = False
    ghost_coverage: bool = False
    coverage_max_miss: int = 0
    coverage_min_score: float = 0.0
    gate_predict: bool = False

    def __post_init__(self):
        if self.solver in UNPORTED_SOLVERS:
            raise NotImplementedError(
                f"solver {self.solver!r} is not ported to mmmot_tpu_torch "
                "(ROADMAP Queue 1); use 'auction'")
        if self.solver != "auction":
            raise ValueError(f"unknown solver {self.solver!r}")
        if self.coverage_max_miss < 0:
            raise ValueError(
                f"coverage_max_miss must be >= 0, "
                f"got {self.coverage_max_miss}")
        if (self.ghost_coverage and self.revival_window
                and self.coverage_max_miss > self.revival_window):
            raise ValueError(
                f"coverage_max_miss={self.coverage_max_miss} exceeds "
                f"revival_window={self.revival_window}: coverage can only "
                "be emitted while the ghost is still in the pool")
        if self.gate_predict:
            if not self.ghost_coverage:
                raise ValueError(
                    "gate_predict needs ghost_coverage (the per-track "
                    "velocity is carried state)")
            if self.iou_gate <= 0.0 and self.iou_weight == 0.0:
                raise ValueError(
                    "gate_predict without iou_gate/iou_weight does "
                    "nothing: configure the spatial gate it predicts for")


@dataclass(frozen=True)
class TrainConfig:
    """Training (``mmmot_tpu/config.py::TrainConfig``, every field, with
    its defaults).  ``batch_size`` counts frame pairs per step;
    ``compact_capacity`` > 0 runs the forward's feature extraction on that
    many valid detections only (overflow is dropped from the loss and
    shows in the ``n_dets`` metric); ``loss_weights`` weigh the link,
    new, end and det terms."""

    optimizer: str = "adam"            # adam (adamw) | sgd
    lr: float = 3e-4
    weight_decay: float = 1e-4
    momentum: float = 0.9
    lr_schedule: str = "step"          # step | cosine | constant
    lr_decay_epochs: Tuple[int, ...] = (20, 30)
    lr_decay_rate: float = 0.1
    warmup_steps: int = 200
    epochs: int = 40
    batch_size: int = 4
    compact_capacity: int = 0
    grad_clip: float = 10.0
    loss_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    seed: int = 0
    log_every: int = 20
    ckpt_dir: str = "checkpoints"
    ckpt_keep: int = 3


@dataclass(frozen=True)
class Config:
    name: str = "default"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    assoc: AssocConfig = field(default_factory=AssocConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


# ``train:`` of experiments/full_mmmot/config.yaml (and of the presets
# built on it): adam at 3e-4, 4 pairs a step at capacity 128, step decay
# at epochs 20 and 30 of 40.
FULL_TRAIN = TrainConfig(optimizer="adam", lr=3e-4, epochs=40, batch_size=4,
                         compact_capacity=128, lr_schedule="step",
                         lr_decay_epochs=(20, 30))


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
            compute_dtype="bfloat16"),
        data=DataConfig(max_dets=32, crop_size=(224, 224), point_len=512,
                        det_source="pointpillars"),
        train=FULL_TRAIN)


def full_mmmot_b8() -> Config:
    """``experiments/full_mmmot_b8/config.yaml``: the flagship at 8
    pairs a step and capacity 256, with the VGG trunk recomputed in the
    backward pass (``model.remat``)."""
    base = full_mmmot()
    return dataclasses.replace(
        base, name="full_mmmot_b8",
        model=dataclasses.replace(base.model, remat=True),
        train=dataclasses.replace(base.train, batch_size=8,
                                  compact_capacity=256))


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
            compute_dtype="float32"),
        data=DataConfig(max_dets=8, crop_size=(32, 32), point_len=16),
        train=TrainConfig(batch_size=2, epochs=2))


def full_mmmot_ydet() -> Config:
    """``experiments/full_mmmot_ydet/config.yaml``: the flagship with
    y_det detection rejection in the LP, on raw new/end logits."""
    return dataclasses.replace(
        full_mmmot(), name="full_mmmot_ydet",
        assoc=AssocConfig(solver="auction", use_det_scores=True,
                          raw_new_end=True))


def full_mmmot_noisy() -> Config:
    """``experiments/full_mmmot_noisy/config.yaml``: the noisy-detector
    quality stack (y_det, a 4-frame ghost pool, the IoU gate and prior,
    ghost coverage for the first missed frame) on noisy detections."""
    base = full_mmmot()
    return dataclasses.replace(
        base, name="full_mmmot_noisy",
        data=dataclasses.replace(base.data, det_source="noisy"),
        assoc=AssocConfig(solver="auction", use_det_scores=True,
                          raw_new_end=True, revival_window=4, iou_gate=0.1,
                          iou_weight=1.0, ghost_coverage=True,
                          coverage_max_miss=1),
        train=dataclasses.replace(base.train, epochs=12,
                                  lr_schedule="cosine", warmup_steps=100))


def full_mmmot_lookalike() -> Config:
    """``experiments/full_mmmot_lookalike/config.yaml``: the look-alike
    operating point (two GNN hops and the learned motion term on top of
    the noisy stack, coverage uncapped) at 112² crops and 256 points."""
    base = full_mmmot()
    m = base.model
    return dataclasses.replace(
        base, name="full_mmmot_lookalike",
        model=dataclasses.replace(
            m, appearance=dataclasses.replace(m.appearance,
                                              crop_size=(112, 112)),
            point=dataclasses.replace(m.point, point_len=256),
            affinity=AffinityConfig(hidden_dim=512, gnn_rounds=2,
                                    motion_dim=8)),
        data=dataclasses.replace(base.data, det_source="noisy",
                                 crop_size=(112, 112), point_len=256),
        assoc=AssocConfig(solver="auction", use_det_scores=True,
                          raw_new_end=True, revival_window=4, iou_gate=0.1,
                          iou_weight=1.0, ghost_coverage=True),
        train=dataclasses.replace(base.train, epochs=10,
                                  lr_schedule="cosine", warmup_steps=60))
