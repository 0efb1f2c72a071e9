"""Configuration of the port: frozen dataclasses and Python presets.

Every field of the JAX package's model config is carried, with its
default and its check (``mmmot_tpu/config.py``): the VGG trunk's depth,
width, BatchNorm, skip pooling, DropBlock and space-to-depth stem; the
PointNet and its T-Net; fusion A, B or C with or without
``keep_single``; the correlation ops, the link head's depth and its
softmax mode, GNN rounds and the learned motion term; new/end v1 or v2
with its pool; the modality switches, the score fusion, the compute and
parameter dtypes, remat and the int8 trunk.  The data, association and
training sections carry the fields the port reads.  No YAML is parsed:
each preset spells out its ``experiments/<name>/config.yaml``, and
``config_to_dict`` / ``config_from_dict`` carry a config through JSON
(a deployment artifact's manifest).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple


@dataclass(frozen=True)
class AppearanceConfig:
    """VGG trunk (``batch_norm``: a BatchNorm after every conv) with skip
    pooling over its last three stages (``skip_pool`` off: the last
    stage alone).  ``dropblock`` drops ``dropblock_size``-square blocks
    of every stage map at rate ``dropblock_rate`` in training.
    ``s2d_stem``: a 2x2 space-to-depth of the crops replaces the first
    pool, so the first stage's convs run at half resolution on 12 input
    channels (not weight-compatible with the plain stem)."""

    arch: str = "vgg"
    depth: int = 16
    batch_norm: bool = True
    skip_pool: bool = True
    reduction_dim: int = 256
    out_dim: int = 512
    crop_size: Tuple[int, int] = (224, 224)
    dropblock: bool = False
    dropblock_size: int = 7
    dropblock_rate: float = 0.1
    width_mult: float = 1.0
    s2d_stem: bool = False

    def __post_init__(self):
        if self.arch != "vgg":
            raise ValueError(f"appearance arch must be 'vgg' (the one "
                             f"family built), got {self.arch!r}")
        if self.depth not in (11, 13, 16, 19):
            raise ValueError(
                f"VGG depth must be 11/13/16/19, got {self.depth}")
        if min(self.crop_size) < 32:
            raise ValueError(f"crop_size {self.crop_size} too small: VGG has "
                             "5 pooling stages, crops must be >= 32x32")
        if self.s2d_stem and (self.crop_size[0] % 2 or self.crop_size[1] % 2):
            raise ValueError(
                f"s2d_stem needs even crop dims, got {self.crop_size}")


@dataclass(frozen=True)
class PointConfig:
    """PointNet over frustum point samples; ``use_tnet`` adds the input
    transform (a 3x3 alignment of the xyz coordinates)."""

    point_len: int = 512
    channels: Tuple[int, ...] = (64, 128, 256, 512)
    out_dim: int = 512
    use_tnet: bool = False


@dataclass(frozen=True)
class FusionConfig:
    """Modality fusion: A concatenates and projects, B adds the two
    projections, C gates them (a sigmoid per modality).  ``keep_single``
    keeps the raw per-modality embeddings beside ``fused`` (they score
    links of their own)."""

    variant: str = "C"
    out_dim: int = 512
    keep_single: bool = True

    def __post_init__(self):
        if self.variant not in ("A", "B", "C"):
            raise ValueError(f"fusion variant must be A/B/C, got "
                             f"{self.variant!r}")


@dataclass(frozen=True)
class AffinityConfig:
    """Per-branch link head: the correlation ops (concatenated in this
    order) -> ``num_layers - 1`` x (Dense+BN+ReLU) -> Dense, and the
    link's ``softmax_mode`` (``dual`` rows and columns averaged,
    ``single`` rows, ``none`` the masked raw link).

    ``gnn_rounds`` message-passing hops refine each branch's embeddings
    across the frame pair before the correlation (``GNNRefine``);
    ``motion_dim`` > 0 adds a learned box-geometry term of that hidden
    width to the raw link (``MotionScore``)."""

    correlation_ops: Tuple[str, ...] = ("subabs",)
    hidden_dim: int = 512
    num_layers: int = 2
    gnn_rounds: int = 0
    softmax_mode: str = "dual"
    motion_dim: int = 0

    def __post_init__(self):
        bad = set(self.correlation_ops) - {"mul", "subabs", "diff",
                                           "cosine"}
        if bad:
            raise ValueError(f"unknown correlation ops {sorted(bad)}")
        if self.softmax_mode not in ("dual", "single", "none"):
            raise ValueError(f"bad softmax_mode {self.softmax_mode!r}")
        if self.motion_dim < 0:
            raise ValueError(f"motion_dim must be >= 0, got "
                             f"{self.motion_dim}")


@dataclass(frozen=True)
class NewEndConfig:
    """Birth/death heads: v2 reads each detection's feature and its
    ``pool`` (max | mean | softmax) of the link's row or column, v1 the
    feature alone.  An unknown pool raises where it is used
    (``NewEndHead``), as in the reference."""

    version: int = 2
    hidden_dim: int = 256
    pool: str = "max"


PARAM_DTYPES = ("float32", "bfloat16", "float16")


@dataclass(frozen=True)
class ModelConfig:
    appearance: AppearanceConfig = field(default_factory=AppearanceConfig)
    point: PointConfig = field(default_factory=PointConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    affinity: AffinityConfig = field(default_factory=AffinityConfig)
    new_end: NewEndConfig = field(default_factory=NewEndConfig)
    compute_dtype: str = "float32"     # "bfloat16" | "float32" (parity)
    param_dtype: str = "float32"       # the parameters' dtype: "float32",
                                       # "bfloat16" or "float16"; each
                                       # layer casts its weights to the
                                       # compute dtype (the motion MLP
                                       # stays float32)
    remat: bool = False                # training: recompute the VGG trunk's
                                       # activations in the backward pass
    int8_appearance: bool = False      # inference only: the VGG trunk in
                                       # int8 (models/quantize.py),
                                       # calibrated on the data root by the
                                       # track and export CLIs; training
                                       # ignores it
    use_image: bool = True             # the camera branch (appear_net)
    use_lidar: bool = True             # the LiDAR branch (point_net)
    score_fusion: str = "add"          # how the branches' link scores
                                       # combine: add | avg | fused-only
    feature_dim: int = 512             # the reference's field; no layer
                                       # reads it

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32/bfloat16, "
                             f"got {self.compute_dtype!r}")
        if self.param_dtype not in PARAM_DTYPES:
            raise ValueError(f"param_dtype must be one of {PARAM_DTYPES}, "
                             f"got {self.param_dtype!r}")
        if self.score_fusion not in ("add", "avg", "fused-only"):
            raise ValueError(f"score_fusion must be add/avg/fused-only, "
                             f"got {self.score_fusion!r}")
        if not (self.use_image or self.use_lidar):
            raise ValueError("fusion needs at least one modality: "
                             "use_image and use_lidar are both off")
        # A single modality's raw embedding stands in for ``fused`` and
        # the single branches feed fused-width heads (the reference's
        # keep_single checks).
        d = self.fusion.out_dim
        for on, what, dim in ((self.use_image, "appearance", self.appearance),
                              (self.use_lidar, "point", self.point)):
            if self.fusion.keep_single and on and dim.out_dim != d:
                raise ValueError(
                    f"{what}.out_dim={dim.out_dim} must equal "
                    f"fusion.out_dim={d}: the single branches feed "
                    "fused-width heads")


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

    solver: str = "auction"            # auction | sinkhorn | greedy (on
                                       # the device) | ilp | lap | native
                                       # (exact host oracles); an unknown
                                       # name raises in ``associate``
    auction_scaling_steps: int = 8     # eps-scaling phases
    sinkhorn_tau: float = 0.05         # Sinkhorn's entropy temperature
    sinkhorn_iters: int = 100          # Sinkhorn's fixed iteration count
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


_SECTIONS = {"model": ModelConfig, "data": DataConfig, "assoc": AssocConfig,
             "train": TrainConfig, "appearance": AppearanceConfig,
             "point": PointConfig, "fusion": FusionConfig,
             "affinity": AffinityConfig, "new_end": NewEndConfig}


def _build(cls, d: Dict[str, Any]):
    """``cls`` from a mapping of its fields (``mmmot_tpu/config.py::
    _build``): a nested mapping builds its section, a list becomes a
    tuple; an unknown key raises ``KeyError``."""
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {}
    for k, v in d.items():
        if k not in fields:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
        if isinstance(v, dict):
            if k not in _SECTIONS:
                raise TypeError(f"config key {k!r} does not take a mapping")
            kw[k] = _build(_SECTIONS[k], v)
        elif isinstance(v, list):
            kw[k] = tuple(v)
        else:
            kw[k] = v
    return cls(**kw)


def config_from_dict(d: Dict[str, Any]) -> "Config":
    """A ``Config`` from nested dicts (``config_to_dict``'s output, or a
    JSON reading of it), with every section's checks."""
    return _build(Config, d)


def config_to_dict(cfg: "Config") -> Dict[str, Any]:
    """Nested dicts of ``cfg``'s fields (tuples stay tuples; JSON writes
    them as lists, which ``config_from_dict`` turns back)."""
    return dataclasses.asdict(cfg)


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


def full_mmmot_int8() -> Config:
    """``experiments/full_mmmot_int8/config.yaml``: the flagship with the
    appearance trunk post-training quantised to int8 at inference
    (``model.int8_appearance``)."""
    base = full_mmmot()
    return dataclasses.replace(
        base, name="full_mmmot_int8",
        model=dataclasses.replace(base.model, int8_appearance=True))


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


def batched_val() -> Config:
    """``experiments/batched_val/config.yaml``: the flagship's model with
    the Sinkhorn association and no training capacity (its ``train:``
    has no ``compact_capacity``)."""
    base = full_mmmot()
    return dataclasses.replace(
        base, name="batched_val", assoc=AssocConfig(solver="sinkhorn"),
        train=dataclasses.replace(base.train, compact_capacity=0))


def fusion_C() -> Config:
    """``experiments/fusion_C/config.yaml``: ``batched_val`` scoring the
    fused branch alone (``score_fusion: fused-only``, one link head)."""
    base = batched_val()
    return dataclasses.replace(
        base, name="fusion_C",
        model=dataclasses.replace(base.model, score_fusion="fused-only"))


def img_only() -> Config:
    """``experiments/img_only/config.yaml``: the camera alone (no
    PointNet; its embedding is ``fused``, one link head), Sinkhorn."""
    base = batched_val()
    return dataclasses.replace(
        base, name="img_only",
        model=dataclasses.replace(base.model, use_lidar=False))


def lidar_only() -> Config:
    """``experiments/lidar_only/config.yaml``: the LiDAR alone (no VGG;
    its embedding is ``fused``, one link head), Sinkhorn."""
    base = batched_val()
    return dataclasses.replace(
        base, name="lidar_only",
        model=dataclasses.replace(base.model, use_image=False))


def tiny_kitti() -> Config:
    """``experiments/tiny_kitti/config.yaml``: ``tiny_debug``'s model on a
    small KITTI tree (its ``data.root``)."""
    base = tiny_debug()
    return dataclasses.replace(
        base, name="tiny_kitti",
        data=dataclasses.replace(base.data, root="/tmp/minikitti"))


def tiny_long() -> Config:
    """``experiments/tiny_long/config.yaml``: ``tiny_debug`` trained for
    12 epochs at 1e-3 on a cosine schedule."""
    base = tiny_debug()
    return dataclasses.replace(
        base, name="tiny_long",
        train=dataclasses.replace(base.train, epochs=12, lr=1e-3,
                                  lr_schedule="cosine"))


def tiny_long30() -> Config:
    """``experiments/tiny_long30/config.yaml``: ``tiny_long`` for 30
    epochs (VGG11 at width 0.125, as ``tiny_debug``)."""
    return dataclasses.replace(
        tiny_long(), name="tiny_long30",
        train=dataclasses.replace(tiny_long().train, epochs=30))
