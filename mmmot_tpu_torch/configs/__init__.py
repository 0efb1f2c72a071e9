"""Canonical experiment configs: port of ``mmmot_tpu/configs``.

``flagship()`` is the reference's released best experiment
(``pp_pv_40e_dualadd_subabs_C``: PointPillars detections, point + VGG
fusion, variant C gated fusion, subabs correlation, dual softmax) at
full size; ``tiny()`` is the CPU-sized debug scale.
"""

from mmmot_tpu_torch.config import (AffinityConfig, AppearanceConfig,
                                    AssocConfig, Config, DataConfig,
                                    FusionConfig, ModelConfig, NewEndConfig,
                                    PointConfig, TrainConfig)


def flagship(compute_dtype: str = "bfloat16", max_dets: int = 32,
             crop: int = 224, point_len: int = 512,
             width_mult: float = 1.0, s2d_stem: bool = False) -> Config:
    return Config(
        name="pp_pv_40e_dualadd_subabs_C",
        model=ModelConfig(
            appearance=AppearanceConfig(depth=16, batch_norm=True,
                                        skip_pool=True, reduction_dim=256,
                                        out_dim=512, crop_size=(crop, crop),
                                        width_mult=width_mult,
                                        s2d_stem=s2d_stem),
            point=PointConfig(point_len=point_len,
                              channels=(64, 128, 256, 512), out_dim=512),
            fusion=FusionConfig(variant="C", out_dim=512, keep_single=True),
            affinity=AffinityConfig(correlation_ops=("subabs",),
                                    hidden_dim=512, num_layers=2,
                                    softmax_mode="dual"),
            new_end=NewEndConfig(version=2, hidden_dim=256, pool="max"),
            use_image=True, use_lidar=True, score_fusion="add",
            compute_dtype=compute_dtype),
        data=DataConfig(max_dets=max_dets, crop_size=(crop, crop),
                        point_len=point_len),
        assoc=AssocConfig(solver="auction"),
        train=TrainConfig(optimizer="adam", lr=3e-4, epochs=40,
                          batch_size=4))


def tiny(crop: int = 32, max_dets: int = 8, point_len: int = 16) -> Config:
    return Config(
        name="tiny_debug",
        model=ModelConfig(
            appearance=AppearanceConfig(depth=11, crop_size=(crop, crop),
                                        reduction_dim=16, out_dim=32,
                                        width_mult=0.0625),
            point=PointConfig(point_len=point_len, channels=(16, 32),
                              out_dim=32),
            fusion=FusionConfig(variant="C", out_dim=32),
            affinity=AffinityConfig(hidden_dim=16),
            new_end=NewEndConfig(hidden_dim=16)),
        data=DataConfig(max_dets=max_dets, crop_size=(crop, crop),
                        point_len=point_len),
        train=TrainConfig(batch_size=2, epochs=2, warmup_steps=10))
