"""KITTI scoring: the CLEAR MOT devkit and HOTA, copies of
``mmmot_tpu/eval``."""

from mmmot_tpu_torch.eval.hota import (HotaEvaluation, HotaMetrics,
                                       evaluate_hota)
from mmmot_tpu_torch.eval.kitti_devkit import (IGNORED_BY_CLASS,
                                               TrackingEvaluation,
                                               TrackingMetrics,
                                               evaluate_tracking,
                                               read_seqmap)
