"""Track ids of the Sinkhorn presets at ``tiny_debug``'s widths against
the JAX package: ``fusion_C`` (the fused branch alone scores),
``img_only`` and ``lidar_only`` (one modality, one branch) and
``batched_val`` (three branches), each with their switches (modalities,
``score_fusion``) and the Sinkhorn solver, in float32 and in bfloat16 on
the seeds of ``test_bfloat16_ids_equal_reference_pallas``.  The
reference runs its fused Pallas kernel in interpret mode, as that test
runs it; the port runs the kernel's plain version.  Ids must be equal.

The weights are the ``models`` fixture's (tests/test_torch_tracking.py),
with the subtrees a single-branch net does not have taken out, as flax
creates none for it (tests/test_torch_branches.py holds that pruning to
flax's own trees).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmot_tpu.config import AssocConfig as JAssocConfig
from mmmot_tpu.models import model_entry
from mmmot_tpu.tracker import TrackingModule as JTrackingModule
from mmmot_tpu.tracker import track_sequence_from_frames as j_track
from mmmot_tpu_torch.config import AssocConfig, tiny_debug
from mmmot_tpu_torch.models.tracking_net import score_branches
from mmmot_tpu_torch.tracker.sequence import track_sequence_from_frames
from mmmot_tpu_torch.tracker.tracker import TrackingModule

from tests.test_torch_tracking import (CROP_WINDOW, P, models,  # noqa: F401
                                       raw_sequence)
from tests.torch_port_fixtures import (assert_close, port_net, tiny_cfg_jax,
                                       torch_one_thread)  # noqa: F401

# Preset -> its model switches (experiments/<preset>/config.yaml); all
# four associate with Sinkhorn.
PRESETS = {"fusion_C": dict(score_fusion="fused-only"),
           "img_only": dict(use_lidar=False),
           "lidar_only": dict(use_image=False),
           "batched_val": {}}
BF16_SEEDS = (11, 20, 26, 28, 29)


def pruned(variables, model_cfg):
    """``variables`` of the full two-modality net without the subtrees
    that a net of ``model_cfg`` does not create: ``appear_net`` without
    the camera, ``point_net`` without the LiDAR, the fusion's gate and
    projections with one modality, ``affinity_image`` / ``affinity_lidar``
    with one score branch."""
    drop = set()
    if not model_cfg.use_image:
        drop.add("appear_net")
    if not model_cfg.use_lidar:
        drop.add("point_net")
    if not (model_cfg.use_image and model_cfg.use_lidar):
        drop.add("fusion")
    drop |= {f"affinity_{b}" for b in ("fused", "image", "lidar")
             if b not in score_branches(model_cfg)}
    return {coll: {k: v for k, v in tree.items() if k not in drop}
            for coll, tree in variables.items()}


@pytest.fixture(scope="module")
def pairs(models):
    """(jitted reference window, port module) per (preset, dtype), built
    on first use."""
    _, variables, _ = models
    cache = {}

    def get(name, dtype):
        if (name, dtype) not in cache:
            sw = dict(PRESETS[name], compute_dtype=dtype)
            pcfg = dataclasses.replace(tiny_debug().model, **sw)
            v = pruned(variables, pcfg)
            jmod = JTrackingModule(
                model_entry(dataclasses.replace(tiny_cfg_jax().model, **sw)),
                v, JAssocConfig(solver="sinkhorn"),
                use_pallas_affinity=True, pallas_interpret=True)
            fn = jax.jit(lambda im, cl, bx, dm, pr: j_track(
                jmod, im, cl, bx, dm, pr, (32, 32), P, compact_capacity=40,
                extract_chunk=16, crop_window=CROP_WINDOW))
            mod = TrackingModule(port_net(v, pcfg),
                                 AssocConfig(solver="sinkhorn"))
            cache[name, dtype] = fn, mod
        return cache[name, dtype]
    return get


@pytest.mark.parametrize("dtype,seed", [("float32", 11)] + [
    ("bfloat16", s) for s in BF16_SEEDS])
@pytest.mark.parametrize("name", list(PRESETS))
def test_preset_ids_equal_reference(pairs, name, dtype, seed):
    fn, mod = pairs(name, dtype)
    images, clouds, boxes, det_mask, proj = raw_sequence(seed)
    ref = fn(*map(jnp.asarray, (images, clouds, boxes, det_mask, proj)))
    out = track_sequence_from_frames(
        mod, images, clouds, boxes, det_mask, proj, (32, 32), P,
        compact_capacity=40, extract_chunk=16, crop_window=CROP_WINDOW)
    assert out["det_score"].dtype == getattr(torch, dtype)
    ids = out["ids"].numpy()
    np.testing.assert_array_equal(ids, np.asarray(ref["ids"]))
    assert int(out["n_dropped"]) == int(ref["n_dropped"]) == 0
    if dtype == "float32":
        assert_close(out["det_score"], ref["det_score"])
        # Links won: some tracks continue across frames.
        assert len(np.unique(ids[ids >= 0])) < det_mask.sum()
