"""The port's per-frame serving step (``mmmot_tpu_torch/deploy.py::
_build_step``) in bfloat16 against the JAX package's ``_build_step`` in
bfloat16: shared weights at ``tiny_debug`` widths (those of
``tests/test_torch_tracking.py::test_bfloat16_ids_equal_reference_pallas``),
the same frames, one step a frame.  Ids must be equal.

The reference's step takes its fused Pallas kernel on a TPU and its XLA
modules elsewhere; its XLA path disagrees with its Pallas path in
bfloat16 (see ``tests/test_torch_tracking.py``), so the oracle is the
Pallas path, run in interpret mode on the CPU: while ``_build_step``
is built, the reference's ``TrackingModule`` it binds is given
``pallas_interpret=True``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmmot_tpu.tracker as jtracker
from mmmot_tpu.config import AssocConfig as JAssocConfig
from mmmot_tpu.deploy import _build_step as j_build_step
from mmmot_tpu.deploy import _fresh_state as j_fresh_state
from mmmot_tpu.deploy import _state_to_dict as j_state_to_dict
from mmmot_tpu.models import model_entry
from mmmot_tpu_torch.config import tiny_debug
from mmmot_tpu_torch.deploy import _build_step, _fresh_state, _state_to_dict
from mmmot_tpu_torch.tracker.tracker import TrackingModule

from tests.test_torch_tracking import models, raw_sequence  # noqa: F401
from tests.torch_port_fixtures import (port_net, tiny_cfg_jax,
                                       torch_one_thread)  # noqa: F401

P, CROP = 16, (32, 32)


@pytest.fixture(scope="module")
def bf16_steps(models):  # noqa: F811
    """(jitted reference step on its Pallas path, its weights, the
    reference module, the port's bfloat16 module) on shared weights."""
    _, variables, _ = models
    jcfg = dataclasses.replace(tiny_cfg_jax().model, compute_dtype="bfloat16")
    jnet = model_entry(jcfg)
    jassoc = JAssocConfig(solver="auction")
    jmod = jtracker.TrackingModule(jnet, variables, jassoc)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtracker, "TrackingModule", functools.partial(
            jtracker.TrackingModule, pallas_interpret=True))
        j_step = j_build_step(jnet, jassoc, CROP, P, use_pallas=True)
    net = port_net(variables, dataclasses.replace(tiny_debug().model,
                                                  compute_dtype="bfloat16"))
    return jax.jit(j_step), variables, jmod, TrackingModule(net)


@pytest.mark.parametrize("seed", [11, 20, 26, 28, 29])
def test_bf16_serve_step_ids_equal_reference(bf16_steps, seed):
    j_step, variables, jmod, module = bf16_steps
    images, clouds, boxes, det_mask, proj = raw_sequence(seed)
    jst = j_state_to_dict(j_fresh_state(jmod, det_mask.shape[1]))
    step = _build_step(module, CROP, P)
    st = _state_to_dict(_fresh_state(module, det_mask.shape[1]))
    seen = []
    for t in range(len(images)):
        frame = (images[t], clouds[t], boxes[t], det_mask[t], proj)
        jst, jids, _ = j_step(variables, jst, *map(jnp.asarray, frame))
        st, ids, scores = step(st, *frame)
        assert scores.dtype == torch.float32
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids),
                                      err_msg=f"frame {t}")
        seen += ids[ids >= 0].tolist()
    # Some tracks continue across frames: links, not only births.
    assert len(set(seen)) < len(seen) == det_mask.sum()
