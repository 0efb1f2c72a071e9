"""Shared set-up for the PyTorch port's parity tests (tests/test_torch_*).

The same weights and inputs go through the JAX package (the reference)
and ``mmmot_tpu_torch``: a flax model is initialised here, its variables
become nested numpy dicts, and ``mmmot_tpu_torch.compat.from_jax`` loads
them into the port's ``TrackingNet`` on the CPU.  Inputs are made with
numpy from a seed.

Float32 tolerance used throughout: rtol=1e-4, atol=1e-5.  Both sides
compute in float32 but with different kernels (XLA's and PyTorch's CPU
convolutions and matmuls sum in other orders), which leaves relative
differences of a few 1e-6 that grow through a dozen layers; 1e-4 relative
is well above that and far below any real error (a wrong weight layout or
a wrong rounding point moves outputs by O(1)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmot_tpu.config import load_config
from mmmot_tpu.models import model_entry

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """The port's CPU ops on one intra-op thread while a test module runs.

    The port's tests run thousands of tiny eager ops (the auction's
    rounds, the per-frame scans).  With several test processes sharing
    the cores, each op's pool of spinning OpenMP threads waits on threads
    that other processes preempted, which made one auction test 10 times
    slower (146 s against 14 s, seven busy processes beside it).  Import
    this fixture into a test module to apply it there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg_jax():
    """The JAX Config of experiments/tiny_debug (what the port's
    ``tiny_debug()`` spells out)."""
    return load_config("experiments/tiny_debug/config.yaml")


def init_flax(model_cfg, N: int = 8, seed: int = 0):
    """(flax TrackingNet, variables) initialised on a dummy batch."""
    net = model_entry(model_cfg)
    h, w = model_cfg.appearance.crop_size
    P = model_cfg.point.point_len
    dummy = {"crops": jnp.zeros((1, 2, N, h, w, 3)),
             "points": jnp.zeros((1, 2, N, P, 4)),
             "point_mask": jnp.ones((1, 2, N, P), bool),
             "det_mask": jnp.ones((1, 2, N), bool)}
    variables = jax.jit(lambda r, b: net.init({"params": r}, b, train=False))(
        jax.random.PRNGKey(seed), dummy)
    return net, randomize_stats(variables, seed)


def randomize_stats(variables, seed: int):
    """BatchNorm running statistics away from (0, 1), so a swapped or
    dropped statistic shows in the outputs."""
    rng = np.random.default_rng(seed + 100)
    stats = jax.tree.map(
        lambda x: np.asarray(x), jax.device_get(variables["batch_stats"]))

    def perturb(path, x):
        name = path[-1].key
        if name == "mean":
            return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return (0.5 + rng.uniform(size=x.shape)).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(perturb, stats)
    return {"params": variables["params"],
            "batch_stats": jax.tree.map(jnp.asarray, stats)}


def to_numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x), jax.device_get(tree))


def port_net(variables, port_model_cfg):
    """The port's TrackingNet on the CPU with the flax weights."""
    from mmmot_tpu_torch.compat.from_jax import load_flax_variables
    from mmmot_tpu_torch.models.tracking_net import TrackingNet

    net = TrackingNet(port_model_cfg, device="cpu")
    net.load_state_dict(load_flax_variables(to_numpy(variables), net))
    return net


def assert_close(actual, desired, rtol=RTOL, atol=ATOL, err_msg=""):
    if hasattr(actual, "detach"):
        actual = actual.detach().float().numpy()
    if hasattr(desired, "detach"):
        desired = desired.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(actual, np.float32),
                               np.asarray(desired, np.float32),
                               rtol=rtol, atol=atol, err_msg=err_msg)


# A small KITTI-layout tree, a copy of tests/test_cli_track.py's
# build_kitti_tree: two sequences of 5 and 3 frames at 48 x 96, two cars
# and a pedestrian per frame, 64-point scans, labels as oracle detections.
KITTI_P2 = np.array([[50.0, 0.0, 48.0, 0.0],
                     [0.0, 50.0, 24.0, 0.0],
                     [0.0, 0.0, 1.0, 0.0]])


def _write_calib(path):
    with open(path, "w") as f:
        f.write("P2: " + " ".join(str(x) for x in KITTI_P2.ravel()) + "\n")
        f.write("R_rect " + " ".join(str(x) for x in np.eye(3).ravel())
                + "\n")
        f.write("Tr_velo_cam " + " ".join(
            str(x) for x in np.array([[0.0, -1, 0, 0], [0, 0, -1, 0],
                                      [1, 0, 0, 0]]).ravel()) + "\n")


def build_kitti_tree(tmp_path):
    import os

    from PIL import Image

    from mmmot_tpu.data.kitti_io import KittiObject, write_kitti_result

    root = str(tmp_path / "kitti")
    rng = np.random.default_rng(0)
    for seq, T in (("0000", 5), ("0001", 3)):
        for sub in (f"image_02/{seq}", f"velodyne/{seq}"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        os.makedirs(os.path.join(root, "label_02"), exist_ok=True)
        os.makedirs(os.path.join(root, "calib"), exist_ok=True)
        objs = []
        for t in range(T):
            img = rng.integers(0, 255, (48, 96, 3)).astype(np.uint8)
            Image.fromarray(img).save(
                os.path.join(root, f"image_02/{seq}/{t:06d}.png"))
            pc = np.zeros((64, 4), np.float32)
            pc[:, 0] = rng.uniform(5, 30, 64)
            pc[:, 1] = rng.uniform(-5, 5, 64)
            pc[:, 2] = rng.uniform(-1, 1, 64)
            pc.tofile(os.path.join(root, f"velodyne/{seq}/{t:06d}.bin"))
            objs.append(KittiObject(frame=t, track_id=1, obj_type="Car",
                                    bbox=np.array([10, 10, 40, 40.0]),
                                    dimensions=np.array([2.0, 4.0, 4.0]),
                                    location=np.array([0.0, 1.0, 15.0]),
                                    rotation_y=0.1))
            objs.append(KittiObject(frame=t, track_id=2, obj_type="Car",
                                    bbox=np.array([50, 8, 80, 38.0]),
                                    dimensions=np.array([2.0, 4.0, 4.0]),
                                    location=np.array([-3.0, 1.0, 20.0]),
                                    rotation_y=-0.2))
            objs.append(KittiObject(frame=t, track_id=3,
                                    obj_type="Pedestrian",
                                    bbox=np.array([60, 20, 70, 44.0]),
                                    dimensions=np.array([1.8, 0.6, 0.6]),
                                    location=np.array([2.0, 1.0, 12.0]),
                                    rotation_y=0.0))
        write_kitti_result(objs, os.path.join(root, "label_02",
                                              f"{seq}.txt"))
        _write_calib(os.path.join(root, "calib", f"{seq}.txt"))
    return root
