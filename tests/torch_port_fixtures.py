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

from mmmot_tpu.config import load_config
from mmmot_tpu.models import model_entry

RTOL, ATOL = 1e-4, 1e-5


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
