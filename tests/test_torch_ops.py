"""Port parity of the masked primitives, the crop path and frustum
sampling: integer outputs (compaction order, sampled indices) exactly,
floats within the float32 tolerance of tests/torch_port_fixtures.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmot_tpu.ops import crop_resize as jcr
from mmmot_tpu.ops import frustum as jfr
from mmmot_tpu.ops import masking as jm
from mmmot_tpu_torch.ops import crop_resize as tcr
from mmmot_tpu_torch.ops import frustum as tfr
from mmmot_tpu_torch.ops import masking as tm

from tests.torch_port_fixtures import (  # noqa: F401
    assert_close, torch_one_thread)


@pytest.mark.parametrize("density,capacity", [(0.3, 12), (0.9, 12),
                                              (0.0, 5), (1.0, 40)])
def test_compact_and_scatter_exact(density, capacity):
    r = np.random.default_rng(int(density * 10) + capacity)
    mask = r.random(32) < density
    j_idx, j_taken = jm.compact_indices(jnp.asarray(mask), capacity)
    t_idx, t_taken = tm.compact_indices(torch.from_numpy(mask), capacity)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_taken.numpy(), np.asarray(j_taken))
    vals = r.normal(0, 1, (len(t_idx), 5)).astype(np.float32)
    ref = jm.scatter_compact(jnp.asarray(vals), j_idx, j_taken, 32)
    out = tm.scatter_compact(torch.from_numpy(vals), t_idx, t_taken, 32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_masked_reductions():
    r = np.random.default_rng(0)
    x = r.normal(0, 3, (4, 6, 7)).astype(np.float32)
    mask = r.random((4, 6, 7)) < 0.5
    mask[1] = False                                     # fully masked
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    xj, mj = jnp.asarray(x), jnp.asarray(mask)
    for dim in (-1, -2):
        assert_close(tm.masked_softmax(xt, mt, dim),
                     jm.masked_softmax(xj, mj, dim))
        assert_close(tm.masked_max(xt, mt, dim), jm.masked_max(xj, mj, dim))
        assert_close(tm.masked_mean(xt, mt, dim), jm.masked_mean(xj, mj, dim))


def _frames(seed, T=3, H=60, W=200):
    r = np.random.default_rng(seed)
    images = r.integers(0, 256, (T, H, W, 3)).astype(np.uint8)
    n = 9
    l = r.uniform(-10, W - 40, n)
    t = r.uniform(-5, H - 20, n)
    boxes = np.stack([l, t, l + r.uniform(5, 70, n), t + r.uniform(5, 40, n)],
                     -1).astype(np.float32)
    boxes[0] = (W - 30, 2, W + 15, 50)                  # clipped right edge
    fidx = r.integers(0, T, n).astype(np.int32)
    mask = np.ones(n, bool)
    mask[3] = False
    return images, fidx, boxes, mask


@pytest.mark.parametrize("window,out", [(64, (32, 32)), (128, (24, 40))])
def test_crop_and_resize_gathered(window, out):
    images, fidx, boxes, mask = _frames(window)
    # Under jit, as the tracker runs it: XLA then contracts the sample
    # positions' and the normalisation's multiply-adds, and so does the
    # port.  At these sizes the crops are bit-equal.
    ref = jax.jit(lambda im, fi, bx, m: jcr.normalize_crops(
        jcr.crop_and_resize_gathered(im, fi, bx, out, mask=m, window=window),
        scale=1 / 255.0))(jnp.asarray(images), jnp.asarray(fidx),
                          jnp.asarray(boxes), jnp.asarray(mask))
    raw = tcr.crop_and_resize_gathered(
        torch.from_numpy(images), torch.from_numpy(fidx),
        torch.from_numpy(boxes), out, mask=torch.from_numpy(mask),
        window=window)
    got = tcr.normalize_crops(raw, scale=1 / 255.0)
    assert got.shape == (len(boxes),) + out + (3,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (raw[3] == 0).all()


def _cloud(seed, B=4, M=300, N=5):
    r = np.random.default_rng(seed)
    pts = np.zeros((B, M, 4), np.float32)
    pts[..., 0] = r.uniform(-10, 10, (B, M))
    pts[..., 1] = r.uniform(-2, 2, (B, M))
    pts[..., 2] = r.uniform(-1, 30, (B, M))            # some behind camera
    pts[..., 3] = r.uniform(0, 1, (B, M))
    W, H = 96, 48
    proj = np.asarray([[50.0, 0, W / 2, 0], [0, 50.0, H / 2, 0],
                       [0, 0, 1, 0]], np.float32)
    l, t = r.uniform(0, 70, (B, N)), r.uniform(0, 30, (B, N))
    boxes = np.stack([l, t, l + r.uniform(3, 40, (B, N)),
                      t + r.uniform(3, 30, (B, N))], -1).astype(np.float32)
    det = r.random((B, N)) < 0.8
    return pts, boxes, proj, det


@pytest.mark.parametrize("P", [16, 400])
def test_frustum_sample(P):
    pts, boxes, proj, det = _cloud(P)
    ref_s, ref_m = jfr.frustum_sample_batched(
        jnp.asarray(pts), jnp.asarray(boxes), jnp.asarray(proj), P,
        det_mask=jnp.asarray(det))
    got_s, got_m = tfr.frustum_sample(
        torch.from_numpy(pts), torch.from_numpy(boxes),
        torch.from_numpy(proj), P, det_mask=torch.from_numpy(det))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    assert got_m.any() and not got_m.all()
    assert_close(got_s, ref_s)
    # Indices where sampled: channel 3 carries each point's cloud index,
    # which centring leaves alone, so the selected points and their order
    # are compared exactly.
    pts[..., 3] = np.arange(pts.shape[1])
    idx_ref = np.asarray(jfr.frustum_sample_batched(
        jnp.asarray(pts), jnp.asarray(boxes), jnp.asarray(proj), P,
        det_mask=jnp.asarray(det))[0])[..., 3]
    idx = tfr.frustum_sample(
        torch.from_numpy(pts), torch.from_numpy(boxes),
        torch.from_numpy(proj), P,
        det_mask=torch.from_numpy(det))[0][..., 3].numpy()
    np.testing.assert_array_equal(idx[got_m.numpy()],
                                  idx_ref[np.asarray(ref_m)])


@pytest.mark.parametrize("M", [300, 16384, 32768])
def test_project_points(M):
    """Bit-equal to the reference's ``hom @ proj.T``, eager and batched
    under ``jit``, with a dense random camera (every term non-zero)."""
    r = np.random.default_rng(M)
    pts = (10 * r.normal(size=(2, M, 3))).astype(np.float32)
    proj = (100 * r.normal(size=(2, 3, 4))).astype(np.float32)
    eager = jfr.project_points(jnp.asarray(pts[0]), jnp.asarray(proj[0]))
    batched = jax.jit(jax.vmap(jfr.project_points))(jnp.asarray(pts),
                                                    jnp.asarray(proj))
    got0 = tfr.project_points(torch.from_numpy(pts[0]),
                              torch.from_numpy(proj[0]))
    got = tfr.project_points(torch.from_numpy(pts), torch.from_numpy(proj))
    for a, b, c, d in zip(got0, eager, got, batched):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(c.numpy(), np.asarray(d))


def _edge_boxes(seed, pts, proj, B, N):
    """Boxes whose edges lie exactly on the reference's projected
    coordinates of in-front points: an ulp of projection error flips
    those points in or out."""
    r = np.random.default_rng(seed)
    u, v, d = (np.asarray(x) for x in jax.jit(jax.vmap(
        jfr.project_points, in_axes=(0, None)))(jnp.asarray(pts[..., :3]),
                                                jnp.asarray(proj)))
    boxes = np.zeros((B, N, 4), np.float32)
    for b in range(B):
        front = np.flatnonzero(d[b] > 0.1)
        for n in range(N):
            i, j = r.choice(front, 2, replace=False)
            boxes[b, n] = (min(u[b, i], u[b, j]), min(v[b, i], v[b, j]),
                           max(u[b, i], u[b, j]), max(v[b, i], v[b, j]))
    return boxes


@pytest.mark.parametrize("seed", range(4))
def test_frustum_sample_box_edges_on_points(seed):
    """Sampled indices and mask equal the reference's when box edges sit
    on projected points, with and without padded cloud entries
    (``point_valid``), and padded entries never count as inside."""
    B, M, N, P = 3, 2048, 6, 64
    pts, _, proj, det = _cloud(seed, B=B, M=M, N=N)
    proj = np.asarray([[52.3, 1.7, 47.9, 0.31], [-0.9, 49.1, 23.7, -1.3],
                       [0.02, 0.01, 1.0, 0.004]], np.float32)
    boxes = _edge_boxes(seed, pts, proj, B, N)
    pts[..., 3] = np.arange(M)                  # cloud index rides along
    valid = np.random.default_rng(seed).random((B, M)) < 0.8
    for pv in (None, valid):
        ref_s, ref_m = jax.jit(
            lambda p, b, d, v: jfr.frustum_sample_batched(
                p, b, jnp.asarray(proj), P, det_mask=d, point_valid=v))(
            jnp.asarray(pts), jnp.asarray(boxes), jnp.asarray(det),
            None if pv is None else jnp.asarray(pv))
        got_s, got_m = tfr.frustum_sample(
            torch.from_numpy(pts), torch.from_numpy(boxes),
            torch.from_numpy(proj), P, det_mask=torch.from_numpy(det),
            point_valid=None if pv is None else torch.from_numpy(pv))
        ref_m = np.asarray(ref_m)
        np.testing.assert_array_equal(got_m.numpy(), ref_m)
        idx = got_s[..., 3].numpy()
        np.testing.assert_array_equal(idx[ref_m],
                                      np.asarray(ref_s)[..., 3][ref_m])
        assert ref_m.any()
        if pv is not None:
            taken = idx.astype(int)
            rows = np.arange(B)[:, None, None]
            assert pv[rows, taken][got_m.numpy()].all()
