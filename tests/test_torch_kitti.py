"""The port's host side against the JAX package's: the PNG decoder
against PIL, the KITTI reader field by field, the result writer byte for
byte, and the devkit and HOTA copies metric for metric."""

import dataclasses
import io
import os
import zlib

import numpy as np
import pytest
from PIL import Image

from mmmot_tpu.data import kitti_dataset as jkd
from mmmot_tpu.data.calib import Calibration as JCalibration
from mmmot_tpu.data.kitti_io import \
    tracker_output_to_objects as j_to_objects
from mmmot_tpu.data.kitti_io import write_kitti_result as j_write
from mmmot_tpu.eval.hota import evaluate_hota as j_hota
from mmmot_tpu.eval.kitti_devkit import evaluate_tracking as j_devkit
from mmmot_tpu_torch.config import tiny_debug
from mmmot_tpu_torch.data import kitti_dataset as tkd
from mmmot_tpu_torch.data import png
from mmmot_tpu_torch.data.calib import Calibration
from mmmot_tpu_torch.data.kitti_io import (KittiObject,
                                           read_kitti_tracking_labels,
                                           tracker_output_to_objects,
                                           write_kitti_result)
from mmmot_tpu_torch.eval import evaluate_hota, evaluate_tracking

from tests.test_devkit_differential import make_scenario
from tests.torch_port_fixtures import (  # noqa: F401
    build_kitti_tree, tiny_cfg_jax, torch_one_thread)


def _image(seed, shape=(37, 53)):
    """Noise over smooth ramps, so every filter predicts something."""
    r = np.random.default_rng(seed)
    y, x = np.mgrid[:shape[0], :shape[1]]
    base = np.stack([x * 3, y * 5, x + y], -1)
    return ((base + r.integers(0, 40, base.shape)) % 256).astype(np.uint8)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_png_decodes_pil_written_files(mode):
    img = _image(0)
    if mode == "RGBA":
        img = np.concatenate([img, _image(1)[..., :1]], -1)
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, format="PNG")
    got = png.decode_png(buf.getvalue())
    want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (4, 3, 2, 1, 0), (1, 2, 0)])
@pytest.mark.parametrize("channels", [3, 4])
def test_png_filters_round_trip_through_pil(filters, channels):
    """Each filter type alone and mixed rows: PIL reads what the port
    writes, and the port decodes it to PIL's pixels."""
    img = _image(2)
    if channels == 4:
        img = np.concatenate([img, _image(3)[..., :1]], -1)
    data = png.encode_png(img, filters)
    idat = data[len(png.SIGNATURE) + 25 + 8:-12 - 4]     # IDAT body
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        img.shape[0], -1)
    assert set(raw[:, 0].tolist()) == set(filters)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(pil, img[..., :3])
    np.testing.assert_array_equal(png.decode_png(data), pil)


def test_png_batch_of_mixed_sizes(tmp_path):
    imgs = [_image(s, shape) for s, shape in
            ((4, (20, 30)), (5, (20, 30)), (6, (9, 14)), (7, (20, 30)))]
    paths = []
    for i, (img, f) in enumerate(zip(imgs, [(4,), (1, 2), (3, 0), (2,)])):
        paths.append(str(tmp_path / f"{i}.png"))
        png.write_png(paths[-1], img, f)
    for got, want in zip(png.read_pngs(paths), imgs):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["L", "I;16", "P"])
def test_png_other_formats_raise(mode):
    img = Image.fromarray(_image(8)[..., 0]).convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    with pytest.raises(ValueError, match="only 8-bit RGB/RGBA"):
        png.decode_png(buf.getvalue())


def test_png_corrupt_chunk_raises():
    data = bytearray(png.encode_png(_image(9)))
    data[40] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(data))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return build_kitti_tree(tmp_path_factory.mktemp("tree"))


@pytest.mark.parametrize("cloud_filter,max_frames", [("boxes", None),
                                                     ("none", 2)])
def test_load_sequence_equals_reference(tree, cloud_filter, max_frames):
    jcfg = dataclasses.replace(tiny_cfg_jax().data, root=tree, max_dets=4,
                               cloud_filter=cloud_filter)
    tcfg = dataclasses.replace(tiny_debug().data, root=tree, max_dets=4,
                               cloud_filter=cloud_filter)
    jds = jkd.KittiTrackingDataset(jcfg, max_cloud_points=4096)
    tds = tkd.KittiTrackingDataset(tcfg, max_cloud_points=4096)
    assert tds.sequences == jds.sequences == ["0000", "0001"]
    for seq in tds.sequences:
        want = jds.load_sequence(seq, max_frames=max_frames)
        got = tds.load_sequence(seq, max_frames=max_frames)
        for f in dataclasses.fields(jkd.SequenceArrays):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        assert got.images.shape[1:] == (tkd.IMG_H, tkd.IMG_W, 3)
    assert tds.decode_s > 0


def test_dataset_helpers_equal_reference():
    r = np.random.default_rng(3)
    a = r.uniform(0, 50, (5, 4)).astype(np.float32)
    a[:, 2:] += a[:, :2]
    b = r.uniform(0, 50, (7, 4)).astype(np.float32)
    b[:, 2:] += b[:, :2]
    np.testing.assert_array_equal(tkd._iou_pair(a, b), jkd._iou_pair(a, b))
    pc = r.normal(0, 10, (300, 4)).astype(np.float32)
    pc[:, 0] = np.abs(pc[:, 0]) + 1
    proj = Calibration(P2=np.array([[50.0, 0, 48, 0], [0, 50, 24, 0],
                                    [0, 0, 1, 0]]), R0=np.eye(3),
                       V2C=np.array([[0.0, -1, 0, 0], [0, 0, -1, 0],
                                     [1, 0, 0, 0]])).projection_matrix()
    np.testing.assert_array_equal(
        tkd.KittiTrackingDataset._filter_cloud_to_boxes(pc, a, proj),
        jkd.KittiTrackingDataset._filter_cloud_to_boxes(pc, a, proj))


def test_calibration_equals_reference(tree):
    path = os.path.join(tree, "calib", "0000.txt")
    got, want = Calibration.from_file(path), JCalibration.from_file(path)
    np.testing.assert_array_equal(got.projection_matrix(),
                                  want.projection_matrix())
    np.testing.assert_array_equal(got.velo_to_rect_matrix(),
                                  want.velo_to_rect_matrix())


def test_result_writer_byte_equal(tmp_path):
    r = np.random.default_rng(4)
    T, N = 4, 5
    ids = r.integers(-1, 6, (T, N)).astype(np.int32)
    mask = r.random((T, N)) < 0.7
    boxes = r.uniform(0, 300, (T, N, 4)).astype(np.float32)
    b3 = r.normal(0, 3, (T, N, 7)).astype(np.float32)
    has3d = r.random((T, N)) < 0.5
    scores = r.random((T, N)).astype(np.float32)
    kw = dict(scores=scores, boxes3d=b3, obj_type="Car",
              frame_ids=np.arange(3, 3 + T), has_3d=has3d)
    write_kitti_result(tracker_output_to_objects(ids, mask, boxes, **kw),
                       str(tmp_path / "p.txt"))
    j_write(j_to_objects(ids, mask, boxes, **kw), str(tmp_path / "j.txt"))
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt") \
        .read_bytes()
    frames = read_kitti_tracking_labels(str(tmp_path / "p.txt"))
    assert all(isinstance(o, KittiObject) for v in frames.values()
               for o in v)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_devkit_and_hota_equal_reference(tmp_path, seed):
    """Both copies score the same result files (noisy tracker with
    dropouts, id switches, clutter, Vans, truncation and DontCare) to the
    reference's metrics, field for field."""
    rng = np.random.default_rng(seed)
    seqs = ["0000", "0001"]
    for d in ("gt", "res"):
        os.makedirs(tmp_path / d)
    for s in seqs:
        gt, trk = make_scenario(rng)
        j_write([o for v in gt.values() for o in v],
                str(tmp_path / "gt" / f"{s}.txt"))
        j_write([o for v in trk.values() for o in v],
                str(tmp_path / "res" / f"{s}.txt"))
    args = (str(tmp_path / "gt"), str(tmp_path / "res"), seqs)
    got, want = evaluate_tracking(*args), j_devkit(*args)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary_text() == want.summary_text()
    hg, hw = evaluate_hota(*args), j_hota(*args)
    assert hg.summary_text() == hw.summary_text()
    for f in dataclasses.fields(hw):
        np.testing.assert_array_equal(getattr(hg, f.name),
                                      getattr(hw, f.name), err_msg=f.name)
