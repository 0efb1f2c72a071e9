"""The traffic generator: made from the seed, the same on two calls,
different across seeds, with the same amount of work for every seed."""

import torch

from bench_port.harness.traffic import capacity_of, crop_window, make_scene
from bench_port.tests.tiny import track_mix

SEEDS = (0, 7, 2 ** 31 + 11)


def scene(seed):
    return make_scene(track_mix(), seed, 8, "cpu")


def test_same_seed_same_traffic():
    a, b = scene(SEEDS[2]), scene(SEEDS[2])
    for k in ("images", "clouds", "boxes", "det_mask", "ids"):
        assert torch.equal(a[k], b[k]), k


def test_seeds_differ():
    a, b = scene(SEEDS[0]), scene(SEEDS[1])
    assert not torch.equal(a["images"], b["images"])
    assert not torch.equal(a["boxes"], b["boxes"])


def test_every_seed_holds_the_same_cars():
    for seed in SEEDS:
        sc = scene(seed)
        assert sorted(sc["cars"].tolist()) == sorted(track_mix()["cars"])
        for s, cars in enumerate(sc["cars"].tolist()):
            per_frame = sc["det_mask"][s].sum(-1)
            assert int(per_frame.max()) <= cars


def test_detections_fill_first_slots_and_carry_ids():
    sc = scene(SEEDS[1])
    dm, ids, boxes = sc["det_mask"], sc["ids"], sc["boxes"]
    n = dm.sum(-1, keepdim=True)
    assert torch.equal(dm, torch.arange(dm.shape[-1]) < n)
    assert bool((ids[dm] >= 0).all()) and bool((ids[~dm] == -1).all())
    w = boxes[..., 2] - boxes[..., 0]
    assert bool((w[dm] > 0).all())
    # A track keeps one id from frame to frame.
    assert len(set(ids[0, 0][dm[0, 0]].tolist())
               & set(ids[0, 1][dm[0, 1]].tolist())) > 0


def test_runner_sizes():
    dm = torch.zeros((2, 8, 4), dtype=torch.bool)
    dm[0, :4, :3] = True
    assert capacity_of(dm, 4, 8) == 16          # 12 valid, steps of 8
    boxes = torch.zeros((2, 8, 4, 4))
    boxes[..., 2] = 300.0
    assert crop_window(boxes, dm, 1248) == 384
    assert crop_window(boxes * 0, dm, 1248) == 256
