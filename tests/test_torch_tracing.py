"""The port's tracer (``mmmot_tpu_torch/utils/profiling.py``) on the CPU:
spans off record nothing; a tracking window's span tree, its window id
and its ids with tracing on and off; the host-sync counter against the
auction's rounds; spans on the profiler's clock; ``trace()``'s files and
``cli/track --trace-dir``.

    python -m pytest tests/test_torch_tracing.py -q
"""

import json
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mmmot_tpu_torch.assoc.auction import SYNC_EVERY, auction_lap
from mmmot_tpu_torch.config import tiny_debug
from mmmot_tpu_torch.models.tracking_net import TrackingNet, init_random_
from mmmot_tpu_torch.tracker.sequence import \
    track_sequences_from_frames_batched
from mmmot_tpu_torch.tracker.tracker import TrackingModule
from mmmot_tpu_torch.utils import profiling

# (span, its parent) in a flagship window: the parallel pre-solve and
# the auction.
TREE = {"track.window": None, "extract": "track.window",
        "extract.chunk": "extract", "assoc": "track.window",
        "affinity": "assoc", "auction": "assoc",
        "auction.quantize": "auction", "auction.bid": "auction",
        "auction.check": ("auction", "auction.complete"),
        "auction.complete": "auction", "ids": "assoc"}


@pytest.fixture
def tracer():
    profiling.reset()
    yield profiling
    profiling.enable(False)
    profiling.reset()


def tiny_window(seed: int = 3, S: int = 2, T: int = 6, N: int = 8):
    """Raw frames of S sequences: images, clouds, boxes, det_mask, proj."""
    gen = torch.Generator().manual_seed(seed)
    H, W, M = 96, 320, 512
    images = torch.randint(0, 256, (S, T, H, W, 3), generator=gen,
                           dtype=torch.uint8)
    clouds = torch.rand((S, T, M, 4), generator=gen) * torch.tensor(
        [50.0, 6.0, 68.0, 1.0]) + torch.tensor([-25.0, -3.0, 2.0, 0.0])
    l = torch.rand((S, T, N), generator=gen) * (W - 60)
    t = torch.rand((S, T, N), generator=gen) * (H - 30)
    boxes = torch.stack([l, t, l + 50, t + 25], -1)
    det_mask = torch.rand((S, T, N), generator=gen) < 0.7
    proj = torch.tensor([[180.0, 0, W / 2, 0], [0, 180.0, H / 2, 0],
                         [0, 0, 1, 0]])
    return images, clouds, boxes, det_mask, proj


@pytest.fixture(scope="module")
def module():
    cfg = tiny_debug()
    net = init_random_(TrackingNet(cfg.model, device="cpu"), 1)
    with torch.no_grad():
        for head in (net.new_end.new_mlp, net.new_end.end_mlp):
            head.dense_1.bias.fill_(-3.0)
    m = TrackingModule(net)
    assert m.parallel_assoc
    return m


def track(module, frames):
    cfg = tiny_debug()
    S, T, N = frames[3].shape
    return track_sequences_from_frames_batched(
        module, *frames, tuple(cfg.model.appearance.crop_size),
        cfg.model.point.point_len, compact_capacity=T * N, extract_chunk=16,
        crop_window=128)


def test_span_off_records_nothing(tracer):
    tracer.enable(False)
    a, b = tracer.span("extract"), tracer.span("auction")
    assert a is b
    with a, b:
        pass

    @tracer.spanned("ids")
    def f(x):
        return x + 1

    assert f(1) == 2
    assert tracer.take() == ([], {})
    tracer.enable(True)
    assert isinstance(tracer.span("x"), tracer._Span)


def test_window_span_tree_and_ids_unchanged(tracer, module):
    frames = tiny_window()
    tracer.enable(False)
    off = track(module, frames)
    tracer.enable(True)
    on = track(module, frames)
    tracer.enable(False)
    spans, offsets = tracer.take()
    assert torch.equal(on["ids"], off["ids"])
    assert torch.equal(on["det_score"], off["det_score"])

    names = {s.name for s in spans}
    assert names >= set(TREE), set(TREE) - names
    assert len({s.window for s in spans}) == 1 and len(offsets) == 1
    assert [s.name for s in spans if s.parent < 0] == ["track.window"]
    # 2 sequences at capacity 48, 16 rows a chunk: 6 chunks.
    assert sum(s.name == "extract.chunk" for s in spans) == 6
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns
        want = TREE.get(s.name)
        if s.parent < 0:
            continue
        p = spans[s.parent]
        assert s.parent < i
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        if want is not None:
            assert p.name in (want if isinstance(want, tuple) else (want,)), \
                (s.name, p.name)


def test_host_syncs_count_the_auction_checks(tracer, module):
    frames = tiny_window(seed=5)
    r0 = auction_lap.rounds
    track(module, frames)
    rounds = auction_lap.rounds - r0
    assert rounds > 0 and rounds % SYNC_EVERY == 0
    assert tracer.COUNTS["host_syncs"] == math.ceil(rounds / SYNC_EVERY) + 2
    assert tracer.COUNTS["track.windows"] == 1
    # Counted with tracing on as with it off; one span a check when on.
    tracer.enable(True)
    track(module, frames)
    tracer.enable(False)
    spans, _ = tracer.take()
    checks = sum(s.name == "auction.check" for s in spans)
    assert checks == rounds // SYNC_EVERY + 2
    assert sum(s.name == "auction.bid" for s in spans) == rounds // SYNC_EVERY
    assert tracer.COUNTS["host_syncs"] == 2 * checks


def test_spans_on_the_profiler_clock(tracer):
    """Spans mapped by ``epoch`` keep their order with profiler ranges on
    the profiler's clock to within 100 us: a span closed just before a
    range opens ends by the range's start, a span opened just inside it
    starts after its start and ends before its end, a span opened just
    after it starts after its end.  A mapping off by more than 100 us
    (plus the least time a ``record_function`` call takes to stamp its
    range, microseconds on an idle host) breaks one of them."""
    x = torch.randn(64, 64)
    tracer.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(15):
            with tracer.span(f"before{k}"):
                pass
            with record_function(f"probe{k}"), tracer.span(f"probe{k}"):
                x = torch.tanh(x @ x)
            with tracer.span(f"after{k}"):
                pass
    tracer.enable(False)
    spans, offsets = tracer.take()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    on_clock = {s.name: ((s.start_ns - t0) / 1e3, (s.end_ns - t0) / 1e3)
                for s in tracer.epoch(spans, offsets)}
    ranges = {e.name: e.time_range for e in prof.events()
              if e.name.startswith("probe")}
    assert len(ranges) == 15 and len(on_clock) == 45
    for k in range(15):
        r = ranges[f"probe{k}"]
        lo, hi = on_clock[f"probe{k}"]
        assert on_clock[f"before{k}"][1] <= r.start + 100.0, k
        assert r.start - 100.0 <= lo <= hi <= r.end + 100.0, k
        assert r.end - 100.0 <= on_clock[f"after{k}"][0], k


def test_trace_writes_spans_and_counters(tracer, module, tmp_path):
    frames = tiny_window(seed=7)
    with tracer.trace(str(tmp_path / "t")):
        track(module, frames)
    assert not tracer._on
    with open(tmp_path / "t" / "trace.json") as f:
        json.load(f)
    with open(tmp_path / "t" / "spans.jsonl") as f:
        rows = [json.loads(line) for line in f]
    with open(tmp_path / "t" / "counters.json") as f:
        counts = json.load(f)
    assert {r["name"] for r in rows} >= set(TREE)
    assert rows[0]["name"] == "track.window" and rows[0]["parent"] == -1
    assert all(rows[r["parent"]]["start_ns"] <= r["start_ns"]
               for r in rows[1:])
    checks = sum(r["name"] == "auction.check" for r in rows)
    assert counts == {"host_syncs": checks, "track.windows": 1}
    # Spans recorded before the region stay for take().
    tracer.enable(True)
    with tracer.span("before"):
        pass
    with tracer.trace(str(tmp_path / "u")):
        with tracer.span("inside"):
            pass
    spans, _ = tracer.take()
    assert [s.name for s in spans] == ["before"]


def test_cli_track_trace_dir(tracer, tmp_path):
    from mmmot_tpu_torch.cli.track import main

    out = tmp_path / "tr"
    stats = main(["--config", "tiny_debug", "--cpu", "--data-root",
                  str(tmp_path / "nowhere"), "--sequences", "1",
                  "--frames", "6", "--no-eval", "--result-path",
                  str(tmp_path / "res"), "--trace-dir", str(out)])
    assert stats["n_sequences"] == 1
    assert (out / "trace.json").is_file()
    with open(out / "spans.jsonl") as f:
        names = {json.loads(line)["name"] for line in f}
    assert {"assoc", "affinity", "auction", "ids"} <= names
    with open(out / "counters.json") as f:
        assert json.load(f)["host_syncs"] >= 2
