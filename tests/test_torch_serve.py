"""The port's serve and export CLIs (``mmmot_tpu_torch/cli/serve.py``,
``cli/export.py``) on the CPU: the NDJSON protocol of
``tests/test_serve.py`` and ``tests/test_deploy.py``, driven end to end
in a subprocess with ``--cpu``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
H, W, M = 96, 192, 400
PROJ = np.array([[100.0, 0, W / 2, 0], [0, 100.0, H / 2, 0], [0, 0, 1, 0]],
                np.float32)


def write_frame(path, seed, n_boxes):
    r = np.random.default_rng(seed)
    img = r.integers(0, 255, (H, W, 3)).astype(np.uint8)
    cloud = np.zeros((M, 4), np.float32)
    cloud[:, 2] = r.uniform(2, 30, M)
    boxes = np.stack([np.array([10 + 40 * i, 10, 40 + 40 * i, 50],
                               np.float32) for i in range(n_boxes)])
    np.savez(path, image=img, cloud=cloud, boxes=boxes, proj=PROJ)


class Service:
    """``python -m mmmot_tpu_torch.cli.serve <args>`` on stdin/stdout."""

    def __init__(self, *args):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "mmmot_tpu_torch.cli.serve", *args],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"))

    def send(self, obj):
        self.proc.stdin.write(json.dumps(obj) + "\n")
        self.proc.stdin.flush()

    def recv(self):
        return json.loads(self.proc.stdout.readline())

    def rpc(self, obj):
        self.send(obj)
        return self.recv()

    def close(self):
        self.proc.stdin.close()
        self.proc.wait(timeout=120)
        return self.proc.returncode


def test_serve_protocol(tmp_path):
    """Single stream: frames, an error that keeps the service alive, a
    reset that restarts the frame counter and the ids, quit."""
    for t in range(2):
        write_frame(tmp_path / f"f{t}.npz", t, 2)
    svc = Service("--config", "tiny_debug", "--cpu")
    try:
        ready = svc.recv()
        assert ready == {"ready": True, "config": "tiny_debug"}
        r0 = svc.rpc({"npz": str(tmp_path / "f0.npz")})
        assert r0["frame"] == 0 and len(r0["ids"]) == 2
        r1 = svc.rpc({"npz": str(tmp_path / "f1.npz")})
        assert r1["frame"] == 1
        assert "error" in svc.rpc({"npz": "/does/not/exist.npz"})
        assert svc.rpc({"cmd": "reset"})["ok"] is True
        r3 = svc.rpc({"npz": str(tmp_path / "f0.npz")})
        assert r3 == r0
        assert svc.rpc({"cmd": "quit"})["ok"] is True
    finally:
        rc = svc.close()
    assert rc == 0


def test_serve_warmup(tmp_path):
    """--warmup runs the step before the ready line, which carries
    warmup_secs."""
    write_frame(tmp_path / "f0.npz", 1, 1)
    svc = Service("--config", "tiny_debug", "--cpu", "--warmup",
                  "--warmup-shape", f"{H}x{W}x{M}")
    try:
        ready = svc.recv()
        assert ready["ready"] is True and ready["warmup_secs"] > 0
        assert svc.rpc({"npz": str(tmp_path / "f0.npz")})["frame"] == 0
        assert svc.rpc({"cmd": "quit"})["ok"] is True
    finally:
        rc = svc.close()
    assert rc == 0


def test_export_cli_and_serve_exported(tmp_path):
    """cli/export writes an artifact that --exported serves without
    --config (ready, track, reset, quit); its ids equal the in-process
    ``DeployedTracker``'s.  --window with --streams exits, --int8
    raises."""
    from mmmot_tpu_torch.cli.export import main as export_main
    from mmmot_tpu_torch.deploy import DeployedTracker

    out = str(tmp_path / "artifact")
    export_main(["--config", "tiny_debug", "--out", out, "--cpu",
                 "--shape", f"{H}x{W}x{M}", "--seed", "3"])
    with pytest.raises(SystemExit):
        export_main(["--config", "tiny_debug", "--out", out, "--cpu",
                     "--window", "4", "--streams", "2"])
    with pytest.raises(NotImplementedError, match="item 12"):
        export_main(["--config", "tiny_debug", "--out", out, "--cpu",
                     "--int8"])
    for t in range(2):
        write_frame(tmp_path / f"f{t}.npz", 10 + t, 3)
    svc = Service("--exported", out, "--cpu", "--warmup")
    try:
        ready = svc.recv()
        assert ready["ready"] is True and ready["exported"] is True
        assert ready["platforms"] == ["cuda"] and "warmup_secs" in ready
        r0 = svc.rpc({"npz": str(tmp_path / "f0.npz")})
        assert r0["frame"] == 0 and len(r0["ids"]) == 3
        r1 = svc.rpc({"npz": str(tmp_path / "f1.npz")})
        assert r1["frame"] == 1 and len(r1["ids"]) == 3
        assert svc.rpc({"cmd": "reset"})["ok"] is True
        r2 = svc.rpc({"npz": str(tmp_path / "f0.npz")})
        assert r2 == r0
        assert svc.rpc({"cmd": "quit"})["ok"] is True
    finally:
        rc = svc.close()
    assert rc == 0
    trk = DeployedTracker.load(out, device="cpu")
    want = []
    for t in range(2):
        d = np.load(tmp_path / f"f{t}.npz")
        want.append(trk.step(d["image"], d["cloud"], d["boxes"],
                             d["proj"])[0])
    assert [r0["ids"], r1["ids"]] == want


@pytest.mark.parametrize("compact", [None, "3"])
def test_serve_multistream_interleaved(tmp_path, compact):
    """--streams 2: a full batch answers both streams in request order;
    a lone frame flushes after --flush-ms; a same-stream pair splits the
    batch; a per-stream reset leaves the other stream's counter; a third
    stream is refused while the others keep serving.  ``--compact 3``
    covers the 2 + 1 valid detections, so the trajectory is the same."""
    for t in range(3):
        write_frame(tmp_path / f"a{t}.npz", 10 + t, 2)
        write_frame(tmp_path / f"b{t}.npz", 20 + t, 1)
    svc = Service("--config", "tiny_debug", "--cpu", "--streams", "2",
                  "--flush-ms", "30", *(["--compact", compact]
                                        if compact else []))
    try:
        assert svc.recv()["streams"] == 2
        svc.send({"npz": str(tmp_path / "a0.npz"), "stream": "a"})
        svc.send({"npz": str(tmp_path / "b0.npz"), "stream": "b"})
        ra, rb = svc.recv(), svc.recv()
        assert (ra["stream"], ra["frame"], len(ra["ids"])) == ("a", 0, 2)
        assert (rb["stream"], rb["frame"], len(rb["ids"])) == ("b", 0, 1)
        a1 = svc.rpc({"npz": str(tmp_path / "a1.npz"), "stream": "a"})
        assert (a1["stream"], a1["frame"]) == ("a", 1)
        svc.send({"npz": str(tmp_path / "b1.npz"), "stream": "b"})
        svc.send({"npz": str(tmp_path / "b2.npz"), "stream": "b"})
        rb1, rb2 = svc.recv(), svc.recv()
        assert (rb1["frame"], rb2["frame"]) == (1, 2)
        assert svc.rpc({"cmd": "reset", "stream": "a"})["ok"] is True
        again = svc.rpc({"npz": str(tmp_path / "a0.npz"), "stream": "a"})
        assert again["frame"] == 0 and again["ids"] == ra["ids"]
        assert "error" in svc.rpc({"npz": str(tmp_path / "a0.npz"),
                                   "stream": "c"})
        assert svc.rpc({"npz": str(tmp_path / "b0.npz"),
                        "stream": "b"})["frame"] == 3
        assert svc.rpc({"cmd": "quit"})["ok"] is True
    finally:
        rc = svc.close()
    assert rc == 0


def test_serve_exported_multistream(tmp_path):
    """cli/export --streams 2 --capacity 3 writes a multi-stream artifact
    that --exported serves with the manifest's S (a third stream is
    refused); its ids equal the in-process ``load_multistream_step``'s."""
    import torch

    from mmmot_tpu_torch.cli.export import main as export_main
    from mmmot_tpu_torch.deploy import _padded, load_multistream_step

    out = str(tmp_path / "artifact")
    export_main(["--config", "tiny_debug", "--out", out, "--cpu",
                 "--shape", f"{H}x{W}x{M}", "--seed", "3", "--streams", "2",
                 "--capacity", "3"])
    for t in range(2):
        write_frame(tmp_path / f"a{t}.npz", 10 + t, 2)
        write_frame(tmp_path / f"b{t}.npz", 20 + t, 1)
    svc = Service("--exported", out, "--cpu", "--flush-ms", "30")
    try:
        ready = svc.recv()
        assert ready["exported"] is True and ready["streams"] == 2
        got = []
        for t in range(2):
            svc.send({"npz": str(tmp_path / f"a{t}.npz"), "stream": "a"})
            svc.send({"npz": str(tmp_path / f"b{t}.npz"), "stream": "b"})
            got.append([svc.recv()["ids"], svc.recv()["ids"]])
        assert "error" in svc.rpc({"npz": str(tmp_path / "a0.npz"),
                                   "stream": "c"})
        assert svc.rpc({"cmd": "quit"})["ok"] is True
    finally:
        rc = svc.close()
    assert rc == 0
    prog = load_multistream_step(out, device="cpu")
    states, want = prog.state0, []
    for t in range(2):
        frames = [np.load(tmp_path / f"{s}{t}.npz") for s in "ab"]
        padded = [_padded(d["boxes"], prog.manifest["max_dets"])
                  for d in frames]
        states, ids, _ = prog(
            prog.weights, states, torch.ones(2, dtype=torch.bool),
            np.stack([d["image"] for d in frames]),
            np.stack([d["cloud"] for d in frames]),
            np.stack([p[0] for p in padded]),
            np.stack([p[1] for p in padded]),
            np.stack([d["proj"] for d in frames]))
        want.append([ids[s, :p[2]].tolist() for s, p in enumerate(padded)])
    assert got == want
