"""The fused affinity of the port: ``affinity_plain`` (the CUDA kernel's
plain version) against the JAX package's Pallas kernel in interpret mode
and against ``TrackingNet.affinity``, with shared weights.  The CUDA
kernel itself is held to ``affinity_plain`` on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmot_tpu.kernels import build_affinity_params as j_build_params
from mmmot_tpu.kernels import pallas_affinity
from mmmot_tpu_torch.config import tiny_debug
from mmmot_tpu_torch.kernels import build as kbuild
from mmmot_tpu_torch.kernels.affinity import (affinity_plain,
                                              build_affinity_params,
                                              fused_affinity)
from mmmot_tpu_torch.models.tracking_net import BRANCHES

from tests.torch_port_fixtures import (assert_close, init_flax, port_net,
                                       tiny_cfg_jax)

D = 64

@pytest.fixture(scope="module")
def shared():
    jcfg = tiny_cfg_jax().model
    jnet, variables = init_flax(jcfg)
    net = port_net(variables, tiny_debug().model)
    return jcfg, jnet, variables, net

def pair_batch(seed, B, N, n_prev, n_curr):
    r = np.random.default_rng(seed)
    a = r.normal(0, 1, (B, 3, N, D)).astype(np.float32)
    b = r.normal(0, 1, (B, 3, N, D)).astype(np.float32)
    mp = np.arange(N)[None] < np.asarray(n_prev)[:, None]
    mc = np.arange(N)[None] < np.asarray(n_curr)[:, None]
    return a, b, mp, mc

CASES = {
    "partial": (8, [5, 8, 1], [7, 2, 8]),
    "empty_frame": (8, [0, 6], [4, 0]),
    "n13": (13, [13, 9, 4], [11, 13, 0]),
}

def test_params_match_reference(shared):
    jcfg, _, variables, net = shared
    ref = j_build_params(variables, jcfg, BRANCHES, jnp.float32)
    got = build_affinity_params(net, torch.float32)
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
        assert_close(got[k], ref[k], err_msg=k)

@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret_and_module_path(shared, case):
    jcfg, jnet, variables, net = shared
    N, n_prev, n_curr = CASES[case]
    a, b, mp, mc = pair_batch(len(case), len(n_prev), N, n_prev, n_curr)
    got = affinity_plain(*map(torch.from_numpy, (a, b, mp, mc)),
                         build_affinity_params(net, torch.float32))
    ref = pallas_affinity(*map(jnp.asarray, (a, b, mp, mc)),
                          j_build_params(variables, jcfg, BRANCHES,
                                         jnp.float32), interpret=True)
    fp = {k: jnp.asarray(a[:, i]) for i, k in enumerate(BRANCHES)}
    fc = {k: jnp.asarray(b[:, i]) for i, k in enumerate(BRANCHES)}
    mod = jnet.apply(variables, fp, fc, jnp.asarray(mp), jnp.asarray(mc),
                     method=jnet.affinity)
    for i, k in enumerate(("link", "link_norm", "new", "end")):
        assert_close(getattr(got, k), ref[i], err_msg=f"{k} vs pallas")
        assert_close(getattr(got, k), getattr(mod, k), err_msg=f"{k} vs xla")
    pm = mp[:, :, None] & mc[:, None, :]
    for k in ("link", "link_norm"):
        assert (getattr(got, k).numpy()[~pm] == 0).all()
    if case == "empty_frame":
        assert (got.link.numpy()[0] == 0).all()
        assert (got.new.numpy()[1] == 0).all()

def test_cpu_tensors_take_the_plain_version(shared):
    _, _, _, net = shared
    a, b, mp, mc = pair_batch(0, 2, 8, [3, 8], [8, 5])
    args = tuple(map(torch.from_numpy, (a, b, mp, mc)))
    params = build_affinity_params(net, torch.float32)
    before = fused_affinity.launches
    got = fused_affinity(*args, params)
    want = affinity_plain(*args, params)
    assert fused_affinity.launches == before
    for x, y in zip(got, want):
        assert torch.equal(x, y)

def test_build_is_keyed_atomic_and_cached(tmp_path, monkeypatch):
    """The library is written under a temporary name, renamed into place
    and reused on the next call (compiler stubbed: no nvcc here)."""
    calls = []

    def fake_run(cmd, capture_output, text):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "w") as f:
            f.write("lib")
        return type("P", (), {"returncode": 0, "stderr": "ptxas info"})()

    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kbuild, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kbuild.subprocess, "run", fake_run)
    first = kbuild.build("affinity")
    second = kbuild.build("affinity")
    assert first == second and first.exists() and len(calls) == 1
    assert "arch=compute_90a,code=sm_90a" in calls[0]
    assert [p.name for p in tmp_path.iterdir()] == [first.name]

def test_missing_nvcc_is_a_clear_error(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kbuild.os.path, "isfile",
                        lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kbuild.find_nvcc()
