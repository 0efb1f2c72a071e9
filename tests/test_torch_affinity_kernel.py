"""The fused affinity of the port: ``affinity_plain`` (the CUDA kernel's
plain version) against the JAX package's Pallas kernel in interpret mode
and against ``TrackingNet.affinity``, with shared weights, for every
instance: the correlation ops (one, two, all four: W1 of len(ops) x D
rows, a net of those ops each), the pools and softmax modes (the same
weights, the JAX net configured with them), and N up to 192.  The CUDA
kernel itself is held to ``affinity_plain`` on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmot_tpu.kernels import build_affinity_params as j_build_params
from mmmot_tpu.kernels import pallas_affinity
from mmmot_tpu.models import model_entry
from mmmot_tpu.models.affinity import normalize_link as j_normalize_link
from mmmot_tpu_torch.config import full_mmmot, tiny_debug
from mmmot_tpu_torch.kernels import build as kbuild
from mmmot_tpu_torch.kernels.affinity import (affinity_plain,
                                              build_affinity_params,
                                              check_widths, fused_affinity)
from mmmot_tpu_torch.models.tracking_net import score_branches

from tests.torch_port_fixtures import (assert_close, init_flax, port_net,
                                       tiny_cfg_jax, torch_one_thread)  # noqa: F401

D = 64
BRANCHES = score_branches(tiny_debug().model)     # fused, image, lidar

@pytest.fixture(scope="module")
def shared():
    jcfg = tiny_cfg_jax().model
    jnet, variables = init_flax(jcfg)
    net = port_net(variables, tiny_debug().model)
    return jcfg, jnet, variables, net


def with_instance(model_cfg, ops, pool, mode):
    """``model_cfg`` with the correlation ops, new/end pool and softmax
    mode of an instance."""
    return dataclasses.replace(
        model_cfg,
        affinity=dataclasses.replace(model_cfg.affinity,
                                     correlation_ops=ops, softmax_mode=mode),
        new_end=dataclasses.replace(model_cfg.new_end, pool=pool))


@pytest.fixture(scope="module")
def instance_nets(shared):
    """(JAX config, flax net, variables, port net) of an instance: the
    shared weights for subabs (a pool or mode changes no weight), a net
    initialised with the ops otherwise (W1 has len(ops) x D rows)."""
    cache = {}

    def get(ops, pool, mode):
        if ops not in cache:
            if ops == ("subabs",):
                cache[ops] = shared[2]
            else:
                cache[ops] = init_flax(with_instance(
                    tiny_cfg_jax().model, ops, "max", "dual"))[1]
        variables = cache[ops]
        jcfg = with_instance(tiny_cfg_jax().model, ops, pool, mode)
        net = port_net(variables, with_instance(tiny_debug().model, ops,
                                                pool, mode))
        return jcfg, model_entry(jcfg), variables, net
    return get

def slot_masks(N, spec):
    """One row per frame pair: an int is a prefix count of valid slots,
    a tuple the valid slots themselves (a mask with holes)."""
    ar = np.arange(N)
    return np.stack([ar < s if isinstance(s, int) else np.isin(ar, s)
                     for s in spec])

def pair_batch(seed, B, N, n_prev, n_curr):
    r = np.random.default_rng(seed)
    a = r.normal(0, 1, (B, 3, N, D)).astype(np.float32)
    b = r.normal(0, 1, (B, 3, N, D)).astype(np.float32)
    return a, b, slot_masks(N, n_prev), slot_masks(N, n_curr)

CASES = {
    "partial": (8, [5, 8, 1], [7, 2, 8]),
    "empty_frame": (8, [0, 6], [4, 0]),
    "n13": (13, [13, 9, 4], [11, 13, 0]),
    "holed_alternating": (8, [(0, 2, 4, 6), (1, 3, 5, 7)],
                          [(1, 3, 5, 7), (0, 2, 4, 6)]),
    "holed_last_slot": (8, [(7,), 5], [(7,), (7,)]),
    "holed_n13_full_row": (13, [13, 13], [(0, 3, 4, 9, 12), (1, 6, 7)]),
    # The additive link bias (the learned motion term), with an empty
    # frame and holes: added before the mask, the softmax and the pools.
    "link_bias": (8, [5, 0, (0, 3, 6)], [8, 4, (1, 3, 7)]),
    # N above 64 (the revival's 2N slots at max_dets 64): holed masks, an
    # empty frame on either side, a full frame.
    "n100": (100, [(0, 7, 33, 64, 65, 99), 0, 100],
             [tuple(range(1, 100, 3)), 57, 0]),
    "n128": (128, [128, (5, 64, 96, 127), 0],
             [tuple(range(0, 128, 2)), 0, (31, 32, 63, 64, 127)]),
    # N above 128 (launch 2 streams its lines from device memory): the
    # revival's 2N = 192 slots at max_dets 96, and N=130 past a ballot
    # word; holed, empty and full frames.
    "n130": (130, [(0, 64, 128, 129), 130], [130, (1, 127, 129)]),
    "n192": (192, [tuple(range(0, 192, 3)), 0, 192],
             [(0, 95, 96, 191), 120, 0]),
}
# Instances (correlation ops, pool, softmax mode) of the cases below;
# every other case runs the shipped instance (subabs, max, dual).
INSTANCES = {
    "op_mul": (("mul",), "max", "dual"),
    "op_diff": (("diff",), "max", "dual"),
    "op_cosine": (("cosine",), "max", "dual"),
    "ops_subabs_mul": (("subabs", "mul"), "max", "dual"),
    "ops_all_four": (("mul", "subabs", "diff", "cosine"), "max", "dual"),
    "pool_mean": (("subabs",), "mean", "dual"),
    "pool_softmax": (("subabs",), "softmax", "dual"),
    "mode_single": (("subabs",), "max", "single"),
    "mode_none": (("subabs",), "max", "none"),
    "n128_all_ops_softmax_none": (("mul", "subabs", "diff", "cosine"),
                                  "softmax", "none"),
    "n100_cosine_mean_single": (("cosine",), "mean", "single"),
}
for _name in INSTANCES:
    CASES[_name] = ((128, [128, (5, 64, 96, 127), 0],
                     [tuple(range(0, 128, 2)), 0, (31, 32, 63, 64, 127)])
                    if _name.startswith("n128") else
                    (100, [(0, 7, 33, 64, 65, 99), 0, 100],
                     [tuple(range(1, 100, 3)), 57, 0])
                    if _name.startswith("n100") else
                    (8, [5, 0, (0, 3, 6)], [8, 4, (1, 3, 7)]))

def test_params_match_reference(shared):
    jcfg, _, variables, net = shared
    ref = j_build_params(variables, jcfg, BRANCHES, jnp.float32)
    got = build_affinity_params(net, torch.float32)
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
        assert_close(got[k], ref[k], err_msg=k)

@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret_and_module_path(shared,
                                                        instance_nets, case):
    ops, pool, mode = INSTANCES.get(case, (("subabs",), "max", "dual"))
    jcfg, jnet, variables, net = (shared if case not in INSTANCES
                                  else instance_nets(ops, pool, mode))
    N, n_prev, n_curr = CASES[case]
    a, b, mp, mc = pair_batch(len(case), len(n_prev), N, n_prev, n_curr)
    bias = None
    if case == "link_bias":
        bias = np.random.default_rng(5).normal(
            0, 2, (len(n_prev), N, N)).astype(np.float32)
    params = build_affinity_params(net, torch.float32)
    assert params["w1"].shape[1] == len(ops) * D
    got = affinity_plain(*map(torch.from_numpy, (a, b, mp, mc)), params,
                         None if bias is None else torch.from_numpy(bias),
                         ops=ops, pool=pool, softmax_mode=mode)
    ref = pallas_affinity(*map(jnp.asarray, (a, b, mp, mc)),
                          j_build_params(variables, jcfg, BRANCHES,
                                         jnp.float32), interpret=True,
                          link_bias=None if bias is None
                          else jnp.asarray(bias), ops=ops, pool=pool,
                          softmax_mode=mode)
    fp = {k: jnp.asarray(a[:, i]) for i, k in enumerate(BRANCHES)}
    fc = {k: jnp.asarray(b[:, i]) for i, k in enumerate(BRANCHES)}
    mod = jnet.apply(variables, fp, fc, jnp.asarray(mp), jnp.asarray(mc),
                     method=jnet.affinity)
    if bias is not None:
        # The module path with the term added to its raw link, as
        # TrackingNet.affinity_link adds the motion term.
        jm, jc = jnp.asarray(mp), jnp.asarray(mc)
        link = mod.link + jnp.asarray(bias) * (jm[:, :, None] & jc[:, None])
        new, end = jnet.apply(variables, fp["fused"], fc["fused"], link, jm,
                              jc, method=lambda m, *x: m.new_end(
                                  *x, train=False))
        mod = mod._replace(link=link, link_norm=j_normalize_link(link, jm, jc),
                           new=new, end=end)
        unbiased = affinity_plain(*map(torch.from_numpy, (a, b, mp, mc)),
                                  params)
        assert (got.link - unbiased.link).abs().max() > 1e-4
    for i, k in enumerate(("link", "link_norm", "new", "end")):
        assert_close(getattr(got, k), ref[i], err_msg=f"{k} vs pallas")
        assert_close(getattr(got, k), getattr(mod, k), err_msg=f"{k} vs xla")
    pm = mp[:, :, None] & mc[:, None, :]
    for k in ("link", "link_norm"):
        assert (getattr(got, k).numpy()[~pm] == 0).all()
    if case == "empty_frame":
        assert (got.link.numpy()[0] == 0).all()
        assert (got.new.numpy()[1] == 0).all()
    if case in INSTANCES:      # the instance is not the shipped one's
        shipped = affinity_plain(*map(torch.from_numpy, (a, b, mp, mc)),
                                 build_affinity_params(shared[3],
                                                       torch.float32))
        assert any((x - y).abs().max() > 1e-4 for x, y in zip(got, shipped))

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

@pytest.mark.parametrize("preset", [tiny_debug, full_mmmot])
def test_check_widths_takes_the_presets(preset):
    m = preset().model
    for N in (1, 32, 64, 128, 129, 256, 512):
        check_widths(N, m.fusion.out_dim, m.affinity.hidden_dim,
                     m.new_end.hidden_dim)

@pytest.mark.parametrize("widths", [(0, 64, 32, 32), (513, 64, 32, 32),
                                    (32, 72, 32, 32), (32, 64, 36, 32),
                                    (32, 64, 32, 12), (32, 0, 32, 32)])
def test_check_widths_rejects_untiled_widths(widths):
    with pytest.raises(ValueError):
        check_widths(*widths)

def test_ptxas_and_sass_summaries():
    # The library's own kernels as nvcc mangles them (sm_90a build).
    ns = "_ZN44_GLOBAL__N__773f31a4_11_affinity_cu_557b72dc"
    products = (f"{ns}15products_kernelI13__nv_bfloat16EEvPKT_S4_PKhS6_S4_"
                "S4_PKfS8_S8_S8_S4_S8_S4_S4_PfS9_iiiii")
    finish = (f"{ns}13finish_kernelIfLb0EEvPKfS2_PKhS4_S2_S2_PKT_S2_S2_S2_"
              "S7_S2_PS5_S8_S8_S8_S2_iii")
    finish_bias = finish.replace("IfLb0EE", "I13__nv_bfloat16Lb1EE")
    # launch 2's instances with a lane's entries of a line as their last
    # argument (4: lines in shared memory, 16: streamed)
    finish_4, finish_16 = (finish.replace("IfLb0EE", f"IfLb0ELi{u}EEE")
                           for u in (4, 16))
    finish_bias_16 = finish.replace("IfLb0EE", "I13__nv_bfloat16Lb1ELi16EEE")
    log = (f"ptxas info    : Compiling entry function '{products}' for "
           "'sm_90a'\n"
           f"ptxas info    : Function properties for {products}\n"
           "    48 bytes stack frame, 40 bytes spill stores, 40 bytes spill "
           "loads\n"
           "ptxas info    : Used 128 registers, used 1 barriers, 5504 bytes "
           "smem, 480 bytes cmem[0]\n"
           f"ptxas info    : Compiling entry function '{finish}' for "
           "'sm_90a'\n"
           "ptxas info    : Used 48 registers, used 1 barriers, 34560 bytes "
           "smem\n"
           f"ptxas info    : Compiling entry function '{finish_bias}' for "
           "'sm_90a'\n"
           "ptxas info    : Used 50 registers, used 1 barriers, 34560 bytes "
           "smem\n")
    log += "".join(f"ptxas info    : Compiling entry function '{name}' for "
                   f"'sm_90a'\nptxas info    : Used {regs} registers, used 1 "
                   "barriers, 2432 bytes smem\n"
                   for name, regs in ((finish_4, 64), (finish_16, 80),
                                      (finish_bias_16, 80)))
    assert kbuild.ptxas_summary(log) == {
        "products_kernel<bf16>": dict(stack=48, spill_stores=40,
                                      spill_loads=40, registers=128,
                                      smem=5504),
        "finish_kernel<f32>": dict(registers=48, smem=34560),
        "finish_kernel<bf16,bias>": dict(registers=50, smem=34560),
        "finish_kernel<f32,4>": dict(registers=64, smem=2432),
        "finish_kernel<f32,16>": dict(registers=80, smem=2432),
        "finish_kernel<bf16,bias,16>": dict(registers=80, smem=2432)}
    sass = (f"\t\tFunction : {products}\n"
            "        /*0450*/                   HMMA.16816.F32.BF16 R24, R4, "
            "R20, R24 ;   /* 0x000000140418723c */\n"
            "                                      /* 0x000fe20000001844 */\n"
            "        /*0460*/               @!P0 HMMA.16816.F32.BF16 R8, R4, "
            "R20, R8 ;\n"
            "        /*0470*/                   FFMA R1, R2, R3, R4 ;\n"
            f"\t\tFunction : {finish}\n"
            "        /*0010*/                   FFMA R1, R2, R3, R4 ;\n")
    assert kbuild.sass_counts(sass) == {
        "products_kernel<bf16>": {"HMMA": 2, "HGMMA": 0},
        "finish_kernel<f32>": {"HMMA": 0, "HGMMA": 0}}

def test_missing_nvcc_is_a_clear_error(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kbuild.os.path, "isfile",
                        lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kbuild.find_nvcc()
