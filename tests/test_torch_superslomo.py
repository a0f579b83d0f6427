"""Super SloMo in the port (``renderloom_torch/models/superslomo.py``)
against the benchmark's plain reference
(``rlbench/reference/models/superslomo.py``, written from the paper's
equations in NCHW), on the CPU at 64×96 with seeded random weights at
the published widths: each U-Net, the backgrounds of two clips at rate 4
and rate 3, the serving pipeline with the backend against the
reference pipeline, an identity of the blend, the U-Nets' counters and
the three spans nested in ``pipeline.background``.

Tolerances, each from its reading on this CPU and with a planted fault
beyond it:

* U-Nets: 1e-5 absolute on outputs of magnitude ~0.3.  Read: 0, as
  both sides call the same CPU convolution; the bound leaves room for
  float32 sums in another order (NHWC against NCHW).  Planted: the
  leaky slope 0.2 for 0.1 reads 0.19 and 0.20.
* Backgrounds: 1e-4 absolute on values in [0, 1].  Read: 5.0e-6 at rate
  4, 4.4e-6 at rate 3; a flow's rounding moves a bilinear sample by its
  share of the neighbours' difference, up to 1 in noise keyframes.
  Planted: V1 = V0 reads 4.4e-2, t fixed at 0.5 0.27.
* The pipeline's fused frames: 1e-4 absolute on [-1, 1].  Read: 1.8e-5,
  the backgrounds' rounding through a two-step rollout.  Planted: V1 =
  V0 reads 4.7e-2.
* The identity: 1e-6.  Read: 1.2e-7, the mean taken off and put back.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import renderloom_torch.models.superslomo as S
from rlbench import port, refrun, spec
from rlbench.reference.convert import load_flax_params as ref_load
from rlbench.reference.models.superslomo import SuperSloMo as RefSloMo
from rlbench.traffic import serve_request
from rlbench.weights import make_trees, motion_stats, tree_spec
from renderloom_torch.convert import load_flax_params
from renderloom_torch.core.config import SloMoConfig, slomo_config_from_dict
from renderloom_torch.eval.pipeline import build_pipeline

H, W = 64, 96
SEED = 2 ** 31 + 77
CELL = "slomo_standard_f32.single"
UNET_TOL, BACK_TOL, PIPE_TOL, ID_TOL = 1e-5, 1e-4, 1e-4, 1e-6
STAGES = ["background.flow_net", "background.warp", "background.time_net",
          "background.warp"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def config():
    """The cell's configuration at 64×96 with a narrow generator; Super
    SloMo at its published widths."""
    c = copy.deepcopy(spec.cell(CELL)["config"])
    data = c["renderer"]["data"]
    data.update(model_height=H, load_height=H, model_width=W, load_width=W)
    g = c["renderer"]["gen"]
    for sub in (g, g["mask"], g["embed"]):
        sub["num_filters"], sub["max_num_filters"] = 4, 32
    return c


@pytest.fixture(scope="module")
def models(config):
    """(program, reference) Super SloMo on one seeded tree."""
    with torch.device("meta"):
        specs = {"slomo": tree_spec(RefSloMo(config["slomo"]))}
    params = make_trees(specs, SEED, torch.device("cpu"))["slomo"][0]
    prog = load_flax_params(S.SuperSloMo(slomo_config_from_dict(
        config["slomo"])), params).eval()
    return prog, ref_load(RefSloMo(config["slomo"]), params).eval()


def _keys(n=2, k=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, k, H, W, 3, generator=g)


def _gap(a, b) -> float:
    return float((a - b).abs().max())


def test_the_config_is_the_published_one(config):
    assert slomo_config_from_dict(config["slomo"]) == SloMoConfig()
    assert SloMoConfig().widths == (32, 64, 128, 256, 512, 512)
    assert SloMoConfig().kernels == (7, 5, 3, 3, 3, 3)
    with pytest.raises(ValueError, match="six widths"):
        slomo_config_from_dict({"widths": [32, 64]})


@pytest.mark.parametrize("name,cin", [("flow_net", 6), ("time_net", 20)])
def test_each_unet_matches_the_reference(models, name, cin):
    prog, ref = (getattr(m, name) for m in models)
    x = torch.randn(2, H, W, cin, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want = ref(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got = prog(x)
        gap = _gap(got, want)
        prog.slope = 0.2            # planted: the leaky slope
        try:
            fault = _gap(prog(x), want)
        finally:
            prog.slope = 0.1
    print(f"{name}: {gap:.2e}, slope 0.2 {fault:.2e}")
    assert got.shape == (2, H, W, 4 if name == "flow_net" else 5)
    assert gap <= UNET_TOL < fault


@pytest.mark.parametrize("rate", [4, 3])
def test_backgrounds_match_the_reference(models, rate):
    prog, ref = models
    keys = _keys()
    with torch.inference_mode():
        got = prog(keys, rate)
        want = torch.stack([ref.backgrounds(k, rate) for k in keys])
    assert got.shape == want.shape == (2, 2 * rate + 1, H, W, 3)
    assert torch.equal(got[:, ::rate], keys)        # keyframes in slots
    gap = _gap(got, want)
    print(f"rate {rate}: {gap:.2e}")
    assert gap <= BACK_TOL


def _plant(monkeypatch, fault):
    """A background fault in the program: keyframe 1's visibility V0
    in place of 1 − V0, or every in-between frame at t = 0.5."""
    if fault == "v1_is_v0":
        monkeypatch.setattr(S, "blend", lambda w0, w1, v0, t: (
            (1 - t) * v0 * w0 + t * v0 * w1) / ((1 - t) * v0 + t * v0))
    else:
        flows, blend = S.time_flows, S.blend
        monkeypatch.setattr(S, "time_flows",
                            lambda f01, f10, t: flows(f01, f10, 0.5))
        monkeypatch.setattr(S, "blend",
                            lambda w0, w1, v0, t: blend(w0, w1, v0, 0.5))


@pytest.mark.parametrize("fault", ["v1_is_v0", "t_at_half"])
def test_planted_faults_leave_the_backgrounds_tolerance(models, fault,
                                                        monkeypatch):
    prog, ref = models
    keys = _keys()
    with torch.inference_mode():
        want = torch.stack([ref.backgrounds(k, 4) for k in keys])
        _plant(monkeypatch, fault)
        gap = _gap(prog(keys, 4), want)
    print(f"{fault}: {gap:.2e}")
    assert gap > 10 * BACK_TOL


def test_the_identity_of_zero_flows_and_even_visibility(models):
    """Both output convolutions zero: flows and their corrections 0, V0
    = σ(0) = 1/2, so It = (1 − t)·I0 + t·I1."""
    prog = copy.deepcopy(models[0])
    with torch.no_grad():
        for net in (prog.flow_net, prog.time_net):
            net.conv3.weight.zero_()
            net.conv3.bias.zero_()
    keys = _keys(seed=2)
    with torch.inference_mode():
        got = prog(keys, 4).reshape(2, -1, H, W, 3)
    for s in range(2):
        for j in range(1, 4):
            t = j / 4
            want = (1 - t) * keys[:, s] + t * keys[:, s + 1]
            gap = _gap(got[:, 4 * s + j], want)
            assert gap <= ID_TOL, (s, j, gap)


def test_shapes_it_refuses(models):
    prog = models[0]
    with pytest.raises(ValueError, match="rate"):
        prog(_keys(), 1)
    with pytest.raises(ValueError, match="divisible by 32"):
        prog(torch.rand(1, 2, 48, 96, 3), 2)


@pytest.fixture(scope="module")
def served(config):
    """The pipeline with the backend through ``build_pipeline``, the
    reference pipeline, and a request of 2 clips of 3 keyframes."""
    traffic = dict(spec.cell(CELL)["traffic"], clips_per_request=2,
                   keyframes=3)
    cpu = torch.device("cpu")
    trees = make_trees(refrun.specs(config, "serve"), SEED, cpu)
    stats = motion_stats()
    mcfg, rcfg = port.configs(config)
    fn, _, _ = build_pipeline(
        mcfg, rcfg, traffic["rate"], traffic["keyframes"],
        m_params=trees["motion"][0], g_params=trees["gen"][0],
        g_stats=trees["gen"][1], mean=stats[0], std=stats[1], device=cpu,
        slomo_cfg=slomo_config_from_dict(config["slomo"]),
        slomo_params=trees["slomo"][0])
    ref = refrun.serving(config, traffic, trees, stats, cpu)
    inputs = serve_request(traffic, (H, W), SEED, 0, cpu)
    with torch.inference_mode(), refrun.precision("float32"):
        want = ref(*inputs)
    return fn, inputs, want


def test_the_pipeline_with_the_backend_matches_the_reference(served,
                                                             monkeypatch):
    fn, inputs, want = served
    got, _ = fn(*inputs)
    assert isinstance(fn.background, S.SuperSloMo)
    assert got.shape == want.shape == (2, 9, H, W, 3)
    gap = _gap(got, want)
    _plant(monkeypatch, "v1_is_v0")
    fault = _gap(fn(*inputs)[0], want)
    print(f"pipeline: {gap:.2e}, V1 = V0 {fault:.2e}")
    assert gap <= PIPE_TOL < fault


def test_the_counters_count_a_request(served):
    fn, inputs, _ = served
    model = fn.background
    model.reset_counters()
    fn(*inputs)
    # 2 clips × 2 pairs in one flow-net call, × 3 times in one time-net
    assert (model.flow_net.calls, model.flow_net.images) == (1, 4)
    assert (model.time_net.calls, model.time_net.images) == (1, 12)


def test_the_spans_nest_in_the_background_stage(served, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    fn, inputs, _ = served
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*inputs)
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)
    events = sorted((e for e in events["traceEvents"] if e.get("ph") == "X"),
                    key=lambda e: float(e["ts"]))
    outer = [e for e in events if e["name"] == "pipeline.background"]
    inner = [e for e in events if e["name"].startswith("background.")]
    assert len(outer) == 1
    assert [e["name"] for e in inner] == STAGES
    s, e = float(outer[0]["ts"]), float(outer[0]["ts"]) + float(
        outer[0]["dur"])
    assert all(e_["cat"] == "cpu_op" and s <= float(e_["ts"])
               and float(e_["ts"]) + float(e_["dur"]) <= e for e_ in inner)


def test_lk_stays_the_default(served, config):
    """Without ``slomo_cfg`` the pipeline has no background model."""
    mcfg, rcfg = port.configs(config)
    fn, _, _ = build_pipeline(mcfg, rcfg, 4, 3, device="cpu")
    assert fn.background is None
    got, _ = fn(*served[1])
    assert got.shape == (2, 9, H, W, 3) and np.isfinite(got.numpy()).all()
