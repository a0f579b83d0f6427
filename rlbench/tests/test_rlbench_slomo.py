"""The ``slomo`` build (Super SloMo's backgrounds in hsm's serving
pipeline) at 64×96 on the CPU, its look for a card skipped: it draws
hsm's trees as hsm does and its own after them; its reference files
import nothing of the program; its FLOP count is the reference's as
``drive.FlopCount`` prices it; and the loop judges the sound program
correct and each planted background fault not."""

import json
import subprocess
import sys
import time

import pytest
import torch

from rlbench import drive, refrun, serve, spec
from rlbench.builds import slomo
from rlbench.weights import make_trees

from conftest import ROOT, tiny_cell

SEED = 2 ** 31 + 59
CELL = "slomo_standard_f32.single"


def _leaves(tree, path=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _hsm_config(config):
    out = dict(config)
    for key in ("build", "slomo"):
        out.pop(key)
    return out


def _differing(a, b):
    """Values of the shared trees ``a`` draws otherwise than ``b``."""
    n = 0
    for name in b:
        for part in (0, 1):
            la, lb = dict(_leaves(a[name][part])), dict(_leaves(b[name][part]))
            assert la.keys() == lb.keys()
            n += sum(int((la[k] != lb[k]).sum()) for k in la)
    return n


def test_the_build_draws_the_shared_trees_of_hsm(cpu):
    config = tiny_cell(CELL)["config"]
    specs = refrun.specs(config, "serve")
    assert list(specs) == ["gen", "motion", "slomo"]
    got = make_trees(specs, SEED, cpu)
    base = make_trees(refrun.specs(_hsm_config(config), "serve"), SEED, cpu)
    assert set(got) == set(base) | {"slomo"}
    # the CPU's torch.randn draws the last 16 values of a call whose
    # length is not a multiple of 16 anew (rlbench.builds); on the card
    # hsm's draws are a prefix, bit for bit (the card test)
    assert _differing(got, base) <= 16
    n = sum(v.size for _, v in _leaves(got["slomo"][0]))
    assert n == 39_610_473          # the two U-Nets' published count
    assert not got["slomo"][1]      # no spectral norm, no statistics


def test_the_build_draws_the_shared_trees_of_hsm_on_the_card(card):
    config = spec.cell(CELL)["config"]
    got = make_trees(refrun.specs(config, "serve"), SEED, card)
    base = make_trees(refrun.specs(_hsm_config(config), "serve"), SEED,
                      card)
    assert _differing(got, base) == 0


def test_the_reference_files_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import rlbench.reference.models.superslomo, "
            "rlbench.reference.eval.slomo_pipeline; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert "rlbench" in loaded
    assert not loaded & {"renderloom_torch", "renderloom", "jax", "flax"}


@pytest.mark.parametrize("size", [(64, 96), (320, 480)])
def test_the_flop_count_is_the_references(size):
    from rlbench.reference.models.superslomo import SuperSloMo
    config = spec.cell(CELL)["config"]
    h, w = size
    with torch.device("meta"):
        model = SuperSloMo(config["slomo"])
        got = {}
        for name, cin in (("flow_net", 6), ("time_net", 20)):
            with drive.FlopCount() as fc:
                getattr(model, name)(torch.empty(1, cin, h, w))
            got[name] = fc.total
    config["renderer"]["data"].update(model_height=h, model_width=w)
    one = dict(clips_per_request=1, keyframes=2, rate=2)
    want = slomo.unet_flops(config, one)
    assert got == {k: want[k] for k in got}
    if size == (320, 480):          # the issue's 98 and 105 GFLOP a call
        assert round(got["flow_net"] / 1e9, 1) == 98.4
        assert round(got["time_net"] / 1e9, 1) == 105.2


def test_the_metric_data_is_the_builds_count():
    cell = spec.cell(CELL)
    with open(f"{ROOT}/rlbench/metrics/unet_mfu_pct.serve_f32.json") as f:
        data = json.load(f)
    want = slomo.unet_flops(cell["config"], cell["traffic"])["per_frame"]
    assert data["flops_per_frame"] == pytest.approx(want, rel=1e-12)


def _serve(monkeypatch=None, fault=None):
    import renderloom_torch.models.superslomo as program
    if fault == "v1_is_v0":
        monkeypatch.setattr(program, "blend", lambda w0, w1, v0, t: (
            (1 - t) * v0 * w0 + t * v0 * w1) / ((1 - t) * v0 + t * v0))
    elif fault == "t_at_half":
        flows, blend = program.time_flows, program.blend
        monkeypatch.setattr(program, "time_flows",
                            lambda f01, f10, t: flows(f01, f10, 0.5))
        monkeypatch.setattr(program, "blend",
                            lambda w0, w1, v0, t: blend(w0, w1, v0, 0.5))
    return serve.run(tiny_cell(CELL), SEED, 0.5, False, torch.device("cpu"),
                     time.perf_counter())


def test_the_sound_program_is_correct():
    res = _serve()
    assert res["correct"], res["check"]
    assert res["readings"]["frame_gap"] < 1e-4


@pytest.mark.parametrize("fault", ["v1_is_v0", "t_at_half"])
def test_planted_background_faults_are_caught(monkeypatch, fault):
    res = _serve(monkeypatch, fault)
    assert not res["correct"], res["check"]


def _slomo_trace():
    """One request (2 frames) whose ``pipeline.background`` holds
    Super SloMo's stages: the flow net (100 µs of kernels), a warp (20),
    the time net (200), a warp (30), and a kernel of its own (30)."""
    from test_rlbench_stages import _dev, _op, _rt
    ev = [_op("pipeline.background", 250, 550),
          _op("background.flow_net", 300, 100),
          _op("background.warp", 410, 40),
          _op("background.time_net", 460, 140),
          _op("background.warp", 610, 90)]
    for i, (ts, start, dur) in enumerate(((320, 330, 100),
                                          (420, 440, 20),
                                          (470, 480, 200),
                                          (620, 690, 30),
                                          (750, 760, 30)), start=1):
        ev += [_rt("cudaLaunchKernel", ts, i),
               _dev(f"void k{i}(Args)", start, dur, i)]
    return ev


def test_the_readers_split_the_background_and_price_the_unets():
    from rlbench.trace import TraceSummary
    cell = spec.cell(CELL)
    read = lambda ev: drive.per_layer(cell, drive.layer_context(
        TraceSummary(ev, 2e-3), "float32", 2, 0, 1.0, None, None))
    got = {k: v["value"] for k, v in read(_slomo_trace()).items()}
    stage = "busy_ms_per_frame.serve_f32.background"
    assert got[stage] == pytest.approx(0.19)        # 380 µs, 2 frames
    parts = {s: got[f"{stage}.{s}"] for s in ("flow_net", "time_net",
                                              "warp")}
    assert parts == pytest.approx({"flow_net": 0.05, "time_net": 0.1,
                                   "warp": 0.025})
    # what the background keeps outside its nested spans: one kernel
    assert got[stage] - sum(parts.values()) == pytest.approx(0.015)
    with open(f"{ROOT}/rlbench/metrics/unet_mfu_pct.serve_f32.json") as f:
        flops = json.load(f)["flops_per_frame"]
    assert got["unet_mfu_pct.serve_f32"] == pytest.approx(
        100 * flops / 0.15e-3 / 67e12)
    # a program without the nested spans (the parent): no new metric
    bare = [e for e in _slomo_trace()
            if not e["name"].startswith("background.")]
    got = read(bare)
    assert stage in got
    assert not [k for k in got if k.startswith(stage + ".")
                or k.startswith("unet_")]
