"""The port's stage spans (``renderloom_torch.utils.profiling.annotate``).

Under ``torch.profiler`` a serving request holds ``pipeline.motion``,
``pipeline.background``, ``pipeline.label`` and ``pipeline.rollout``
once each, in that order, inside the caller's span; a train step on raw
windows holds ``gan.prep`` once and then ``gan.g_forward``,
``gan.d_step`` and ``gan.g_step`` per trained frame.  The trace lists
them as host operations (``cpu_op``), which is where the benchmark's
trace reduction (``rlbench/stages.py``) finds them.  With no profiler on
a request and a step make no profiler record at all, and the frozen
``torch.export`` program holds no profiler op.  Port code only, on the
CPU at 64×96 with tiny widths."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import renderloom_torch.core.config as TC
from _torch_parity import motion_cfg, renderer_cfg, single_thread  # noqa: F401
from renderloom_torch.cli.train_renderer import synthetic_batches
from renderloom_torch.eval.export import export_pipeline
from renderloom_torch.eval.pipeline import build_pipeline
from renderloom_torch.train import gan as TG
from renderloom_torch.utils import profiling

H, W, RATE, K = 64, 96, 2, 3
B, L = 2, 4
SERVE = ("pipeline.motion", "pipeline.background", "pipeline.label",
         "pipeline.rollout")
TRAIN = ("gan.prep", "gan.g_forward", "gan.d_step", "gan.g_step")


@pytest.fixture(scope="module")
def pipeline(single_thread):
    """A one-clip pipeline from random weights, its models, and inputs."""
    mean = np.zeros((19, 2), np.float32)
    mean[-1] = (-0.8, -0.85)
    fn, m_model, gen = build_pipeline(
        motion_cfg(TC), renderer_cfg(TC, H, W), RATE, K, device="cpu",
        mean=mean, std=np.full((19, 2), 0.02, np.float32))
    rng = np.random.default_rng(0)
    motion = np.stack([rng.uniform(-0.9, -0.7, (1, 19, K)),
                       rng.uniform(-0.9, -0.8, (1, 19, K))], axis=2)
    inputs = (torch.from_numpy(motion.astype(np.float32)),
              torch.full((1, 19, 1, K), 0.9),
              torch.from_numpy(rng.uniform(0, 1, (1, K, H, W, 3))
                               .astype(np.float32)))
    return fn, m_model, gen, inputs


@pytest.fixture(scope="module")
def training(single_thread):
    """A tiny train state, its step on raw windows, and a raw window."""
    tiny = lambda n, layers=2: TC.PatchDiscConfig(
        num_filters=4, max_num_filters=16, num_discriminators=n,
        num_layers=layers)
    base = renderer_cfg(TC, H, W)
    cfg = dataclasses.replace(
        base, batch_size=B,
        data=dataclasses.replace(base.data, max_frames=L),
        dis=TC.DiscriminatorConfig(image=tiny(2), face=tiny(1),
                                   hand=tiny(1, layers=1)))
    state = TG.create_gan_state(cfg, "cpu", seed=3)
    step = TG.make_gan_train_step(cfg, TG.make_perceptual(cfg, "cpu", seed=0),
                                  data_cfg=cfg.data)
    raw = next(synthetic_batches(np.random.default_rng(1), 1, B, L, H, W))
    return state, step, {k: torch.from_numpy(v) for k, v in raw.items()}


def _traced(tmp_path, caller: str, fn):
    """Run ``fn`` under the profiler inside a ``caller`` annotation; the
    Chrome trace's complete events, by start."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(caller):
            fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events) if isinstance(events, dict) \
        else events
    return sorted((e for e in events if e.get("ph") == "X"),
                  key=lambda e: float(e["ts"]))


def _within(inner, outer) -> bool:
    s, e = float(outer["ts"]), float(outer["ts"]) + float(outer["dur"])
    return s <= float(inner["ts"]) and \
        float(inner["ts"]) + float(inner["dur"]) <= e


def test_a_request_holds_the_four_stages_in_order(pipeline, tmp_path):
    fn, _, _, inputs = pipeline
    events = _traced(tmp_path, "request", lambda: fn(*inputs))
    request = [e for e in events if e["name"] == "request"]
    stages = [e for e in events if e["name"] in SERVE]
    assert [e["name"] for e in stages] == list(SERVE)
    assert len(request) == 1
    assert all(e["cat"] == "cpu_op" and _within(e, request[0])
               for e in stages)
    # each stage ends before the next begins, and each holds its work
    assert all(float(a["ts"]) + float(a["dur"]) <= float(b["ts"])
               for a, b in zip(stages, stages[1:]))
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"].startswith("aten::")]
    for stage in stages:
        assert any(_within(op, stage) for op in ops), stage["name"]


def test_a_step_holds_prep_once_then_three_stages_a_frame(training,
                                                          tmp_path):
    state, step, raw = training
    events = _traced(tmp_path, "step", lambda: step(state, raw))
    outer = [e for e in events if e["name"] == "step"]
    stages = [e for e in events if e["name"] in TRAIN]
    assert [e["name"] for e in stages] == \
        ["gan.prep"] + list(TRAIN[1:]) * (L - 2)
    assert all(e["cat"] == "cpu_op" and _within(e, outer[0])
               for e in stages)
    assert all(float(a["ts"]) + float(a["dur"]) <= float(b["ts"])
               for a, b in zip(stages, stages[1:]))


def test_no_profiler_record_without_a_profiler(pipeline, training,
                                               monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler record with no profiler on")

    assert not torch.autograd._profiler_enabled()
    assert profiling.annotate("a") is profiling.annotate("b")
    for owner, name in ((torch.profiler, "record_function"),
                        (torch.autograd.profiler, "record_function"),
                        (torch._C._profiler, "_RecordFunctionFast")):
        monkeypatch.setattr(owner, name, refuse)
    fn, _, _, inputs = pipeline
    fused, _ = fn(*inputs)
    assert fused.shape == (1, (K - 1) * RATE + 1, H, W, 3)
    state, step, raw = training
    metrics = step(state, raw)
    assert torch.isfinite(metrics["g/total"])


def test_the_frozen_program_holds_no_profiler_op(pipeline):
    fn, m_model, gen, _ = pipeline
    ep, _ = export_pipeline(fn, m_model, gen, 1, K, H, W, RATE, "cpu")
    targets = [str(node.target) for mod in ep.graph_module.modules()
               if isinstance(mod, torch.fx.GraphModule)
               for node in mod.graph.nodes]
    assert any("renderloom" in t for t in targets)
    assert not [t for t in targets if "profiler" in t
                or "record_function" in t]
