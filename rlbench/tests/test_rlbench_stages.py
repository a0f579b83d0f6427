import pytest

from rlbench import drive, spec
from rlbench.stages import OUTSIDE, SERVE, TRAIN, per_unit, split, \
    syncs_per_unit
from rlbench.trace import TraceSummary

WALL_S = 2e-3


def _op(name, ts, dur, tid=1, cat="cpu_op"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


def _rt(name, ts, corr, tid=1):
    return {"cat": "cuda_runtime", "name": name, "ts": ts, "dur": 4,
            "tid": tid, "args": {"correlation": corr}}


def _dev(name, ts, dur, corr, cat="kernel"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _trace():
    """One step of a 2 ms stretch: ``gan.d_step`` over [100, 400] and
    ``gan.g_step`` over [500, 900] µs on the main thread (tid 1), inside
    the caller's ``step`` annotation and around aten ops; a backward
    kernel launched from autograd's thread (tid 2) while the main thread
    waits in ``gan.g_step``; a launch and a sync after the spans."""
    ev = [_op("step", 0, 1000, cat="user_annotation"),
          _op("gan.d_step", 100, 300),
          _op("aten::conv2d", 110, 40),                 # nested in d_step
          _op("gan.g_step", 500, 400),
          _op("autograd::engine::evaluate_function: ConvolutionBackward0",
              600, 100, tid=2),
          _rt("cudaLaunchKernel", 120, 1),              # d_step, tid 1
          _rt("cudaMemcpyAsync", 130, 2),               # not blocking
          _rt("cudaLaunchKernel", 140, 3),              # d_step
          _rt("cudaStreamSynchronize", 300, 4),         # d_step
          _rt("cudaLaunchKernel", 650, 5, tid=2),       # g_step's backward
          _rt("cudaLaunchKernel", 950, 6),              # outside
          _rt("cudaDeviceSynchronize", 980, 7),         # outside
          _dev("void conv_fwd<float>(Args)", 200, 100, 1),
          _dev("Memcpy HtoD", 210, 10, 2, cat="gpu_memcpy"),
          _dev("void add_kernel(Args)", 250, 100, 3),   # overlaps conv_fwd
          _dev("void dgrad_kernel(Args)", 700, 100, 5),
          _dev("void tail_kernel(Args)", 1000, 100, 6)]
    return ev


def _serve_trace():
    """One request of a 2 ms stretch: the four pipeline stages on the
    main thread, each around aten ops; ``pipeline.background`` holds
    two spans of its own, ``background.flow`` (a launch, a synchronous
    copy) and ``background.synth`` (a launch), and launches two kernels
    outside them; ``pipeline.label`` synchronises; a sync after the
    request."""
    return [_op("pipeline.motion", 0, 200),
            _op("aten::linear", 10, 50),
            _op("pipeline.background", 250, 550),
            _op("background.flow", 300, 200),
            _op("aten::conv2d", 310, 40),
            _op("background.synth", 550, 150),
            _op("pipeline.label", 820, 80),
            _op("pipeline.rollout", 950, 750),
            _op("aten::conv2d", 1000, 100),
            _rt("cudaLaunchKernel", 20, 1),           # motion
            _rt("cudaLaunchKernel", 260, 2),          # background
            _rt("cudaLaunchKernel", 320, 3),          # flow
            _rt("cudaMemcpy", 450, 4),                # flow, blocking
            _rt("cudaLaunchKernel", 560, 5),          # synth
            _rt("cudaLaunchKernel", 750, 6),          # background
            _rt("cudaLaunchKernel", 830, 8),          # label
            _rt("cudaStreamSynchronize", 880, 7),     # label
            _rt("cudaLaunchKernel", 1010, 9),         # rollout
            _rt("cudaLaunchKernel", 1200, 10),        # rollout
            _rt("cudaDeviceSynchronize", 1800, 11),   # outside
            _dev("void motion_k(Args)", 100, 50, 1),
            _dev("void bg_k(Args)", 280, 60, 2),
            _dev("void flow_k(Args)", 330, 100, 3),   # overlaps bg_k
            _dev("Memcpy DtoH", 455, 5, 4, cat="gpu_memcpy"),
            _dev("void synth_k(Args)", 600, 80, 5),
            _dev("void bg_tail(Args)", 760, 30, 6),
            _dev("void label_k(Args)", 850, 20, 8),
            _dev("void roll_a(Args)", 1050, 300, 9),
            _dev("void roll_b(Args)", 1300, 200, 10)]


def _train_trace():
    """:func:`_trace` with ``gan.prep`` over [10, 90] µs (a launch) and
    ``gan.g_forward`` over [420, 490] (a launch inside an aten op, a
    sync) before the two stages it has."""
    return _trace() + [
        _op("gan.prep", 10, 80),
        _op("gan.g_forward", 420, 70),
        _op("aten::conv2d", 425, 20),
        _rt("cudaLaunchKernel", 20, 21),
        _rt("cudaLaunchKernel", 430, 22),
        _rt("cudaStreamSynchronize", 480, 23),
        _dev("void prep_k(Args)", 30, 30, 21),
        _dev("void g_fwd_k(Args)", 440, 30, 22)]


NESTED = ("background.flow", "background.synth")
CELLS = ("hsm_fastpath_bf16.batch8", "hsm_fastpath_bf16.single",
         "hsm_standard_f32.single", "hsm_standard_f32.train")
STAGED = ("busy_ms", "idle_ms", "syncs_per")
# the 27 stage metrics on the two synthetic traces (2 units a stretch),
# as they read while only the outermost spans were read
BEFORE = {
    **{f"{q}.{d}{stage}": v for d in ("serve", "serve_f32")
       for q, stage, v in (
           ("busy_ms_per_frame", ".motion", 0.025),
           ("busy_ms_per_frame", ".background", 0.1325),
           ("busy_ms_per_frame", ".label", 0.01),
           ("busy_ms_per_frame", ".rollout", 0.225),
           ("idle_ms_per_frame", ".motion", 0.0),
           ("idle_ms_per_frame", ".background", 0.1875),
           ("idle_ms_per_frame", ".label", 0.03),
           ("idle_ms_per_frame", ".rollout", 0.09),
           ("syncs_per_frame", "", 1.0))},
    "busy_ms_per_window.train.prep": 0.015,
    "busy_ms_per_window.train.g_forward": 0.015,
    "busy_ms_per_window.train.d_step": 0.075,
    "busy_ms_per_window.train.g_step": 0.05,
    "idle_ms_per_window.train.prep": 0.0,
    "idle_ms_per_window.train.g_forward": 0.045,
    "idle_ms_per_window.train.d_step": 0.07,
    "idle_ms_per_window.train.g_step": 0.115,
    "syncs_per_window.train": 1.0,
}


def _stage_metrics(name):
    cell = spec.cell(name)
    events = _train_trace() if cell["traffic"]["kind"] == "train" \
        else _serve_trace()
    ctx = drive.layer_context(TraceSummary(events, WALL_S), "float32",
                              2, 0, 1.0, None, None)
    return {k: v["value"] for k, v in drive.per_layer(cell, ctx).items()
            if k.split(".")[0].startswith(STAGED)}


def test_the_stage_metrics_read_as_before_nested_spans():
    got = {}
    for name in CELLS:
        got.update(_stage_metrics(name))
    assert len(got) == 27
    assert got == pytest.approx(BEFORE, rel=1e-12, abs=0)


def test_a_nested_stage_is_split_from_the_stage_around_it():
    tr = TraceSummary(_serve_trace(), WALL_S)
    alone = split(tr, SERVE)
    nested = split(tr, SERVE + NESTED)
    flow, synth = nested["background.flow"], nested["background.synth"]
    # flow_k covers [340, 430) past bg_k, the copy [455, 460) after a
    # gap of 25 µs; synth_k [600, 680) after a gap of 140 µs
    assert flow["busy_s"] == pytest.approx(95e-6)
    assert flow["idle_s"] == pytest.approx(25e-6)
    assert (flow["launches"], flow["syncs"], flow["spans"]) == (1, 1, 1)
    assert synth["busy_s"] == pytest.approx(80e-6)
    assert synth["idle_s"] == pytest.approx(140e-6)
    assert (synth["launches"], synth["syncs"], synth["spans"]) == (1, 0, 1)
    outer = nested["pipeline.background"]
    assert outer["launches"] == 2 and outer["spans"] == 1
    for field in ("busy_s", "idle_s", "launches", "syncs"):
        assert outer[field] + flow[field] + synth[field] == pytest.approx(
            alone["pipeline.background"][field])
    for stage in SERVE[:1] + SERVE[2:] + (OUTSIDE,):
        assert nested[stage] == alone[stage]
    # idle gaps are still named by the outermost host operation
    gaps = dict(tr.idle_gaps())
    assert gaps["pipeline.background -> synth_k"] == pytest.approx(140e-6)


def test_a_nested_stage_that_starts_with_its_parent_is_the_innermost():
    ev = [_op("pipeline.background", 0, 100),
          _op("background.flow", 0, 50),
          _rt("cudaLaunchKernel", 10, 1), _rt("cudaLaunchKernel", 60, 2),
          _dev("k1", 20, 10, 1), _dev("k2", 70, 10, 2)]
    got = split(TraceSummary(ev, 1e-3), SERVE + NESTED)
    assert got["background.flow"]["launches"] == 1
    assert got["pipeline.background"]["launches"] == 1


def test_spans_place_device_time_launches_and_syncs():
    got = split(TraceSummary(_trace(), WALL_S), TRAIN)
    assert set(got) == {"gan.d_step", "gan.g_step", OUTSIDE}
    d, g, out = got["gan.d_step"], got["gan.g_step"], got[OUTSIDE]
    # [200, 350) covered once though three intervals overlap in it
    assert d["busy_s"] == pytest.approx(150e-6)
    assert (d["launches"], d["syncs"], d["spans"]) == (2, 1, 1)
    # the backward kernel, launched on another thread inside g_step's
    # interval, is g_step's, and so is the gap its launch ends
    assert g["busy_s"] == pytest.approx(100e-6)
    assert g["idle_s"] == pytest.approx(350e-6)
    assert (g["launches"], g["syncs"]) == (1, 0)
    assert (out["launches"], out["syncs"], out["spans"]) == (1, 1, 0)
    assert out["busy_s"] == pytest.approx(100e-6)
    # the gap before the tail kernel and the stretch's lead and tail
    assert out["idle_s"] == pytest.approx(200e-6 + WALL_S - 900e-6)


def test_the_parts_add_up_to_busy_and_idle():
    tr = TraceSummary(_trace(), WALL_S)
    got = split(tr, TRAIN)
    assert sum(v["busy_s"] for v in got.values()) == pytest.approx(
        tr.busy_s)
    assert sum(v["idle_s"] for v in got.values()) == pytest.approx(
        tr.wall_s - tr.busy_s)
    assert sum(v["launches"] for v in got.values()) == tr.launches


def test_the_span_that_started_last_holds_a_timestamp():
    ev = [_op("pipeline.rollout", 0, 1000),
          _op("pipeline.label", 100, 100, tid=3),
          _rt("cudaLaunchKernel", 150, 1), _rt("cudaLaunchKernel", 500, 2),
          _dev("k1", 160, 10, 1), _dev("k2", 510, 10, 2)]
    got = split(TraceSummary(ev, 1e-3), SERVE)
    assert got["pipeline.label"]["launches"] == 1
    assert got["pipeline.rollout"]["launches"] == 1
    assert got["pipeline.rollout"]["idle_s"] == pytest.approx(340e-6)


def test_readers_none_without_spans_and_a_number_with_them():
    ctx = drive.layer_context(TraceSummary(_trace(), WALL_S), "float32",
                              2, 0, 1.0, None, None)
    assert per_unit(ctx, "gan.prep", TRAIN, "busy_s") is None
    assert per_unit(ctx, "gan.d_step", TRAIN, "busy_s", 1e3) == \
        pytest.approx(0.075)
    assert syncs_per_unit(ctx, TRAIN) == 0.5
    assert syncs_per_unit(ctx, SERVE) is None
    for name, reads in (("hsm_standard_f32.train", 5),
                        ("hsm_fastpath_bf16.single", 0)):
        got = drive.per_layer(spec.cell(name), dict(ctx))
        staged = [k for k in got if k.split(".")[0].startswith(
            ("busy_ms", "idle_ms", "syncs_per"))]
        assert len(staged) == reads, got
    # a trace of a program without spans: every stage metric is left out
    bare = [e for e in _trace() if not e["name"].startswith("gan.")]
    ctx = drive.layer_context(TraceSummary(bare, WALL_S), "float32",
                              2, 0, 1.0, None, None)
    got = drive.per_layer(spec.cell("hsm_standard_f32.train"), ctx)
    assert not [k for k in got if k.startswith(("busy_ms", "idle_ms",
                                                "syncs_per"))]
