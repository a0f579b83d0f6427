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
