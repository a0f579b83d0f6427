import json

import pytest

from rlbench import peaks
from rlbench.metrics import _layer
from rlbench.trace import TraceSummary, reduce_trace, union_length


def _trace():
    """Two host ops launching three kernels, one copy; device busy over
    [100, 200) ∪ [150, 260) ∪ [400, 450) µs of a 1 ms stretch."""
    ev = []
    ev.append({"cat": "cpu_op", "name": "aten::conv2d", "ts": 0, "dur": 90,
               "tid": 1})
    ev.append({"cat": "cpu_op", "name": "aten::add", "ts": 300, "dur": 80,
               "tid": 1})
    for corr, ts in ((1, 10), (2, 20), (3, 310)):
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": ts, "dur": 5, "tid": 1,
                   "args": {"correlation": corr}})
    ev.append({"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 30,
               "dur": 5, "tid": 1, "args": {"correlation": 4}})
    ev.append({"cat": "kernel", "name": "void norm_fwd_kernel<float>(Args)",
               "ts": 100, "dur": 100, "args": {"correlation": 1}})
    ev.append({"cat": "kernel", "name": "void cluster_fwd<float>(Args)",
               "ts": 150, "dur": 110, "args": {"correlation": 2}})
    ev.append({"cat": "kernel", "name": "sm90_conv", "ts": 400, "dur": 50,
               "args": {"correlation": 3}})
    ev.append({"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 260,
               "dur": 0, "args": {"correlation": 4}})
    return ev


def test_union_and_idle_from_a_synthetic_trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _trace()}))
    tr = reduce_trace(str(path), 1e-3)
    assert not path.exists()
    assert union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert tr.busy_s == pytest.approx(210e-6)
    assert tr.launches == 3
    ctx = {"trace": tr}
    assert _layer.idle_pct(ctx) == pytest.approx(79.0)
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::add -> sm90_conv"] == pytest.approx(140e-6)
    ops = dict(tr.device_ops())
    assert ops["norm_fwd_kernel<float>"] == pytest.approx(100e-6)


def test_roofline_and_mfu_arithmetic():
    tr = TraceSummary(_trace(), 1e-3)
    kernels = ["norm_fwd_kernel", "cluster_fwd"]
    assert tr.kernel_s(kernels) == pytest.approx(210e-6)
    # 2 units of 0.2 GB each: least time 0.4e9 / 3.35e12 s
    ctx = {"trace": tr, "units_stretch": 2}
    got = _layer.roofline_pct(ctx, kernels, 0.2e9)
    assert got == pytest.approx(100 * 0.4e9 / peaks.HBM_BYTES_PER_S
                                / 210e-6)
    assert _layer.roofline_pct(ctx, ["absent"], 0.2e9) is None
    mctx = {"flops_per_unit": 1e12, "units_after": 10, "seconds_after": 2.0,
            "peak_flops": peaks.FLOPS_PER_S["bfloat16"]}
    assert _layer.mfu_pct(mctx) == pytest.approx(100 * 5e12 / 989e12)
    assert _layer.launches_per_unit(ctx) == 1.5
