"""The port's bench (``python -m renderloom_torch.bench``): with
``--device cpu`` each metric prints exactly one JSON line, tagged
``scaled`` (bench.py's reduced CPU shapes); without it and without a
CUDA device it raises and prints no result."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNITS = {"e2e": ("e2e_interp_frames_per_sec", "frame/s"),
         "motion_train": ("motion_train_seqs_per_sec", "seq/s"),
         "gan_train": ("gan_train_windows_per_sec", "window/s")}


def _bench(metric, *argv, env=None):
    return subprocess.run(
        [sys.executable, "-m", "renderloom_torch.bench", *argv], cwd=ROOT,
        env=dict(os.environ, BENCH_METRIC=metric, OMP_NUM_THREADS="1",
                 **(env or {})),
        capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("metric", sorted(UNITS))
def test_cpu_run_prints_one_scaled_json_line(metric):
    proc = _bench(metric, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    (line,) = proc.stdout.strip().splitlines()
    result = json.loads(line)
    assert (result["metric"], result["unit"]) == UNITS[metric]
    assert result["value"] > 0 and result["vs_baseline"] is None
    assert result["device"] == "cpu" and "CPU-reduced" in result["scaled"]


def test_no_cpu_fallback():
    proc = _bench("e2e", env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr
