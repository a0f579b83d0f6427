"""The port's motion training entry point
(``renderloom_torch.cli.train_motion``) on the CPU at a tiny size
(configs/smoke_motion.yaml): ``--synthetic`` and ``--h5`` (a tiny AMASS
h5 the test writes), the ``train/`` and ``eval/`` records of
``metrics.jsonl``, the checkpoint and a resume that continues from its
step, the statistics computed and cached, and ``read_motion`` of the
checkpoint."""

import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import single_thread, write_amass_h5  # noqa: F401
from renderloom_torch import convert
from renderloom_torch.cli import train_motion
from renderloom_torch.core.checkpoint import read_motion
from renderloom_torch.core.config import MotionDatasetConfig
from renderloom_torch.data.amass import stats_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "smoke_motion.yaml")


def _lines(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(autouse=True)
def log_every_step(monkeypatch):
    monkeypatch.setattr(train_motion, "TRAIN_LOG_EVERY", 1)


def test_synthetic_train_save_and_resume(tmp_path):
    args = ["--synthetic", "--device", "cpu", "--config", SMOKE,
            "--steps-per-epoch", "2", "--seed", "3"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    out = train_motion.main(args + ["--epochs", "2", "--out-dir", a])
    train_motion.main(args + ["--epochs", "1", "--out-dir", b])
    resumed = train_motion.main(args + ["--epochs", "2", "--out-dir", b,
                                        "--resume"])
    la, lb = _lines(a), _lines(b)
    assert [r["step"] for r in la] == [r["step"] for r in lb] == [1, 2, 3, 4]
    drop = lambda r: {k: v for k, v in r.items() if k != "time"}
    assert drop(la[0]) == drop(lb[0])          # same seed, same first step
    assert sorted(la[0]) == sorted(
        ["step", "time", "train/loss/denoise", "train/loss/pose2d",
         "train/loss/total", "train/grad_norm", "train/notfinite"])
    for r in la + lb:
        assert r["train/notfinite"] == 0.0
        assert all(np.isfinite(v) for v in r.values())
    assert [e["epoch"] for e in resumed["epochs"]] == [1]
    ck = torch.load(os.path.join(b, "checkpoint.pt"))
    assert ck["step"] == 4 and int(ck["opt"]["count"]) == 4
    assert os.path.exists(os.path.join(a, "code.zip"))
    # read_motion reads the checkpoint's model as flax trees
    params = read_motion(os.path.join(a, "checkpoint.pt"))
    want = convert.flax_trees(out["state"].model)[0]
    np.testing.assert_array_equal(params["dec_1"]["ffn"]["linear2"]
                                  ["kernel"], want["dec_1"]["ffn"]
                                  ["linear2"]["kernel"])


def test_h5_train_evaluate_and_resume(tmp_path):
    h5 = write_amass_h5(str(tmp_path / "amass.h5"),
                        {"CMU": (40, 25, 70), "KIT": (36,),
                         "HumanEva": (45, 20), "SFU": (50,)})
    data_root = tmp_path / "data"
    cfg = tmp_path / "motion.yaml"
    with open(SMOKE) as f:
        text = f.read().replace("eval_step: 1000", "eval_step: 1")
    cfg.write_text(text + f"\ndata_root: {data_root}\n")
    args = ["--h5", h5, "--device", "cpu", "--config", str(cfg),
            "--seed", "1"]
    out = str(tmp_path / "run")
    first = train_motion.main(args + ["--epochs", "1", "--out-dir", out])
    assert all(os.path.exists(p) for p in stats_paths(
        MotionDatasetConfig(data_root=str(data_root))))
    assert os.path.exists(data_root / "evaluation_view.npy")
    again = train_motion.main(args + ["--epochs", "2", "--out-dir", out,
                                      "--resume"])
    lines = _lines(out)
    train = [r for r in lines if "train/loss/total" in r]
    evals = [r for r in lines if "eval/mse_global" in r]
    # 4 train motions at batch 2: 2 steps an epoch
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert [r["step"] for r in evals] == [2, 4]
    assert sorted(k for k in evals[0] if k.startswith("eval/")) == sorted(
        f"eval/{k}_{s}" for k in ("mse", "mae", "max")
        for s in ("global", "interp"))
    for r in lines:
        assert all(np.isfinite(v) for v in r.values())
    assert again["epochs"][0]["epoch"] == 1 and \
        again["epochs"][0]["eval_seconds"] > 0
    # the cached statistics are the ones the first run computed
    np.testing.assert_array_equal(first["mean"], again["mean"])
    assert torch.load(os.path.join(out, "checkpoint.pt"))["step"] == 4
