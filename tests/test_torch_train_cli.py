"""The port's training entry point on the CPU at a tiny size: raw
synthetic windows through the train-mode preparation and the GAN step,
``train/`` metrics to ``metrics.jsonl`` (``MetricLogger``'s records; the
logging interval set to every step), a ``torch.save`` checkpoint, and a
resume that continues from the saved step; and a config with
``compute_dtype: bfloat16``, which trains in bf16 on float32
parameters."""

import json
import os

import pytest
import torch

from _torch_parity import single_thread  # noqa: F401
from renderloom_torch.cli import train_renderer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--synthetic", "--device", "cpu", "--config",
        os.path.join(ROOT, "configs", "smoke_hsm.yaml"), "--height", "64",
        "--width", "96", "--batch-size", "1", "--steps-per-epoch", "1",
        "--seed", "3"]


def _lines(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(autouse=True)
def log_every_step(monkeypatch):
    monkeypatch.setattr(train_renderer, "TRAIN_LOG_EVERY", 1)


def test_train_save_and_resume(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    train_renderer.main(ARGS + ["--epochs", "2", "--out-dir", a])
    train_renderer.main(ARGS + ["--epochs", "1", "--out-dir", b])
    train_renderer.main(ARGS + ["--epochs", "2", "--out-dir", b,
                                "--resume"])
    la, lb = _lines(a), _lines(b)
    assert [r["step"] for r in la] == [r["step"] for r in lb] == [1, 2]
    # the same seed gives the same first step, to the bit
    drop = lambda r: {k: v for k, v in r.items() if k != "time"}
    assert drop(la[0]) == drop(lb[0])
    for r in la:
        assert r["train/notfinite/g"] == r["train/notfinite/d"] == 0.0
        assert all(map(lambda v: v == v, r.values()))       # no NaN
    ca = torch.load(os.path.join(a, "checkpoint.pt"))
    cb = torch.load(os.path.join(b, "checkpoint.pt"))
    assert ca["step"] == cb["step"] == 2
    # like the JAX CLI, a resumed run restarts its window generator from
    # the seed, so its second step trains on other windows than run a's
    assert ca["gen"].keys() == cb["gen"].keys()
    assert int(cb["opt_g"]["count"]) == 2
    assert any(k.endswith("sn_u") for k in ca["dis"])


def test_train_with_a_bf16_config(tmp_path):
    """The yaml key ``compute_dtype: bfloat16`` trains: finite metrics,
    no skipped update, float32 parameters in the checkpoint."""
    with open(os.path.join(ROOT, "configs", "smoke_hsm.yaml")) as f:
        text = f.read()
    config = tmp_path / "smoke_bf16.yaml"
    config.write_text(text + "\ncompute_dtype: bfloat16\n")
    out = str(tmp_path / "bf16")
    args = [a if a != ARGS[ARGS.index("--config") + 1] else str(config)
            for a in ARGS]
    train_renderer.main(args + ["--epochs", "1", "--out-dir", out])
    (line,) = _lines(out)
    assert line["train/notfinite/g"] == line["train/notfinite/d"] == 0.0
    assert all(v == v for v in line.values())
    ckpt = torch.load(os.path.join(out, "checkpoint.pt"))
    assert all(v.dtype == torch.float32 for v in ckpt["gen"].values())
    assert ckpt["opt_g"]["flat"].dtype == torch.float32
