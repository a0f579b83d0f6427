"""The port's export CLI (``renderloom_torch.cli.export_model``) on the
CPU, as tests/test_export.py runs the JAX one: tiny configs from yaml,
no checkpoints (seeded random weights), a 2-clip program at 64×96, rate
2, 3 keyframes, loaded and served; and its refusal to export for the
CUDA device (the default) without one."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import yaml

import renderloom_torch.core.config as TC
from _torch_parity import motion_cfg, renderer_cfg, single_thread  # noqa: F401
from renderloom_torch.cli import export_model
from renderloom_torch.eval.export import load_exported

H, W = 64, 96
RATE, K = 2, 3


def _configs(tmp_path):
    paths = []
    for name, cfg in (("m", motion_cfg(TC)), ("r", renderer_cfg(TC, H, W))):
        path = str(tmp_path / f"{name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(dataclasses.asdict(cfg), f)
        paths.append(path)
    return paths


def test_export_cli_without_checkpoints(tmp_path, capsys):
    m_yaml, r_yaml = _configs(tmp_path)
    out = str(tmp_path / "cli.pt2")
    meta = export_model.main(["--motion-config", m_yaml, "--renderer-config",
                              r_yaml, "--rate", str(RATE), "--keyframes",
                              str(K), "--clips", "2", "--device", "cpu",
                              "--out", out])
    assert f"({meta['bytes'] / 1e6:.1f} MB)" in capsys.readouterr().out
    serve, meta2 = load_exported(out)
    assert meta2["n_clips"] == 2 and meta2["trained"] is False
    assert meta2["device"] == "cpu" and meta2["fastpath"] is False
    rng = np.random.default_rng(7)
    fused, sync = serve(rng.uniform(-0.5, 0.5, (2, 19, 2, K)),
                        rng.uniform(0.5, 1.0, (2, 19, 1, K)),
                        rng.uniform(0.0, 1.0, (2, K, H, W, 3)))
    assert tuple(fused.shape) == (2, meta2["frames_out"], H, W, 3)
    assert bool(torch.isfinite(fused).all()) and np.isfinite(float(sync))


def test_export_cli_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_model.main(["--out", str(tmp_path / "x.pt2")])
