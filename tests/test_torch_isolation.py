"""The PyTorch port stands alone: importing every module of
``renderloom_torch`` (the CLIs included) loads none of JAX, flax, optax
or the JAX package, and ``chip_smoke.py`` imports none of them.  Its
serving and training entry points run on the card unless told
otherwise, and without a card they refuse rather than run on the CPU.
The native decoder builds beside the CUDA kernels, not in the
package."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

import renderloom_torch.core.config as TC
from _torch_parity import motion_cfg, renderer_cfg
from renderloom_torch import native
from renderloom_torch.cli import build_dataset, infer_motion, infer_renderer
from renderloom_torch.cli import pipeline as pipeline_cli
from renderloom_torch.cli import train_motion, train_renderer
from renderloom_torch.eval import pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    names = []
    pkg = os.path.join(ROOT, "renderloom_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                names.append(mod[:-len(".__init__")]
                             if mod.endswith(".__init__") else mod)
    return sorted(names)


def test_port_imports_no_jax_and_no_jax_package():
    mods = _port_modules()
    assert {"renderloom_torch.eval.pipeline", "renderloom_torch.train.gan",
            "renderloom_torch.cli.train_renderer",
            "renderloom_torch.cli.infer_motion",
            "renderloom_torch.cli.infer_renderer",
            "renderloom_torch.cli.pipeline",
            "renderloom_torch.core.checkpoint",
            "renderloom_torch.data.amass", "renderloom_torch.data.hsm",
            "renderloom_torch.data.openpose",
            "renderloom_torch.eval.render_eval", "renderloom_torch.native",
            "renderloom_torch.utils.visualize",
            "renderloom_torch.cli.train_motion",
            "renderloom_torch.core.logging",
            "renderloom_torch.data.prefetch",
            "renderloom_torch.eval.motion_eval",
            "renderloom_torch.models.motion_discriminator",
            "renderloom_torch.train.motion",
            "renderloom_torch.utils.profiling",
            "renderloom_torch.parallel", "renderloom_torch.parallel.mesh",
            "renderloom_torch.eval.export",
            "renderloom_torch.utils.serving", "renderloom_torch.bench",
            "renderloom_torch.cli.export_model",
            "renderloom_torch.cli.import_checkpoint",
            "renderloom_torch.cli.build_dataset",
            "renderloom_torch.data.torch_import",
            "renderloom_torch.data.builders",
            "renderloom_torch.core.registry"} <= set(mods)
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "renderloom")]
    assert not bad, bad


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "renderloom_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "optax", "renderloom"}, \
        roots


def test_build_pipeline_defaults_to_the_card_and_never_falls_back(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.build_pipeline(motion_cfg(TC), renderer_cfg(TC, 32, 48),
                                2, 3)


def test_train_cli_defaults_to_the_card_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_renderer.main(["--synthetic", "--epochs", "1"])


@pytest.mark.parametrize("cli,argv", [
    (train_renderer, ["--h5", "absent.h5", "--epochs", "1"]),
    (train_motion, ["--synthetic", "--epochs", "1"]),
    (train_motion, ["--h5", "absent.h5", "--epochs", "1"]),
])
def test_h5_and_motion_training_default_to_the_card(monkeypatch, cli, argv):
    """Refused before any file is opened."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


@pytest.mark.parametrize("cli,argv", [
    (infer_motion, ["--ckpt", "m.npz", "--pose-dir", ".", "--save-dir",
                    "."]),
    (infer_renderer, ["--ckpt", "r.pt", "--input-dir", "."]),
    (pipeline_cli, ["--frames-dir", ".", "--pose-dir", ".",
                    "--motion-ckpt", "m.npz", "--renderer-ckpt", "r.pt",
                    "--out-dir", "."]),
    (build_dataset, ["warp", "--frames", ".", "--out", "."]),
])
def test_serving_clis_default_to_the_card_and_never_fall_back(
        monkeypatch, cli, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def test_native_decoder_builds_outside_the_package():
    lib = native.library_path()
    assert lib.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "renderloom_torch")
    assert os.path.dirname(str(native.BUILD_DIR.parent)) == ROOT
    assert native.native_available() and lib.exists()
    pkg = os.path.join(ROOT, "renderloom_torch", "native")
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]
