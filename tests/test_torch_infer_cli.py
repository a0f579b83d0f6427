"""The PyTorch port's serving CLIs (``renderloom_torch/cli/infer_motion.py``,
``infer_renderer.py``, ``pipeline.py``) with ``--device cpu`` against the
JAX package's functions on the same files and weights, at 64×96 with
tiny widths, reading the weights from an ``.npz`` of the JAX flax trees
and from the port's ``torch.save`` checkpoints
(``renderloom_torch/core/checkpoint.py``).

Tolerances: the ``Predict_motion`` and ``Linear_motion`` joints within
1e-3 px of JAX's ``interpolate_openpose`` (``openpose_scale`` 512 times
float32 differences of the transformer's output; the reading is
4.6e-5 px); the generated PNGs within 1 level of JAX's ``render_folder``
run on the port's own ``DAIN/`` and ``Predict_motion/`` (so the
background quantization is not counted twice), and the LK backgrounds
within 1 level of JAX's ``synthesize_backgrounds``.  Super SloMo's
backgrounds (``--background superslomo``), which the JAX package lacks,
are held against the port's own model on the same files, exactly.
"""

import json
import os
import types

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import renderloom.core.config as JC
import renderloom_torch.core.config as TC
from _torch_parity import (blobs, generator_trees, motion_cfg,  # noqa: F401
                           motion_tree, renderer_cfg, single_thread)
from renderloom.cli.infer_renderer import \
    synthesize_backgrounds as jax_backgrounds
from renderloom.eval import render_eval as JE
from renderloom.eval.motion_infer import MotionInterpolator as JInterp
from renderloom.models.motion_transformer import build_motion_model
from renderloom_torch.cli import infer_motion, infer_renderer, pipeline
from renderloom_torch.convert import (flax_trees, load_flax_params,
                                      random_init_)
from renderloom_torch.core import checkpoint
from renderloom_torch.data.amass import stats_paths
from renderloom_torch.data.openpose import write_openpose_dir
from renderloom_torch.models import motion_transformer as TM
from renderloom_torch.models.layers import enable_spectral_norm
from renderloom_torch.models.renderer import Generator
from renderloom_torch.models.superslomo import SuperSloMo

H, W, RATE, K = 64, 96, 2, 3
JOINT_TOL = 1e-3        # px


def _tree_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Configs, statistics, keyframes and keyframe poses, and both
    checkpoint formats of the same weights."""
    root = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(11)
    stats = root / "stats"
    stats.mkdir()
    mean = np.zeros((19, 2), np.float32)
    std = np.full((19, 2), 0.02, np.float32)
    mraw = {"transformer": {"hidden_dim": 32, "nheads": 4,
                            "dim_feedforward": 64, "enc_layers": 2,
                            "dec_layers": 2, "dropout": 0.0},
            "pos_encode": {"hidden_dim": 32},
            "dataset": {"data_root": str(stats)}}
    rraw = {"gen": {"num_filters": 4, "max_num_filters": 16,
                    "num_layers": 6, "num_downsamples": 4,
                    "do_checkpoint": False,
                    "mask": {"num_filters": 4, "max_num_filters": 16,
                             "num_downsamples": 3, "num_res_blocks": 2},
                    "embed": {"num_filters": 4, "max_num_filters": 16,
                              "num_downsamples": 4}},
            "data": {"model_width": W, "model_height": H, "load_width": W,
                     "load_height": H}}
    paths = {"motion_cfg": str(root / "motion.yaml"),
             "renderer_cfg": str(root / "renderer.yaml")}
    for key, raw in (("motion_cfg", mraw), ("renderer_cfg", rraw)):
        with open(paths[key], "w") as f:
            yaml.safe_dump(raw, f)
    mcfg = TC.load_motion_config(paths["motion_cfg"])
    rcfg = TC.load_renderer_config(paths["renderer_cfg"])
    assert rcfg == renderer_cfg(TC, H, W)
    assert mcfg.transformer == motion_cfg(TC).transformer
    for path, arr in zip(stats_paths(mcfg.dataset), (mean, std)):
        np.save(path, arr)

    m_params = motion_tree(JC.load_motion_config(paths["motion_cfg"]),
                           seed=2)
    g_params, g_stats = generator_trees(renderer_cfg(JC, H, W), H, W,
                                        seed=4)
    paths["motion.npz"] = str(root / "motion.npz")
    paths["renderer.npz"] = str(root / "renderer.npz")
    checkpoint.write_npz(paths["motion.npz"], m_params)
    checkpoint.write_npz(paths["renderer.npz"], g_params, g_stats)
    paths["motion.pt"] = str(root / "motion.pt")
    paths["renderer.pt"] = str(root / "renderer.pt")
    torch.save(load_flax_params(TM.build_motion_model(mcfg),
                                m_params).state_dict(), paths["motion.pt"])
    gen = enable_spectral_norm(Generator(rcfg.gen))
    load_flax_params(gen, g_params, g_stats)
    torch.save({"step": 0, "gen": gen.state_dict()}, paths["renderer.pt"])

    frames = root / "frames"
    frames.mkdir()
    keys = (blobs(K, H, W, seed=3) * 255).astype(np.uint8)
    for i, key in enumerate(keys):
        Image.fromarray(key).save(frames / f"{i:03d}.png")
    motion = np.stack([rng.uniform(-0.47, -0.34, (19, K)),
                       rng.uniform(-0.48, -0.4, (19, K))], axis=1)
    write_openpose_dir(motion, np.full((19, 1, K), 0.9), str(root / "poses"))
    return dict(paths, root=root, frames=str(frames),
                poses=str(root / "poses"), m_params=m_params,
                g_trees=(g_params, g_stats), mean=mean, std=std)


def _joints(folder):
    out = []
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name)) as f:
            person = json.load(f)["people"][0]
        out.append([person[k] for k in ("pose_keypoints_2d",
                                        "hand_left_keypoints_2d",
                                        "hand_right_keypoints_2d")])
    return np.asarray([np.concatenate(p) for p in out])


def _pngs(path):
    return np.stack([np.asarray(Image.open(os.path.join(path, f)))
                     for f in sorted(os.listdir(path))])


@pytest.fixture(scope="module")
def jax_motion(files):
    """JAX's ``interpolate_openpose`` of the keyframe poses."""
    jcfg = JC.load_motion_config(files["motion_cfg"])
    interp = JInterp(build_motion_model(jcfg), files["m_params"], jcfg,
                     files["mean"], files["std"])
    out = files["root"] / "jax_motion"
    interp.interpolate_openpose(files["poses"], RATE, str(out / "pred"),
                                str(out / "lin"))
    return {"Predict_motion": _joints(out / "pred"),
            "Linear_motion": _joints(out / "lin")}


def _hold_motion(save_dir, jax_motion):
    for name, want in jax_motion.items():
        got = _joints(os.path.join(save_dir, name))
        assert got.shape == want.shape == ((K - 1) * RATE + 1, 75 + 126)
        err = np.abs(got - want).max()
        print(f"{name}: max |port - JAX| {err:.3e} px")
        assert err <= JOINT_TOL, (name, err)


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_infer_motion_cli_matches_jax(files, jax_motion, tmp_path, fmt):
    infer_motion.main(["--config", files["motion_cfg"], "--ckpt",
                       files[f"motion.{fmt}"], "--pose-dir", files["poses"],
                       "--save-dir", str(tmp_path), "--upsample-rate",
                       str(RATE), "--device", "cpu"])
    _hold_motion(str(tmp_path), jax_motion)


@pytest.fixture(scope="module")
def pipeline_runs(files):
    """The pipeline CLI from each checkpoint format, and JAX's
    ``render_folder`` on the npz run's backgrounds and poses."""
    runs = {}
    for fmt in ("npz", "pt"):
        out = str(files["root"] / f"out_{fmt}")
        seconds = pipeline.main([
            "--frames-dir", files["frames"], "--pose-dir", files["poses"],
            "--motion-ckpt", files[f"motion.{fmt}"], "--renderer-ckpt",
            files[f"renderer.{fmt}"], "--motion-config", files["motion_cfg"],
            "--renderer-config", files["renderer_cfg"], "--out-dir", out,
            "--rate", str(RATE), "--device", "cpu"])
        assert sorted(seconds) == ["background", "motion", "render"]
        runs[fmt] = out
    out = runs["npz"]
    params, stats = files["g_trees"]
    JE.render_folder(None, types.SimpleNamespace(params_g=params,
                                                 stats_g=stats),
                     renderer_cfg(JC, H, W), files["frames"],
                     os.path.join(out, "DAIN"),
                     os.path.join(out, "Predict_motion"),
                     str(files["root"] / "jax_frames"))
    runs["jax"] = _pngs(files["root"] / "jax_frames")
    return runs


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_pipeline_cli_matches_jax(files, jax_motion, pipeline_runs, fmt):
    out = pipeline_runs[fmt]
    _hold_motion(out, jax_motion)
    got, want = _pngs(os.path.join(out, "Generated_frames")), \
        pipeline_runs["jax"]
    assert got.shape == want.shape == ((K - 1) * RATE + 1, H, W, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    print(f"{fmt}: max |port - JAX| {diff.max()} levels, "
          f"{100 * (diff > 0).mean():.4f}% of values not equal")
    assert diff.max() <= 1
    # both checkpoint formats carry the same weights
    np.testing.assert_array_equal(
        got, _pngs(os.path.join(pipeline_runs["npz"], "Generated_frames")))


def test_synthesize_backgrounds_matches_jax(files, tmp_path):
    n = infer_renderer.synthesize_backgrounds(files["frames"],
                                              str(tmp_path / "port"), 4,
                                              "cpu")
    m = jax_backgrounds(files["frames"], str(tmp_path / "jax"), 4)
    assert n == m == (K - 1) * 4 + 1
    got, want = _pngs(tmp_path / "port"), _pngs(tmp_path / "jax")
    diff = np.abs(got.astype(int) - want.astype(int))
    print(f"backgrounds: max |port - JAX| {diff.max()} levels, "
          f"{100 * (diff > 0).mean():.4f}% of values not equal")
    assert diff.max() <= 1


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_pipeline_cli_takes_superslomo_backgrounds(files, tmp_path, fmt):
    """``--background superslomo``: stage 2 writes Super SloMo's
    backgrounds (published widths, seeded weights) read from a checkpoint
    the test writes, the port's ``torch.save`` of the state dict or an
    ``.npz`` of its flax tree, exactly as the model makes them from the
    keyframe files; the frames are rendered over them."""
    model = random_init_(SuperSloMo(), seed=5).eval()
    ckpt = str(tmp_path / f"slomo.{fmt}")
    if fmt == "pt":
        torch.save(model.state_dict(), ckpt)
    else:
        checkpoint.write_npz(ckpt, flax_trees(model)[0])
    out = tmp_path / "out"
    seconds = pipeline.main([
        "--frames-dir", files["frames"], "--pose-dir", files["poses"],
        "--motion-ckpt", files["motion.npz"], "--renderer-ckpt",
        files["renderer.npz"], "--motion-config", files["motion_cfg"],
        "--renderer-config", files["renderer_cfg"], "--out-dir", str(out),
        "--rate", str(RATE), "--device", "cpu", "--background",
        "superslomo", "--slomo-ckpt", ckpt])
    assert sorted(seconds) == ["background", "motion", "render"]
    keys = torch.from_numpy(_pngs(files["frames"]).astype(np.float32)
                            / 255.0)
    with torch.inference_mode():
        want = model(keys[None], RATE)[0]
    want = (want.clamp(0, 1) * 255).to(torch.uint8).numpy()
    np.testing.assert_array_equal(_pngs(out / "DAIN"), want)
    assert _pngs(out / "Generated_frames").shape == ((K - 1) * RATE + 1, H,
                                                     W, 3)
    with pytest.raises(SystemExit, match="needs --slomo-ckpt"):
        pipeline.main(["--frames-dir", ".", "--pose-dir", ".",
                       "--motion-ckpt", "m", "--renderer-ckpt", "r",
                       "--out-dir", str(out), "--background", "superslomo"])


@pytest.mark.parametrize("cli,argv", [
    (infer_renderer, ["--ckpt", "x.pt", "--input-dir", ".", "--flow-ckpt",
                      "ORBAX"]),
    (pipeline, ["--frames-dir", ".", "--pose-dir", ".", "--motion-ckpt",
                "m", "--renderer-ckpt", "r", "--out-dir", "OUT",
                "--flow-ckpt", "ORBAX"]),
    (pipeline, ["--frames-dir", ".", "--pose-ckpt", "ORBAX",
                "--motion-ckpt", "m", "--renderer-ckpt", "r", "--out-dir",
                "OUT"]),
])
def test_unported_options_raise(cli, argv, tmp_path):
    """The learned flow and the pose head are ported, but the JAX CLIs
    save them as orbax directories, which the port cannot read: given
    one, each CLI refuses it with the way out, before any stage runs."""
    sub = {"ORBAX": str(tmp_path), "OUT": str(tmp_path / "out")}
    with pytest.raises(ValueError, match="without JAX"):
        cli.main([sub.get(a, a) for a in argv] + ["--device", "cpu"])
    assert not (tmp_path / "out" / "Predict_motion").exists()


def test_checkpoint_formats(files, tmp_path):
    """An ``.npz`` reads back to the trees written, spectral-norm keys
    (which hold slashes) included; an orbax directory is refused with
    the way out."""
    params, stats = checkpoint.read_renderer(files["renderer.npz"])
    _tree_equal(params, files["g_trees"][0])
    _tree_equal(stats, files["g_trees"][1])
    _tree_equal(checkpoint.read_params(files["motion.npz"]),
                files["m_params"])
    _tree_equal(checkpoint.read_params(files["motion.pt"]),
                files["m_params"])
    with pytest.raises(ValueError, match="without JAX"):
        checkpoint.read_renderer(str(tmp_path))
    with pytest.raises(ValueError, match="not a renderer checkpoint"):
        checkpoint.read_renderer(files["motion.pt"])
